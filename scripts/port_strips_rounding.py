#!/usr/bin/env python3
"""How float32 rounding plays on the strip-coarse pressure preconditioner
(K3-coarse) of fluidgym_tpu_torch, on the host.

    python3 scripts/port_strips_rounding.py [--threads 8]

Two measurements, printed as one JSON object:

* ``solves``: the pressure system of one main-path substep of the bundled
  CylinderJet2D-easy-v0 (``test_00``) and Airfoil2D-easy-v0 (``train_00``)
  snapshots (the sim step cut to CFL 0.8), solved cold by the plain K3 in
  float32 at the env's pressure tolerance with Jacobi alone, with the
  strips as the port builds them (``coarse_strips.coarse_inverse``, the
  constant mode projected out), and with the JAX package's form of the
  coarse inverse (``(E + eps I)^-1`` unprojected): iterations, converged,
  final residual.
* ``threads``: one CylinderJet2D-easy-v0 env step (25 sim steps) from the
  bundled training snapshot (``reset(seed=0)`` without randomization, the
  state of ``chip_smoke.py`` phases 10 and 18) under the action 0.4, with
  the strips off and on, at 1 and at ``--threads`` host threads: the
  largest relative difference of each obs, of the reward, and the pressure
  iterations of each run.  Jacobi alone is the yardstick of how far
  summation order alone moves a step.

Runs on the CPU only; imports nothing of JAX or of the JAX package.
"""

import argparse
import dataclasses
import json
import os
import sys


def _system(env_id, data, split, dt0):
    import torch

    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.solver import block_merge, piso
    from fluidgym_tpu_torch.solver import stencil as st
    from fluidgym_tpu_torch.utils import data_utils

    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir(data) / split, device="cpu")
    plan = block_merge.merge_plan(topo)
    cfg = piso.SimConfig(dt=dt0, adaptive_cfl=0.8, differentiable=False)
    dt = piso._cfl_ts(state, geoms, topo, cfg, torch.tensor(dt0))
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    hbyA = st.pressure_rhs_vec(state, geoms, topo, adv,
                               tuple(b.velocity for b in state.blocks),
                               state.viscosity, dt)
    rhs = tuple(-d for d in st.divergence_of(hbyA, state, geoms, topo))
    n = sum(r.numel() for r in rhs)
    mean = sum(r.sum() for r in rhs) / n
    rhs = tuple(r - mean for r in rhs)
    return plan, block_merge.pack_ops(plan, p_ops), block_merge.pack_fields(plan, rhs), n


def _solves():
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import coarse_strips as cs

    out = {}
    for env_id, data, split, dt0, tol in (
            ("CylinderJet2D-easy-v0", "cylinder_2D_Re100_Res24", "test_00", 0.01, 1e-5),
            ("Airfoil2D-easy-v0", "airfoil_2D_Re1000", "train_00", 0.05, 1e-7)):
        plan, mops, bs, n = _system(env_id, data, split, dt0)
        sp = cs.strip_plan(plan)
        diag, off = cg_cuda_mb.flatten_ops(plan, tuple(m[0] for m in mops),
                                           tuple(m[1] for m in mops))
        b = cg_cuda_mb.flatten_fields(plan, tuple(x[None] for x in bs))
        E = cs._assemble_E64(plan, sp, mops)
        eps = 1e-6 * torch.trace(E) / sp.K
        jax_form = torch.linalg.inv(E + eps * torch.eye(sp.K, dtype=E.dtype))
        arms = {"jacobi": None,
                "strips": (sp, cs.coarse_inverse(plan, sp, mops)[None]),
                "strips_unprojected": (sp, jax_form.float()[None])}
        tol2 = cg_cuda.tol2_sum_f32(tol, n)
        out[env_id] = {}
        for arm, coarse in arms.items():
            _, it, rs = cg_cuda_mb.fused_cg_mb_plain(
                plan, diag, off, b, None, tol2_sum=tol2, maxiter=5000,
                stall_iters=250, precondition=True, return_best=True,
                coarse=coarse)
            out[env_id][arm] = {"iterations": int(it[0]),
                                "converged": bool(rs[0] <= tol2),
                                "residual": float(torch.sqrt(rs[0] / n)),
                                "tol": tol}
    return out


def _threads(n_threads):
    import numpy as np
    import torch

    import fluidgym_tpu_torch

    out = {}
    for strips in (False, True):
        runs = {}
        for nt in (1, n_threads):
            torch.set_num_threads(nt)
            env = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu",
                                          randomize_initial_state=False)
            env.reset(seed=0)
            env._cfg = dataclasses.replace(env._cfg, pressure_coarse_strips=strips)
            obs, reward, *_, info = env.step(np.array([0.4], np.float32))
            runs[nt] = (dict(obs, reward=reward), int(info["pressure_iterations"]))
        (a, ia), (b, ib) = runs[1], runs[n_threads]
        out["strips" if strips else "jacobi"] = {
            **{k: float((a[k] - b[k]).abs().max() / b[k].abs().max()) for k in a},
            "pressure_iterations": [ia, ib]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    print(json.dumps({"device": "cpu", "solves": _solves(),
                      "threads": {"n": args.threads, **_threads(args.threads)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
