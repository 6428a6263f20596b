#!/usr/bin/env python3
"""How float32 rounding plays on the strip-coarse pressure preconditioner
(K3-coarse) of fluidgym_tpu_torch, on the host.

    python3 scripts/port_strips_rounding.py [PART ...] [--threads 8]

Measurements, printed as one JSON object (PART picks some of them by name;
all when none is given):

* ``solves``: the pressure system of one main-path substep of the bundled
  CylinderJet2D-easy-v0 (``test_00``) and Airfoil2D-easy-v0 (``train_00``)
  snapshots (the sim step cut to CFL 0.8), solved cold by the plain K3 in
  float32 at the env's pressure tolerance with Jacobi alone, with the
  strips as the port builds them (``coarse_strips.coarse_inverse``, the
  constant mode projected out), and with the JAX package's form of the
  coarse inverse (``(E + eps I)^-1`` unprojected): iterations, converged,
  final residual.
* ``sensitivity``: the cylinder's system above solved twice per arm
  (Jacobi, the strips, the strips with eps_rel 1e-2), the second time
  with its RHS perturbed by 1e-7 relative: how far each arm carries that
  into its solution (``_sensitivity``); and the same pair of systems
  through the JAX package's own K3 entry, ``fused_cg_mb(coarse_strips=True,
  interpret=True)`` and with Jacobi alone (``_sensitivity_jax``), so the
  reference's two-level preconditioner is measured beside the port's;
* ``iterates``: the same pair of solves stopped after k = 10, 20, ..., 80
  iterations: how the two runs' iterates part as the iterations go
  (``_iterates``);
* ``spectrum``: the strips' coarse matrix E on both ids' systems: K, its
  mean diagonal, lowest and largest eigenvalues, and the overlap of its
  lowest eigenvector with ``1_K`` (``_spectrum``);
* ``threads``: one CylinderJet2D-easy-v0 env step (25 sim steps) from the
  bundled training snapshot (``reset(seed=0)`` without randomization, the
  state of ``chip_smoke.py`` phases 10 and 18) under the action 0.4, with
  the strips off and on, at 1 and at ``--threads`` host threads: the
  largest relative difference of each obs, of the reward, and the pressure
  iterations of each run.  Jacobi alone is the yardstick of how far
  summation order alone moves a step.

Runs on the CPU only.  Only ``_sensitivity_jax`` imports JAX and the JAX
package (inside the function; the port itself never does).
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


def _perturbed_cylinder():
    """The cylinder's pressure system of ``_system``, its RHS ``b`` and ``b``
    perturbed by 1e-7 relative (seeded normal noise), the env's tol2 and
    the arms (Jacobi, the strips, the strips with eps_rel 1e-2)."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import coarse_strips as cs

    torch.set_num_threads(1)
    plan, mops, bs, n = _system("CylinderJet2D-easy-v0",
                                "cylinder_2D_Re100_Res24", "test_00", 0.01)
    sp = cs.strip_plan(plan)
    diag, off = cg_cuda_mb.flatten_ops(plan, tuple(m[0] for m in mops),
                                       tuple(m[1] for m in mops))
    b = cg_cuda_mb.flatten_fields(plan, tuple(x[None] for x in bs))
    g = torch.Generator().manual_seed(0)
    bp = b * (1 + 1e-7 * torch.randn(b.shape, generator=g))
    arms = {"jacobi": None,
            "strips": (sp, cs.coarse_inverse(plan, sp, mops)[None]),
            "strips_eps_1e-2": (sp, cs.coarse_inverse(plan, sp, mops,
                                                      eps_rel=1e-2)[None])}
    return plan, diag, off, b, bp, cg_cuda.tol2_sum_f32(1e-5, n), arms


def _rel_diff(xa, xb):
    xa, xb = xa - xa.mean(), xb - xb.mean()
    return float((xa - xb).abs().max() / xa.abs().max())


def _sensitivity():
    """How far each arm carries a 1e-7 relative perturbation of the RHS
    into its solution (``_perturbed_cylinder``), cold, at the env's
    tolerance: the largest difference of the two mean-free solutions
    relative to max|x|, and both iteration counts.  ``strips_eps_1e-2``:
    the strips with a 1e4 x larger regularisation of the coarse inverse;
    ``strips_float64``: the strips on the same numbers widened to float64."""
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    from fluidgym_tpu_torch.solver import coarse_strips as cs

    plan, diag, off, b, bp, tol2, arms = _perturbed_cylinder()
    # the strips in float64: the same float32 numbers widened
    wide = lambda t: t.double()
    mops64 = tuple((wide(d[0]), wide(o)) for d, o in zip(
        cg_cuda_mb.unflatten_fields(plan, diag),
        (u.reshape((2 * plan.ndims,) + tuple(u.shape[1:])) for u in
         cg_cuda_mb.unflatten_fields(plan, off.reshape(2 * plan.ndims, -1)))))
    sp = cs.strip_plan(plan)
    cases = [(arm, coarse, diag, off, b, bp) for arm, coarse in arms.items()]
    cases.append(("strips_float64", (sp, cs.coarse_inverse(plan, sp, mops64)[None]),
                  wide(diag), wide(off), wide(b), wide(bp)))
    out = {}
    for arm, coarse, d, o, rhs0, rhs1 in cases:
        xs, its = [], []
        for rhs in (rhs0, rhs1):
            x, it, _ = cg_cuda_mb.fused_cg_mb_plain(
                plan, d, o, rhs, None, tol2_sum=tol2, maxiter=5000,
                stall_iters=250, precondition=True, return_best=True,
                coarse=coarse)
            xs.append(x)
            its.append(int(it[0]))
        out[arm] = {"x_rel_diff": _rel_diff(*xs), "iterations": its}
    return out


def _sensitivity_jax():
    """``_sensitivity``'s two solves (the RHS and the RHS perturbed by 1e-7
    relative) through the JAX package's ``cg_pallas_mb.fused_cg_mb`` on the
    same numbers (the port's operator and RHS as float32 arrays, the plan
    merged from the JAX package's own cylinder topology), with the strips
    (``coarse_strips=True``, the reference's unprojected coarse inverse) and
    with Jacobi alone, in interpret mode on the CPU, and with the strips in
    float64 (the same float32 numbers widened): how far the reference
    carries the perturbation into its solution."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import fluidgym_tpu
    from fluidgym_tpu.ops import cg_pallas_mb
    from fluidgym_tpu.solver import block_merge as jbm
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    jax.config.update("jax_platforms", "cpu")
    plan, diag, off, b, bp, _, _ = _perturbed_cylinder()
    env = fluidgym_tpu.make("CylinderJet2D-easy-v0", load_initial_domain=False,
                            load_domain_statistics=False,
                            randomize_initial_state=False)
    env.reset(seed=0)
    jplan = jbm.merge_plan(env._topo)
    nf = 2 * plan.ndims
    per_sb = lambda t: [jnp.asarray(x[0].numpy())
                        for x in cg_cuda_mb.unflatten_fields(plan, t)]
    jd = per_sb(diag)
    jo = [jnp.asarray(x.numpy().reshape((nf,) + tuple(x.shape[1:])))
          for x in cg_cuda_mb.unflatten_fields(plan, off.reshape(nf, -1))]
    flat = lambda xs: np.concatenate([np.asarray(x).reshape(-1) for x in xs])
    out = {}
    for arm, strips, f64 in (("jax_jacobi", False, False),
                             ("jax_strips", True, False),
                             ("jax_strips_float64", True, True)):
        xs, its, conv = [], [], []
        for rhs in (b, bp):
            with jax.enable_x64(f64):
                cast = lambda xs: [x.astype(jnp.float64 if f64 else jnp.float32)
                                   for x in xs]
                x, info = cg_pallas_mb.fused_cg_mb(
                    jplan, cast(jd), cast(jo), cast(per_sb(rhs)), None,
                    tol=1e-5, maxiter=5000, stall_iters=250, precondition=True,
                    return_best=True, coarse_strips=strips, interpret=True)
                xs.append(flat(x))
                its.append(int(info.iterations))
                conv.append(bool(info.converged))
        xa, xb = (x - x.mean() for x in xs)
        out[arm] = {"x_rel_diff": float(np.abs(xa - xb).max() / np.abs(xa).max()),
                    "iterations": its, "converged": conv}
    return out


def _iterates():
    """Where the two solves of ``_sensitivity`` part: after k iterations
    (no stopping test, no return-best) the largest difference of their
    mean-free iterates relative to max|x|, per arm."""
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    plan, diag, off, b, bp, _, arms = _perturbed_cylinder()
    out = {}
    for arm, coarse in arms.items():
        out[arm] = {}
        for k in (10, 20, 30, 40, 50, 60, 70, 80):
            xs = [cg_cuda_mb.fused_cg_mb_plain(
                plan, diag, off, rhs, None, tol2_sum=0.0, maxiter=k,
                stall_iters=250, precondition=True, return_best=False,
                coarse=coarse)[0] for rhs in (b, bp)]
            out[arm][k] = _rel_diff(*xs)
    return out


def _spectrum():
    """The coarse matrix E of the strips on each id's pressure system of
    ``_system``: its K, mean diagonal (trace / K), lowest eigenvalues and
    largest one, and how far its lowest eigenvector is from ``1_K``."""
    import torch

    from fluidgym_tpu_torch.solver import coarse_strips as cs

    out = {}
    for env_id, data, split, dt0 in (
            ("CylinderJet2D-easy-v0", "cylinder_2D_Re100_Res24", "test_00", 0.01),
            ("Airfoil2D-easy-v0", "airfoil_2D_Re1000", "train_00", 0.05)):
        plan, mops, _, _ = _system(env_id, data, split, dt0)
        sp = cs.strip_plan(plan)
        ev, vec = torch.linalg.eigh(cs._assemble_E64(plan, sp, mops))
        out[env_id] = {"K": sp.K, "mean_diagonal": float(ev.sum() / sp.K),
                       "lowest": [float(v) for v in ev[:4]],
                       "largest": float(ev[-1]),
                       "lowest_vector_dot_ones": float(abs(vec[:, 0].sum())
                                                       / sp.K ** 0.5)}
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
    parts = {"solves": _solves, "sensitivity": _sensitivity,
             "sensitivity_jax": _sensitivity_jax, "iterates": _iterates,
             "spectrum": _spectrum}
    ap = argparse.ArgumentParser()
    ap.add_argument("part", nargs="*", choices=[*parts, "threads"],
                    help="measurements to run (default: all)")
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    chosen = args.part or [*parts, "threads"]
    if "sensitivity" in chosen and "sensitivity_jax" not in chosen:
        chosen.append("sensitivity_jax")
    out = {"device": "cpu"}
    for name in chosen:
        out[name] = ({"n": args.threads, **_threads(args.threads)}
                     if name == "threads" else parts[name]())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
