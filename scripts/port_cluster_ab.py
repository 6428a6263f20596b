#!/usr/bin/env python3
"""The cluster arm of K3 / K2-mb against the chunk grid, end to end, on one
CUDA card.

    python3 scripts/port_cluster_ab.py [--airfoil-steps 2] [--cyl-steps 5]
        [--parent DIR] [--out FILE]

For Airfoil2D-easy-v0 and CylinderJet2D-easy-v0 at their registered
defaults (the airfoil without randomization, as ``chip_smoke.py`` phase 12;
the cylinder as phase 9), ``make`` and ``reset(seed=0)``, then four arms in
turns from that same state: plain, cluster, cluster, plain.  "plain" pins
the cluster rule to C = 1 (``cg_cuda_mb.pinned_cluster(1)``: every solve
on the chunk grid, one block per lane), "cluster" leaves it free
(``default_cluster``).  Each arm takes the same fixed actions and reports
ms per env step (host clock around ``env.step``, ending in a device
synchronise), pressure iterations, the K3 / K2-mb launches and how many
took the cluster arm, and the largest obs difference from the first plain
arm and whether every obs is bit-equal to it (the cluster arm's sums are
the chunk grid's, so the four arms step the same trajectory).

With ``--parent DIR`` (a directory holding the parent revision's
``fluidgym_tpu_torch/csrc/`` and ``fluidgym_tpu_torch/ops/_build.py``, e.g.
from ``git archive``), it first builds that revision's kernel library and
holds this tree's K3, K3-flip, K2-mb and K2-mb-flip at C = 1 and at the
rule's C to it bit for bit on the main path's systems (the bundled
snapshots' pressure solve warm from the deflated guess, and the 2-lane
velocity solve).

Prints one JSON object (also to ``--out``) with the card's name and power
limit.  Needs a card; imports nothing of JAX or of the JAX package.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402  (the snapshot systems of phases 7-13)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def _parent_library(root: str):
    """The parent revision's kernel library, built from its own sources."""
    path = os.path.join(root, "fluidgym_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library(), mod


def parent_check(dev, root: str) -> dict:
    """This tree's K3 / K2-mb at C = 1 and at the rule's C against the
    parent's launch of the same systems, bit for bit."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge, piso
    from fluidgym_tpu_torch.solver import stencil as st

    lib, mod = _parent_library(root)
    out = {}
    for case in chip_smoke.MERGED_CASES:
        sy = chip_smoke._snapshot_system(dev, piso, case)
        plan, n = sy["plan"], sy["n"]
        flat = lambda xs: cg_cuda_mb.flatten_fields(plan, xs)

        def ops_of(ops):
            m = block_merge.pack_ops(plan, ops)
            return cg_cuda_mb.flatten_ops(plan, tuple(a[0] for a in m),
                                          tuple(a[1] for a in m))

        state = sy["state"]
        vel = st.advection_rhs_velocity(state, sy["geoms"], sy["topo"],
                                        state.viscosity, sy["dt"])
        pack = lambda fs: flat(tuple(p.unsqueeze(0) for p in
                                     block_merge.pack_fields(plan, fs)))
        systems = (
            (case["k3"], "cg", *ops_of(sy["p_ops"]), pack(sy["rhs"]),
             pack(sy["guess"]), case["tol_p"]),
            (case["k2"], "bicgstab", *ops_of(sy["adv"]),
             torch.cat([pack(tuple(f[c] for f in vel)) for c in range(2)]),
             torch.cat([pack(tuple(b.velocity[c] for b in state.blocks))
                        for c in range(2)]), 1e-5))
        for name, algo, diag, off, b, x0, tol in systems:
            L = b.shape[0]
            kw = dict(tol2_sum=cg_cuda.tol2_sum_f32(tol, n), maxiter=5000,
                      stall_iters=250, precondition=True,
                      return_best=algo == "cg")
            res = {}
            for C in (1, cg_cuda_mb.default_cluster(L, n, 2, 1, dev, algo)):
                x, it, rs = cg_cuda_mb._launch_merged(algo, plan, diag, off, b,
                                                      x0, chunk=1, cluster=C, **kw)
                res[C] = (x.clone(), it.clone(), rs.clone())
            # the parent's entry: the same arguments without cluster
            nbr = cg_cuda_mb.neighbor_table(plan, dev)
            px = torch.empty_like(b)
            scratch = [torch.empty_like(b) for _ in range(4 if algo == "cg" else 8)]
            pit = torch.empty(L, dtype=torch.int32, device=dev)
            prs = torch.empty(L, dtype=torch.float32, device=dev)
            entry = lib.fg_cg_mb_solve if algo == "cg" else lib.fg_bicgstab_mb_solve
            status = entry(b.data_ptr(), diag.data_ptr(), off.data_ptr(),
                           nbr.data_ptr(), x0.data_ptr(), px.data_ptr(),
                           pit.data_ptr(), prs.data_ptr(),
                           *[s.data_ptr() for s in scratch], L, 1, n, 2, 0,
                           kw["tol2_sum"], 5000, 250, 1, int(kw["return_best"]),
                           1, torch.cuda.current_stream(dev).cuda_stream)
            mod.check(status, f"parent {name}")
            torch.cuda.synchronize()
            same = lambda C: bool(all(torch.equal(u, v) for u, v in
                                      zip(res[C], (px, pit, prs))))
            Cr = max(res)
            out[name] = dict(
                bit_equal_at_cluster_1=same(1), rule_cluster=Cr,
                bit_equal_at_rule_cluster=same(Cr),
                iterations_parent=pit.tolist(), iterations_rule=res[Cr][1].tolist(),
                rel_dx_rule_vs_parent=float((res[Cr][0] - px).abs().max()
                                            / px.abs().max().clamp(min=1e-30)))
            print(f"parent check {name}: {out[name]}", flush=True)
    return out


def ab(env_id: str, steps: int, make_kw: dict) -> dict:
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    env = fluidgym_tpu_torch.make(env_id, **make_kw)
    env.reset(seed=0)
    start = env.get_state()
    rng = np.random.default_rng(0)
    actions = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
               for _ in range(steps)]
    counts = lambda: (k3.launches + k3.flip_launches,
                      k2.merged_launches + k2.merged_flip_launches,
                      k3.cluster_launches + k2.cluster_launches)
    arms, first_obs = [], None
    for arm in ("plain", "cluster", "cluster", "plain"):
        with cg_cuda_mb.pinned_cluster(1 if arm == "plain" else None):
            env.set_state(start)
            c0 = counts()
            step_ms, p_its, obs_last = [], [], None
            for a in actions:
                torch.cuda.synchronize()
                t = time.perf_counter()
                obs, reward, term, trunc, info = env.step(a)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t))
                p_its.append(int(info["pressure_iterations"]))
                obs_last = obs
        c1 = counts()
        if first_obs is None:
            first_obs = obs_last
        diff = max(float((obs_last[k] - first_obs[k]).abs().max()
                         / first_obs[k].abs().max().clamp(min=1e-30))
                   for k in obs_last)
        bit_equal = all(torch.equal(obs_last[k], first_obs[k]) for k in obs_last)
        row = dict(arm=arm, ms_per_step=step_ms,
                   mean_ms=sum(step_ms) / len(step_ms),
                   pressure_iterations=p_its,
                   k3_launches=c1[0] - c0[0], k2_launches=c1[1] - c0[1],
                   cluster_launches=c1[2] - c0[2],
                   obs_rel_diff_from_first_plain=diff,
                   obs_bit_equal_to_first_plain=bit_equal)
        print(f"{env_id} {arm}: {row}", flush=True)
        arms.append(row)
    mean = lambda a: sum(r["mean_ms"] for r in arms if r["arm"] == a) / 2
    return dict(env_id=env_id, steps=steps, arms=arms,
                plain_ms=mean("plain"), cluster_ms=mean("cluster"),
                speedup=mean("plain") / mean("cluster"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--airfoil-steps", type=int, default=2)
    ap.add_argument("--cyl-steps", type=int, default=5)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_cluster_ab: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    result = dict(card=_smi(), device=torch.cuda.get_device_name(0))
    if args.parent:
        result["parent_check"] = parent_check(dev, args.parent)
    runs = []
    if args.airfoil_steps:
        runs.append(ab("Airfoil2D-easy-v0", args.airfoil_steps,
                       dict(randomize_initial_state=False)))
    if args.cyl_steps:
        runs.append(ab("CylinderJet2D-easy-v0", args.cyl_steps, {}))
    result["ab"] = runs
    for r in runs:
        print(f"{r['env_id']}: plain {r['plain_ms']:.1f} ms/step, cluster "
              f"{r['cluster_ms']:.1f} ms/step ({r['speedup']:.2f}x)", flush=True)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
