#!/usr/bin/env python3
"""The cluster arm of K3 / K3-coarse / K2-mb against the chunk grid, end to
end, on one CUDA card.

    python3 scripts/port_cluster_ab.py [--airfoil-steps 2] [--cyl-steps 5]
        [--strips-airfoil-steps 1] [--strips-cyl-steps 3] [--parent DIR]
        [--out FILE]

For Airfoil2D-easy-v0 and CylinderJet2D-easy-v0 at their registered
defaults (the airfoil without randomization, as ``chip_smoke.py`` phase 12;
the cylinder as phase 9), ``make`` and ``reset(seed=0)``, then four arms in
turns from that same state: plain, cluster, cluster, plain.  "plain" pins
the cluster rule to C = 1 (``cg_cuda_mb.pinned_cluster(1)``: every solve
on the chunk grid, one block per lane), "cluster" leaves it free
(``default_cluster``).  Each arm takes the same fixed actions and reports
ms per env step (host clock around ``env.step``, ending in a device
synchronise), pressure iterations, the K3 / K3-coarse / K2-mb launches and
how many took the cluster arm, and the largest obs difference from the
first plain arm and whether every obs is bit-equal to it (the cluster
arm's sums are the chunk grid's, so the four arms step the same
trajectory).  The strips arms do the same with ``chip_smoke.py`` phase
17's levers on (``SimConfig.pressure_coarse_strips`` and the K4 switch:
K3-coarse / K3-coarse-flip on the pressure solves) for phase 17's steps;
with ``--device-ms`` each arm then steps the first action once more from
the same state under ``torch.profiler`` (the CUDA activity alone) and
reports the step's device ms and the share of it in ``fg_cg_kernel``
(K3 / K3-coarse).

With ``--parent DIR`` (a directory holding the parent revision's
``fluidgym_tpu_torch/csrc/`` and ``fluidgym_tpu_torch/ops/_build.py``, e.g.
from ``git archive``), it first builds that revision's kernel library and
holds this tree's K3, K3-flip, K2-mb, K2-mb-flip, K3-coarse and
K3-coarse-flip at C = 1 and at the rule's C to the parent's chunk grid bit
for bit on the main path's systems (the bundled snapshots' pressure solve
warm from the deflated guess, and the 2-lane velocity solve), and times
the coarse forms' raw launches in turns (parent C = 1, this tree's rule C,
the rule C, parent C = 1).

Prints one JSON object (also to ``--out``) with the card's name and power
limit.  Needs a card; imports nothing of JAX or of the JAX package.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (the snapshot systems of phases 7-13)
from port_spread_ab import _rev_merged_launcher  # noqa: E402


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


def _rev_coarse_launcher(lib, mod, plan, diag, off, b, x0, coarse, tol2, kw,
                         cluster=1):
    """One raw launch of a revision's K3-coarse entry on preallocated
    buffers; an entry without a ``cluster`` argument takes C = 1 only (None
    otherwise)."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda_mb

    name = "fg_cg_mb_coarse_solve"
    takes_cluster = len(mod._ARGTYPES[name]) == 30
    if cluster > 1 and not takes_cluster:
        return None
    sp, einv = coarse
    (L, n), dev = b.shape, b.device
    x = torch.empty_like(b)
    scratch = [torch.empty_like(b) for _ in range(4)]
    it = torch.empty(L, dtype=torch.int32, device=dev)
    rs = torch.empty(L, dtype=torch.float32, device=dev)
    bufs = (b, diag, off, cg_cuda_mb.neighbor_table(plan, dev),
            b if x0 is None else x0, x, it, rs, *scratch,
            einv.transpose(-1, -2).contiguous(),
            *cg_cuda_mb.strip_lists(plan, dev))
    shape = ((L, 1) + ((cluster,) if takes_cluster else ())
             + (n, plan.ndims, int(diag.shape[0] != 1), sp.K))
    tail = (tol2, kw["maxiter"], kw["stall_iters"], int(kw["precondition"]),
            int(kw["return_best"]), int(x0 is not None))
    entry = getattr(lib, name)

    def launch():
        status = entry(*[t.data_ptr() for t in bufs], *shape, *tail,
                       torch.cuda.current_stream(dev).cuda_stream)
        mod.check(status, f"revision {name}")
        return x, it, rs

    return launch


def parent_check(dev, root: str) -> dict:
    """This tree's K3 / K2-mb / K3-coarse at C = 1 and at the rule's C
    against the parent's chunk grid on the same systems, bit for bit; the
    coarse forms' raw launches in turns against the parent's."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge, coarse_strips, piso
    from fluidgym_tpu_torch.solver import stencil as st

    parent = _parent_library(root)
    out = {}
    for case in chip_smoke.MERGED_CASES:
        sy = chip_smoke._snapshot_system(dev, piso, case)
        plan, n = sy["plan"], sy["n"]
        flat = lambda xs: cg_cuda_mb.flatten_fields(plan, xs)
        mops = block_merge.pack_ops(plan, sy["p_ops"])
        sp = coarse_strips.strip_plan(plan)
        einv = coarse_strips.coarse_inverse(plan, sp, mops)[None]

        def ops_of(ops):
            m = block_merge.pack_ops(plan, ops)
            return cg_cuda_mb.flatten_ops(plan, tuple(a[0] for a in m),
                                          tuple(a[1] for a in m))

        state = sy["state"]
        vel = st.advection_rhs_velocity(state, sy["geoms"], sy["topo"],
                                        state.viscosity, sy["dt"])
        pack = lambda fs: flat(tuple(p.unsqueeze(0) for p in
                                     block_merge.pack_fields(plan, fs)))
        pressure = (*ops_of(sy["p_ops"]), pack(sy["rhs"]), pack(sy["guess"]),
                    case["tol_p"])
        systems = (
            (case["k3"], "cg", *pressure, None),
            (case["k2"], "bicgstab", *ops_of(sy["adv"]),
             torch.cat([pack(tuple(f[c] for f in vel)) for c in range(2)]),
             torch.cat([pack(tuple(b.velocity[c] for b in state.blocks))
                        for c in range(2)]), 1e-5, None),
            (case["k3c"], "cg", *pressure, (sp, einv)))
        for name, algo, diag, off, b, x0, tol, coarse in systems:
            L = b.shape[0]
            kw = dict(maxiter=5000, stall_iters=250, precondition=True,
                      return_best=algo == "cg")
            tol2 = cg_cuda.tol2_sum_f32(tol, n)
            rule = cg_cuda_mb.merged_arm(
                L, n, 2, 1, dev, algo if coarse is None else "cg_coarse")[0]
            here = {C: cg_cuda_mb.merged_launcher(
                algo, plan, diag, off, b, x0, tol2_sum=tol2, chunk=1,
                cluster=C, coarse=coarse, **kw) for C in sorted({1, rule})}
            theirs = (_rev_merged_launcher(*parent, algo, plan, diag, off, b,
                                           x0, tol2, kw) if coarse is None
                      else _rev_coarse_launcher(*parent, plan, diag, off, b,
                                                x0, coarse, tol2, kw))
            ref = tuple(t.clone() for t in theirs())
            row = dict(rule_cluster=rule, iterations_parent=ref[1].tolist())
            for C, launch in here.items():
                got = launch()
                torch.cuda.synchronize()
                row[f"bit_equal_at_cluster_{C}"] = all(
                    torch.equal(u, v) for u, v in zip(got, ref))
                row[f"iterations_at_cluster_{C}"] = got[1].tolist()
            if coarse is not None:
                t = {"parent": 0.0, "rule": 0.0}
                for arm in ("parent", "rule", "rule", "parent"):
                    fn = theirs if arm == "parent" else here[rule]
                    t[arm] += chip_smoke.cuda_ms(torch, fn, 10) / 2
                its = int(ref[1].max())
                row.update(parent_raw_ms=t["parent"], rule_raw_ms=t["rule"],
                           parent_us_per_it=t["parent"] * 1e3 / max(its, 1),
                           rule_us_per_it=t["rule"] * 1e3 / max(its, 1))
            out[name] = row
            print(f"parent check {name} ({L} lane(s)): {row}", flush=True)
    return out


def device_split(torch, fn) -> tuple[float, float]:
    """Device ms of ``fn()`` (the summed durations of the CUDA activities
    ``torch.profiler`` records with the CUDA activity alone) and the ms of
    them in ``fg_cg_kernel`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = k3 = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            total += ev.duration_ns()
            k3 += ev.duration_ns() * ("fg_cg_kernel" in ev.name())
    return total / 1e6, k3 / 1e6


def ab(env_id: str, steps: int, make_kw: dict, strips: bool = False,
       profiled: bool = False) -> dict:
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb, stencil_cuda

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    env = fluidgym_tpu_torch.make(env_id, **make_kw)
    env.reset(seed=0)
    if strips:  # chip_smoke.py phase 17's levers
        env._cfg = dataclasses.replace(env._cfg, pressure_coarse_strips=True)
    start = env.get_state()
    rng = np.random.default_rng(0)
    actions = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
               for _ in range(steps)]
    counts = lambda: (k3.launches + k3.flip_launches + k3.coarse_launches
                      + k3.coarse_flip_launches,
                      k2.merged_launches + k2.merged_flip_launches,
                      k3.cluster_launches + k2.cluster_launches)
    arms, first_obs = [], None
    stencil_cuda.set_stencil_kernel(strips)
    try:
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
                dev_ms = k3_ms = None
                if profiled:
                    env.set_state(start)
                    dev_ms, k3_ms = device_split(
                        torch, lambda: env.step(actions[0]))
            if first_obs is None:
                first_obs = obs_last
            diff = max(float((obs_last[k] - first_obs[k]).abs().max()
                             / first_obs[k].abs().max().clamp(min=1e-30))
                       for k in obs_last)
            bit_equal = all(torch.equal(obs_last[k], first_obs[k])
                            for k in obs_last)
            row = dict(arm=arm, ms_per_step=step_ms,
                       mean_ms=sum(step_ms) / len(step_ms),
                       pressure_iterations=p_its,
                       k3_launches=c1[0] - c0[0], k2_launches=c1[1] - c0[1],
                       cluster_launches=c1[2] - c0[2],
                       obs_rel_diff_from_first_plain=diff,
                       obs_bit_equal_to_first_plain=bit_equal,
                       device_ms_first_step=dev_ms,
                       k3_device_ms_first_step=k3_ms)
            print(f"{env_id}{' strips' if strips else ''} {arm}: {row}",
                  flush=True)
            arms.append(row)
    finally:
        stencil_cuda.set_stencil_kernel(False)
    mean = lambda a, key="mean_ms": (
        sum(r[key] for r in arms if r["arm"] == a) / 2
        if arms[0][key] is not None else None)
    return dict(env_id=env_id, strips=strips, steps=steps, arms=arms,
                plain_ms=mean("plain"), cluster_ms=mean("cluster"),
                speedup=mean("plain") / mean("cluster"),
                plain_device_ms=mean("plain", "device_ms_first_step"),
                cluster_device_ms=mean("cluster", "device_ms_first_step"),
                plain_k3_device_ms=mean("plain", "k3_device_ms_first_step"),
                cluster_k3_device_ms=mean("cluster", "k3_device_ms_first_step"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--airfoil-steps", type=int, default=2)
    ap.add_argument("--cyl-steps", type=int, default=5)
    ap.add_argument("--strips-airfoil-steps", type=int, default=1)
    ap.add_argument("--strips-cyl-steps", type=int, default=3)
    ap.add_argument("--device-ms", action="store_true",
                    help="profile one step per strips arm (device ms)")
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
    if args.strips_airfoil_steps:
        runs.append(ab("Airfoil2D-easy-v0", args.strips_airfoil_steps,
                       dict(randomize_initial_state=False), strips=True,
                       profiled=args.device_ms))
    if args.strips_cyl_steps:
        runs.append(ab("CylinderJet2D-easy-v0", args.strips_cyl_steps, {},
                       strips=True, profiled=args.device_ms))
    result["ab"] = runs
    for r in runs:
        dev = ("" if r["plain_device_ms"] is None else
               f"; device ms per step plain {r['plain_device_ms']:.1f} (K3 "
               f"{r['plain_k3_device_ms']:.1f}), cluster "
               f"{r['cluster_device_ms']:.1f} (K3 {r['cluster_k3_device_ms']:.1f})")
        print(f"{r['env_id']}{' strips' if r['strips'] else ''}: plain "
              f"{r['plain_ms']:.1f} ms/step, cluster {r['cluster_ms']:.1f} "
              f"ms/step ({r['speedup']:.2f}x){dev}", flush=True)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
