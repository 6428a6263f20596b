#!/usr/bin/env python3
"""Where one env step of fluidgym_tpu_torch spends its time on a CUDA card.

    python3 scripts/port_step_profile.py [--env RBC2D-easy-v0] [--steps 2]
        [--strips] [--k4] [--batch N] [--cluster C] [--resident 0|1]
        [--spread 0|1] [--cuda-only] [--warmup 1] [--generated]
        [--seed 0] [--step-length S] [--no-randomize]

Makes ``--env`` (a registered id; default RBC2D-easy-v0) at its registered
defaults on the card, resets it (seed 0), switches on the strip-coarse
pressure preconditioner (``--strips``: ``SimConfig.pressure_coarse_strips``)
and the fused stencil apply (``--k4``) if asked, takes one warm-up step,
then profiles ``--steps`` steps with ``torch.profiler`` (CPU + CUDA
activities).  With ``--batch N`` it steps a ``parallel.BatchedFluidEnv`` of
N envs instead (seeds 0..N-1, random actions), one batched step being one
"step" below; a substep is then a lockstep round of the batch.  ``--cluster
C`` pins the merged kernels' cluster rule to C (``cg_cuda_mb.pinned_cluster``;
1: one block per lane) for an A/B of device time; ``--resident 0|1`` pins
K1's and K2's resident rule (``cg_cuda.pinned_resident``: 1 the resident
arm, 0 the chunk grid) likewise, and ``--spread 0|1`` the spread rule of K1
and K2 and of K3 and K2-mb over a 3D merged plan (CylinderJet3D)
(``cg_cuda.pinned_spread``: 0 the chunk grid, 1 the rule's G).
``--cuda-only`` records the CUDA activity alone and sums its device events
(``kineto_results``), with no host operator table: minutes faster on a
step of hundreds of substeps (Airfoil2D-medium's ~420), whose event tree
the full profile walks for tens of minutes.  ``--warmup`` sets the steps
taken before the profiled ones (default 1).  ``--generated`` starts from
the env's generated state (``load_initial_domain=False``) instead of a
bundled snapshot: for an id whose snapshots the copy does not hold
(TCFLarge3D; Airfoil3D, which has none and warm-starts from a 2D
snapshot drawn by the seed: ``--seed 23`` draws ``train_00``, the one
the copy holds).  ``--seed`` sets the reset's seed (default 0),
``--step-length`` the env's ``step_length`` (one sim step: the id's
``dt``) and ``--no-randomize`` resets without randomization (Airfoil3D's
randomized reset runs 6-10 sim steps of 7 M cells).  Prints one JSON
object:

* ``wall_ms_per_step``: host clock around the profiled steps, ending in a
  device synchronise (``env_steps_per_s``: envs x steps over that time);
* ``substeps_per_step``: calls of ``piso.piso_substep_info`` (a single
  env's substeps, or a batch's lockstep rounds: one vmapped call each);
* ``device_ms_per_step``: summed CUDA kernel time (self device time of the
  kernel events); ``device_busy_share`` = device / wall;
* ``kernel_launches_per_step`` and the top kernels by device time;
* per kernel of the port (K1, K2, K2-mb, K3, K3-coarse, K4, and the
  flip-seam forms K2-mb-flip, K3-flip, K3-coarse-flip): launches per step
  and per substep, counted by the wrappers, and device ms per step (the
  profiler's kernel
  events of that instantiation: ``fg_cg_kernel<ND, false, false>`` is K1,
  ``<ND, true, false, ...>`` K3 and ``<ND, true, true, ...>`` K3-coarse in
  either seam form (with the last argument AGG true: K3-agg and
  K3-agg-flip), ``fg_bicg_kernel<ND, false, ...>`` K2, ``<ND, true,
  ...>`` K2-mb in either form, the cluster arm's instances (template
  argument CLUSTER) under their form, the resident arm's (RESIDENT) and
  the spread arm's (SPREAD) under K1 / K2, or K3 / K2-mb for a merged
  plan, ``fg_stencil2d_kernel`` K4;
  a flip form's device time is
  reported under its template's entry, which for an id with flip seams
  holds only the flip form);
* the host operators with the most self CPU time per step (not with
  ``--cuda-only``);
* the card's name and power limit.

Also writes the JSON to ``<--out>/port_step_profile_<env>.json``.  Needs a card;
imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import os
import subprocess
import sys
import time



def _port_kernel(name: str) -> str | None:
    """K1/K2/K2-mb/K3/K3-coarse/K3-agg/K4 for a profiler kernel name, else
    None."""
    head = name.split("(")[0]
    args = head[head.find("<") + 1:head.rfind(">")].replace(" ", "").split(",")
    if "fg_cg_kernel" in name:
        # <ND, TABLE, COARSE[, CLUSTER, RESIDENT, SPREAD, AGG]>: the cluster
        # arm counts as K3, the resident arm as K1
        if args[1:3] == ["true", "true"] and args[6:7] == ["true"]:
            return "K3-agg"
        if args[1:3] == ["true", "true"]:
            return "K3-coarse"
        return "K3" if args[1:2] == ["true"] else "K1"
    if "fg_bicg_kernel" in name:
        return "K2-mb" if args[1:2] == ["true"] else "K2"
    if "fg_stencil2d_kernel" in name:
        return "K4"
    return None


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="RBC2D-easy-v0")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--strips", action="store_true")
    ap.add_argument("--k4", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--cluster", type=int, default=None)
    ap.add_argument("--resident", type=int, choices=(0, 1), default=None)
    ap.add_argument("--spread", type=int, choices=(0, 1), default=None)
    ap.add_argument("--cuda-only", action="store_true")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--generated", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step-length", type=float, default=None)
    ap.add_argument("--no-randomize", action="store_true")
    args = ap.parse_args()
    if args.batch and args.strips:
        print("port_step_profile: the batched path runs without the strips",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("port_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    arm = None if args.resident is None else bool(args.resident)
    spread = 0 if args.spread == 0 else None
    with cg_cuda_mb.pinned_cluster(args.cluster), cg_cuda.pinned_resident(arm), \
            cg_cuda.pinned_spread(spread):
        return _profile(args)


def _profile(args) -> int:
    """The profiled run of ``main`` (the cluster, resident and spread rules
    pinned as asked)."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb, stencil_cuda
    from fluidgym_tpu_torch.solver import piso

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    if args.batch:
        from fluidgym_tpu_torch.parallel import BatchedFluidEnv

        stepper = BatchedFluidEnv(args.env, args.batch)
        stepper.reset(seed=0)
        env = stepper.env
        shape = (args.batch,) + tuple(env.action_space.shape)
    else:
        kw = {"load_initial_domain": False} if args.generated else {}
        if args.step_length is not None:
            kw["step_length"] = args.step_length
        if args.no_randomize:
            kw["randomize_initial_state"] = False
        env = stepper = fluidgym_tpu_torch.make(args.env, **kw)
        env.reset(seed=args.seed)
        env._cfg = dataclasses.replace(env._cfg,
                                       pressure_coarse_strips=args.strips)
        shape = tuple(env._zero_action.shape)  # (agents, 1) for a MARL id
    stencil_cuda.set_stencil_kernel(args.k4)
    rng = np.random.default_rng(0)
    act = lambda: rng.uniform(-1, 1, shape).astype(np.float32)
    for _ in range(args.warmup):
        stepper.step(act())
    torch.cuda.synchronize()
    substeps = [0]
    substep = piso.piso_substep_info

    def counted(*a, **k):
        substeps[0] += 1
        return substep(*a, **k)

    piso.piso_substep_info = counted
    def counts():
        return {"K1": cg_cuda.fused_cg.launches,
                "K2": cg_cuda_mb.fused_bicgstab_mb.launches,
                "K2-mb": cg_cuda_mb.fused_bicgstab_mb.merged_launches,
                "K3": cg_cuda_mb.fused_cg_mb.launches,
                "K2-mb-flip": cg_cuda_mb.fused_bicgstab_mb.merged_flip_launches,
                "K3-flip": cg_cuda_mb.fused_cg_mb.flip_launches,
                "K3-coarse": cg_cuda_mb.fused_cg_mb.coarse_launches,
                "K3-coarse-flip": cg_cuda_mb.fused_cg_mb.coarse_flip_launches,
                "K3-agg": cg_cuda_mb.fused_cg_mb.agg_launches,
                "K3-agg-flip": cg_cuda_mb.fused_cg_mb.agg_flip_launches,
                "K4": stencil_cuda.stencil_apply.launches,
                "K1 resident": cg_cuda.fused_cg.resident_launches,
                "K2 resident": cg_cuda_mb.fused_bicgstab_mb.resident_launches,
                "K1 spread": cg_cuda.fused_cg.spread_launches,
                "K2 spread": cg_cuda_mb.fused_bicgstab_mb.spread_launches,
                "K3 spread": cg_cuda_mb.fused_cg_mb.spread_launches,
                "K2-mb spread":
                    cg_cuda_mb.fused_bicgstab_mb.merged_spread_launches,
                "K3-flip 3d": cg_cuda_mb.fused_cg_mb.flip_launches_3d,
                "K2-mb-flip 3d":
                    cg_cuda_mb.fused_bicgstab_mb.merged_flip_launches_3d,
                "K3 global terms": cg_cuda_mb.fused_cg_mb.global_terms_launches,
                "K2-mb global terms":
                    cg_cuda_mb.fused_bicgstab_mb.merged_global_terms_launches}

    k0 = counts()
    acts = ([ProfilerActivity.CUDA] if args.cuda_only
            else [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            stepper.step(act())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / args.steps
    k1 = counts()
    piso.piso_substep_info = substep
    subs = substeps[0] / args.steps

    kernels = {}
    port_us = {k: 0.0 for k in ("K1", "K2", "K2-mb", "K3", "K3-coarse",
                                "K3-agg", "K4")}
    n_launch = 0
    for name, us in _device_events(prof, args.cuda_only):
        which = _port_kernel(name)
        if which is not None:
            port_us[which] += us
        name = name if len(name) <= 80 else name[:77] + "..."
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += us
        n_launch += 1
    device_ms = sum(v[1] for v in kernels.values()) / 1e3 / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    host = ([] if args.cuda_only else
            sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15])
    out = {
        "env": args.env, "strips": args.strips, "k4": args.k4,
        "cuda_only": args.cuda_only, "warmup": args.warmup,
        "batch": args.batch or None, "cluster_pin": args.cluster,
        "resident_pin": args.resident,
        "card": smi,
        "steps": args.steps,
        "wall_ms_per_step": wall * 1e3,
        "env_steps_per_s": max(args.batch, 1) / wall if wall > 0 else None,
        "substeps_per_step": subs,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / (wall * 1e3) if wall > 0 else None,
        "kernel_launches_per_step": n_launch / args.steps,
        "port_kernels": {
            k: {"launches_per_step": (k1[k] - k0[k]) / args.steps,
                "launches_per_substep": (k1[k] - k0[k]) / args.steps
                / max(subs, 1),
                "device_ms_per_step": port_us.get(k, 0.0) / 1e3 / args.steps}
            for k in k0 if " " not in k},
        "resident_launches_per_step": {
            k.split()[0]: (k1[k] - k0[k]) / args.steps
            for k in k0 if "resident" in k},
        "spread_pin": args.spread,
        "spread_launches_per_step": {
            k.split()[0]: (k1[k] - k0[k]) / args.steps
            for k in k0 if "spread" in k},
        "flip_3d_launches_per_step": {
            k.split()[0]: (k1[k] - k0[k]) / args.steps
            for k in k0 if k.endswith("flip 3d")},
        "global_terms_launches_per_step": {
            k.split()[0]: (k1[k] - k0[k]) / args.steps
            for k in k0 if "global terms" in k},
        "seed": args.seed, "step_length": env.step_length,
        "top_kernels": [
            {"name": n, "calls_per_step": c / args.steps,
             "device_ms_per_step": us / 1e3 / args.steps}
            for n, (c, us) in top],
        "top_host_ops": [
            {"name": e.key[:80], "calls_per_step": e.count / args.steps,
             "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3 / args.steps}
            for e in host],
    }
    os.makedirs(args.out, exist_ok=True)
    tag = "".join(("_strips" if args.strips else "", "_k4" if args.k4 else "",
                   f"_batch{args.batch}" if args.batch else "",
                   "" if args.cluster is None else f"_cluster{args.cluster}",
                   "" if args.resident is None else f"_resident{args.resident}",
                   "" if args.spread is None else f"_spread{args.spread}",
                   "_cuda" if args.cuda_only else ""))
    with open(os.path.join(args.out, f"port_step_profile_{args.env}{tag}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


def _device_events(prof, cuda_only: bool):
    """``(name, device us)`` of every device event of the profile: with
    ``cuda_only`` from ``kineto_results`` (no event tree), else the self
    device time of the profiler's CUDA events."""
    if cuda_only:
        from torch.autograd import DeviceType

        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                yield ev.name(), ev.duration_ns() / 1e3
        return
    for ev in prof.events():
        dev_type = getattr(ev, "device_type", None)
        if dev_type is None or "CUDA" not in str(dev_type):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        yield ev.name, us


if __name__ == "__main__":
    sys.exit(main())
