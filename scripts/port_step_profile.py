#!/usr/bin/env python3
"""Where one env step of fluidgym_tpu_torch spends its time on a CUDA card.

    python3 scripts/port_step_profile.py [--env RBC2D-easy-v0] [--steps 2]
        [--strips] [--k4] [--batch N]

Makes ``--env`` (a registered id; default RBC2D-easy-v0) at its registered
defaults on the card, resets it (seed 0), switches on the strip-coarse
pressure preconditioner (``--strips``: ``SimConfig.pressure_coarse_strips``)
and the fused stencil apply (``--k4``) if asked, takes one warm-up step,
then profiles ``--steps`` steps with ``torch.profiler`` (CPU + CUDA
activities).  With ``--batch N`` it steps a ``parallel.BatchedFluidEnv`` of
N envs instead (seeds 0..N-1, random actions), one batched step being one
"step" below; a substep is then a lockstep round of the batch.  Prints one
JSON object:

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
  ``<ND, true, false>`` K3 and ``<ND, true, true>`` K3-coarse in either
  seam form, ``fg_bicg_kernel<ND, false>`` K2, ``<ND, true>`` K2-mb in
  either form, ``fg_stencil2d_kernel`` K4; a flip form's device time is
  reported under its template's entry, which for an id with flip seams
  holds only the flip form);
* the host operators with the most self CPU time per step;
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
    """K1/K2/K2-mb/K3/K3-coarse/K4 for a profiler kernel name, else None."""
    head = name.split("(")[0]
    args = head[head.find("<") + 1:head.rfind(">")].replace(" ", "").split(",")
    if "fg_cg_kernel" in name:
        if args[1:] == ["true", "true"]:
            return "K3-coarse"
        return "K3" if args[1:2] == ["true"] else "K1"
    if "fg_bicg_kernel" in name:
        return "K2-mb" if args[1:2] == ["true"] else "K2"
    if "fg_stencil2d_kernel" in name:
        return "K4"
    return None


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="RBC2D-easy-v0")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--strips", action="store_true")
    ap.add_argument("--k4", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    args = ap.parse_args()
    if args.batch and args.strips:
        print("port_step_profile: the batched path runs without the strips",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("port_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import fluidgym_tpu_torch
    import dataclasses

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb, stencil_cuda
    from fluidgym_tpu_torch.solver import piso
    from torch.profiler import ProfilerActivity, profile

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
        env = stepper = fluidgym_tpu_torch.make(args.env)
        env.reset(seed=0)
        env._cfg = dataclasses.replace(env._cfg,
                                       pressure_coarse_strips=args.strips)
        shape = env.action_space.shape
    stencil_cuda.set_stencil_kernel(args.k4)
    rng = np.random.default_rng(0)
    act = lambda: rng.uniform(-1, 1, shape).astype(np.float32)
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
                "K4": stencil_cuda.stencil_apply.launches}

    k0 = counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            stepper.step(act())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / args.steps
    k1 = counts()
    piso.piso_substep_info = substep
    subs = substeps[0] / args.steps

    kernels = {}
    port_us = {k: 0.0 for k in ("K1", "K2", "K2-mb", "K3", "K3-coarse", "K4")}
    n_launch = 0
    for ev in prof.events():
        dev_type = getattr(ev, "device_type", None)
        if dev_type is None or "CUDA" not in str(dev_type):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        which = _port_kernel(ev.name)
        if which is not None:
            port_us[which] += us
        name = ev.name if len(ev.name) <= 80 else ev.name[:77] + "..."
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += us
        n_launch += 1
    device_ms = sum(v[1] for v in kernels.values()) / 1e3 / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]
    out = {
        "env": args.env, "strips": args.strips, "k4": args.k4,
        "batch": args.batch or None,
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
            for k in k0},
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
                   f"_batch{args.batch}" if args.batch else ""))
    with open(os.path.join(args.out, f"port_step_profile_{args.env}{tag}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
