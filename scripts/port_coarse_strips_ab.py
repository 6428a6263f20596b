#!/usr/bin/env python3
"""A/B of the strip-coarse pressure preconditioner (K3-coarse) and the
fused stencil apply (K4) in fluidgym_tpu_torch, one env on one card.

    python3 scripts/port_coarse_strips_ab.py [--cyl-steps 20]
        [--airfoil-steps 5] [--device cuda] [--out PATH]

Counterpart of ``scripts/coarse_strips_ab.py`` (the JAX package's batched
TPU A/B) for the port: one env, no batch, from the bundled ``test_00``
snapshot of CylinderJet2D-easy-v0 and Airfoil2D-easy-v0 at the registered
defaults, zero actions.  Four arms per id, run in turn on the same card
(``--steps 0`` skips an id):

* ``jacobi``: the defaults (K3 / K3-flip, Jacobi-preconditioned);
* ``k4``: ``stencil_cuda.set_stencil_kernel(True)`` alone;
* ``strips``: ``SimConfig.pressure_coarse_strips=True`` (K3-coarse /
  K3-coarse-flip);
* ``strips_k4``: both.

Per arm: ms per env step (host clock around ``env.step`` ending in a
device synchronise; mean over all steps and over steps 2..N), substeps and
pressure iterations per env step, mean drag and lift, whether every
pressure solve converged, and the launches per env step of each kernel
form.  One JSON object goes to stdout (and to ``--out``), with the card's
name and power limit.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time


def _run_arm(env_id, steps, arm, device):
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb, stencil_cuda
    from fluidgym_tpu_torch.solver import piso

    env = fluidgym_tpu_torch.make(env_id, device=device,
                                  randomize_initial_state=False,
                                  episode_length=steps)
    env.test()
    env.reset(seed=0)
    env._cfg = dataclasses.replace(env._cfg,
                                   pressure_coarse_strips="strips" in arm)
    counters = {
        "K3": (cg_cuda_mb.fused_cg_mb, "launches"),
        "K3-flip": (cg_cuda_mb.fused_cg_mb, "flip_launches"),
        "K3-coarse": (cg_cuda_mb.fused_cg_mb, "coarse_launches"),
        "K3-coarse-flip": (cg_cuda_mb.fused_cg_mb, "coarse_flip_launches"),
        "K2-mb": (cg_cuda_mb.fused_bicgstab_mb, "merged_launches"),
        "K2-mb-flip": (cg_cuda_mb.fused_bicgstab_mb, "merged_flip_launches"),
        "K4": (stencil_cuda.stencil_apply, "launches"),
    }
    before = {k: getattr(*v) for k, v in counters.items()}
    substeps = [0]
    inner = piso.piso_substep_info

    def counted(*a, **k):
        substeps[0] += 1
        return inner(*a, **k)

    sync = torch.cuda.synchronize if env.device.type == "cuda" else (lambda: None)
    zero = np.zeros(env.action_space.shape, np.float32)
    step_ms, its, drag, lift, conv = [], [], [], [], True
    piso.piso_substep_info = counted
    stencil_cuda.set_stencil_kernel("k4" in arm)
    try:
        for _ in range(steps):
            sync()
            t = time.perf_counter()
            _, _, _, _, info = env.step(zero)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t))
            its.append(int(info["pressure_iterations"]))
            drag.append(float(info["drag"]))
            lift.append(float(info["lift"]))
            conv = conv and bool(info["pressure_converged"])
    finally:
        stencil_cuda.set_stencil_kernel(False)
        piso.piso_substep_info = inner
    launches = {k: (getattr(*v) - before[k]) / steps for k, v in counters.items()}
    return {
        "ms_per_env_step": sum(step_ms) / steps,
        "ms_per_env_step_after_first": (sum(step_ms[1:]) / (steps - 1)
                                        if steps > 1 else None),
        "step_ms": step_ms,
        "substeps_per_env_step": substeps[0] / steps,
        "pressure_iterations_per_env_step": sum(its) / steps,
        "pressure_iterations": its,
        "mean_drag": float(np.mean(drag)), "mean_lift": float(np.mean(lift)),
        "all_pressure_converged": conv,
        "launches_per_env_step": {k: v for k, v in launches.items() if v},
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cyl-steps", type=int, default=20)
    ap.add_argument("--airfoil-steps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    card = None
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"device": args.device, "card": card, "ids": {}}
    for env_id, steps in (("CylinderJet2D-easy-v0", args.cyl_steps),
                          ("Airfoil2D-easy-v0", args.airfoil_steps)):
        if steps < 1:
            continue
        out["ids"][env_id] = {
            "steps": steps,
            **{arm: _run_arm(env_id, steps, arm, args.device)
               for arm in ("jacobi", "k4", "strips", "strips_k4")}}
        print(json.dumps({env_id: {arm: {k: v for k, v in r.items()
                                         if k in ("ms_per_env_step",
                                                  "pressure_iterations_per_env_step",
                                                  "mean_drag")}
                                   for arm, r in out["ids"][env_id].items()
                                   if isinstance(r, dict)}}), flush=True)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
