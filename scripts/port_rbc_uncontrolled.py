#!/usr/bin/env python3
"""Uncontrolled RBC2D-easy-v0 episode of fluidgym_tpu_torch against the
bundled reference trace.

    python3 scripts/port_rbc_uncontrolled.py [--steps 200] [--device cuda]

The bundled dataset ships, beside each initial-domain snapshot, the Nusselt
number of every step of a zero-action episode recorded by the JAX package
(``<split>_<idx>_uncontrolled_episode.csv``).  This script resets the port's
env to the same snapshot (``train_00``, no randomization), takes ``--steps``
zero-action steps at the registered defaults, and prints one JSON object:
the per-step Nusselt deviation from the reference trace (max, and at steps
1, 10, 50, ...), the mean Nusselt of both over the episode, the reference's
own p5-p95 band, and ms per env step.  The device defaults to the card.
"""

import argparse
import csv
import json
import os
import sys
import time


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.utils import data_utils

    env = fluidgym_tpu_torch.make("RBC2D-easy-v0", device=args.device,
                                  randomize_initial_state=False,
                                  episode_length=args.steps)
    env.reset(seed=0)
    path = (data_utils.initial_domain_dir(env.initial_domain_id)
            / "train_00_uncontrolled_episode.csv")
    with open(path, newline="") as fh:
        ref = np.array([float(r["nusselt"]) for r in csv.DictReader(fh)])
    n = min(args.steps, len(ref))
    zero = np.zeros(env.action_space.shape, np.float32)
    nus = []
    t = time.perf_counter()
    for _ in range(n):
        _, _, _, _, info = env.step(zero)
        nus.append(float(info["nusselt"]))
    wall = (time.perf_counter() - t) / n
    nus = np.array(nus)
    dev = np.abs(nus - ref[:n])
    card = None
    if env.device.type == "cuda":
        card = torch.cuda.get_device_name(0)
    out = {
        "device": str(env.device), "card": card, "steps": n,
        "ms_per_env_step": wall * 1e3,
        "max_abs_dev": float(dev.max()),
        "abs_dev_at": {str(k): float(dev[k - 1]) for k in (1, 10, 50, 100, 200)
                       if k <= n},
        "mean_nusselt": float(nus.mean()),
        "ref_mean_nusselt": float(ref[:n].mean()),
        "ref_p5_p95": [float(np.percentile(ref, 5)), float(np.percentile(ref, 95))],
        "finite": bool(np.isfinite(nus).all()),
    }
    print(json.dumps(out))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
