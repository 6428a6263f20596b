#!/usr/bin/env python3
"""Uncontrolled RBC episode of fluidgym_tpu_torch against the bundled
reference trace.

    python3 scripts/port_rbc_uncontrolled.py [--env RBC2D-easy-v0]
        [--snapshot train_00] [--steps 200] [--device cuda]

The bundled dataset ships, beside each initial-domain snapshot, the Nusselt
number and the pressure iterations of every step of a zero-action episode
recorded by the JAX package (``<split>_<idx>_uncontrolled_episode.csv``).
This script resets the port's env for ``--env`` (any RBC id, 2D or 3D, in
its registered defaults; a MARL id steps with one zero action per agent)
to the same snapshot (no randomization), takes ``--steps`` zero-action
steps and prints one JSON object: the per-step Nusselt deviation from the
reference trace (max, and at steps 1, 10, 50, ...), the mean Nusselt of
both over the episode, the reference's own p5-p95 band and min-max range
and the share of the port's steps inside each, the pressure iterations per env step of both
(mean, and the first steps), and ms per env step.  The device defaults to
the card.
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
    ap.add_argument("--env", default="RBC2D-easy-v0")
    ap.add_argument("--snapshot", default="train_00")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.utils import data_utils

    env = fluidgym_tpu_torch.make(args.env, device=args.device,
                                  randomize_initial_state=False,
                                  episode_length=args.steps)
    split, idx = args.snapshot.rsplit("_", 1)
    env.load_initial_domain(split, int(idx))
    env._apply_action(env._zero_action)
    path = (data_utils.initial_domain_dir(env.initial_domain_id)
            / f"{args.snapshot}_uncontrolled_episode.csv")
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    ref = np.array([float(r["nusselt"]) for r in rows])
    # older traces record no pressure iterations
    ref_its = (np.array([float(r["pressure_iterations"]) for r in rows])
               if "pressure_iterations" in rows[0] else None)
    n = min(args.steps, len(ref))
    zero = np.zeros(tuple(env._zero_action.shape), np.float32)
    nus, its = [], []
    t = time.perf_counter()
    for _ in range(n):
        _, _, _, _, info = env.step(zero)
        nus.append(float(info["nusselt"]))
        its.append(int(info["pressure_iterations"]))
    wall = (time.perf_counter() - t) / n
    nus = np.array(nus)
    dev = np.abs(nus - ref[:n])
    band = [float(np.percentile(ref, 5)), float(np.percentile(ref, 95))]
    card = None
    if env.device.type == "cuda":
        card = torch.cuda.get_device_name(0)
    out = {
        "env": args.env, "snapshot": args.snapshot,
        "device": str(env.device), "card": card, "steps": n,
        "ms_per_env_step": wall * 1e3,
        "max_abs_dev": float(dev.max()),
        "abs_dev_at": {str(k): float(dev[k - 1]) for k in (1, 10, 50, 100, 200)
                       if k <= n},
        "mean_nusselt": float(nus.mean()),
        "ref_mean_nusselt": float(ref[:n].mean()),
        "ref_p5_p95": band,
        "share_in_ref_p5_p95": float(np.mean((nus >= band[0]) & (nus <= band[1]))),
        "ref_min_max": [float(ref.min()), float(ref.max())],
        "share_in_ref_min_max": float(np.mean((nus >= ref.min()) & (nus <= ref.max()))),
        "pressure_iterations_per_step": {
            "port_mean": float(np.mean(its)), "port_first": its[:5],
            **({} if ref_its is None else {
                "ref_mean": float(np.mean(ref_its[:n])),
                "ref_first": [float(v) for v in ref_its[:5]],
                "max_abs_diff": float(np.max(np.abs(np.array(its) - ref_its[:n])))})},
        "finite": bool(np.isfinite(nus).all()),
    }
    print(json.dumps(out))
    return 0 if out["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
