#!/usr/bin/env python3
"""Uncontrolled channel-flow episode of fluidgym_tpu_torch against the
bundled reference trace.

    python3 scripts/port_tcf_uncontrolled.py [--env TCFSmall3D-bottom-easy-v0]
        [--snapshot train_01] [--steps 20] [--device cuda] [--out FILE]

The bundled dataset ships, beside each channel snapshot, the wall stresses
and the pressure iterations of every step of a zero-action episode recorded
by the JAX package (``<split>_<idx>_uncontrolled_episode.csv``).  This
script loads the snapshot into the port's env for ``--env`` (any TCF id at
its registered defaults; MARL ids step with one zero action per agent), takes
``--steps`` zero-action steps and prints one JSON object: per step the
port's ``wall_stress``, ``wall_stress_bottom``, ``wall_stress_top`` and
pressure iterations beside the trace's and the relative deviations; the
step where the pressure iterations first part from the trace's; the bars
(``wall_stress_bottom`` within 1e-3 relative on every step before that one,
its mean over the steps within 1%) and ms per env step.  Exits 1 if a bar
fails or a value is not finite.  The device defaults to the card.
"""

import argparse
import csv
import json
import os
import sys
import time

METRICS = ("wall_stress", "wall_stress_bottom", "wall_stress_top")


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="TCFSmall3D-bottom-easy-v0")
    ap.add_argument("--snapshot", default="train_01")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.utils import data_utils

    env = fluidgym_tpu_torch.make(args.env, device=args.device,
                                  randomize_initial_state=False,
                                  episode_length=args.steps)
    split, idx = args.snapshot.rsplit("_", 1)
    t = time.perf_counter()
    env.load_initial_domain(split, int(idx))
    load_s = time.perf_counter() - t
    path = (data_utils.initial_domain_dir(env.initial_domain_id)
            / f"{args.snapshot}_uncontrolled_episode.csv")
    with open(path, newline="") as fh:
        ref = list(csv.DictReader(fh))
    n = min(args.steps, len(ref))
    zero = np.zeros(tuple(env._zero_action.shape), np.float32)
    rows, secs = [], []
    for i in range(n):
        t = time.perf_counter()
        _, _, _, _, info = env.step(zero)
        if env.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        r = {"step": i + 1,
             "pressure_iterations": int(info["pressure_iterations"]),
             "ref_pressure_iterations": int(float(ref[i]["pressure_iterations"]))}
        for k in METRICS:
            v, rv = float(info[k]), float(ref[i][k])
            r[k], r[f"ref_{k}"], r[f"rel_{k}"] = v, rv, abs(v - rv) / abs(rv)
        rows.append(r)
    part = next((r["step"] for r in rows
                 if r["pressure_iterations"] != r["ref_pressure_iterations"]), None)
    before = [r for r in rows if part is None or r["step"] < part]
    mean = float(np.mean([r["wall_stress_bottom"] for r in rows]))
    ref_mean = float(np.mean([r["ref_wall_stress_bottom"] for r in rows]))
    bars = {
        "bottom_1e-3_before_part": all(r["rel_wall_stress_bottom"] <= 1e-3
                                       for r in before),
        "bottom_mean_1pct": abs(mean - ref_mean) <= 0.01 * abs(ref_mean),
    }
    finite = all(np.isfinite(r[k]) for r in rows for k in METRICS)
    card = torch.cuda.get_device_name(0) if env.device.type == "cuda" else None
    out = {
        "env": args.env, "snapshot": args.snapshot, "device": str(env.device),
        "card": card, "steps": n, "load_s": load_s,
        "ms_per_env_step": 1e3 * float(np.mean(secs)),
        "step_ms": [1e3 * s for s in secs],
        "pressure_iterations_part_at_step": part,
        "max_rel_bottom_before_part": max(
            (r["rel_wall_stress_bottom"] for r in before), default=None),
        "max_rel": {k: max(r[f"rel_{k}"] for r in rows) for k in METRICS},
        "mean_wall_stress_bottom": mean, "ref_mean_wall_stress_bottom": ref_mean,
        "mean_rel_dev": abs(mean - ref_mean) / abs(ref_mean),
        "bars": bars, "finite": finite, "rows": rows,
    }
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return 0 if finite and all(bars.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
