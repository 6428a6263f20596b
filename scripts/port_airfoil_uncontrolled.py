#!/usr/bin/env python3
"""Uncontrolled Airfoil2D episode of fluidgym_tpu_torch against the
bundled reference trace.

    python3 scripts/port_airfoil_uncontrolled.py [--env Airfoil2D-easy-v0] \
        [--steps 40] [--device cuda]

The bundled dataset ships, beside each initial-domain snapshot, the drag,
lift and pressure iterations of every step of a zero-action episode
recorded by the JAX package (``<split>_<idx>_uncontrolled_episode.csv``).
This script resets the port's env to the same snapshot (``test_00``, no
randomization) at the registered defaults (6 blocks, 73,456 cells), takes
``--steps`` zero-action steps and prints one JSON object: per-step |delta
cd|, |delta cl| and pressure iterations against the trace (max, and at
steps 1, 10, 20, 40), the episode means, the total pressure iterations, ms
per env step and substeps per env step, and the card's name and power
limit; and the first step whose pressure iterations differ from the
trace's (``iterations_part_at``; a float32 step's drag is decided by where
its pressure solves stop) with the largest |delta cd| before it.  Bars:
for ``Airfoil2D-easy-v0`` episode-mean drag and lift within 0.2% of the
trace's and total pressure iterations within 10% of the trace's; for the
other ids (the aggregation coarse space) |delta cd| <= 1e-3 at every step
before the iterations part and the episode-mean drag within 1%.  The exit
code is 1 if a bar fails or a value is not finite.  The device defaults to
the card.
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import time


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="Airfoil2D-easy-v0")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.solver import piso
    from fluidgym_tpu_torch.utils import data_utils

    env = fluidgym_tpu_torch.make(args.env, device=args.device,
                                  randomize_initial_state=False,
                                  episode_length=args.steps)
    env.test()
    env.reset(seed=0)
    root = data_utils.initial_domain_dir(env.initial_domain_id)
    with open(root / "test_00_uncontrolled_episode.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    ref = {k: np.array([float(r[k]) for r in rows])
           for k in ("drag", "lift", "pressure_iterations")}
    n = min(args.steps, len(rows))
    zero = np.zeros(env.action_space.shape, np.float32)
    got = {k: [] for k in ref}
    substeps = [0]
    inner = piso.piso_substep_info

    def counted(*a, **k):
        substeps[0] += 1
        return inner(*a, **k)

    piso.piso_substep_info = counted
    sync = torch.cuda.synchronize if env.device.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    try:
        for _ in range(n):
            _, _, _, _, info = env.step(zero)
            for k in got:
                got[k].append(float(info[k]))
    finally:
        piso.piso_substep_info = inner
    sync()
    wall = (time.perf_counter() - t) / n
    got = {k: np.array(v) for k, v in got.items()}
    ref = {k: v[:n] for k, v in ref.items()}
    d = {k: np.abs(got[k] - ref[k]) for k in ("drag", "lift")}
    card = None
    if env.device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    rel = {k: float(abs(got[k].mean() - ref[k].mean()) / abs(ref[k].mean()))
           for k in ("drag", "lift")}
    it_rel = float(abs(got["pressure_iterations"].sum()
                       - ref["pressure_iterations"].sum())
                   / ref["pressure_iterations"].sum())
    finite = bool(all(np.isfinite(v).all() for v in got.values()))
    parted = np.nonzero(got["pressure_iterations"] != ref["pressure_iterations"])[0]
    part = int(parted[0]) + 1 if parted.size else None  # 1-based step
    before = d["drag"][:(part - 1) if part else n]
    at = [k for k in (1, 10, 20, 40) if k <= n]
    out = {
        "env": args.env, "device": str(env.device), "card": card, "steps": n,
        "ms_per_env_step": wall * 1e3,
        "substeps_per_env_step": substeps[0] / n,
        "max_abs_dcd": float(d["drag"].max()), "max_abs_dcl": float(d["lift"].max()),
        "abs_dcd_at": {str(k): float(d["drag"][k - 1]) for k in at},
        "abs_dcl_at": {str(k): float(d["lift"][k - 1]) for k in at},
        "pressure_iterations_at": {
            str(k): [int(got["pressure_iterations"][k - 1]),
                     int(ref["pressure_iterations"][k - 1])] for k in at},
        "mean_cd": float(got["drag"].mean()), "ref_mean_cd": float(ref["drag"].mean()),
        "mean_cl": float(got["lift"].mean()), "ref_mean_cl": float(ref["lift"].mean()),
        "mean_cd_rel_diff": rel["drag"], "mean_cl_rel_diff": rel["lift"],
        "pressure_iterations_total": int(got["pressure_iterations"].sum()),
        "ref_pressure_iterations_total": int(ref["pressure_iterations"].sum()),
        "pressure_iterations_rel_diff": it_rel,
        "finite": finite,
        "means_within_0.2pct": bool(max(rel.values()) <= 2e-3),
        "iterations_within_10pct": bool(it_rel <= 0.1),
        "iterations_part_at": part,
        "max_abs_dcd_before_part": float(before.max()) if before.size else None,
        "dcd_within_1e-3_before_part": bool((before <= 1e-3).all()),
        "mean_cd_within_1pct": bool(rel["drag"] <= 1e-2),
        "abs_dcd": [float(v) for v in d["drag"]],
        "pressure_iterations": [int(v) for v in got["pressure_iterations"]],
        "ref_pressure_iterations": [int(v) for v in ref["pressure_iterations"]],
    }
    print(json.dumps(out))
    if args.env == "Airfoil2D-easy-v0":
        ok = out["means_within_0.2pct"] and out["iterations_within_10pct"]
    else:
        ok = out["dcd_within_1e-3_before_part"] and out["mean_cd_within_1pct"]
    ok = finite and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
