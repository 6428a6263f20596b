#!/usr/bin/env python3
"""Uncontrolled cylinder episode of fluidgym_tpu_torch against the bundled
reference trace.

    python3 scripts/port_cylinder_uncontrolled.py [--env CylinderJet2D-easy-v0]
        [--steps 80] [--device cuda] [--pressure-tol TOL]

The bundled dataset ships, beside each initial-domain snapshot, the drag
and lift of every step of a zero-action episode recorded by the JAX package
(``<split>_<idx>_uncontrolled_episode.csv``).  This script resets the port's
env to the same snapshot (``test_00``, no randomization) at the registered
defaults of ``--env`` (any cylinder id: ``CylinderJet2D-easy-v0``:
resolution 24, 5 blocks, 14,232 cells; the 2D medium and hard ids 23,424
cells; ``CylinderJet3D-easy-v0``: 5 extruded blocks, 341,568 cells, 8 jets,
SARL; ``-hard-v0`` 2,481,408 cells; a ``CylinderRot2D`` id, whose zero
action leaves the wall at rest, reads the jet ids' datasets), takes
``--steps`` zero-action steps and prints one JSON
object: the per-step |delta cd| and |delta cl| against the trace (max, at
steps 1, 10, 40, 80, and every step), the port's and the trace's pressure
iterations and converged flags per step, both episode means, the trace
statistics' p5-p95 bands (``domain_statistics.json``; the trace's
iterations and flags are null where an older trace does not record them),
ms per env step,
the card's name and power limit (``--pressure-tol`` replaces the registered
pressure tolerance after the reset), whether every step's |delta cd| is within
1e-3, and whether the episode-mean drag is within 0.2% of the trace's (the
exit code is 1 if not, or if a value is not finite).  The device defaults
to the card.
"""

import argparse
import csv
import dataclasses
import json
import os
import subprocess
import sys
import time


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="CylinderJet2D-easy-v0")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pressure-tol", type=float, default=None,
                    help="replace the registered pressure tolerance after "
                         "the reset (how far where the solves stop moves cd)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.utils import data_utils

    env = fluidgym_tpu_torch.make(args.env, device=args.device,
                                  randomize_initial_state=False,
                                  episode_length=args.steps)
    env.test()
    env.reset(seed=0)
    if args.pressure_tol is not None:
        env._cfg = dataclasses.replace(env._cfg, pressure_tol=args.pressure_tol)
    root = data_utils.initial_domain_dir(env.initial_domain_id)
    with open(root / "test_00_uncontrolled_episode.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    ref_cd = np.array([float(r["drag"]) for r in rows])
    ref_cl = np.array([float(r["lift"]) for r in rows])
    # older traces (cylinder_2D_Re100_Res24) record no solver health
    ref_its = [int(float(r["pressure_iterations"])) if "pressure_iterations" in r
               else None for r in rows]
    ref_conv = [bool(float(r["pressure_converged"])) if "pressure_converged" in r
                else None for r in rows]
    stats = data_utils.load_statistics(env.initial_domain_id)
    n = min(args.steps, len(ref_cd))
    zero = np.zeros(env.action_space.shape, np.float32)
    cds, cls, its, conv = [], [], [], []
    sync = torch.cuda.synchronize if env.device.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    for _ in range(n):
        _, _, _, _, info = env.step(zero)
        cds.append(float(info["drag"]))
        cls.append(float(info["lift"]))
        its.append(int(info["pressure_iterations"]))
        conv.append(bool(info["pressure_converged"]))
    sync()
    wall = (time.perf_counter() - t) / n
    cds, cls = np.array(cds), np.array(cls)
    dcd, dcl = np.abs(cds - ref_cd[:n]), np.abs(cls - ref_cl[:n])
    card = None
    if env.device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    mean_rel = abs(cds.mean() - ref_cd[:n].mean()) / abs(ref_cd[:n].mean())
    finite = bool(np.isfinite(cds).all() and np.isfinite(cls).all())
    out = {
        "env": args.env, "device": str(env.device), "card": card, "steps": n,
        "pressure_tol": env._cfg.pressure_tol,
        "ms_per_env_step": wall * 1e3,
        "max_abs_dcd": float(dcd.max()), "max_abs_dcl": float(dcl.max()),
        "abs_dcd_at": {str(k): float(dcd[k - 1]) for k in (1, 10, 40, 80)
                       if k <= n},
        "abs_dcl_at": {str(k): float(dcl[k - 1]) for k in (1, 10, 40, 80)
                       if k <= n},
        "abs_dcd": [float(v) for v in dcd], "abs_dcl": [float(v) for v in dcl],
        "pressure_iterations": its, "ref_pressure_iterations": ref_its[:n],
        "pressure_converged": conv, "ref_pressure_converged": ref_conv[:n],
        "abs_dcd_within_1e-3": bool(dcd.max() <= 1e-3),
        "mean_cd": float(cds.mean()), "ref_mean_cd": float(ref_cd[:n].mean()),
        "mean_cl": float(cls.mean()), "ref_mean_cl": float(ref_cl[:n].mean()),
        "mean_cd_rel_diff": float(mean_rel),
        "ref_cd_p5_p95": [stats["drag"]["p5"], stats["drag"]["p95"]],
        "ref_cl_p5_p95": [stats["lift"]["p5"], stats["lift"]["p95"]],
        "finite": finite,
        "mean_cd_within_0.2pct": bool(mean_rel <= 2e-3),
    }
    print(json.dumps(out))
    return 0 if finite and out["mean_cd_within_0.2pct"] else 1


if __name__ == "__main__":
    sys.exit(main())
