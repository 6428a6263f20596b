#!/usr/bin/env python3
"""The JAX package's own uncontrolled cylinder, airfoil or channel episode
on the host, against its bundled reference trace: what the reference itself
holds on a backend other than the one that recorded the trace.

    JAX_PLATFORMS=cpu python3 scripts/jax_uncontrolled.py \
        [--env CylinderJet2D-hard-v0 | Airfoil2D-hard-v0 | \
         TCFSmall3D-bottom-easy-v0 | ...] [--snapshot test_00] [--steps 20]

Resets the JAX package's env to the bundled ``--snapshot`` (default
``test_00``) at the registered defaults of ``--env`` (no randomization;
float32), takes ``--steps`` zero-action steps (one per agent for a MARL
id) and prints one JSON object per step: against
``<snapshot>_uncontrolled_episode.csv``, |delta cd| and |delta cl| (cylinder,
airfoil) or the relative deviation of ``wall_stress``,
``wall_stress_bottom`` and ``wall_stress_top`` (channel), the pressure
iterations beside the trace's and the seconds since the reset.  Compare
with ``scripts/port_cylinder_uncontrolled.py`` /
``scripts/port_airfoil_uncontrolled.py`` / ``scripts/port_tcf_uncontrolled.py``
with ``--device cpu`` (the port on the same host).  Runs on the CPU only;
the port does not import it.
"""

import argparse
import csv
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="CylinderJet2D-hard-v0")
    ap.add_argument("--snapshot", default="test_00")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np

    import fluidgym_tpu
    from fluidgym_tpu.types import EnvMode

    env = fluidgym_tpu.make(args.env, randomize_initial_state=False,
                            episode_length=args.steps)
    split, idx = args.snapshot.rsplit("_", 1)
    env.mode = EnvMode(split)
    env.reset(seed=0)  # the split's first snapshot
    if int(idx):
        env.load_initial_domain(EnvMode(split), int(idx))
    path = os.path.join(root, "fluidgym_tpu", "data", "initial_domains",
                        env.initial_domain_id,
                        f"{args.snapshot}_uncontrolled_episode.csv")
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    zero = np.zeros(np.shape(env._zero_action), np.float32)
    t0 = time.perf_counter()
    for i in range(min(args.steps, len(rows))):
        _, _, _, _, info = env.step(zero)
        ref_its = rows[i].get("pressure_iterations")
        if "wall_stress" in info:
            dev = {f"rel_{k}": abs(float(np.asarray(info[k]))
                                   - float(rows[i][k])) / abs(float(rows[i][k]))
                   for k in ("wall_stress", "wall_stress_bottom",
                             "wall_stress_top")}
            dev["wall_stress_bottom"] = float(np.asarray(info["wall_stress_bottom"]))
        else:
            dev = {"abs_dcd": abs(float(np.asarray(info["drag"]))
                                  - float(rows[i]["drag"])),
                   "abs_dcl": abs(float(np.asarray(info["lift"]))
                                  - float(rows[i]["lift"]))}
        print(json.dumps({
            "env": args.env, "step": i + 1, **dev,
            "pressure_iterations": int(np.asarray(info["pressure_iterations"])),
            "ref_pressure_iterations": (None if ref_its is None
                                        else int(float(ref_its))),
            "seconds": round(time.perf_counter() - t0, 1)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
