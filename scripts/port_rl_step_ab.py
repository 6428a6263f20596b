#!/usr/bin/env python3
"""The RL step (``differentiable=False``) of this tree against another
revision's, on one CUDA card.

    python3 scripts/port_rl_step_ab.py --parent DIR
        [--envs RBC2D-easy-v0,CylinderJet2D-easy-v0] [--steps 5]
        [--rounds 1] [--out FILE]

``DIR`` holds another revision's ``fluidgym_tpu_torch/`` (e.g. the
parent's, unpacked from ``git archive``); both revisions read the datasets
of this tree (``FLUIDGYM_TPU_DATA``).  For each id, each round runs the
arms in turns (parent, this, this, parent), each arm in a process of its
own: ``make(id)`` at the registered defaults, ``reset(seed=0)``, one
warm-up step, then ``--steps`` steps with actions drawn from a numpy
generator of seed 0, each timed on the host clock ending in a device
synchronise; then one more step (untimed) whose PyTorch function calls
are counted (``TorchFunctionMode``: the host's op dispatches, kernel
wrappers' own ops included).  Both revisions step the same states, so
their substeps agree.  Prints the card's name and power limit, one line
per arm and one JSON object (also to ``--out``): per id and revision the
ms of every step, the substeps and the counted calls, and the ratio of the
medians (this / parent).  Imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.overrides import TorchFunctionMode
import fluidgym_tpu_torch
from fluidgym_tpu_torch.solver import piso

env_id, steps = sys.argv[2], int(sys.argv[3])
assert fluidgym_tpu_torch.__file__.startswith(sys.argv[1])
env = fluidgym_tpu_torch.make(env_id)
env.reset(seed=0)
rng = np.random.default_rng(0)
acts = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
        for _ in range(steps + 1)]
env.step(acts[0])
torch.cuda.synchronize()
n = {"sub": 0}
inner = piso.piso_substep_info


def counted(*a, **k):
    n["sub"] += 1
    return inner(*a, **k)


piso.piso_substep_info = counted
ms = []
for a in acts[1:]:
    t = time.perf_counter()
    env.step(a)
    torch.cuda.synchronize()
    ms.append(1e3 * (time.perf_counter() - t))


class Calls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


with Calls() as calls:
    env.step(acts[-1])
torch.cuda.synchronize()
print(json.dumps({"ms": ms, "substeps": n["sub"], "torch_calls": calls.n}))
"""


def arm(tree, env_id, steps):
    envv = dict(os.environ, FLUIDGYM_TPU_DATA=os.path.join(
        ROOT, "fluidgym_tpu", "data"))
    out = subprocess.run([sys.executable, "-c", CHILD, tree, env_id,
                          str(steps)], capture_output=True, text=True,
                         cwd=tree, env=envv, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree} {env_id}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--envs", default="RBC2D-easy-v0,CylinderJet2D-easy-v0")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "this": ROOT}
    res = {"card": smi, "steps": args.steps}
    for env_id in args.envs.split(","):
        runs = {"parent": [], "this": []}
        for _ in range(args.rounds):
            for name in ("parent", "this", "this", "parent"):
                r = arm(trees[name], env_id, args.steps)
                runs[name].append(r)
                print(f"{env_id} {name}: ms {[round(m, 1) for m in r['ms']]}"
                      f", substeps {r['substeps']}, torch calls in the next "
                      f"step {r['torch_calls']}", flush=True)
        med = {k: statistics.median(m for r in v for m in r["ms"])
               for k, v in runs.items()}
        res[env_id] = dict(runs=runs, median_ms=med,
                           ratio=med["this"] / med["parent"])
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
