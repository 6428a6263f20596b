#!/usr/bin/env python3
"""The RL-framework surface's cost per env step on one CUDA card: an env
stepped bare against the same env stepped through a wrapper / adapter
stack, each arm in a process of its own, in turns.

    python3 scripts/port_rl_surface_ab.py [--steps 5] [--rounds 1]
        [--cases cylinder,rbc] [--out FILE]

Cases (the stacks of ``chip_smoke.py`` phases 54-55):

- ``cylinder``: ``CylinderJet2D-easy-v0`` from its snapshot (no
  randomization), bare against ``GymFluidEnv(ActionNoise(SensorNoise(
  ObsExtraction(env, ["pressure"]))))``; the bare arm steps on the same
  noisy actions (the action noise replayed from a generator on the card
  seeded as the wrapper's), so both arms step the same states;
- ``rbc``: ``RBC2D-easy-v0`` MARL from its generated state, bare against
  ``VecFluidEnv(FlattenObservation(env))``, with an episode longer than
  the run (no auto-reset).

Each round runs the arms in turns (bare, wrapped, wrapped, bare): ``make``,
``reset(seed=0)``, one warm-up step, then ``--steps`` steps, each timed on
the host clock ending in a device synchronise; then one more step (untimed)
whose PyTorch function calls are counted (``TorchFunctionMode``).  Prints
the card's name and power limit, one line per arm and one JSON object
(also to ``--out``): per case and arm the ms of every step and the counted
calls, and the ratio of the medians (wrapped / bare).  Imports nothing of
JAX or of the JAX package.
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
from fluidgym_tpu_torch.integration.gymnasium import GymFluidEnv
from fluidgym_tpu_torch.integration.sb3 import VecFluidEnv
from fluidgym_tpu_torch.wrappers import (ActionNoise, FlattenObservation,
                                         ObsExtraction, SensorNoise)

case, arm, steps = sys.argv[2], sys.argv[3], int(sys.argv[4])
dev = torch.device("cuda")
if case == "cylinder":
    env = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0",
                                  randomize_initial_state=False)
    shape = env.action_space.shape
    if arm == "wrapped":
        stack = GymFluidEnv(ActionNoise(SensorNoise(
            ObsExtraction(env, ["pressure"]), 0.01, 5), 0.1, 6))
        reset, step = (lambda: stack.reset(seed=0)), stack.step
    else:
        gen = torch.Generator(device=dev).manual_seed(6)

        def step(a):
            at = torch.as_tensor(a, device=dev)
            return env.step(at + torch.randn(at.shape, generator=gen, device=dev,
                                              dtype=at.dtype) * 0.1)
        reset = lambda: env.reset(seed=0)
else:
    env = fluidgym_tpu_torch.make(
        "RBC2D-easy-v0", use_marl=True, load_initial_domain=False,
        load_domain_statistics=False, episode_length=steps + 3)
    shape = (env.n_agents, 1)
    if arm == "wrapped":
        stack = VecFluidEnv(FlattenObservation(env))
        reset, step = (lambda: stack.reset(seed=0)), stack.step
    else:
        reset, step = (lambda: env.reset(seed=0)), env.step
reset()
rng = np.random.default_rng(0)
acts = [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(steps + 2)]
step(acts[0])
torch.cuda.synchronize()
ms = []
for a in acts[1:-1]:
    t = time.perf_counter()
    step(a)
    torch.cuda.synchronize()
    ms.append(1e3 * (time.perf_counter() - t))


class Calls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


with Calls() as c:
    step(acts[-1])
torch.cuda.synchronize()
print("RESULT " + json.dumps({"ms": ms, "calls": c.n}), flush=True)
"""


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def run_arm(case: str, arm: str, steps: int) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, ROOT, case, arm, str(steps)],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    lines = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"{case} {arm} failed:\n{out.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--cases", default="cylinder,rbc")
    p.add_argument("--out")
    args = p.parse_args()
    card = smi()
    print(card, flush=True)
    res = {"card": card, "steps": args.steps, "cases": {}}
    for case in args.cases.split(","):
        arms = {"bare": [], "wrapped": []}
        for _ in range(args.rounds):
            for arm in ("bare", "wrapped", "wrapped", "bare"):
                r = run_arm(case, arm, args.steps)
                arms[arm].append(r)
                print(f"{case} {arm}: ms {[round(v, 1) for v in r['ms']]}, "
                      f"torch calls {r['calls']}", flush=True)
        med = {a: statistics.median([v for r in rs for v in r["ms"]])
               for a, rs in arms.items()}
        res["cases"][case] = dict(arms=arms, median_ms=med,
                                  ratio=med["wrapped"] / med["bare"])
        print(f"{case}: median ms bare {med['bare']:.1f}, wrapped "
              f"{med['wrapped']:.1f}, ratio {med['wrapped'] / med['bare']:.3f}",
              flush=True)
    print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
