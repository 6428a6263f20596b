#!/usr/bin/env python3
"""How far float32 runs sit from the float64 run, in both packages, from
one numpy state (CPU; imports the JAX package beside the port, like the
port's tests).

    JAX_PLATFORMS=cpu python3 scripts/port_float32_gap.py --env Airfoil2D-easy-v0
    JAX_PLATFORMS=cpu python3 scripts/port_float32_gap.py --env CylinderJet2D-easy-v0
    JAX_PLATFORMS=cpu python3 scripts/port_float32_gap.py --env RBC3D-easy-v0

The configurations are those of the port's float32 tests:

* ``Airfoil2D-easy-v0`` (``tests/test_torch_airfoil_rollout.py``): the
  bundled ``train_00``, 3 env steps of one sim step (``step_length = dt =
  0.05``), actions ``linspace(-0.5, 0.7, 3) * (1 - 0.3 i)``, no domain
  statistics;
* ``CylinderJet2D-easy-v0`` (``tests/test_torch_cylinder_env.py``): the
  bundled ``test_00``, 1 env step of 25 sim steps, action 0.5;
* ``RBC3D-easy-v0`` (``tests/test_torch_rbc3d.py``): the bundled
  ``train_00``, MARL at the registered defaults, 1 sim step
  (``step_length = dt = 0.05``), actions ``linspace(-1, 1, 64)``;
* ``RBC2D-wide-easy-v0`` (``tests/test_torch_rbc3d_ids.py``): the bundled
  ``train_00``, 1 env step of 20 sim steps, actions ``linspace(-1, 1, 24)``.

Every run starts from the port's float32 state after ``reset(seed=0)``:
the port in float32, the JAX package in float32 on its default CPU path
(blockwise ``linsolve`` for the airfoil's flip-seam plan), in float32 with
its merged Pallas kernels routed in (interpret mode; ``--kernels``), and in
float64.  Prints one JSON object: per step and quantity (velocity and
pressure obs, reward, drag, lift; RBC: velocity and temperature obs,
reward, Nusselt) the max relative difference of each run
from the float64 run and of the port from each JAX float32 run, and the
pressure iterations of each run.
"""

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="Airfoil2D-easy-v0")
    ap.add_argument("--kernels", action="store_true",
                    help="also run the JAX package with its merged kernels")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import fluidgym_tpu
    import fluidgym_tpu_torch
    from fluidgym_tpu.ops import cg_pallas, cg_pallas_mb
    from fluidgym_tpu_torch.envs.fluid_env import env_state_to_numpy
    from torch_port_helpers import jax_domain_state

    torch.set_num_threads(1)
    if args.env.startswith("Airfoil"):
        kw = dict(randomize_initial_state=False, load_domain_statistics=False,
                  episode_length=5, step_length=0.05, dt=0.05)
        actions = [(np.linspace(-0.5, 0.7, 3) * (1 - 0.3 * i)).astype(np.float32)
                   for i in range(3)]
        mode = "train"
    elif args.env.startswith("RBC3D"):
        kw = dict(randomize_initial_state=False, episode_length=2,
                  step_length=0.05)
        actions = [np.linspace(-1, 1, 64, dtype=np.float32).reshape(64, 1)]
        mode = "train"
    elif args.env.startswith("RBC2D"):
        kw = dict(randomize_initial_state=False, episode_length=2)
        actions = [np.linspace(-1, 1, 24, dtype=np.float32).reshape(24, 1)]
        mode = "train"
    else:
        kw = dict(randomize_initial_state=False, load_domain_statistics=False,
                  episode_length=2)
        actions = [np.array([0.5], np.float32)]
        mode = "test"
    rbc = args.env.startswith("RBC")
    keys = (("velocity", "temperature", "reward", "nusselt") if rbc
            else ("velocity", "pressure", "reward", "drag", "lift"))

    def run(env):
        out = []
        for a in actions:
            obs, r, _, _, info = env.step(a)
            f = lambda x: np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                                     np.float64)
            both = dict(obs, reward=r, **info)
            out.append(dict({k: f(both[k]) for k in keys},
                            iterations=int(f(info["pressure_iterations"]))))
        return out

    def fresh(pkg, **extra):
        env = pkg.make(args.env, **kw, **extra)
        getattr(env, mode)()
        env.reset(seed=0)
        return env

    tenv = fresh(fluidgym_tpu_torch, device="cpu")
    host = env_state_to_numpy(tenv.get_state())

    def jax_run(dtype, npdtype):
        env = fresh(fluidgym_tpu, dtype=dtype)
        env._state = jax_domain_state(host.domain, npdtype)
        if not rbc:
            env._last_control = jnp.asarray(host.additional_info["last_control"],
                                            dtype)
        return run(env)

    runs = {"port32": run(tenv), "jax32": jax_run(jnp.float32, np.float32)}
    with jax.enable_x64(True):
        runs["jax64"] = jax_run(jnp.float64, np.float64)
    if args.kernels:
        cg_pallas.set_fused_cg(True)
        cg_pallas_mb.set_fused_cg_mb(True)
        cg_pallas_mb.set_fused_bicg_mb(True)
        try:
            runs["jax32_kernels"] = jax_run(jnp.float32, np.float32)
        finally:
            cg_pallas.set_fused_cg("auto")
            cg_pallas_mb.set_fused_cg_mb("auto")
            cg_pallas_mb.set_fused_bicg_mb("auto")

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    pairs = [(r, "jax64") for r in runs if r != "jax64"]
    pairs += [("port32", r) for r in runs if r.startswith("jax32")]
    out = {"env": args.env, "snapshot": f"{mode}_00",
           "iterations": {r: [s["iterations"] for s in v] for r, v in runs.items()},
           "gaps": {f"{a} vs {b}": [{k: rel(sa[k], sb[k]) for k in keys}
                                    for sa, sb in zip(runs[a], runs[b])]
                    for a, b in pairs}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
