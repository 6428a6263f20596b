#!/usr/bin/env python3
"""The resident arm of K1 / K2 against the chunk grid, end to end, on one
CUDA card.

    python3 scripts/port_resident_ab.py [--steps 3] [--batch 64]
        [--batch-steps 2] [--rev NAME=DIR ...] [--out FILE]

RBC2D-easy-v0 at its registered defaults: ``make`` and ``reset(seed=0)``,
then four arms in turns from that same state: grid, resident, resident,
grid.  "grid" pins the resident rule to the chunk grid
(``cg_cuda.pinned_resident(False)``), "resident" to the resident arm (the
rule's own answer on these shapes).  Each arm takes the same fixed actions
and reports ms per env step (host clock around ``step``, ending in a device
synchronise), pressure iterations, the K1 / K2 launches and how many took
the resident arm, and whether every obs is bit-equal to the first grid
arm's (the arm computes the chunk grid's bits, so the four arms step one
trajectory).  Then the same for ``BatchedFluidEnv("RBC2D-easy-v0",
--batch)`` (seeds 0..B-1), its batched state restored before each arm
(``--batch 0`` skips it).

With ``--rev NAME=DIR`` (a directory holding another revision's
``fluidgym_tpu_torch/csrc/`` and ``fluidgym_tpu_torch/ops/_build.py``, e.g.
the parent's from ``git archive``; repeatable), it first builds each
revision's kernel library and runs K1 and K2 of this tree (both arms) and
of every revision (both arms where its entries take one) on the main
path's systems: the bundled snapshot's pressure solve, its temperature and
velocity solves warm from the snapshot's fields, and 64 pressure lanes
(operators scaled 0.5..2) and 64 envs' velocity solves (128 lanes), one
lane per block.  Every launch must return this tree's chunk grid's x,
iterations and residual bit for bit; ms per raw launch (preallocated
buffers, CUDA events) of each, in turns.

Prints one JSON object (also to ``--out``) with the card's name and power
limit.  Needs a card; imports nothing of JAX or of the JAX package.
"""

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

ARMS = ("grid", "resident", "resident", "grid")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def _systems(dev):
    """K1 / K2's systems of the RBC2D-easy main path from the bundled
    snapshot (one substep at dt / 2): ``(name, algo, diag, off, b, x0,
    tol2, kw)``."""
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.ops import cg_cuda
    from fluidgym_tpu_torch.solver import stencil as st
    from fluidgym_tpu_torch.utils import data_utils

    cfg = fluidgym_tpu_torch.registry._entries["RBC2D-easy-v0"][1]
    dom = (f"rbc_2d_Ra{float(cfg['rayleigh_number'])}_Pr"
           f"{float(cfg['prandtl_number'])}_NH{cfg['n_heaters']}"
           f"_HW{cfg['resolution']}")
    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir(dom) / "train_00", device=dev)
    dt = torch.tensor(float(cfg["dt"]) / 2, device=dev)
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    hbyA = st.pressure_rhs_vec(state, geoms, topo, adv,
                               tuple(b.velocity for b in state.blocks),
                               state.viscosity, dt)
    p_rhs = -st.divergence_of(hbyA, state, geoms, topo)[0]
    p_rhs = (p_rhs - p_rhs.mean()).unsqueeze(0).contiguous()
    n = math.prod(p_rhs.shape[1:])
    kappa = state.scalar_diffusivity[0]
    sc = st.build_advection_ops(state, geoms, topo, kappa, dt,
                                for_scalar=True, scalar_channel=0)[0]
    sc_rhs = st.advection_rhs_scalar(state, geoms, topo, kappa, dt, 0)[0][None]
    vel = st.advection_rhs_velocity(state, geoms, topo, state.viscosity, dt)[0]
    tol2 = cg_cuda.tol2_sum_f32(1e-5, n)
    kw = dict(maxiter=5000, stall_iters=250, precondition=True)
    po = p_ops[0]
    return [
        ("K1 pressure", "cg", po.diag[None], po.off[None], p_rhs, None, tol2,
         dict(kw, return_best=True)),
        ("K2 temperature", "bicgstab", sc.diag[None], sc.off[None], sc_rhs,
         state.blocks[0].scalar, tol2, dict(kw, return_best=False)),
        ("K2 velocity", "bicgstab", adv[0].diag[None], adv[0].off[None], vel,
         state.blocks[0].velocity, tol2, dict(kw, return_best=False))]


def _systems_wide(dev):
    """``_systems`` plus the 64-lane pressure solve (the operator scaled
    0.5..2 per lane) and 64 envs' velocity solves (128 lanes)."""
    out = _systems(dev)
    name, algo, diag, off, b, x0, tol2, kw = out[0]
    import torch

    s = torch.linspace(0.5, 2.0, 64, device=dev)
    out.append(("K1 pressure x64 lanes", algo, diag * s.reshape(-1, 1, 1),
                off * s.reshape(-1, 1, 1, 1), b.expand(64, -1, -1).contiguous(),
                None, tol2, kw))
    name, algo, diag, off, b, x0, tol2, kw = out[2]
    out.append(("K2 velocity x64 envs", algo, diag, off, b.repeat(64, 1, 1),
                x0.repeat(64, 1, 1), tol2, kw))
    return out


def _revision(root: str):
    """Another revision's kernel library, built from its own sources, and
    its loader module."""
    path = os.path.join(root, "fluidgym_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location(
        f"rev_build_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library(), mod


def _rev_launcher(lib, mod, algo, diag, off, b, x0, tol2, kw, resident):
    """One raw launch of a revision's K1 / K2 entry (the chunk grid, or its
    resident arm) on preallocated buffers, 2D or 3D (``b`` of (lanes,
    [nz,] ny, nx)); ``resident`` is passed only to entries that take it
    (None where the revision's entry has no arm argument).  Entries with
    the spread arm's arguments (buffers, G, layout) get G = 0."""
    import torch

    name = "fg_cg_solve" if algo == "cg" else "fg_bicgstab_solve"
    n_args = len(mod._ARGTYPES[name])
    spread = n_args == (30 if algo == "cg" else 34)
    takes_arm = spread or n_args == (26 if algo == "cg" else 30)
    if resident and not takes_arm:
        return None
    L, dev = b.shape[0], b.device
    x = torch.empty_like(b)
    scratch = [torch.empty_like(b) for _ in range(4 if algo == "cg" else 8)]
    it = torch.empty(L, dtype=torch.int32, device=dev)
    rs = torch.empty(L, dtype=torch.float32, device=dev)
    x0c = b if x0 is None else x0.contiguous()
    bufs = (b, diag, off, x0c, x, it, rs, *scratch) + ((None,) * 2 * spread)
    ndims = b.dim() - 1
    nz = b.shape[1] if ndims == 3 else 1
    shape = ((L, 1) + ((int(resident),) if takes_arm else ())
             + ((0, 0) if spread else ())
             + (nz, b.shape[-2], b.shape[-1], ndims, int(diag.shape[0] != 1)))
    tail = (tol2, kw["maxiter"], kw["stall_iters"],
            int(kw.get("precondition", True)), int(kw["return_best"]),
            int(x0 is not None))
    entry = getattr(lib, name)

    def launch():
        status = entry(*[0 if t is None else t.data_ptr() for t in bufs],
                       *shape, *tail,
                       torch.cuda.current_stream(dev).cuda_stream)
        mod.check(status, f"revision {name}")
        return x, it, rs

    return launch


def revisions(dev, revs: dict) -> dict:
    """This tree's K1 / K2 in both arms and every revision's, on the main
    path's systems: bit for bit against this tree's chunk grid, and ms per
    raw launch in turns (forward, then backward)."""
    import chip_smoke
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    libs = {name: _revision(root) for name, root in revs.items()}
    out = {}
    for name, algo, diag, off, b, x0, tol2, kw in _systems_wide(dev):
        here = cg_cuda if algo == "cg" else cg_cuda_mb
        runs = {f"this/{'resident' if arm else 'grid'}": here.launcher(
            diag, off, b, x0, ndims=2, chunk=1, resident=arm, tol2_sum=tol2,
            **kw) for arm in (False, True)}
        for rev, (lib, mod) in libs.items():
            for arm in (False, True):
                ln = _rev_launcher(lib, mod, algo, diag, off, b, x0, tol2, kw, arm)
                if ln is not None:
                    runs[f"{rev}/{'resident' if arm else 'grid'}"] = ln
        outs = {k: tuple(t.clone() for t in f()) for k, f in runs.items()}
        torch.cuda.synchronize()
        ref = outs["this/grid"]
        bits = {k: bool(all(torch.equal(u, v) for u, v in zip(o, ref)))
                for k, o in outs.items()}
        ms = {k: [] for k in runs}
        for k in list(runs) + list(reversed(list(runs))):
            ms[k].append(chip_smoke.cuda_ms(torch, runs[k], 20))
        its = int(ref[1].max())
        out[name] = dict(iterations=its, bit_equal_to_this_grid=bits,
                         raw_ms={k: min(v) for k, v in ms.items()},
                         us_per_it={k: min(v) * 1e3 / max(its, 1)
                                    for k, v in ms.items()})
        print(f"revisions {name} at {its} iterations: " + ", ".join(
            f"{k} {min(v):.4f} ms{'' if bits[k] else ' NOT BIT-EQUAL'}"
            for k, v in ms.items()), flush=True)
    return out


def _counts():
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    k1, k2 = cg_cuda.fused_cg, cg_cuda_mb.fused_bicgstab_mb
    return (k1.launches, k2.launches, k1.resident_launches + k2.resident_launches)


def _arms(step, restore, actions, label) -> dict:
    """The four arms from one state: ``restore()`` before each, then
    ``step(a) -> (obs, pressure_iterations)`` for every action."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda

    rows, first = [], None
    for arm in ARMS:
        with cg_cuda.pinned_resident(arm == "resident"):
            restore()
            c0 = _counts()
            step_ms, p_its, obs = [], [], None
            for a in actions:
                torch.cuda.synchronize()
                t = time.perf_counter()
                obs, its = step(a)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t))
                p_its.append(its)
        c1 = _counts()
        first = obs if first is None else first
        row = dict(arm=arm, ms_per_step=step_ms,
                   mean_ms=sum(step_ms) / len(step_ms), pressure_iterations=p_its,
                   k1_launches=c1[0] - c0[0], k2_launches=c1[1] - c0[1],
                   resident_launches=c1[2] - c0[2],
                   obs_bit_equal_to_first_grid=all(
                       torch.equal(obs[k], first[k]) for k in obs))
        print(f"{label} {arm}: {row}", flush=True)
        rows.append(row)
    mean = lambda a: sum(r["mean_ms"] for r in rows if r["arm"] == a) / 2
    return dict(env=label, steps=len(actions), arms=rows, grid_ms=mean("grid"),
                resident_ms=mean("resident"),
                speedup=mean("grid") / mean("resident"))


def single(steps: int) -> dict:
    import numpy as np

    import fluidgym_tpu_torch

    env = fluidgym_tpu_torch.make("RBC2D-easy-v0")
    env.reset(seed=0)
    start = env.get_state()
    rng = np.random.default_rng(0)
    actions = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
               for _ in range(steps)]

    def step(a):
        obs, _, _, _, info = env.step(a)
        return obs, int(info["pressure_iterations"])

    return _arms(step, lambda: env.set_state(start), actions, "RBC2D-easy-v0")


def batched(n_envs: int, steps: int) -> dict:
    import numpy as np
    import torch

    from fluidgym_tpu_torch.parallel import BatchedFluidEnv
    from fluidgym_tpu_torch.parallel.batched_env import _tree_map

    benv = BatchedFluidEnv("RBC2D-easy-v0", n_envs, auto_reset=False)
    benv.reset(seed=0)
    copy = lambda tree: _tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
    start, counts = copy(benv._bcarry), benv._step_counts.copy()

    def restore():
        benv._bcarry, benv._step_counts = copy(start), counts.copy()

    rng = np.random.default_rng(20)
    actions = [rng.uniform(-1, 1, (n_envs,) + tuple(benv.action_space.shape))
               .astype(np.float32) for _ in range(steps)]

    def step(a):
        obs, _, _, _, info = benv.step(a)
        return obs, info["pressure_iterations"].tolist()

    return _arms(step, restore, actions, f"BatchedFluidEnv x{n_envs}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batch-steps", type=int, default=2)
    ap.add_argument("--rev", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_resident_ab: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    result = dict(card=_smi(), device=torch.cuda.get_device_name(0))
    if args.rev:
        result["revisions"] = revisions(
            dev, dict(r.split("=", 1) for r in args.rev))
    runs = [single(args.steps)] if args.steps else []
    if args.batch:
        runs.append(batched(args.batch, args.batch_steps))
    result["ab"] = runs
    ok = all(all(r["bit_equal_to_this_grid"].values())
             for r in result.get("revisions", {}).values())
    ok &= all(row["obs_bit_equal_to_first_grid"] for r in runs
              for row in r["arms"])
    for r in runs:
        print(f"{r['env']}: grid {r['grid_ms']:.1f} ms/step, resident "
              f"{r['resident_ms']:.1f} ms/step ({r['speedup']:.2f}x)", flush=True)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
