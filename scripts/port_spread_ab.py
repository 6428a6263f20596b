#!/usr/bin/env python3
"""The spread arm of K1 / K2 (RBC's roll-form solves) and of K3 / K2-mb
over a 3D merged plan (CylinderJet3D) against the chunk grid on one CUDA
card.

    python3 scripts/port_spread_ab.py [--env ID ...] [--steps 2]
        [--parent DIR] [--out FILE]

For each ``--env`` (default: RBC3D-easy-v0 and RBC3D-wide-easy-v0): the
solves of a first substep from the bundled ``train_00`` snapshot, captured
at the wrappers (an RBC id: ``chip_smoke._captured_systems``, K1's
pressure solve, K2's temperature and velocity solves; a CylinderJet3D id:
``chip_smoke._captured_merged``, K3's pressure solve warm from the deflated
guess and K2-mb's 3-lane velocity solve), each launched on the chunk grid
and on the spread arm at every G the card holds, in both layouts
(``chip_smoke.spread_arms``): every arm bit-equal to the chunk grid (a
merged system twice), ms per raw launch in turns.  With ``--parent DIR`` (a
directory holding another revision's ``fluidgym_tpu_torch/csrc/`` and
``fluidgym_tpu_torch/ops/_build.py``, e.g. the parent's from ``git
archive``) that revision's chunk grid joins every system, held bit for bit
and timed in the same turns; the 2D merged lanes' cluster arm (K3, K2-mb,
K3-flip, K2-mb-flip on the CylinderJet2D and Airfoil2D snapshots' systems,
``chip_smoke.MERGED_CASES``) is held bit for bit against that revision's
at C = 1 and at the rule's C; and both libraries' ``ptxas`` lines
(registers, spills) are printed.  Then, with ``--steps`` > 0, ms per env
step of each RBC id under both arms in turns from one state
(``chip_smoke.spread_env_ab``; ``--pin G`` pins the spread arm's G, for
ids the rule leaves on the chunk grid); CylinderJet3D's end-to-end A/B is
``chip_smoke.py`` phase 36.

``--env Airfoil3D-easy-v0`` takes the first substep's pressure and
velocity solves of one sim step at 7,051,776 cells (phase 49's env, reset
and action; ``chip_smoke._first_solves``), each lane launched alone at
G = 128 as the rule launches it: this tree's ring against the ``--parent``
revision's spread arm at the same G and layout (``chains`` = 2, the
chain terms in a global scratch before the ring; its slot buffer sized
for them), held bit for bit against each other and timed per raw launch
in turns (parent, ring, ring, parent); this id needs ``--parent``.
With ``--steps`` > 0, Airfoil3D-easy also runs end to end, one sim step
per env step from one state, with every ring launch sent to the parent's
arm or to this tree's in turns (``airfoil3d_env_ab``: ms and device ms per
sim step, obs against the first arm's).  A CylinderJet3D id also times
the ring pinned on its lanes against the shared-memory spread arm at the
rule's G (bit for bit, in turns).

Prints one JSON object (also to ``--out``) with the card's name and power
limit.  Needs a card; imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def _ptxas(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def _rev_merged_launcher(lib, mod, algo, plan, diag, off, b, x0, tol2, kw,
                         cluster=1, G=0, chains=0):
    """One raw launch of a revision's K3 / K2-mb entry on the flat merged
    layout (the chunk grid, its cluster arm at ``cluster``, or its spread
    arm at ``G`` blocks per lane in layout ``chains``, the entries' value)
    on preallocated buffers.  Entries without the spread arm's arguments
    (buffers, G, layout) take G = 0 only, entries without a cluster argument
    C = 1 only (None otherwise).  A spread launch's slot buffer also holds,
    after the lanes' slots, every block's chain terms (``L x G`` blocks of
    ``2 (1024 / G) ceil(n / 1024)`` floats): the scratch that the layout
    ``chains`` = 2 read and wrote before the ring."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda_mb

    name = "fg_cg_mb_solve" if algo == "cg" else "fg_bicgstab_mb_solve"
    n_args = len(mod._ARGTYPES[name])
    spread = n_args == (29 if algo == "cg" else 33)
    takes_cluster = spread or n_args == (25 if algo == "cg" else 29)
    if (cluster > 1 and not takes_cluster) or (G and not spread):
        return None
    (L, n), dev = b.shape, b.device
    x = torch.empty_like(b)
    scratch = [torch.empty_like(b) for _ in range(4 if algo == "cg" else 8)]
    it = torch.empty(L, dtype=torch.int32, device=dev)
    rs = torch.empty(L, dtype=torch.float32, device=dev)
    nbr = cg_cuda_mb.neighbor_table(plan, dev)
    bufs = (b, diag, off, nbr, b if x0 is None else x0, x, it, rs, *scratch)
    if G:
        terms = L * G * 2 * (1024 // G) * -(-n // 1024) if chains == 2 else 0
        bufs += (torch.empty(L, dtype=torch.int32, device=dev),
                 torch.empty(L * 2 * 1024 * 2 + terms, dtype=torch.float32,
                             device=dev))
    elif spread:
        bufs += (None, None)
    shape = ((L, 1) + ((cluster,) if takes_cluster else ())
             + ((G, chains) if spread else ())
             + (n, plan.ndims, int(diag.shape[0] != 1)))
    tail = (tol2, kw["maxiter"], kw["stall_iters"],
            int(kw.get("precondition", True)), int(kw["return_best"]),
            int(x0 is not None))
    entry = getattr(lib, name)

    def launch():
        status = entry(*[0 if t is None else t.data_ptr() for t in bufs],
                       *shape, *tail, torch.cuda.current_stream(dev).cuda_stream)
        mod.check(status, f"revision {name}")
        return x, it, rs

    return launch


def _roll_cases(dev, env_id: str) -> list:
    """RBC's captured roll-form systems: ``(name, algo, launcher(G,
    chains), parent_launcher(lib, mod), lanes, n, ndims)``."""
    import chip_smoke
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from port_resident_ab import _rev_launcher

    sy = chip_smoke._captured_systems(dev, env_id)
    (diag, off, b, x0), kw1 = sy["K1"]
    tol = kw1.pop("tol")
    nd, n = kw1["ndims"], math.prod(b.shape[1:])
    raw = [("K1 pressure", "cg", diag[None], off[None], b, x0,
            cg_cuda.tol2_sum_f32(tol, n), kw1)]
    for what, ((plan, diags, offs, bs), kw2) in zip(("temperature", "velocity"),
                                                   sy["K2"]):
        tol, x0s = kw2.pop("tol"), kw2.pop("x0s", None)
        raw.append((f"K2 {what}", "bicgstab", diags[0][None], offs[0][None],
                    bs[0], None if x0s is None else x0s[0],
                    cg_cuda.tol2_sum_f32(tol, n), dict(kw2, ndims=nd)))
    cases = []
    for name, algo, d, o, rhs, start, tol2, kw in raw:
        mod = cg_cuda if algo == "cg" else cg_cuda_mb
        rk = {k: v for k, v in kw.items() if k != "ndims"}
        cases.append((
            f"{name} {tuple(rhs.shape)}", algo,
            lambda G, chains, mod=mod, d=d, o=o, rhs=rhs, start=start,
            tol2=tol2, kw=kw: mod.launcher(d, o, rhs, start, chunk=1, spread=G,
                                           chains=chains, tol2_sum=tol2, **kw),
            lambda lib, pm, algo=algo, d=d, o=o, rhs=rhs, start=start,
            tol2=tol2, rk=rk: _rev_launcher(lib, pm, algo, d, o, rhs, start,
                                            tol2, rk, False),
            rhs.shape[0], n, nd))
    return cases


def _merged_cases(dev, env_id: str) -> list:
    """CylinderJet3D's captured merged systems (K3's pressure solve, K2-mb's
    velocity solve), as ``_roll_cases``."""
    import chip_smoke
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    sy = chip_smoke._captured_merged(dev, env_id)
    cases = []
    for name, algo, key in (("K3 pressure", "cg", "K3"),
                            ("K2-mb velocity", "bicgstab", "K2")):
        (plan, diags, offs, bs), kw = sy[key]
        tol, x0s = kw.pop("tol"), kw.pop("x0s", None)
        kw.pop("coarse_strips", None)
        diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
        lead = (lambda t: t.unsqueeze(0)) if algo == "cg" else (lambda t: t)
        b = cg_cuda_mb.flatten_fields(plan, tuple(lead(t) for t in bs))
        x0 = (None if x0s is None else
              cg_cuda_mb.flatten_fields(plan, tuple(lead(t) for t in x0s)))
        n = b.shape[1]
        tol2 = cg_cuda.tol2_sum_f32(tol, n)
        cases.append((
            f"{name} {tuple(b.shape)}", algo,
            lambda G, chains, ring=None, algo=algo, plan=plan, diag=diag,
            off=off, b=b, x0=x0, tol2=tol2, kw=kw: cg_cuda_mb.merged_launcher(
                algo, plan, diag, off, b, x0, tol2_sum=tol2, chunk=1,
                spread=G, chains=chains, ring=ring, **kw),
            lambda lib, pm, algo=algo, plan=plan, diag=diag, off=off, b=b,
            x0=x0, tol2=tol2, kw=kw: _rev_merged_launcher(
                lib, pm, algo, plan, diag, off, b, x0, tol2, kw),
            b.shape[0], n, 3))
    return cases


def _ring_on_cylinder(dev, env_id: str) -> dict:
    """The ring pinned on a CylinderJet3D id's captured lanes at the rule's
    G against the shared-memory spread arm (all its chain terms in shared
    memory): bit for bit twice, ms per raw launch in turns (shared, ring,
    ring, shared)."""
    import torch

    import chip_smoke
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    out = {}
    for name, algo, launcher, _, L, n, _ in _merged_cases(dev, env_id):
        G = cg_cuda_mb.merged_arm(L, n, 3, 1, dev, algo).spread
        r = chip_smoke.arms_in_turns(torch, {
            f"G={G} shared": launcher(G, True, False),
            f"G={G} ring (pinned)": launcher(G, True, True)}, 5)
        out[name] = dict(r, G=G, lanes=L, cells=n)
        print(f"{env_id} {name}: the ring pinned at G = {G} bit-equal to the "
              f"shared-memory arm twice; ms per raw launch "
              + json.dumps({k: round(v, 4) for k, v in r["raw_ms"].items()})
              + f" at {r['iterations']} iterations", flush=True)
    return out


def airfoil3d_ab(dev, parent) -> dict:
    """Airfoil3D-easy's first pressure and velocity solves (phase 49's sim
    step), every lane alone at G = 128: the parent revision's global-terms
    arm against this tree's ring, bit for bit twice and ms per raw launch
    in turns; us per iteration of the lanes' launches together over the
    solve's most iterations; the peak device memory over the env's make,
    reset and sim step."""
    import numpy as np
    import torch

    import chip_smoke
    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    torch.cuda.reset_peak_memory_stats()
    env = fluidgym_tpu_torch.make(chip_smoke.AIRFOIL3D, step_length=0.05,
                                  **chip_smoke.AIRFOIL3D_KW)
    env.reset(seed=chip_smoke.AIRFOIL3D_SEED)
    a = np.random.default_rng(49).uniform(
        -1, 1, tuple(env.action_space.shape)).astype(np.float32)
    _, seen = chip_smoke._first_solves(lambda: env.step(a))
    torch.cuda.synchronize()
    out = {"peak_gb_reset_and_sim_step": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{chip_smoke.AIRFOIL3D}: peak device memory over make, reset and "
          f"one sim step {out['peak_gb_reset_and_sim_step']:.3f} GB", flush=True)
    del env
    for key, algo, name in (("K3", "cg", "K3-3D-flip"),
                            ("K2", "bicgstab", "K2-mb-3D-flip")):
        plan, diags, offs, bs, x0s, tol, kw = chip_smoke._captured_lanes(
            seen, key)
        diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
        b = cg_cuda_mb.flatten_fields(plan, bs)
        x0 = None if x0s is None else cg_cuda_mb.flatten_fields(plan, x0s)
        L, n = b.shape
        chip_smoke.check(n == 7_051_776 and cg_cuda.spread_ring(1, n, 3),
                         f"{name}: {n} cells, not the ring's 7,051,776")
        t2 = cg_cuda.tol2_sum_f32(tol, n)
        one = lambda t, l: t if t is None or t.shape[0] == 1 else t[l:l + 1]

        def lanes(mk):
            fs = [mk(one(diag, l), one(off, l), b[l:l + 1], one(x0, l))
                  for l in range(L)]
            return lambda: tuple(torch.cat(t) for t in zip(*[f() for f in fs]))

        ring = lanes(lambda d, o, bb, xx: cg_cuda_mb.merged_launcher(
            algo, plan, d, o, bb, xx, tol2_sum=t2, chunk=1, spread=128,
            ring=True, **kw))
        arms = {"parent G=128 global terms": lanes(
            lambda d, o, bb, xx: _rev_merged_launcher(
                *parent, algo, plan, d, o, bb, xx, t2, kw, G=128, chains=2)),
            "G=128 ring": ring}
        r = chip_smoke.arms_in_turns(torch, arms, 3)
        its = max(r["iterations"], 1)
        r.update(lanes=L, cells=n, launches=L,
                 us_per_it={k: v * 1e3 / its for k, v in r["raw_ms"].items()})
        ref = "parent G=128 global terms"
        r["speedup"] = r["raw_ms"][ref] / r["raw_ms"]["G=128 ring"]
        out[name] = r
        print(f"{chip_smoke.AIRFOIL3D} {name} ({L}, {n}), {L} launch(es) of "
              f"one lane at {r['iterations']} iterations: the ring bit-equal "
              f"to {ref} twice; us per iteration "
              + json.dumps({k: round(v, 2) for k, v in r["us_per_it"].items()})
              + f" ({r['speedup']:.2f}x)", flush=True)
    return out


def airfoil3d_env_ab(dev, parent, steps: int) -> dict:
    """Airfoil3D-easy end to end, one sim step per env step (phase 49's env
    and reset), from one state in turns: "parent" sends every ring launch
    of the main path to the parent revision's spread arm at the same G in
    the layout that was the global scratch (``cg_cuda_mb.merged_launcher``
    patched to ``_rev_merged_launcher``), "ring" to this tree's; each arm
    takes the same seeded actions.  ms per env step (host clock, ending in
    a device synchronise), the obs of every arm against the first's, then
    the first step once more per arm under ``torch.profiler``
    (``chip_smoke.device_ms``)."""
    import numpy as np
    import torch

    import chip_smoke
    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    original = cg_cuda_mb.merged_launcher

    def parent_launcher(algo, plan, diag, off, b, x0, *, tol2_sum, chunk,
                        coarse=None, cluster=1, spread=0, chains=None,
                        ring=None, **kw):
        L, n = b.shape
        if spread and coarse is None and (
                cg_cuda.spread_ring(L, n, plan.ndims) if ring is None
                else ring):
            return _rev_merged_launcher(
                *parent, algo, plan, diag.contiguous(), off.contiguous(),
                b.contiguous(), None if x0 is None else x0.contiguous(),
                tol2_sum, kw, G=spread, chains=2)
        return original(algo, plan, diag, off, b, x0, tol2_sum=tol2_sum,
                        chunk=chunk, coarse=coarse, cluster=cluster,
                        spread=spread, chains=chains, ring=ring, **kw)

    env = fluidgym_tpu_torch.make(chip_smoke.AIRFOIL3D, step_length=0.05,
                                  **chip_smoke.AIRFOIL3D_KW)
    env.reset(seed=chip_smoke.AIRFOIL3D_SEED)
    start = env.get_state()
    rng = np.random.default_rng(49)
    actions = [rng.uniform(-1, 1, tuple(env.action_space.shape)
                           ).astype(np.float32) for _ in range(steps)]
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    rows, first = [], None

    def run(arm, fn):
        cg_cuda_mb.merged_launcher = (parent_launcher if arm == "parent"
                                      else original)
        try:
            env.set_state(start)
            return fn()
        finally:
            cg_cuda_mb.merged_launcher = original

    for arm in ("parent", "ring", "ring", "parent"):
        def steps_():
            out = []
            for a in actions:
                torch.cuda.synchronize()
                t = time.perf_counter()
                obs, _, _, _, info = env.step(a)
                torch.cuda.synchronize()
                out.append((1e3 * (time.perf_counter() - t), obs,
                            int(info["pressure_iterations"])))
            return out
        c0 = (k3.ring_launches, k2.merged_ring_launches)
        got = run(arm, steps_)
        obs = got[-1][1]
        first = obs if first is None else first
        same = all(torch.equal(obs[k], first[k]) for k in obs)
        diff = max(float((obs[k] - first[k]).abs().max()) for k in obs)
        rows.append(dict(arm=arm, ms_per_step=[g[0] for g in got],
                         pressure_iterations=[g[2] for g in got],
                         ring_launches=[k3.ring_launches - c0[0],
                                        k2.merged_ring_launches - c0[1]],
                         obs_bit_equal_to_first=same, obs_max_diff=diff))
        print(f"{chip_smoke.AIRFOIL3D} end to end, {arm}: ms per sim step "
              f"{[round(g[0], 1) for g in got]}, pressure iterations "
              f"{[g[2] for g in got]}, obs bit-equal to the first arm's "
              f"{same} (max diff {diff:.3e})", flush=True)
    dev_ms = {arm: run(arm, lambda: chip_smoke.device_ms(
        torch, lambda: env.step(actions[0]))) for arm in ("parent", "ring")}
    mean = lambda a: (sum(sum(r["ms_per_step"]) for r in rows if r["arm"] == a)
                      / sum(len(r["ms_per_step"]) for r in rows
                            if r["arm"] == a))
    out = dict(arms=rows, parent_ms=mean("parent"), ring_ms=mean("ring"),
               device_ms_first_step=dev_ms)
    print(f"{chip_smoke.AIRFOIL3D} end to end: ms per sim step parent "
          f"{out['parent_ms']:.1f}, ring {out['ring_ms']:.1f}; device ms "
          f"{json.dumps({k: round(v, 1) for k, v in dev_ms.items()})}",
          flush=True)
    return out


def systems_ab(dev, env_id: str, parent=None) -> dict:
    """Every captured system of ``env_id`` on every arm (and the parent's
    chunk grid, held bit for bit where it agrees)."""
    import torch

    import chip_smoke
    from fluidgym_tpu_torch.ops import cg_cuda

    if env_id.startswith("Airfoil3D"):
        if parent is None:
            raise SystemExit(f"{env_id} is held against --parent's arm")
        return airfoil3d_ab(dev, parent)
    merged = env_id.startswith("CylinderJet3D")
    cases = _merged_cases(dev, env_id) if merged else _roll_cases(dev, env_id)
    out = {}
    for name, algo, launcher, parent_launcher, L, n, nd in cases:
        extra = {}
        if parent is not None:
            extra["parent grid"] = parent_launcher(*parent)
            # the parent's chunk grid, twice, against this tree's
            runs = [tuple(t.clone() for t in f()) for f in (
                launcher(0, None), extra["parent grid"], extra["parent grid"])]
            torch.cuda.synchronize()
            same = [all(torch.equal(a, b) for a, b in zip(run, runs[0]))
                    for run in runs[1:]]
            for i, (x, it, rs) in enumerate(runs[1:]):
                print(f"{env_id} {name}: parent grid run {i} against this "
                      f"grid: bit-equal {same[i]}, max|dx| {float((x - runs[0][0]).abs().max()):.3e} "
                      f"(max|x| {float(runs[0][0].abs().max()):.3e}), "
                      f"iterations {it.tolist()} / {runs[0][1].tolist()}, "
                      f"residual {rs.tolist()} / {runs[0][2].tolist()}",
                      flush=True)
            if not all(same):  # timed, not held (the record says which)
                del extra["parent grid"]
        r = chip_smoke.spread_arms(torch, cg_cuda, launcher, L, n, nd, algo,
                                   reps=5, extra=extra, merged=merged,
                                   runs=2 if merged else 1)
        out[name] = r
        print(f"{env_id} {name} at {r['iterations']} iterations (rule "
              f"{r['rule']}), every arm bit-equal to the chunk grid; ms per "
              "raw launch "
              + json.dumps({k: round(v, 4) for k, v in r["raw_ms"].items()}),
              flush=True)
    if merged:
        out["ring pinned"] = _ring_on_cylinder(dev, env_id)
    return out


def cluster_parent_check(dev, parent) -> dict:
    """The 2D merged lanes' solves (``chip_smoke.MERGED_CASES``: the
    snapshots' pressure solve warm from the deflated guess and the 2-lane
    velocity solve of CylinderJet2D-easy and Airfoil2D-easy) at C = 1 and
    at the rule's C, this tree's against the parent revision's, bit for
    bit."""
    import torch

    import chip_smoke
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge, piso
    from fluidgym_tpu_torch.solver import stencil as st

    out = {}
    for case in chip_smoke.MERGED_CASES:
        sy = chip_smoke._snapshot_system(dev, piso, case)
        plan, n = sy["plan"], sy["n"]
        flat = lambda xs: cg_cuda_mb.flatten_fields(plan, xs)

        def ops_of(ops):
            m = block_merge.pack_ops(plan, ops)
            return cg_cuda_mb.flatten_ops(plan, tuple(a[0] for a in m),
                                          tuple(a[1] for a in m))

        state = sy["state"]
        vel = st.advection_rhs_velocity(state, sy["geoms"], sy["topo"],
                                        state.viscosity, sy["dt"])
        pack = lambda fs: flat(tuple(p.unsqueeze(0) for p in
                                     block_merge.pack_fields(plan, fs)))
        systems = (
            (case["k3"], "cg", *ops_of(sy["p_ops"]), pack(sy["rhs"]),
             pack(sy["guess"]), case["tol_p"]),
            (case["k2"], "bicgstab", *ops_of(sy["adv"]),
             torch.cat([pack(tuple(f[c] for f in vel)) for c in range(2)]),
             torch.cat([pack(tuple(b.velocity[c] for b in state.blocks))
                        for c in range(2)]), 1e-5))
        for name, algo, diag, off, b, x0, tol in systems:
            L = b.shape[0]
            kw = dict(maxiter=5000, stall_iters=250, precondition=True,
                      return_best=algo == "cg")
            tol2 = cg_cuda.tol2_sum_f32(tol, n)
            row = {}
            for C in sorted({1, cg_cuda_mb.default_cluster(L, n, 2, 1, dev,
                                                           algo)}):
                here = tuple(t.clone() for t in cg_cuda_mb.merged_launcher(
                    algo, plan, diag, off, b, x0, tol2_sum=tol2, chunk=1,
                    cluster=C, **kw)())
                theirs = _rev_merged_launcher(*parent, algo, plan, diag, off,
                                              b, x0, tol2, kw, C)
                torch.cuda.synchronize()
                if theirs is None:
                    row[f"C={C}"] = "the parent has no cluster arm"
                    continue
                got = theirs()
                torch.cuda.synchronize()
                row[f"C={C}"] = dict(
                    bit_equal=all(torch.equal(u, v) for u, v in zip(here, got)),
                    iterations=here[1].tolist(),
                    iterations_parent=got[1].tolist())
            out[name] = row
            print(f"parent check {name} ({L} lane(s)): {row}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env", action="append", default=None)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--pin", type=int, default=None)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_spread_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from fluidgym_tpu_torch.ops import _build
    from port_resident_ab import _revision, _smi
    from port_spread_sass import ptxas_log

    dev = torch.device("cuda")
    envs = args.env or ["RBC3D-easy-v0", "RBC3D-wide-easy-v0"]
    result = dict(card=_smi(), device=torch.cuda.get_device_name(0))
    _build.library()
    result["ptxas"] = _ptxas(ptxas_log())
    parent = None
    if args.parent:
        lib, mod = _revision(args.parent)
        parent = (lib, mod)
        # the parent's library was built just now unless a build was cached
        result["parent_ptxas"] = _ptxas(mod.build_info()["log"])
    for key in ("ptxas", "parent_ptxas"):
        for ln in result.get(key, []):
            print(f"{key}: {ln}", flush=True)
    if parent is not None:
        result["cluster_parent"] = cluster_parent_check(dev, parent)
    result["systems"] = {env_id: systems_ab(dev, env_id, parent)
                         for env_id in envs}
    if args.steps:
        result["env"] = {}
        for env_id in envs:
            if env_id.startswith("Airfoil3D"):
                result["env"][env_id] = airfoil3d_env_ab(dev, parent,
                                                         args.steps)
                continue
            if env_id.startswith(("CylinderJet3D", "Airfoil3D")):
                continue  # chip_smoke.py phase 36
            r = result["env"][env_id] = chip_smoke.spread_env_ab(
                dev, env_id, args.steps, args.pin)
            print(f"{env_id}: chunk grid {r['grid_ms']:.1f} ms/env step, "
                  f"spread {r['spread_ms']:.1f} ({r['speedup']:.2f}x), per arm "
                  + json.dumps([[round(v, 1) for v in a["ms_per_step"]]
                                for a in r["arms"]]), flush=True)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
