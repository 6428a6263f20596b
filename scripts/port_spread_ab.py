#!/usr/bin/env python3
"""The spread arm of K1 / K2 (RBC's roll-form solves) against the chunk
grid on one CUDA card.

    python3 scripts/port_spread_ab.py [--env ID ...] [--steps 2]
        [--parent DIR] [--out FILE]

For each ``--env`` (default: RBC3D-easy-v0 and RBC3D-wide-easy-v0): the
solves of a first substep from the bundled ``train_00`` snapshot, captured
at the wrappers (``chip_smoke._captured_systems``: K1's pressure solve, K2's
temperature and velocity solves), each launched on the chunk grid and on
the spread arm at every G the card holds, in both layouts
(``chip_smoke.spread_arms``): every arm bit-equal to the chunk grid, ms per
raw launch in turns.  With ``--parent DIR`` (a directory holding another
revision's ``fluidgym_tpu_torch/csrc/`` and ``fluidgym_tpu_torch/ops/
_build.py``, e.g. the parent's from ``git archive``) that revision's chunk
grid joins every system, held bit for bit and timed in the same turns, and
both libraries' ``ptxas`` lines (registers, spills) are printed.  Then, with
``--steps`` > 0, ms per env step of each id under both arms in turns from
one state (``chip_smoke.spread_env_ab``; ``--pin G`` pins the spread arm's
G, for ids the rule leaves on the chunk grid).

Prints one JSON object (also to ``--out``) with the card's name and power
limit.  Needs a card; imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def _ptxas(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def systems_ab(dev, env_id: str, parent=None) -> dict:
    """Every captured roll-form system of ``env_id`` on every arm."""
    import torch

    import chip_smoke
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from port_resident_ab import _rev_launcher

    sy = chip_smoke._captured_systems(dev, env_id)
    (diag, off, b, x0), kw1 = sy["K1"]
    tol = kw1.pop("tol")
    nd, n = kw1["ndims"], math.prod(b.shape[1:])
    cases = [("K1 pressure", "cg", diag[None], off[None], b, x0,
              cg_cuda.tol2_sum_f32(tol, n), kw1)]
    for what, ((plan, diags, offs, bs), kw2) in zip(("temperature", "velocity"),
                                                   sy["K2"]):
        tol, x0s = kw2.pop("tol"), kw2.pop("x0s", None)
        cases.append((f"K2 {what}", "bicgstab", diags[0][None], offs[0][None],
                      bs[0], None if x0s is None else x0s[0],
                      cg_cuda.tol2_sum_f32(tol, n), dict(kw2, ndims=nd)))
    out = {}
    for name, algo, d, o, rhs, start, tol2, kw in cases:
        mod = cg_cuda if algo == "cg" else cg_cuda_mb
        launcher = lambda G, chains: mod.launcher(
            d, o, rhs, start, chunk=1, spread=G, chains=chains, tol2_sum=tol2,
            **kw)
        extra = {}
        if parent is not None:
            rk = {k: v for k, v in kw.items() if k != "ndims"}
            extra["parent grid"] = _rev_launcher(*parent, algo, d, o, rhs, start,
                                                 tol2, rk, False)
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
        r = chip_smoke.spread_arms(torch, cg_cuda, launcher, rhs.shape[0], n,
                                   nd, algo, reps=5, extra=extra)
        out[f"{name} {tuple(rhs.shape)}"] = r
        print(f"{env_id} {name} {tuple(rhs.shape)} at {r['iterations']} "
              f"iterations (rule {r['rule']}), every arm bit-equal to the chunk "
              "grid; ms per raw launch "
              + json.dumps({k: round(v, 4) for k, v in r["raw_ms"].items()}),
              flush=True)
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
    result["systems"] = {env_id: systems_ab(dev, env_id, parent)
                         for env_id in envs}
    if args.steps:
        result["env"] = {}
        for env_id in envs:
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
