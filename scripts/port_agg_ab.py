#!/usr/bin/env python3
"""K3-agg-flip (the aggregation coarse space inside K3) of this tree against
another revision's on one CUDA card.

    python3 scripts/port_agg_ab.py --parent DIR [--reps 10] [--no-env]
        [--out FILE]

``DIR`` holds another revision's ``fluidgym_tpu_torch/csrc/`` and
``fluidgym_tpu_torch/ops/_build.py`` (e.g. the parent's, unpacked from
``git archive``); its entry ``fg_cg_mb_agg_solve`` is called with the
arguments its signature takes (the tiles' cell lists in CSR form and Einv
K x K, or the tiles' runs and Einv padded to 16 B rows).  Three parts:

1. Kernel A/B.  Phase 41's two captured pressure solves of one
   Airfoil2D-medium sim step from its bundled ``train_00``
   (``chip_smoke._capture_solves``), and the airfoil and cylinder systems
   of ``tests/test_torch_kernels_cuda.py`` ``_agg_system``, cold and warm,
   go through both revisions' kernels at C = 1 and at the rule's C: x,
   iterations and residual held bit for bit against the other revision's
   C = 1, each arm twice, then ms per raw launch in turns (parent, this,
   this, parent: ``chip_smoke.arms_in_turns``) as us per iteration; with
   both libraries' ``ptxas`` lines (registers, spills) of the K3-agg
   instances.
2. The per-phase split of one iteration at the rule's C on phase 41's
   solves: each revision's sources copied into ``build/agg_probe/``, its
   ``cg.cu`` given ``%globaltimer`` reads by thread 0 of every block at the
   phase boundaries (a ``__syncthreads`` first where the boundary is a
   block's own work ending before a barrier), built there and launched
   (parent, this, this, parent); the package's library has no probe.
   Reported per block as us per iteration of each phase, and the probe
   build's own us per iteration beside the plain build's.
3. End to end (skipped with ``--no-env``): one Airfoil2D-medium sim step
   (``step_length`` = dt = 0.05) from ``train_00`` per env step, from one
   state, with every K3-agg-flip launch sent to the parent's library or to
   this tree's in turns (parent, this, this, parent): ms per sim step (host
   clock, ending in a device synchronise), obs against the first arm's, and
   the first step once more per arm under ``torch.profiler`` with the CUDA
   activity alone: device ms, and the K3-agg instances' share.

Prints the card's name and power limit and one JSON object (also to
``--out``).  Needs a card; imports nothing of JAX or of the JAX package.
"""

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(ROOT, "tests"))

PROBE_DIR = os.path.join(ROOT, "build", "agg_probe")

#: the phases of one iteration, by the mark that opens each (the probe's
#: slots), for the cell-list form with its gathers and for the ring form
PHASES = {
    "gather": ["passes A, B (A's sum)", "r barrier", "restriction",
               "tile-sum barrier + gather", "Einv rows",
               "row barrier + gather", "z pass + sum", "pass C + top barrier"],
    "ring": ["passes A, B (A's sum)", "arrive, ring fill", "tiles' cells",
             "r barrier wait", "restriction", "tile-sum barrier",
             "Einv rows (ring)", "coarse-value barrier", "z pass + sum",
             "pass C + top barrier"],
}
SLOTS = 16

_PROBE_HEAD = r'''
// ---- probe: %globaltimer reads at K3-agg's phase boundaries ----
__device__ unsigned long long fg_probe_ns[16 * 16];
__device__ unsigned long long fg_probe_cnt[16 * 16];
__device__ unsigned long long fg_probe_t[16];
__device__ int fg_probe_prev[16];
__device__ __forceinline__ void fg_probe(int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const int b = blockIdx.x & 15;
    const int p = fg_probe_prev[b];
    if (p >= 0) {
      fg_probe_ns[b * 16 + p] += t - fg_probe_t[b];
      fg_probe_cnt[b * 16 + p] += 1;
    }
    fg_probe_t[b] = t;
    fg_probe_prev[b] = i;
  }
}
#define FG_PROBE_IF(cond, i) \
  do { if constexpr (cond) fg_probe(i); } while (0)
#define FG_PROBE_SYNC_IF(cond, i) \
  do { if constexpr (cond) { __syncthreads(); fg_probe(i); } } while (0)
extern "C" int fg_probe_reset() {
  unsigned long long z[16 * 16] = {};
  int m[16];
  for (int i = 0; i < 16; ++i) m[i] = -1;
  cudaMemcpyToSymbol(fg_probe_ns, z, sizeof(z));
  cudaMemcpyToSymbol(fg_probe_cnt, z, sizeof(z));
  cudaMemcpyToSymbol(fg_probe_prev, m, sizeof(m));
  return (int)cudaDeviceSynchronize();
}
extern "C" int fg_probe_read(unsigned long long* ns, unsigned long long* cnt) {
  cudaMemcpyFromSymbol(ns, fg_probe_ns, sizeof(unsigned long long) * 256);
  cudaMemcpyFromSymbol(cnt, fg_probe_cnt, sizeof(unsigned long long) * 256);
  return (int)cudaDeviceSynchronize();
}
'''

_KERNEL_TOP = ("    const int recompute = ((it + 1) % 100) == 0;\n",
               "    const int recompute = ((it + 1) % 100) == 0;\n"
               "    FG_PROBE_IF((ARM == FG_ARM_CLUSTER && AGG), 0);\n")


def _marks(form: str) -> list:
    """(anchor, replacement) pairs that put the probe's marks into cg.cu:
    the cell-list form's ``fg_coarse_precond<ARM, AGG>`` or the ring
    form's ``fg_agg_precond<ARM>``."""
    if form == "gather":
        c = "(ARM == FG_ARM_CLUSTER && AGG)"
        S = lambda i: f"FG_PROBE_SYNC_IF({c}, {i});"
        M = lambda i: f"FG_PROBE_IF({c}, {i});"
        return [
            _KERNEL_TOP,
            ("    fg_cluster_sync();  // r of every range is complete\n",
             f"    {S(1)}\n    fg_cluster_sync();  // r of every range is "
             f"complete\n    {M(2)}\n"),
            ("    fg_cluster_sync();  // every strip sum is in its owner's "
             "s_rc\n",
             f"    {S(3)}\n    fg_cluster_sync();  // every strip sum is in "
             "its owner's s_rc\n"),
            ("  __syncthreads();\n  const float* et = ",
             f"  __syncthreads();\n  {M(4)}\n  const float* et = "),
            ("      fg_cluster_sync();  // every row is in its owner's s_xc\n",
             f"      {S(5)}\n      fg_cluster_sync();  // every row is in its "
             "owner's s_xc\n"),
            ("  __syncthreads();\n  a1 = 0.0f;\n  a2 = 0.0f;\n  for (int c = "
             "L.c0 + tid;",
             f"  __syncthreads();\n  {M(6)}\n  a1 = 0.0f;\n  a2 = 0.0f;\n  "
             "for (int c = L.c0 + tid;"),
            ("    w = rr * rr;\n  });\n}\n\n// One 1024-thread block per SM",
             f"    w = rr * rr;\n  }});\n  {M(7)}\n}}\n\n// One 1024-thread "
             "block per SM"),
        ]
    c = "(ARM == FG_ARM_CLUSTER)"
    S = lambda i: f"FG_PROBE_SYNC_IF({c}, {i});"
    M = lambda i: f"FG_PROBE_IF({c}, {i});"
    arrive = ('    __syncwarp();\n    asm volatile("barrier.cluster.arrive.'
              'release.aligned;\\n" ::: "memory");\n')
    cells = "    find_cells(0);\n    __syncwarp();\n"
    wait = ('    __syncwarp();\n    asm volatile("barrier.cluster.wait.'
            'acquire.aligned;\\n" ::: "memory");\n')
    tiles = ("    fg_cluster_sync();  // every tile sum is in every block's "
             "s_rc\n")
    values = "    fg_cluster_sync();\n    // z of this block's range at the init"
    return [
        _KERNEL_TOP,
        (arrive, f"    {S(1)}\n{arrive}"),
        (cells, f"    {S(2)}\n    find_cells(0);\n    __syncwarp();\n"),
        (wait, f"    {S(3)}\n{wait}    {M(4)}\n"),
        (tiles, f"    {S(5)}\n{tiles}    {M(6)}\n"),
        ("    ++calls;\n", f"    ++calls;\n    {S(7)}\n"),
        (values, values.replace("sync();\n", f"sync();\n    {M(8)}\n")),
        ("    fg_lane_sum2<ARM, true>(a1, a2, sh, L, sp, n, [](int, float&, "
         "float&) {});\n",
         "    fg_lane_sum2<ARM, true>(a1, a2, sh, L, sp, n, [](int, float&, "
         f"float&) {{}});\n    {M(9)}\n"),
    ]


def _load_build(root: str, tag: str):
    path = os.path.join(root, "fluidgym_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location(f"agg_ab_build_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _form(root: str) -> str:
    src = open(os.path.join(root, "fluidgym_tpu_torch", "csrc", "cg.cu")).read()
    return "ring" if "fg_agg_precond" in src else "gather"


def _probe_build(root: str, tag: str):
    """``root``'s kernel sources with the probe, built under PROBE_DIR:
    ``(lib, loader module, form)``."""
    import ctypes

    mod = _load_build(root, f"probe_{tag}")
    form = _form(root)
    dst = os.path.join(PROBE_DIR, tag)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "fluidgym_tpu_torch", "csrc"),
                    os.path.join(dst, "csrc"))
    cu = os.path.join(dst, "csrc", "cg.cu")
    src = open(cu).read()
    inc = '#include "krylov.cuh"\n'
    if src.count(inc) != 1:
        raise SystemExit(f"{root}: cg.cu has no single include of krylov.cuh")
    src = src.replace(inc, inc + _PROBE_HEAD)
    for anchor, repl in _marks(form):
        if src.count(anchor) != 1:
            raise SystemExit(f"{root} ({form}): the probe's anchor is not "
                             f"found once: {anchor!r}")
        src = src.replace(anchor, repl)
    with open(cu, "w") as fh:
        fh.write(src)
    mod.CSRC = type(mod.CSRC)(os.path.join(dst, "csrc"))
    mod.BUILD_DIR = type(mod.BUILD_DIR)(os.path.join(dst, "kernels"))
    lib = mod.library()
    lib.fg_probe_reset.argtypes = []
    lib.fg_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, mod, form


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


_CSR = {}


def _csr(space):
    """The tiles' cell lists in CSR form (ascending within a tile), as the
    cell-list form's entry takes them: ``(ptr (K + 1,), cells)`` int32."""
    import torch

    key = space.cidx.data_ptr()
    if key not in _CSR:
        cidx = space.cidx.long()
        covered = torch.nonzero(cidx >= 0).reshape(-1)
        order = torch.argsort(cidx[covered], stable=True)
        counts = torch.bincount(cidx[covered], minlength=space.K)
        ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        _CSR[key] = (ptr.int(), covered[order].int())
    return _CSR[key]


def rev_agg_launcher(lib, mod, plan, diag, off, b, x0, space, tol2, kw, C):
    """One raw launch of a revision's ``fg_cg_mb_agg_solve`` (one lane per
    launch, chunk 1, cluster C) on preallocated buffers: the cell-list
    form's arguments or the ring form's, by the entry's signature."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda_mb

    name = "fg_cg_mb_agg_solve"
    (L, n), dev = b.shape, b.device
    x = torch.empty_like(b)
    scratch = [torch.empty_like(b) for _ in range(4)]
    it = torch.empty(L, dtype=torch.int32, device=dev)
    rs = torch.empty(L, dtype=torch.float32, device=dev)
    nbr = cg_cuda_mb.neighbor_table(plan, dev)
    bufs = (b, diag, off, nbr, b if x0 is None else x0, x, it, rs, *scratch)
    K = space.K
    if len(mod._ARGTYPES[name]) == 30:  # the cell lists, Einv K x K
        bufs += (space.einv[None].contiguous(), *_csr(space), space.cidx)
        shape = (L, 1, C, n, 2, 0, K)
    else:
        bufs += (space.einv[None], space.runs, space.cidx)
        shape = (L, 1, C, n, 2, 0, K, cg_cuda_mb.agg_kp(K),
                 space.runs.shape[1], cg_cuda_mb.agg_ring_stages(n, C, K))
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


def _cases(dev) -> list:
    """``(name, plan, diag, off, b, x0, space, tol2, kw)``: phase 41's two
    captured solves, then ``_agg_system``'s airfoil and cylinder, cold and
    warm."""
    import chip_smoke
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from test_torch_kernels_cuda import _agg_system

    out = []
    seen = chip_smoke._capture_solves(dev, chip_smoke.AGG_IDS[0], 0.05, {
        "K3": (cg_cuda_mb, "fused_cg_mb")})["K3"]
    for i, ((plan, diags, offs, bs), kw) in enumerate(seen[:2]):
        kw = dict(kw)
        x0s, tol, space = kw.pop("x0s"), kw.pop("tol"), kw.pop("agg")
        kw.pop("coarse_strips", None)
        diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
        b = cg_cuda_mb.flatten_fields(plan, tuple(t.unsqueeze(0) for t in bs))
        x0 = (None if x0s is None else cg_cuda_mb.flatten_fields(
            plan, tuple(t.unsqueeze(0) for t in x0s)))
        n = b.shape[1]
        out.append((f"phase 41 solve {i}", plan, diag, off, b, x0, space,
                    cg_cuda.tol2_sum_f32(tol, n),
                    dict(maxiter=kw.get("maxiter", 5000),
                         stall_iters=kw.get("stall_iters", 250),
                         precondition=kw.get("precondition", True),
                         return_best=kw.get("return_best", True))))
    for system in ("airfoil", "cylinder"):
        plan, diags, offs, b, guess, space = _agg_system(system, dev)
        diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
        tol = 1e-7 if system == "airfoil" else 1e-6
        kw = dict(maxiter=5000, stall_iters=250, precondition=True,
                  return_best=True)
        for start, x0 in (("cold", None), ("warm", guess)):
            out.append((f"{system} {start}", plan, diag, off, b, x0, space,
                        cg_cuda.tol2_sum_f32(tol, b.shape[1]), kw))
    return out


def _bits(arms: dict) -> None:
    """Every arm twice against the first arm's first run, bit for bit."""
    import torch

    import chip_smoke

    names = list(arms)
    ref = tuple(t.clone() for t in arms[names[0]]())
    torch.cuda.synchronize()
    for name in names:
        for i in range(2):
            out = arms[name]()
            torch.cuda.synchronize()
            chip_smoke.check(
                all(torch.equal(a, b) for a, b in zip(out, ref)),
                f"{name} (run {i}) differs from {names[0]}: max|dx| "
                f"{float((out[0] - ref[0]).abs().max()):.3e}, iterations "
                f"{out[1].tolist()} / {ref[1].tolist()}, residual "
                f"{out[2].tolist()} / {ref[2].tolist()}")


def kernel_ab(dev, parent, cases, reps: int) -> dict:
    import torch

    import chip_smoke
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    out = {}
    for name, plan, diag, off, b, x0, space, tol2, kw in cases:
        n = b.shape[1]
        rule = cg_cuda_mb.merged_arm(1, n, 2, 1, dev, "cg_coarse",
                                     space.K).cluster
        coarse = (space, space.einv[None])
        this = lambda C: cg_cuda_mb.merged_launcher(
            "cg", plan, diag, off, b, x0, tol2_sum=tol2, chunk=1, cluster=C,
            coarse=coarse, **kw)
        par = lambda C: rev_agg_launcher(*parent, plan, diag, off, b, x0,
                                         space, tol2, kw, C)
        arms = {f"parent C={rule}": par(rule), f"this C={rule}": this(rule)}
        c1 = {"parent C=1": par(1), "this C=1": this(1)}
        _bits({**c1, **arms})
        r = chip_smoke.arms_in_turns(torch, arms, reps)
        r1 = chip_smoke.arms_in_turns(torch, c1, max(1, reps // 5))
        its = max(r["iterations"], 1)
        ms = {**r["raw_ms"], **r1["raw_ms"]}
        row = dict(C=rule, iterations=r["iterations"], cells=n, K=space.K,
                   raw_ms=ms, us_per_it={k: v * 1e3 / its for k, v in ms.items()},
                   speedup=ms[f"parent C={rule}"] / ms[f"this C={rule}"])
        out[name] = row
        print(f"{name} (1, {n}), K = {space.K}, {r['iterations']} "
              f"iterations: both revisions bit-equal at C = 1 and {rule}, "
              f"twice; us per iteration "
              + json.dumps({k: round(v, 2) for k, v in row["us_per_it"].items()})
              + f" ({row['speedup']:.3f}x at C = {rule})", flush=True)
    return out


def split(dev, probes, cases) -> dict:
    """Per-phase us per iteration at the rule's C on phase 41's solves,
    each probe build in turns (parent, this, this, parent), 3 launches a
    turn; per block (its rank) and the mean and max over blocks."""
    import ctypes

    import torch

    from fluidgym_tpu_torch.ops import cg_cuda_mb

    out = {}
    for name, plan, diag, off, b, x0, space, tol2, kw in cases:
        if not name.startswith("phase 41"):
            continue
        n = b.shape[1]
        C = cg_cuda_mb.merged_arm(1, n, 2, 1, dev, "cg_coarse", space.K).cluster
        acc = {tag: [[0] * SLOTS for _ in range(C)] for tag in probes}
        its = {tag: 0 for tag in probes}
        raw = {tag: [] for tag in probes}
        for tag in list(probes) + list(probes)[::-1]:
            lib, mod, form = probes[tag]
            launch = rev_agg_launcher(lib, mod, plan, diag, off, b, x0, space,
                                      tol2, kw, C)
            launch()
            torch.cuda.synchronize()
            for _ in range(3):
                ns = (ctypes.c_ulonglong * (16 * SLOTS))()
                cnt = (ctypes.c_ulonglong * (16 * SLOTS))()
                mod.check(lib.fg_probe_reset(), "probe reset")
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                _, it, _ = launch()
                e1.record()
                torch.cuda.synchronize()
                mod.check(lib.fg_probe_read(ctypes.addressof(ns),
                                            ctypes.addressof(cnt)),
                          "probe read")
                raw[tag].append(e0.elapsed_time(e1))
                its[tag] += int(it[0])
                for blk in range(C):
                    for p in range(SLOTS):
                        acc[tag][blk][p] += ns[blk * SLOTS + p]
        row = {}
        for tag, (_, _, form) in probes.items():
            per_it = [[v / 1e3 / its[tag] for v in blk] for blk in acc[tag]]
            names = PHASES[form]
            row[tag] = dict(
                form=form, iterations=its[tag] // len(raw[tag]),
                probe_us_per_it=1e3 * sum(raw[tag]) / its[tag],
                phases={names[p]: dict(
                    mean=sum(blk[p] for blk in per_it) / C,
                    max=max(blk[p] for blk in per_it),
                    min=min(blk[p] for blk in per_it))
                    for p in range(len(names))},
                per_block=per_it)
            print(f"split {name}, {tag} ({form}), C = {C}, probe build "
                  f"{row[tag]['probe_us_per_it']:.2f} us/it: "
                  + json.dumps({k: [round(v['mean'], 2), round(v['max'], 2)]
                                for k, v in row[tag]["phases"].items()})
                  + " (mean, max over blocks; us per iteration)", flush=True)
        row["rows_per_block"] = [-(-(space.K - r) // C) for r in range(C)]
        row["ring_stages"] = cg_cuda_mb.agg_ring_stages(n, C, space.K)
        out[name] = row
    return out


def _device_ms(fn):
    """Device ms of ``fn()`` (the CUDA activity alone, as
    ``chip_smoke.device_ms``) and the K3-agg instances' part of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = agg = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        total += ev.duration_ns()
        nm = ev.name()
        if "fg_cg_kernel" in nm and ("0, true>" in nm or
                                     "ILi0ELb1EE" in nm):
            agg += ev.duration_ns()
    return total / 1e6, agg / 1e6


def env_ab(dev, parent, steps: int = 1) -> dict:
    """Airfoil2D-medium end to end (see the module's notes)."""
    import numpy as np
    import torch

    import chip_smoke
    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    original = cg_cuda_mb.merged_launcher

    def parent_launcher(algo, plan, diag, off, b, x0, *, tol2_sum, chunk,
                        coarse=None, cluster=1, **kw):
        if coarse is not None and isinstance(coarse[0], cg_cuda_mb.AggSpace):
            return rev_agg_launcher(
                *parent, plan, diag.contiguous(), off.contiguous(),
                b.contiguous(), None if x0 is None else x0.contiguous(),
                coarse[0], tol2_sum, kw, cluster)
        return original(algo, plan, diag, off, b, x0, tol2_sum=tol2_sum,
                        chunk=chunk, coarse=coarse, cluster=cluster, **kw)

    env = fluidgym_tpu_torch.make(chip_smoke.AGG_IDS[0],
                                  randomize_initial_state=False,
                                  step_length=chip_smoke.AGG_STEP_LENGTH)
    env.reset(seed=0)
    start = env.get_state()
    a = np.array([0.5, -0.2, -0.3], np.float32)
    k3 = cg_cuda_mb.fused_cg_mb

    def run(arm, fn):
        cg_cuda_mb.merged_launcher = (parent_launcher if arm == "parent"
                                      else original)
        try:
            env.set_state(start)
            return fn()
        finally:
            cg_cuda_mb.merged_launcher = original

    rows, first = [], None
    for arm in ("parent", "this", "this", "parent"):
        def steps_():
            got = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                obs, _, _, _, info = env.step(a)
                torch.cuda.synchronize()
                got.append((1e3 * (time.perf_counter() - t), obs,
                            int(info["pressure_iterations"])))
            return got
        c0 = k3.agg_flip_launches
        got = run(arm, steps_)
        obs = got[-1][1]
        first = obs if first is None else first
        same = all(torch.equal(obs[k], first[k]) for k in obs)
        rows.append(dict(arm=arm, ms_per_step=[g[0] for g in got],
                         pressure_iterations=[g[2] for g in got],
                         agg_flip_launches=k3.agg_flip_launches - c0,
                         obs_bit_equal_to_first=same))
        print(f"Airfoil2D-medium end to end, {arm}: ms per sim step "
              f"{[round(g[0], 1) for g in got]}, pressure iterations "
              f"{[g[2] for g in got]}, K3-agg-flip launches "
              f"{rows[-1]['agg_flip_launches']}, obs bit-equal to the first "
              f"arm's {same}", flush=True)
    dev_ms = {}
    for arm in ("parent", "this"):
        total, agg = run(arm, lambda: _device_ms(lambda: env.step(a)))
        dev_ms[arm] = dict(device_ms=total, k3_agg_ms=agg)
    mean = lambda w: (sum(sum(r["ms_per_step"]) for r in rows if r["arm"] == w)
                      / sum(len(r["ms_per_step"]) for r in rows
                            if r["arm"] == w))
    out = dict(arms=rows, parent_ms=mean("parent"), this_ms=mean("this"),
               device_ms_first_step=dev_ms)
    print(f"Airfoil2D-medium end to end: ms per sim step parent "
          f"{out['parent_ms']:.1f}, this {out['this_ms']:.1f}; device ms "
          + json.dumps({k: {x: round(y, 2) for x, y in v.items()}
                        for k, v in dev_ms.items()}), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-env", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_agg_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from fluidgym_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = _smi()
    print(card, flush=True)
    result = dict(card=card, device=torch.cuda.get_device_name(0))
    # the four builds at once: this tree, the parent, and both with the probe
    t = time.perf_counter()
    built, errors = {}, []

    def build(key, fn):
        try:
            built[key] = fn()
        except BaseException as err:  # reported below
            errors.append((key, err))

    jobs = {"this": _build.library,
            "parent": lambda: (lambda m: (m.library(), m))(
                _load_build(args.parent, "parent")),
            "probe parent": lambda: _probe_build(args.parent, "parent"),
            "probe this": lambda: _probe_build(ROOT, "this")}
    threads = [threading.Thread(target=build, args=kv) for kv in jobs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise SystemExit(f"build failed: {errors[0][0]}: {errors[0][1]}")
    result["build_s"] = time.perf_counter() - t
    print(f"four builds in {result['build_s']:.1f} s", flush=True)
    parent = built["parent"]
    import chip_smoke
    result["ptxas"] = {"this": chip_smoke.agg_build_ptxas(),
                       "parent": chip_smoke.agg_ptxas(
                           parent[1].build_info()["log"])}
    for k, v in result["ptxas"].items():
        for row in v:
            print(f"ptxas {k}: K3-agg {row}", flush=True)
    cases = _cases(dev)
    result["kernel"] = kernel_ab(dev, parent, cases, args.reps)
    probes = {"parent": built["probe parent"], "this": built["probe this"]}
    result["split"] = split(dev, probes, cases)
    if not args.no_env:
        result["env"] = env_ab(dev, parent)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
