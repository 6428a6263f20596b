#!/usr/bin/env python3
"""Smoke run of fluidgym_tpu_torch on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds:

1. the card's name and power limit (``nvidia-smi``);
2. build of the CUDA kernels (K1/K3/K3-coarse ``csrc/cg.cu``, K2
   ``csrc/bicgstab_mb.cu``, K4 ``csrc/stencil.cu``): one ``nvcc -c`` per
   source, all started together, and one link into ``build/kernels/``;
3. K1 against its plain PyTorch version on the card: the pressure system of
   the bundled RBC2D-easy snapshot at the main-path shape (1, 61, 96), then a
   4-lane run whose lanes converge at different speeds (one zero RHS) and
   that passes iteration 100; then the main-path solve in both arms, in
   turns (the chunk grid, the resident arm, the resident arm, the chunk
   grid): ms per raw launch on preallocated buffers, us per iteration, ms
   per wrapper call with the arm pinned;
4. K2 against its plain version: the snapshot's temperature (1 lane) and
   velocity (2 lanes) advection systems, then both arms in turns as in 3;
5. the main path: ``make("RBC2D-easy-v0")`` at its registered full width,
   ``reset(seed=0)``, 3 steps with fixed numpy actions; the kernels' launch
   counters are zeroed just before and read just after: every substep must
   launch K1 once per pressure corrector and K2 once per advection solve,
   every one of them on the resident arm (``.resident_launches`` equal to
   ``.launches``), and neither the plain versions nor ``linsolve``'s loops
   may run;
6. the card against the host (the kernels against the plain versions, end
   to end): a small config for 3 steps and the full width from the bundled
   snapshot for 1 step; observations and rewards must agree to 1e-4;
7. K3 (``csrc/cg.cu`` ``fg_cg_mb_solve``) against its plain version on the
   pressure system of the bundled CylinderJet2D-easy snapshot at full width
   (5 blocks -> 2 super-blocks, 14,232 cells): cold, warm-started from the
   deflated guess, and a 3-lane run whose lanes converge at different
   speeds (one zero RHS) and that passes iteration 100;
8. K2 in merged form ("K2-mb", ``fg_bicgstab_mb_solve``) against its plain
   version on the snapshot's velocity advection system (2 lanes);
9. the cylinder main path: ``make("CylinderJet2D-easy-v0")`` at its
   registered defaults, ``reset(seed=0)``, 3 steps with fixed numpy actions;
   the counters are zeroed just before and read just after: in every step
   K3 launches twice per substep and K2-mb once, no plain version and no
   ``linsolve`` loop runs; drag, lift, obs and reward finite;
10. the card against the host for the cylinder: 1 env step from the bundled
   snapshot, no randomization; obs and reward must agree to 1e-4;
11. K3 and K2-mb in their flip-seam form ("K3-flip", "K2-mb-flip": the
   Airfoil2D C-grid, 6 blocks -> 3 super-blocks whose wake cut is a
   reflected seam, 73,456 cells) against their plain versions on the
   pressure and velocity advection systems of the bundled Airfoil2D-easy
   ``train_00`` snapshot at full width: K3 cold and warm from the deflated
   guess, K2-mb with 2 lanes; the same iteration counts;
12. the airfoil main path: ``make("Airfoil2D-easy-v0")`` at its registered
   defaults (no randomization), ``reset(seed=0)``, 3 steps with fixed numpy
   actions; in every step K3-flip launches twice per substep and K2-mb-flip
   once, no other kernel form, no plain version and no ``linsolve`` loop;
   obs, reward, drag and lift finite;
13. the card against the host for the airfoil: 1 sim step (``step_length =
   dt``) from the bundled snapshot; the velocity obs and the reward must
   agree to 1e-4, the pressure obs to 1e-3 (float32 decides it only to
   ~1e-4 here; see ``MERGED_CASES``);
14. K4 (``csrc/stencil.cu``, the fused 2D stencil apply) against its plain
   version on every block of the two snapshots' pressure operators, scalar
   and in the deflation setup's column form (15 / 18 columns): max|dy|
   (bar 1e-6 relative; it is bit-equal when the rounding matches), us per
   launch, the bound;
15. K3-coarse (``csrc/cg.cu`` ``fg_cg_mb_coarse_solve``, the strip-coarse
   two-level preconditioner of ``solver/coarse_strips.py``, K = 34 strips)
   against its plain version on the cylinder's full-width pressure system:
   cold, warm from the deflated guess and a 3-lane run past iteration 100;
   the same converged flags, iterations within 2; each run also at the
   cluster rule's C (one lane over C SMs, ``csrc/krylov.cuh``; the 1-lane
   runs through the wrapper at it) bit-equal to C = 1 (x, iterations,
   residual); the warm solve's raw launch at C = 1 and at the rule's C in
   turns (ms, us per iteration), the coarse inverse's ms, the bound and
   the streamed bound; the Jacobi-only K3 iterations on the same systems
   beside them;
16. K3-coarse-flip likewise on the airfoil's system (K = 59);
17. the slice's main path: ``make`` of each merged id at its registered
   defaults, ``reset(seed=0)``, then ``SimConfig.pressure_coarse_strips``
   and the K4 switch on; 3 cylinder steps and 1 airfoil step with phases
   9 and 12's actions; in every step K3-coarse(-flip) launches twice per
   substep, each on the cluster arm (``.cluster_launches``), K2-mb(-flip)
   once, K4 once per block per ``domain_apply`` (15
   per cylinder substep, 18 per airfoil substep), and no other kernel form,
   plain version or ``linsolve`` loop; ms and pressure iterations per env
   step beside phases 9 and 12's;
18. the card against the host for the cylinder with the strips and K4 on:
   1 env step at full width from the bundled snapshot; obs and reward to
   1e-3, the card's solves as the cluster rule picks them (with the strips
   a float32 step is rounding-decided; see ``_strips_card_vs_host``);
19. the chunk grid: K1, K2, K3, K2-mb, K3-flip and K3-coarse at 130 lanes
   with one operator per lane, in chunks of 33 (4 blocks in one launch)
   against their plain versions in the same chunks (the same converged
   flags, iterations and x within each form's bar, a zero lane exactly 0,
   the CG forms past iteration 100); the vmapped wrapper equal to its raw
   launch, and no launch of the batch on the cluster arm; ms per solve at
   1, 64 and 130 lanes and the bound of the batch;
   K1 and K2 also in both arms at 1, 64 and 130 lanes, one lane per block,
   in turns (ms per raw launch);
20. the batched main path: ``BatchedFluidEnv("RBC2D-easy-v0", 64)`` at its
   registered defaults, ``reset(seed=0)``, 3 steps with seeded numpy
   actions; counters zeroed just before and read just after: in every step
   K1 launches exactly 2 and K2 2 per lockstep round, whatever the batch,
   every one on the resident arm, and no other kernel form, plain
   version, ``linsolve`` loop or vmap
   per-lane fallback runs; lanes 0 and 63 against single envs reset from
   the same seeds (see ``BATCH_CASES`` for the bars);
21. the same for ``CylinderJet2D-easy-v0``, 2 steps: K3 2 and K2-mb 1 per
   round;
22. batched env-steps/s beside the single env's, measured in the same run;
23. the cluster arm of K3 and K2-mb (one lane over a thread-block cluster,
   ``csrc/krylov.cuh``): K3, K3-flip, K2-mb and K2-mb-flip at their
   main-path shapes (phases 7, 8 and 11's systems) for C = 1 and every
   cluster size the card holds for their lanes, in turns on one card:
   against the plain version (the same converged flags, iterations within
   3, x within phases 7, 8 and 11's bars), two runs bit-equal, C = 1
   through the wrapper bit-equal to the chunk grid's raw launch; ms per
   wrapper call and per raw launch (preallocated buffers), us per
   iteration, the C that ``default_cluster`` picks and
   ``cudaOccupancyMaxActiveClusters`` per C;
24. the resident arm of K1 and K2 (one lane per block, the lane's operator
   rows and four vectors in shared memory, ``csrc/krylov.cuh``): on the
   main path's solves of phases 3-4 and phase 19's 64 and 130 lanes it
   must return the chunk grid's x, iterations and residual bit for bit,
   twice, and per raw launch (phases 3, 4 and 19) be no slower than the
   chunk grid at 1 and 64 lanes;
25. K1-3D and K2-3D (the 3D roll forms) against their plain versions on
   the solves of a first substep of RBC3D-easy (64, 41, 64) and
   RBC3D-wide-easy (128, 41, 128) from their bundled snapshots, captured at
   the wrappers: K1 on 1 and 2 lanes, K2 on the temperature (1 lane) and
   velocity (3 lanes) solves, with phases 3 and 4's bars; on each, the
   spread arm (one lane over G co-resident blocks, ``csrc/krylov.cuh``) at
   every G the card holds for the lanes, in both layouts, must return the
   chunk grid's x, iterations and residual bit for bit, and is timed
   against it per raw launch in turns; at (128, 41, 128) the rule's arm
   must be faster than the chunk grid for K1 and K2's velocity solve; ms
   per wrapper call and per raw launch, us per iteration, the plain
   version's ms, the bound;
26. the RBC3D main path: ``make("RBC3D-easy-v0")`` at its registered
   defaults (MARL, 64 agents), ``reset(seed=0)`` (randomized: noise and a
   1-2 time-unit burn-in), 3 steps; then ``use_marl=False``, 1 step; the
   counters zeroed just before each ``make`` and read after every step: in
   every step K1 launches once per pressure corrector per substep and K2
   once per advection solve, every one of them a 3D launch (K1-3D, K2-3D)
   on the spread arm, and no other kernel form, plain version or
   ``linsolve`` loop runs; ms and pressure iterations per env step;
27. the card against the host for RBC3D-easy: 1 sim step (``step_length =
   dt``) at full width from the bundled snapshot; obs and rewards to 1e-4;
28. ``RBC3D-wide-easy-v0`` (256 agents, (128, 41, 128)): reset and 1 step
   with phase 26's checks;
29. the five other RBC2D ids (medium, hard, wide-easy, wide-medium,
   wide-hard) at their registered defaults: reset and 2 steps each with
   phase 26's checks, the (61, 96) blocks on the resident arm and the (61,
   192) blocks on the spread arm (G = 32);
30. the other four RBC3D ids: ``make`` at the registered defaults on the
   card, then (this run does not read their datasets) 1 step from a
   conduction state at full width with phase 26's checks;
31. the spread arm against the chunk grid end to end: RBC3D-easy (2
   steps), RBC3D-wide-easy (1) and RBC2D-wide-easy (1, the spread arm
   pinned to G = 32) at their registered defaults, four arms in turns
   (chunk grid, spread, spread, chunk grid) from one reset state, obs
   bit-equal across the arms: ms per env step of each; and RBC2D-wide's
   (61, 192) K1 lane per raw launch at every G against the chunk grid;
32. K3-3D and K2-mb-3D (the 3D merged forms: identity seams, periodic z)
   against their plain versions on the solves of a first substep of
   CylinderJet3D-easy from its bundled ``train_00`` snapshot at full width
   (341,568 cells, 2 super-blocks), captured at the wrappers: the pressure
   solve cold and warm from the deflated guess, a 3-lane pressure run (one
   zero RHS) past iteration 100, the velocity advection solve (3 lanes);
   the same converged flags, iterations within 3 (K3) / 2 (K2), x within
   phases 7-8's bars; ``default_cluster`` gives 1, the launcher refuses
   C = 2 and ``merged_arm`` picks the spread arm (G = 128 for K3, 32 for
   K2-mb's 3 lanes); on each system the spread arm at every G the card
   holds for the lanes, in both layouts, must return the chunk grid's x,
   iterations and residual bit for bit, twice, timed against it per raw
   launch in turns; then CylinderJet3D-medium's first pressure solve
   (749,568 cells) alike; the rule's arm must be faster per raw launch than
   the chunk grid for K3-3D at both widths and for K2-mb-3D; ms per wrapper
   call and per raw launch, us per iteration, the plain version's ms, the
   bound;
33. the CylinderJet3D-easy main path: ``make("CylinderJet3D-easy-v0")`` at
   its registered defaults (SARL, 8 jets), ``reset(seed=0)``
   (randomized), 3 steps with fixed numpy actions; then ``use_marl=True``
   (8 agents): reset and 1 step; the counters zeroed just before each
   ``make`` and read after every step: in every step K3 launches twice per
   substep and K2-mb once, every one a 3D merged launch
   (``.launches_3d`` / ``.merged_launches_3d``) on the spread arm
   (``fused_cg_mb.spread_launches`` / ``fused_bicgstab_mb.
   merged_spread_launches`` equal to them, no cluster launch), and no
   other kernel form, plain version or ``linsolve`` loop runs; drag, lift,
   obs and rewards finite; ms and pressure iterations per env step;
34. the card against the host for CylinderJet3D-easy: 1 sim step
   (``step_length = dt``) at full width from the bundled snapshot, no
   randomization; obs and reward to 1e-4 (see ``CYL3D_HOST_BARS``);
35. ``CylinderJet3D-medium-v0`` (749,568 cells) at its registered
   defaults: reset from its bundled ``train_00`` (randomized) and 1 step
   with phase 33's checks;
36. the merged forms' spread arm against the chunk grid end to end:
   CylinderJet3D-easy (2 SARL steps; four arms in turns: chunk grid,
   spread, spread, chunk grid) and -medium (1 step; chunk grid, spread)
   at their registered defaults, every arm from the state phases 33
   (SARL) and 35 left, the chunk grid pinned with
   ``cg_cuda.pinned_spread(0)``; obs bit-equal across the arms; ms per
   env step of each arm and, for easy, device ms of the first step per
   arm (``torch.profiler``, CUDA activity only).

Phases 9 and 12 also hold every K3 and K2-mb launch of the single env's
main path to the cluster arm (``.cluster_launches`` equal to the form
counts).  Then a ``{"kernels": [...]}`` line, and last ``{"ok": true,
"device": ...}``.
Any failed check exits non-zero; there is no CPU fallback.  Imports nothing
of JAX or of the JAX package.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings

H100_BYTES_PER_S = 3.35e12    # HBM3, SXM data sheet
H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores, SXM data sheet

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def arm_times(torch, cg_cuda, launcher, wrapper, reps: int = 10) -> dict:
    """K1 / K2 (roll form) in its two arms, in turns (the chunk grid, the
    resident arm, the resident arm, the chunk grid) on one card:
    ``launcher(resident)`` gives a raw launch on preallocated buffers,
    ``wrapper()`` one wrapper call (the arm pinned with
    ``cg_cuda.pinned_resident``).  Returns the mean ms per raw launch and
    per wrapper call of each arm, the iterations and us per iteration."""
    launches = {arm: launcher(arm) for arm in (False, True)}
    raw = {False: 0.0, True: 0.0}
    wrap = {False: 0.0, True: 0.0}
    for arm in (False, True, True, False):
        raw[arm] += cuda_ms(torch, launches[arm], reps) / 2
        with cg_cuda.pinned_resident(arm):
            wrap[arm] += cuda_ms(torch, wrapper, reps) / 2
    its = int(launches[True]()[1].max())
    return dict(iterations=its, raw_ms=raw[True], raw_ms_global=raw[False],
                ms=wrap[True], ms_global=wrap[False],
                us_per_it=raw[True] * 1e3 / max(its, 1),
                us_per_it_global=raw[False] * 1e3 / max(its, 1))


def bound_ms(n_cells: int, lanes: int, ndims: int, iters: int, algo: str,
             warm: bool, op_shared: bool, seam_cells: int = 0,
             coarse_K: int = 0) -> tuple[float, str, float]:
    """Least time for the same work on an H100 (the larger of: bytes read
    once / written once over HBM rate, and this run's fp32 operations over
    the fp32 rate), and the time if every field went through HBM once per
    pass instead (``stream``: the working set NOT kept on chip).
    ``n_cells``: cells of a lane, summed over the super-blocks of a merged
    plan; ``seam_cells``: cells of its seam-fixup slabs (each read once more
    and corrected once more per matvec); ``coarse_K``: strips of K3-coarse
    (its K x K inverse and per-strip cell lists read once; per iteration a
    restriction add and a prolongation add per cell and a K x K product)."""
    nf = 2 * ndims
    op_words = (1 + nf) * n_cells * (1 if op_shared else lanes)
    if coarse_K:
        op_words += coarse_K * coarse_K + 2 * n_cells + coarse_K + 1
    io_words = (op_words + lanes * (n_cells * (2 + (1 if warm else 0))
                                    + seam_cells) + 2 * lanes)
    t_bytes = 4 * io_words / H100_BYTES_PER_S * 1e3
    if algo == "cg":
        flops_cell = 4 * ndims + 14       # matvec, 2 axpy, precond, 3 dots, p
        mv_per_it = 1
        stream_words = n_cells * (nf + 1 + 10)
    else:
        flops_cell = 8 * ndims + 26       # 2 matvecs, 2 precond, 5 dots, updates
        mv_per_it = 2
        stream_words = n_cells * (2 * (nf + 1) + 22)
    if coarse_K:
        flops_cell += 2
    flops = float(iters) * lanes * (n_cells * flops_cell
                                    + 3 * mv_per_it * seam_cells
                                    + 2 * coarse_K * coarse_K)
    t_ops = flops / H100_FP32_FLOPS * 1e3
    stream = float(iters) * lanes * 4 * stream_words / H100_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", stream
    return t_bytes, "bytes", stream


def count_calls(piso, linsolve):
    """Count substeps and ``linsolve``'s plain Krylov loops by wrapping the
    module functions the solver looks up at call time.  Returns ``(calls,
    restore)``."""
    calls = {"piso_substep_info": 0, "cg": 0, "bicgstab": 0}
    originals = [(mod, name, getattr(mod, name)) for mod, name in (
        (piso, "piso_substep_info"), (linsolve, "cg"), (linsolve, "bicgstab"))]
    for mod, name, fn in originals:
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)

    def restore():
        for mod, name, fn in originals:
            setattr(mod, name, fn)

    return calls, restore


def compare(name, wrapper_call, plain_call, b, tol, rel_tol, it_tol,
            matvec):
    """Kernel vs plain on the same inputs: iterations within ``it_tol``,
    max|dx| <= rel_tol * max|x_plain|, converged lanes' true residual
    RMSE <= 2 tol, zero-RHS lanes exactly zero."""
    import torch

    xk, ik, rk = wrapper_call()
    xp, ip, rp = plain_call()
    torch.cuda.synchronize()
    err = float((xk - xp).abs().max())
    scale = float(xp.abs().max())
    L = b.shape[0]
    # the true residual in float64: in float32, b - A x has a rounding
    # floor of ~eps * |A x| per cell, above tol for these systems
    res = (b.double() - matvec(xk.double())).reshape(L, -1)
    rmse = torch.sqrt((res * res).mean(dim=1))
    conv = rp <= tol * tol * b[0].numel()
    zero = (b.reshape(L, -1) == 0).all(dim=1)
    log(f"  {name}: iters kernel {ik.tolist()} plain {ip.tolist()} | "
        f"max|dx| {err:.3e} (max|x| {scale:.3e}, bar {rel_tol:g} rel) | "
        f"true-residual rmse {[f'{v:.2e}' for v in rmse.tolist()]} "
        f"(bar 2*tol = {2 * tol:.1e}) | zero lanes {zero.tolist()}")
    check(all(abs(a - c) <= it_tol for a, c in zip(ik.tolist(), ip.tolist())),
          f"{name}: iteration counts differ by more than {it_tol}")
    check(err <= rel_tol * max(scale, 1e-30), f"{name}: solutions differ")
    check(bool(torch.isfinite(xk).all()), f"{name}: non-finite solution")
    for l in range(L):
        if bool(zero[l]):
            check(bool((xk[l] == 0).all()), f"{name}: zero-RHS lane {l} not zero")
        elif bool(conv[l]):
            check(float(rmse[l]) <= 2 * tol,
                  f"{name}: lane {l} residual {float(rmse[l])} > 2 tol")
    return err, int(ik.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    return _run(torch.device("cuda"))


def _run(dev) -> int:
    """All phases on ``dev`` (the card; a CPU device only rehearses the
    control flow with the plain versions and fails the launch checks)."""
    import numpy as np
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import fluidgym_tpu_torch
        from fluidgym_tpu_torch.core.domain_io import load_domain
        from fluidgym_tpu_torch.ops import _build, cg_cuda, cg_cuda_mb
        from fluidgym_tpu_torch.solver import block_merge, linsolve, piso
        from fluidgym_tpu_torch.solver import stencil as st
        from fluidgym_tpu_torch.utils import data_utils
    except ImportError as err:
        print(f"chip_smoke: cannot import the port ({err}); run from the "
              "repository root", file=sys.stderr)
        return 2
    for mod in ("jax", "fluidgym_tpu"):
        check(mod not in sys.modules, f"{mod} was imported")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---- 1: the card -----------------------------------------------------
    smi = nvidia_smi_line()
    log(f"phase 1 card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    # ---- 2: build ----------------------------------------------------------
    t = time.perf_counter()
    _build.library()
    info = _build.build_info()
    build_s = time.perf_counter() - t
    log(f"phase 2 build: {build_s:.2f}s (nvcc {info['build_seconds']}) -> "
        f"{info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # systems of the main path, from the bundled snapshot at full width
    cfg_env = fluidgym_tpu_torch.registry._entries["RBC2D-easy-v0"][1]
    dom_id = (f"rbc_2d_Ra{float(cfg_env['rayleigh_number'])}_Pr"
              f"{float(cfg_env['prandtl_number'])}_NH{cfg_env['n_heaters']}"
              f"_HW{cfg_env['resolution']}")
    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir(dom_id) / "train_00", device=dev)
    nd = topo.ndims
    dt = torch.tensor(float(cfg_env["dt"]) / 2, device=dev)
    adv_ops = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv_ops), geoms, topo)
    hbyA = st.pressure_rhs_vec(state, geoms, topo, adv_ops,
                               tuple(b.velocity for b in state.blocks),
                               state.viscosity, dt)
    div = st.divergence_of(hbyA, state, geoms, topo)
    p_rhs = -div[0]
    p_rhs = (p_rhs - p_rhs.mean()).unsqueeze(0).contiguous()
    shape = tuple(p_rhs.shape[1:])
    n = math.prod(shape)
    log(f"main-path block shape {shape} ({n} cells)")
    kernels = {}

    # ---- 3: K1 vs plain ------------------------------------------------------
    po = p_ops[0]
    mv_p = lambda v: cg_cuda.roll_matvec(po.diag[None], po.off[None], v, nd)
    kw1 = dict(ndims=nd, maxiter=5000, stall_iters=250, precondition=True,
               return_best=True)
    tol_p = 1e-5
    tol2 = cg_cuda.tol2_sum_f32(tol_p, n)

    def k1_call(b=p_rhs):
        x, inf = cg_cuda.fused_cg(po.diag, po.off, b, tol=tol_p, **kw1)
        return x, inf.iterations, inf.residual ** 2 * n

    def k1_plain(b=p_rhs):
        return cg_cuda.fused_cg_plain(po.diag[None], po.off[None], b, None,
                                      tol2_sum=tol2, **kw1)

    err1, it1 = compare("K1 pressure (1,61,96)", k1_call, k1_plain, p_rhs,
                        tol_p, 1e-3, 3, mv_p)
    # 4 lanes: different RHS scales and content, one zero RHS, tight tol so
    # the lockstep loop passes iteration 100 (true-residual refresh)
    g = torch.Generator().manual_seed(0)
    b4 = torch.randn((4,) + shape, generator=g).to(dev)
    b4[1] = b4[1] * 1e-3
    b4[2] = 0
    b4[3] = p_rhs[0]
    b4 = b4 - b4.reshape(4, -1).mean(dim=1).reshape(4, 1, 1)
    tol4 = 1e-7
    tol24 = cg_cuda.tol2_sum_f32(tol4, n)
    err4, it4 = compare(
        "K1 4 lanes (4,61,96)",
        lambda: (lambda x, inf: (x, inf.iterations, inf.residual ** 2 * n))(
            *cg_cuda.fused_cg(po.diag, po.off, b4, tol=tol4, chunk=4, **kw1)),
        lambda: cg_cuda.fused_cg_plain(po.diag[None], po.off[None], b4, None,
                                       tol2_sum=tol24, **kw1),
        b4, tol4, 1e-3, 3, mv_p)
    check(it4 > 100, f"4-lane K1 run stopped at iteration {it4} (<= 100)")
    k1_arm = "resident" if cg_cuda.default_resident(1, n, nd, 1, dev) else "global"
    k1 = arm_times(torch, cg_cuda, lambda arm: cg_cuda.launcher(
        po.diag[None], po.off[None], p_rhs, None, chunk=1, resident=arm,
        tol2_sum=tol2, **kw1), k1_call)
    k1_ms = cuda_ms(torch, lambda: k1_call(), 10)
    k1_plain_ms = cuda_ms(torch, lambda: k1_plain(), 3)
    b1, by1, s1 = bound_ms(n, 1, nd, it1, "cg", False, True)
    log(f"phase 3 K1 ok: {k1_ms:.3f} ms/solve (plain {k1_plain_ms:.3f} ms, "
        f"bound {b1 * 1e3:.3f} us by {by1}, streaming {s1 * 1e3:.3f} us) at "
        f"{it1} iterations; the rule's arm {k1_arm}; in turns, raw launch "
        f"resident {k1['raw_ms']:.3f} ms = {k1['us_per_it']:.2f} us/iteration, "
        f"chunk grid {k1['raw_ms_global']:.3f} ms = "
        f"{k1['us_per_it_global']:.2f} us/iteration "
        f"({k1['raw_ms_global'] / k1['raw_ms']:.2f}x); per wrapper call "
        f"{k1['ms']:.3f} / {k1['ms_global']:.3f} ms")
    kernels["K1"] = dict(
        name="K1 fused_cg (Jacobi-PCG, whole solve)", route="cuda",
        source="fluidgym_tpu_torch/csrc/cg.cu",
        replaces="fluidgym_tpu/ops/cg_pallas.py:143", max_abs_err=max(err1, err4),
        ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=b1, bound_by=by1,
        library_ms=None, iterations=it1, arm=k1_arm, raw_ms=k1["raw_ms"],
        us_per_it=k1["us_per_it"], raw_ms_global=k1["raw_ms_global"],
        ms_global=k1["ms_global"], in_turns=k1)

    # ---- 4: K2 vs plain ------------------------------------------------------
    plan = block_merge.trivial_plan(topo)
    kappa = state.scalar_diffusivity[0]
    sc_ops = st.build_advection_ops(state, geoms, topo, kappa, dt,
                                    for_scalar=True, scalar_channel=0)
    sc_rhs = st.advection_rhs_scalar(state, geoms, topo, kappa, dt, 0)[0][None]
    vel_rhs = st.advection_rhs_velocity(state, geoms, topo, state.viscosity, dt)[0]
    kw2 = dict(maxiter=5000, stall_iters=250, precondition=True,
               return_best=False)
    tol_a = 1e-5
    tol2a = cg_cuda.tol2_sum_f32(tol_a, n)
    k2_err, k2_ms, k2_plain_ms, k2_it, k2_arms = 0.0, {}, {}, {}, {}
    for name, ops, b, x0 in (
            ("temperature", sc_ops[0], sc_rhs, state.blocks[0].scalar),
            ("velocity", adv_ops[0], vel_rhs, state.blocks[0].velocity)):
        mv_a = lambda v, o=ops: cg_cuda.roll_matvec(o.diag[None], o.off[None], v, nd)

        def k2_call(o=ops, b=b, x0=x0):
            xs, inf = cg_cuda_mb.fused_bicgstab_mb(
                plan, (o.diag,), (o.off,), (b,), (x0,), tol=tol_a, **kw2)
            # the wrapper aggregates its info over lanes (components)
            return xs[0], inf.iterations.repeat(b.shape[0]), None

        def k2_plain(o=ops, b=b, x0=x0):
            return cg_cuda_mb.fused_bicgstab_plain(
                o.diag[None], o.off[None], b, x0, ndims=nd, tol2_sum=tol2a, **kw2)

        e, it = compare(f"K2 {name} {tuple(b.shape)}", k2_call, k2_plain, b,
                        tol_a, 1e-4, 2, mv_a)
        k2_err = max(k2_err, e)
        k2_it[name] = it
        k2_ms[name] = cuda_ms(torch, k2_call, 10)
        k2_plain_ms[name] = cuda_ms(torch, k2_plain, 3)
        k2_arms[name] = a = arm_times(
            torch, cg_cuda, lambda arm, o=ops, b=b, x0=x0: cg_cuda_mb.launcher(
                o.diag[None], o.off[None], b, x0, ndims=nd, chunk=1,
                resident=arm, tol2_sum=tol2a, **kw2), k2_call)
        log(f"  K2 {name}: {k2_ms[name]:.3f} ms/solve (plain "
            f"{k2_plain_ms[name]:.3f} ms) at {it} iterations; in turns, raw "
            f"launch resident {a['raw_ms']:.3f} ms = {a['us_per_it']:.2f} "
            f"us/iteration, chunk grid {a['raw_ms_global']:.3f} ms = "
            f"{a['us_per_it_global']:.2f} us/iteration "
            f"({a['raw_ms_global'] / a['raw_ms']:.2f}x); per wrapper call "
            f"{a['ms']:.3f} / {a['ms_global']:.3f} ms")
    b2, by2, s2 = bound_ms(n, 2, nd, k2_it["velocity"], "bicgstab", True, True)
    log(f"phase 4 K2 ok: velocity bound {b2 * 1e3:.3f} us by {by2}, "
        f"streaming {s2 * 1e3:.3f} us")
    kernels["K2"] = dict(
        name="K2 fused_bicgstab_mb (right-Jacobi BiCGStab, trivial plan)",
        route="cuda", source="fluidgym_tpu_torch/csrc/bicgstab_mb.cu",
        replaces="fluidgym_tpu/ops/cg_pallas_mb.py:458", max_abs_err=k2_err,
        ms=k2_ms["velocity"], plain_ms=k2_plain_ms["velocity"], bound_ms=b2,
        bound_by=by2, library_ms=None, iterations=k2_it["velocity"],
        shape="(2, 61, 96) velocity",
        scalar_ms=k2_ms["temperature"],
        scalar_plain_ms=k2_plain_ms["temperature"],
        arm="resident" if cg_cuda.default_resident(2, n, nd, 1, dev) else "global",
        raw_ms=k2_arms["velocity"]["raw_ms"],
        us_per_it=k2_arms["velocity"]["us_per_it"],
        raw_ms_global=k2_arms["velocity"]["raw_ms_global"],
        ms_global=k2_arms["velocity"]["ms_global"],
        in_turns=k2_arms["velocity"], scalar_in_turns=k2_arms["temperature"])

    # phase 24's main-path systems, each as launcher(arm) at one lane per block
    res_systems = [
        ("K1 pressure (1, 61, 96)", lambda arm: cg_cuda.launcher(
            po.diag[None], po.off[None], p_rhs, None, chunk=1, resident=arm,
            tol2_sum=tol2, **kw1)),
        ("K1 4 lanes past the refresh", lambda arm: cg_cuda.launcher(
            po.diag[None], po.off[None], b4, None, chunk=1, resident=arm,
            tol2_sum=tol24, **kw1))]
    for name, ops, b, x0 in (
            ("temperature", sc_ops[0], sc_rhs, state.blocks[0].scalar),
            ("velocity", adv_ops[0], vel_rhs, state.blocks[0].velocity)):
        res_systems.append((
            f"K2 {name} {tuple(b.shape)} warm",
            lambda arm, o=ops, b=b, x0=x0: cg_cuda_mb.launcher(
                o.diag[None], o.off[None], b, x0, ndims=nd, chunk=1,
                resident=arm, tol2_sum=tol2a, **kw2)))

    # ---- 5: the main path ------------------------------------------------------
    calls, restore = count_calls(piso, linsolve)
    cg_cuda.fused_cg.launches = 0
    cg_cuda_mb.fused_bicgstab_mb.launches = 0
    cg_cuda.fused_cg.resident_launches = 0
    cg_cuda_mb.fused_bicgstab_mb.resident_launches = 0
    cg_cuda.fused_cg_plain.calls = 0
    cg_cuda_mb.fused_bicgstab_plain.calls = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    env = fluidgym_tpu_torch.make("RBC2D-easy-v0")
    obs, _ = env.reset(seed=0)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t
    reset_launches = {"K1": cg_cuda.fused_cg.launches,
                      "K2": cg_cuda_mb.fused_bicgstab_mb.launches}
    reset_substeps = calls["piso_substep_info"]
    rng = np.random.default_rng(0)
    actions = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
               for _ in range(3)]
    step_s = []
    nus = []
    for a in actions:
        t = time.perf_counter()
        obs, reward, term, trunc, info = env.step(a)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        nu = float(info["nusselt"])
        nus.append(nu)
        for k, v in obs.items():
            check(tuple(v.shape) == env.observation_space[k].shape,
                  f"obs {k} shape {tuple(v.shape)}")
            check(bool(torch.isfinite(v).all()), f"obs {k} not finite")
        check(bool(torch.isfinite(reward).all()), "reward not finite")
        check(math.isfinite(nu) and nu > 0, f"Nusselt {nu} not finite/positive")
        check(bool(info["pressure_converged"]), "a pressure solve did not converge")
    launches = {"K1": cg_cuda.fused_cg.launches,
                "K2": cg_cuda_mb.fused_bicgstab_mb.launches}
    resident = {"K1": cg_cuda.fused_cg.resident_launches,
                "K2": cg_cuda_mb.fused_bicgstab_mb.resident_launches}
    plain_calls = (cg_cuda.fused_cg_plain.calls
                   + cg_cuda_mb.fused_bicgstab_plain.calls)
    restore()
    check(resident == launches,
          f"not every K1 / K2 launch took the resident arm: {resident} of "
          f"{launches}")
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"a kernel of the main path was not launched: {launches}")
    check(plain_calls == 0, f"plain versions ran {plain_calls} times on the main path")
    check(calls["cg"] + calls["bicgstab"] == 0,
          f"linsolve's plain loops ran on the main path: {calls}")
    # every step substep: one K1 launch per pressure corrector, one K2 launch
    # per scalar channel and one for the velocity prediction
    n_sub = calls["piso_substep_info"] - reset_substeps
    expect = {"K1": env._cfg.corrector_steps * n_sub,
              "K2": (env._topo.scalar_channels + 1) * n_sub}
    step_launches = {k: launches[k] - reset_launches[k] for k in launches}
    check(n_sub > 0 and step_launches == expect,
          f"launches over the steps {step_launches} != {expect} for {n_sub} "
          "substeps")
    per_step = {k: step_launches[k] / len(actions) for k in launches}
    substeps = n_sub / len(actions)
    ms_step = 1e3 * sum(step_s) / len(step_s)
    log(f"phase 5 main path ok: RBC2D-easy-v0 {env._topo.blocks[0].shape} "
        f"reset {reset_s:.2f}s, steps {[round(s, 3) for s in step_s]} s, "
        f"{ms_step:.1f} ms/env step, {substeps:.1f} substeps/step "
        f"({env.n_sim_steps} sim steps of dt {env.dt}), Nusselt "
        f"{[round(v, 5) for v in nus]}, launches {launches} (reset "
        f"{reset_launches}; on the resident arm {resident}), plain calls "
        f"{plain_calls}, linsolve calls "
        f"{calls['cg'] + calls['bicgstab']}; per solve K1 {k1_ms:.3f} ms vs plain "
        f"{k1_plain_ms:.3f} ms, K2 {k2_ms['velocity']:.3f} ms vs plain "
        f"{k2_plain_ms['velocity']:.3f} ms")
    for k in ("K1", "K2"):
        kernels[k]["launches"] = launches[k]
        kernels[k]["launches_per_env_step"] = per_step[k]

    # ---- 6: card against host (kernels against plain versions, end to end)
    small = dict(n_heaters=4, resolution=4, load_initial_domain=False,
                 load_domain_statistics=False, randomize_initial_state=False,
                 episode_length=5, step_length=0.1, dt=0.05, local_obs_window=3)
    full = dict(randomize_initial_state=False, episode_length=2)
    for label, kw, n_steps, seed in (("small (10, 16)", small, 3, 1),
                                     ("full width (61, 96)", full, 1, 0)):
        t = time.perf_counter()
        outs = {}
        for where in (dev, torch.device("cpu")):
            e = fluidgym_tpu_torch.make("RBC2D-easy-v0", device=where, **kw)
            e.reset(seed=seed)
            seq = []
            for i in range(n_steps):
                a = np.full(e.action_space.shape, 0.3 * (i - 1), np.float32)
                a[0] = 0.5
                o, r, *_ = e.step(a)
                seq.append((o, r))
            outs[where.type] = seq
        worst = 0.0
        for (og, rg), (oc, rc) in zip(outs[dev.type], outs["cpu"]):
            pairs = [(og[k].cpu(), oc[k]) for k in og] + [(rg.cpu(), rc)]
            for g_, c_ in pairs:
                worst = max(worst, float((g_ - c_).abs().max()
                                         / c_.abs().max().clamp(min=1e-30)))
        log(f"phase 6 {label}, {n_steps} step(s), card vs host: worst "
            f"relative obs/reward diff {worst:.2e} (bar 1e-4) in "
            f"{time.perf_counter() - t:.2f}s")
        check(worst <= 1e-4, f"card and host disagree on the {label} config")

    for case in MERGED_CASES:
        _merged_phases(dev, kernels, compare, piso, linsolve, case)

    _k4_phase(dev, kernels, piso)
    for case in MERGED_CASES:
        _coarse_phase(dev, kernels, compare, piso, case)
    _strips_main_path(dev, kernels, piso, linsolve)
    _strips_card_vs_host(dev, piso)

    with warnings.catch_warnings():
        # vmap's per-lane fallback must not hide anywhere in the batch phases
        warnings.filterwarnings("error", message=".*performance drop.*")
        roll = _chunk_phase(dev, kernels, piso,
                            dict(po=po, adv=adv_ops[0], topo=topo))
        results = [_batched_phase(dev, kernels, piso, linsolve, case)
                   for case in BATCH_CASES]
    _throughput_phase(kernels, results)
    log(f"phase 22 summary {json.dumps(kernels.pop('batched'))}")
    for case in MERGED_CASES:
        _cluster_phase(dev, kernels, piso, case)
    for name, f in roll.items():
        res_systems += [(f"{name} {Ln} lanes", lambda arm, f=f, Ln=Ln:
                         f["roll_launcher"](Ln, arm)) for Ln in (64, CHUNK_LANES)]
    _resident_phase(kernels, res_systems)
    _rbc_phases(dev, kernels, compare, piso, linsolve)
    _cyl3d_phases(dev, kernels, compare, piso, linsolve)

    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernels[k] for k in (
        "K1", "K2", "K2-mb", "K3", "K3-flip", "K2-mb-flip", "K4", "K3-coarse",
        "K3-coarse-flip", "K1 lanes", "K2 lanes", "K3 lanes", "K2-mb lanes",
        "K1-3D", "K2-3D", "K3-3D", "K2-mb-3D")]}),
        flush=True)
    log(f"total {time.perf_counter() - T0:.1f}s (build {build_s:.1f}s)")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


#: the merged-frame main paths: phases 7-10 (the cylinder's identity seams)
#: and 11-13 (the airfoil's C-grid, whose wake cut is a reflected seam)
MERGED_CASES = (
    dict(env_id="CylinderJet2D-easy-v0", snapshot=("cylinder_2D_Re100_Res24",
                                                   "test_00"),
         phases=(7, 8, 9, 10), plan=(2, 2, 0), cells=(5, 14232),
         k3="K3", k3_count="launches", k2="K2-mb", k2_count="merged_launches",
         k3c="K3-coarse", k3c_count="coarse_launches", coarse_phase=15,
         k3c_lanes_tol=3e-7, k3c_steps=3,
         k3_form="", k2_form="", dt=0.01, tol_p=1e-5, k3_it_tol=3,
         k2_it_tol=2, lanes3=True, plain_reps=3, make_kw={},
         host_kw=dict(randomize_initial_state=False), host_pressure_bar=1e-4),
    dict(env_id="Airfoil2D-easy-v0", snapshot=("airfoil_2D_Re1000", "train_00"),
         phases=(11, 11, 12, 13), plan=(3, 6, 2), cells=(6, 73456),
         k3="K3-flip", k3_count="flip_launches", k2="K2-mb-flip",
         k3c="K3-coarse-flip", k3c_count="coarse_flip_launches",
         coarse_phase=16, k3c_lanes_tol=None, k3c_steps=1,
         k2_count="merged_flip_launches", k3_form=" with reflected seams",
         k2_form=" with reflected seams", dt=0.05, tol_p=1e-7, k3_it_tol=0,
         k2_it_tol=0, lanes3=False, plain_reps=1,
         make_kw=dict(randomize_initial_state=False),
         # one sim step; reward = cl/cd without the statistics' cl_cd_ref,
         # whose difference of near-equal numbers would amplify rounding
         host_kw=dict(randomize_initial_state=False,
                      load_domain_statistics=False, step_length=0.05,
                      dt=0.05),
         # a float32 airfoil pressure obs is decided by rounding at ~1e-4
         # (substeps of ~0.003 put O(u/dt) terms into the divergence that
         # cancel): on the host alone, 1 vs 8 threads moves it 2e-5 (7e-5
         # at tol 1e-8) and float32 vs float64 8.9e-5..1.1e-4, and the JAX
         # package's own float32 runs are 6.6e-5..3.8e-3 off its float64
         # run; 1e-3 still catches a wrong seam, which moves it O(1)
         host_pressure_bar=1e-3),
)


def _snapshot_system(dev, piso, case) -> dict:
    """The bundled snapshot of a merged case and the pressure system of one
    main-path substep (the sim step cut to CFL 0.8): operators, the
    mean-free RHS and the deflated warm start from the snapshot's
    pressure."""
    import torch

    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.solver import block_merge
    from fluidgym_tpu_torch.solver import stencil as st
    from fluidgym_tpu_torch.utils import data_utils

    data_id, split = case["snapshot"]
    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir(data_id) / split, device=dev)
    plan = block_merge.merge_plan(topo)
    n_flip = sum(any(fx.flip) for fx in plan.fixups)
    check((len(plan.superblocks), len(plan.fixups), n_flip) == case["plan"],
          f"the {case['env_id']} merge plan is not (super-blocks, fixups, "
          f"flips) = {case['plan']}")
    n = sum(math.prod(sb.shape) for sb in plan.superblocks)
    seam = sum(math.prod(hi - lo for K, (lo, hi) in enumerate(fx.window)
                         if K != fx.face // 2) for fx in plan.fixups)
    cfg = piso.SimConfig(dt=case["dt"], adaptive_cfl=0.8, differentiable=False)
    dt = piso._cfl_ts(state, geoms, topo, cfg,
                      torch.tensor(case["dt"], device=dev))
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    hbyA = st.pressure_rhs_vec(state, geoms, topo, adv,
                               tuple(b.velocity for b in state.blocks),
                               state.viscosity, dt)
    rhs = tuple(-d for d in st.divergence_of(hbyA, state, geoms, topo))
    mean = sum(r.sum() for r in rhs) / n
    rhs = tuple(r - mean for r in rhs)
    guess = piso._make_deflation_x0(p_ops, topo, torch.float32)(
        rhs, base=tuple(b.pressure for b in state.blocks))
    return dict(topo=topo, geoms=geoms, state=state, plan=plan, n=n, seam=seam,
                dt=dt, adv=adv, p_ops=p_ops, rhs=rhs, guess=guess)


def _merged_phases(dev, kernels, compare, piso, linsolve, case) -> None:
    """K3 and K2-mb of one merged plan against their plain versions on the
    systems of a bundled snapshot at full width, the main path of its id
    with launch counts per form, and the card against the host."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge
    from fluidgym_tpu_torch.solver import stencil as st

    env_id, k3n, k2n = case["env_id"], case["k3"], case["k2"]
    ph3, ph2, ph_main, ph_host = case["phases"]
    sy = _snapshot_system(dev, piso, case)
    topo, geoms, state, plan, n, seam = (
        sy[k] for k in ("topo", "geoms", "state", "plan", "n", "seam"))
    dt, adv, p_ops, rhs, guess = (sy[k] for k in ("dt", "adv", "p_ops", "rhs",
                                                  "guess"))
    n_flip = sum(any(fx.flip) for fx in plan.fixups)
    nd = topo.ndims
    S = len(plan.superblocks)
    log(f"{env_id} snapshot: blocks {[b.shape for b in topo.blocks]} -> "
        f"super-blocks {[sb.shape for sb in plan.superblocks]}, {n} cells, "
        f"{len(plan.fixups)} fixups ({n_flip} flips, {seam} seam cells)")

    # ---- K3 vs plain on the snapshot's pressure system --------------------
    mops = block_merge.pack_ops(plan, p_ops)
    diags, offs = tuple(m[0] for m in mops), tuple(m[1] for m in mops)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    mv3 = cg_cuda_mb._merged_mv(plan, diag, off)
    tol_p = case["tol_p"]  # the env's pressure tolerance
    kw3 = dict(maxiter=5000, stall_iters=250, precondition=True,
               return_best=True)

    def k3_pair(bs, x0s, tol):
        def kern():
            xs, inf = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s,
                                             tol=tol, chunk=bs[0].shape[0],
                                             **kw3)
            return (cg_cuda_mb.flatten_fields(plan, xs), inf.iterations,
                    inf.residual ** 2 * n)

        def plain():
            return cg_cuda_mb.fused_cg_mb_plain(
                plan, diag, off, cg_cuda_mb.flatten_fields(plan, bs),
                None if x0s is None else cg_cuda_mb.flatten_fields(plan, x0s),
                tol2_sum=cg_cuda.tol2_sum_f32(tol, n), **kw3)
        return kern, plain

    b1 = tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, rhs))
    g1 = tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, guess))
    flat1 = cg_cuda_mb.flatten_fields(plan, b1)
    errs, its = [], {}
    for label, x0s in (("cold", None), ("warm (deflated guess)", g1)):
        kern, plain = k3_pair(b1, x0s, tol_p)
        e, it = compare(f"{k3n} pressure {label} (1, {n})", kern, plain, flat1,
                        tol_p, 1e-3, case["k3_it_tol"], mv3)
        errs.append(e)
        its[label] = it
    if case["lanes3"]:
        # 3 lanes: different RHS scales and content, one zero RHS, tight tol
        # so the lockstep loop passes iteration 100 (true-residual refresh)
        g = torch.Generator().manual_seed(3)
        lanes3 = [torch.randn(n, generator=g).to(dev), 1e-3 * flat1[0],
                  torch.zeros(n, device=dev)]
        lanes3[0] = lanes3[0] - lanes3[0].mean()
        flat3 = torch.stack(lanes3)
        kern, plain = k3_pair(cg_cuda_mb.unflatten_fields(plan, flat3), None,
                              1e-7)
        e3, it3 = compare(f"{k3n} 3 lanes (3, {n})", kern, plain, flat3, 1e-7,
                          1e-3, case["k3_it_tol"], mv3)
        check(it3 > 100, f"3-lane {k3n} run stopped at iteration {it3} (<= 100)")
        errs.append(e3)
    kern, plain = k3_pair(b1, g1, tol_p)
    k3_ms = cuda_ms(torch, kern, 10)
    k3_plain_ms = cuda_ms(torch, plain, case["plain_reps"])
    warm_it = its["warm (deflated guess)"]
    b_3, by3, s3 = bound_ms(n, 1, nd, warm_it, "cg", True, True, seam)
    log(f"phase {ph3} {k3n} ok: {k3_ms:.3f} ms/solve warm (plain "
        f"{k3_plain_ms:.3f} ms, bound {b_3 * 1e3:.3f} us by {by3}, streaming "
        f"{s3 * 1e3:.3f} us) at {warm_it} iterations (cold: {its['cold']}), "
        f"{k3_ms * 1e3 / max(warm_it, 1):.1f} us/iteration, substep dt "
        f"{float(dt):.5f}")
    kernels[k3n] = dict(
        name=f"{k3n} fused_cg_mb (Jacobi-PCG, merged frame{case['k3_form']}, "
             "whole solve)",
        route="cuda", source="fluidgym_tpu_torch/csrc/cg.cu",
        replaces="fluidgym_tpu/ops/cg_pallas_mb.py:284", max_abs_err=max(errs),
        ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=b_3, bound_by=by3,
        library_ms=None, iterations=warm_it, cold_iterations=its["cold"],
        shape=f"(1, {n}) pressure, {S} super-blocks, {n_flip} flip seams")

    # ---- K2-mb vs plain on the snapshot's velocity advection system -------
    amops = block_merge.pack_ops(plan, adv)
    adiags, aoffs = tuple(m[0] for m in amops), tuple(m[1] for m in amops)
    adiag, aoff = cg_cuda_mb.flatten_ops(plan, adiags, aoffs)
    vel_rhs = st.advection_rhs_velocity(state, geoms, topo, state.viscosity, dt)

    def pack2(fields):
        per_c = [block_merge.pack_fields(plan, tuple(f[c] for f in fields))
                 for c in range(2)]
        return tuple(torch.stack([per_c[c][s_] for c in range(2)])
                     for s_ in range(S))

    bv = pack2(vel_rhs)
    xv = pack2(tuple(b.velocity for b in state.blocks))
    flatv = cg_cuda_mb.flatten_fields(plan, bv)
    # the float64 true residual of a float32 solution has a floor of
    # ~eps * |A x| (diag ~ 1/dt): 1.4e-5 on the airfoil, next to 2 * tol
    tol_a = 1e-5
    kw2 = dict(maxiter=5000, stall_iters=250, precondition=True,
               return_best=False)

    def k2_call():
        xs, inf = cg_cuda_mb.fused_bicgstab_mb(plan, adiags, aoffs, bv, xv,
                                               tol=tol_a, **kw2)
        return cg_cuda_mb.flatten_fields(plan, xs), inf.iterations.repeat(2), None

    def k2_plain():
        return cg_cuda_mb.fused_bicgstab_plain(
            adiag, aoff, flatv, cg_cuda_mb.flatten_fields(plan, xv), ndims=nd,
            plan=plan, tol2_sum=cg_cuda.tol2_sum_f32(tol_a, n), **kw2)

    e2, it2 = compare(f"{k2n} velocity (2, {n})", k2_call, k2_plain, flatv,
                      tol_a, 1e-4, case["k2_it_tol"],
                      cg_cuda_mb._merged_mv(plan, adiag, aoff))
    k2_ms = cuda_ms(torch, k2_call, 10)
    k2_plain_ms = cuda_ms(torch, k2_plain, case["plain_reps"])
    b_2, by2, s2 = bound_ms(n, 2, nd, it2, "bicgstab", True, True, seam)
    log(f"phase {ph2} {k2n} ok: {k2_ms:.3f} ms/solve (plain {k2_plain_ms:.3f} "
        f"ms, bound {b_2 * 1e3:.3f} us by {by2}, streaming {s2 * 1e3:.3f} us) "
        f"at {it2} iterations")
    kernels[k2n] = dict(
        name=f"{k2n} fused_bicgstab_mb (right-Jacobi BiCGStab, merged "
             f"plan{case['k2_form']})",
        route="cuda", source="fluidgym_tpu_torch/csrc/bicgstab_mb.cu",
        replaces="fluidgym_tpu/ops/cg_pallas_mb.py:458", max_abs_err=e2,
        ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=b_2, bound_by=by2,
        library_ms=None, iterations=it2,
        shape=f"(2, {n}) velocity, {S} super-blocks, {n_flip} flip seams")

    # ---- the main path -------------------------------------------------------
    calls, restore = count_calls(piso, linsolve)
    k3w, k2w = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    forms = ((k3w, "launches"), (k3w, "flip_launches"), (k2w, "launches"),
             (k2w, "merged_launches"), (k2w, "merged_flip_launches"),
             (cg_cuda.fused_cg, "launches"))
    plains = (cg_cuda.fused_cg_plain, cg_cuda_mb.fused_cg_mb_plain,
              cg_cuda_mb.fused_bicgstab_plain)

    def counts():
        out = {k3n: getattr(k3w, case["k3_count"]),
               k2n: getattr(k2w, case["k2_count"])}
        out["other"] = sum(getattr(w, a) for w, a in forms) - out[k3n] - out[k2n]
        out["cluster"] = k3w.cluster_launches + k2w.cluster_launches
        out["plain"] = sum(f.calls for f in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        return out

    for w, a in forms + ((k3w, "cluster_launches"), (k2w, "cluster_launches")):
        setattr(w, a, 0)
    for f in plains:
        f.calls = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        env = fluidgym_tpu_torch.make(env_id, **case["make_kw"])
        obs, _ = env.reset(seed=0)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        reset_counts = counts()
        nb = [b.shape for b in env._topo.blocks]
        check((len(nb), sum(math.prod(s_) for s_ in nb)) == case["cells"],
              f"the {env_id} main path is not the registered width: {nb}")
        rng = np.random.default_rng(0)
        actions = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
                   for _ in range(3)]
        step_s, per_step, drags, lifts, p_its = [], [], [], [], []
        for a in actions:
            c0 = counts()
            t = time.perf_counter()
            obs, reward, term, trunc, info = env.step(a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            c1 = counts()
            d = {k: c1[k] - c0[k] for k in c1}
            per_step.append(d)
            check(d["substeps"] > 0 and d[k3n] == 2 * d["substeps"]
                  and d[k2n] == d["substeps"] and d["other"] == 0,
                  f"{env_id} step launches {d}: expected {k3n} = 2 x "
                  f"substeps, {k2n} = substeps, no other kernel form")
            check(d["plain"] == 0, f"plain versions ran on the main path: {d}")
            check(d["linsolve"] == 0, f"linsolve's loops ran on the main path: {d}")
            # the single env's solves take the cluster arm, every one
            check(d["cluster"] == d[k3n] + d[k2n],
                  f"{env_id} step launches {d}: not every {k3n} / {k2n} "
                  "launch took the cluster arm")
            for k, v in obs.items():
                check(tuple(v.shape) == env.observation_space[k].shape,
                      f"obs {k} shape {tuple(v.shape)}")
                check(bool(torch.isfinite(v).all()), f"obs {k} not finite")
            check(bool(torch.isfinite(reward).all()), "reward not finite")
            drags.append(float(info["drag"]))
            lifts.append(float(info["lift"]))
            p_its.append(int(info["pressure_iterations"]))
            check(math.isfinite(drags[-1]) and math.isfinite(lifts[-1]),
                  "drag/lift not finite")
    finally:
        restore()
    total = counts()
    check(total[k3n] > 0 and total[k2n] > 0,
          f"a kernel of the {env_id} path was not launched: {total}")
    check(total["plain"] == 0 and total["linsolve"] == 0 and total["other"] == 0,
          f"another solver ran on the {env_id} path: {total}")
    check(total["cluster"] == total[k3n] + total[k2n],
          f"not every {env_id} solve took the cluster arm: {total}")
    n_steps = len(actions)
    sub = sum(d["substeps"] for d in per_step)
    ms_step = 1e3 * sum(step_s) / n_steps
    log(f"phase {ph_main} main path ok: {env_id} blocks {nb} reset "
        f"{reset_s:.2f}s ({reset_counts}), steps {[round(x, 3) for x in step_s]} s, "
        f"{ms_step:.1f} ms/env step, {sub / n_steps:.1f} substeps/step "
        f"({env.n_sim_steps} sim steps of dt {env.dt}), pressure iterations "
        f"per step {p_its}, drag {[round(x, 5) for x in drags]}, lift "
        f"{[round(x, 5) for x in lifts]}, per-step launches {per_step}, "
        f"totals {total}")
    for k in (k3n, k2n):
        kernels[k]["launches"] = total[k]
        kernels[k]["cluster_launches"] = total[k]
        kernels[k]["launches_per_env_step"] = sum(d[k] for d in per_step) / n_steps
        kernels[k]["ms_per_env_step"] = ms_step
    kernels[k3n]["step_ms"] = [1e3 * x for x in step_s]
    kernels[k3n]["pressure_iterations_per_step"] = p_its
    kernels[k3n]["substeps_per_step"] = [d["substeps"] for d in per_step]

    # ---- the card against the host ---------------------------------------
    t = time.perf_counter()
    outs = {}
    for where in (dev, torch.device("cpu")):
        e = fluidgym_tpu_torch.make(env_id, device=where, **case["host_kw"])
        e.reset(seed=0)
        a = np.linspace(0.4, -0.4, e.action_space.shape[0]).astype(np.float32)
        o, r, *_ = e.step(a)
        outs[where.type] = dict(o, reward=r)
    og, oc = outs[dev.type], outs["cpu"]
    diffs = {k: float((og[k].cpu() - oc[k]).abs().max()
                      / oc[k].abs().max().clamp(min=1e-30)) for k in og}
    p_bar = case["host_pressure_bar"]
    log(f"phase {ph_host} {env_id} full width, 1 step from the bundled "
        f"snapshot ({e.n_sim_steps} sim steps), card vs host: relative diffs "
        f"{diffs} (bar 1e-4; pressure obs {p_bar:g}) in "
        f"{time.perf_counter() - t:.2f}s")
    check(all(v <= (p_bar if k == "pressure" else 1e-4) for k, v in diffs.items()),
          f"card and host disagree on {env_id}")


def k4_bound_ms(ny: int, nx: int, cols: int) -> tuple[float, str]:
    """Least time of one K4 launch on an H100: diag and 4 off read once,
    x and the 4 halo layers read and y written once per column; 9 fp32
    operations per output cell."""
    n = ny * nx
    t_bytes = 4 * (5 * n + cols * (2 * n + 2 * (ny + nx))) / H100_BYTES_PER_S * 1e3
    t_ops = 9.0 * cols * n / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _k4_phase(dev, kernels, piso) -> None:
    """Phase 14: K4 against its plain version on every block of the two
    snapshots' pressure operators, as the main path calls it: scalar
    fields (the warm-start gate, twice per substep) and the deflation
    basis in column form (the coarse setup, once per substep)."""
    import torch

    from fluidgym_tpu_torch.ops import stencil_cuda
    from fluidgym_tpu_torch.solver import stencil as st

    rows, worst, worst_abs, exact = {}, 0.0, 0.0, True
    for case in MERGED_CASES:
        sy = _snapshot_system(dev, piso, case)
        topo, p_ops = sy["topo"], sy["p_ops"]
        g = torch.Generator().manual_seed(14)
        scalar = tuple(torch.randn(tuple(o.diag.shape), generator=g).to(dev)
                       for o in p_ops)
        columns = tuple(piso._deflation_basis(topo, torch.float32, dev))
        for form, xs in (("scalar", scalar), ("columns", columns)):
            halos = [tuple(st._halo_layer(xs, b, f, topo).contiguous()
                           for f in range(4)) for b in range(len(xs))]

            def run(fn, xs=xs, halos=halos):
                return [fn(o.diag, o.off, x, h)
                        for o, x, h in zip(p_ops, xs, halos)]

            yk = run(stencil_cuda.stencil_apply)
            yp = run(stencil_cuda.stencil_apply_plain)
            torch.cuda.synchronize()
            for a, b in zip(yk, yp):
                d = float((a - b).abs().max())
                worst_abs = max(worst_abs, d)
                worst = max(worst, d / max(float(b.abs().max()), 1e-30))
                exact = exact and bool(torch.equal(a, b))
            nb = len(xs)
            cols = 1 if form == "scalar" else xs[0].shape[0]
            bounds = [k4_bound_ms(*o.diag.shape, cols) for o in p_ops]
            rows[(case["env_id"], form)] = dict(
                ms=cuda_ms(torch, lambda: run(stencil_cuda.stencil_apply), 50) / nb,
                plain_ms=cuda_ms(torch, lambda: run(stencil_cuda.stencil_apply_plain),
                                 20) / nb,
                bound_ms=sum(b for b, _ in bounds) / nb, bound_by=bounds[0][1],
                cols=cols)
            r = rows[(case["env_id"], form)]
            log(f"  K4 {case['env_id']} {form} ({nb} blocks, {cols} column(s)): "
                f"{r['ms'] * 1e3:.2f} us/launch (plain {r['plain_ms'] * 1e3:.2f} "
                f"us, bound {r['bound_ms'] * 1e3:.4f} us by {r['bound_by']})")
    log(f"phase 14 K4 ok: max|dy| {worst_abs:.3e} ({worst:.2e} of max|y|, bar "
        f"1e-6 relative), bit-equal to the plain version: {exact}")
    check(worst <= 1e-6, f"K4 differs from its plain version by {worst:.3e}")
    # one cylinder substep: per block 1 column-form and 2 scalar launches
    cyl = MERGED_CASES[0]["env_id"]
    mix = lambda key: (rows[(cyl, "columns")][key]
                       + 2 * rows[(cyl, "scalar")][key]) / 3
    kernels["K4"] = dict(
        name="K4 stencil_apply (fused 2D stencil apply of one block)",
        route="cuda", source="fluidgym_tpu_torch/csrc/stencil.cu",
        replaces="fluidgym_tpu/ops/stencil_pallas.py:77", max_abs_err=worst_abs,
        bit_equal=exact, ms=mix("ms"), plain_ms=mix("plain_ms"),
        bound_ms=mix("bound_ms"), bound_by=rows[(cyl, "scalar")]["bound_by"],
        library_ms=None,
        shape="per launch, mean over one cylinder substep's mix",
        forms={f"{k[0]} {k[1]}": v for k, v in rows.items()})


def _coarse_phase(dev, kernels, compare, piso, case) -> None:
    """Phases 15-16: K3-coarse (identity seams, the cylinder) and
    K3-coarse-flip (the airfoil) against their plain versions on the
    snapshot's full-width pressure system: cold, warm from the deflated
    guess and (cylinder) a 3-lane run past iteration 100; the same
    converged flags and iterations within 2.  Each run also at the cluster
    rule's C (one lane per cluster; the 1-lane runs go through the wrapper
    at it) against C = 1, bit for bit (x, iterations, residual).  Also the
    Jacobi-only K3 iterations on the same systems, and the warm solve's raw
    launch at C = 1 and at the rule's C in turns."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge, coarse_strips

    name, ph = case["k3c"], case["coarse_phase"]
    sy = _snapshot_system(dev, piso, case)
    plan, n, seam, rhs, guess = (sy[k] for k in ("plan", "n", "seam", "rhs",
                                                  "guess"))
    sp = coarse_strips.strip_plan(plan)
    mops = block_merge.pack_ops(plan, sy["p_ops"])
    diags, offs = tuple(m[0] for m in mops), tuple(m[1] for m in mops)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    einv = coarse_strips.coarse_inverse(plan, sp, mops)[None]
    mv = cg_cuda_mb._merged_mv(plan, diag, off)
    kw = dict(maxiter=5000, stall_iters=250, precondition=True, return_best=True)
    flat = lambda xs: None if xs is None else cg_cuda_mb.flatten_fields(plan, xs)

    def pair(bs, x0s, tol, flags):
        def kern():
            xs, inf = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s, tol=tol,
                                             coarse_strips=True,
                                             chunk=bs[0].shape[0], **kw)
            flags["kernel"] = inf.converged.reshape(-1).cpu()
            return flat(xs), inf.iterations, inf.residual ** 2 * n

        def plain():
            x, it, rs = cg_cuda_mb.fused_cg_mb_plain(
                plan, diag, off, flat(bs), flat(x0s),
                tol2_sum=cg_cuda.tol2_sum_f32(tol, n), coarse=(sp, einv), **kw)
            zero = (flat(bs) == 0).all(dim=1)
            flags["plain"] = ((rs <= cg_cuda.tol2_sum_f32(tol, n)) | zero).cpu()
            return x, it, rs

        def jacobi():
            _, inf = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s, tol=tol,
                                            chunk=bs[0].shape[0], **kw)
            return int(inf.iterations.max())
        return kern, plain, jacobi

    b1 = tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, rhs))
    g1 = tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, guess))
    runs = [("cold", b1, None, case["tol_p"]),
            ("warm (deflated guess)", b1, g1, case["tol_p"])]
    if case["k3c_lanes_tol"]:
        # 3 lanes: different RHS scales and content, one zero RHS, tolerance
        # tight enough to pass the iteration-100 true-residual refresh; the
        # first lane is A x for a random x (a mean-free random RHS sits at
        # float32's floor for 3e-7: there the strips stall where Jacobi
        # alone needs 361 iterations)
        g = torch.Generator().manual_seed(3)
        flat1 = flat(b1)
        lane0 = mv(torch.randn((1, n), generator=g).to(dev))[0]
        flat3 = torch.stack([lane0, 1e-3 * flat1[0], torch.zeros(n, device=dev)])
        runs.append(("3 lanes", cg_cuda_mb.unflatten_fields(plan, flat3), None,
                     case["k3c_lanes_tol"]))
    def raw(bs, x0s, tol, C, coarse=(sp, einv)):
        """A raw launch on preallocated buffers at C (one lane per block or
        per cluster)."""
        return cg_cuda_mb.merged_launcher(
            "cg", plan, diag, off, flat(bs), flat(x0s),
            tol2_sum=cg_cuda.tol2_sum_f32(tol, n), coarse=coarse, chunk=1,
            cluster=C, **kw)

    rule = cg_cuda_mb.merged_arm(1, n, 2, 1, dev, coarse=True)[0]
    errs, its, jac, bits = [], {}, {}, {}
    for label, bs, x0s, tol in runs:
        flags = {}
        kern, plain, jacobi = pair(bs, x0s, tol, flags)
        lanes = bs[0].shape[0]
        cl0 = cg_cuda_mb.fused_cg_mb.cluster_launches
        e, it = compare(f"{name} {label} ({lanes}, {n})", kern, plain,
                        flat(bs), tol, 1e-3, 2, mv)
        check(torch.equal(flags["kernel"], flags["plain"]),
              f"{name} {label}: converged flags {flags}")
        if lanes == 1:
            check(cg_cuda_mb.fused_cg_mb.cluster_launches == cl0 + int(rule > 1),
                  f"{name} {label}: the wrapper did not take the cluster arm")
        errs.append(e)
        its[label] = it
        jac[label] = jacobi()
        if label == "3 lanes":
            check(it > 100, f"3-lane {name} run stopped at iteration {it} (<= 100)")
        # the cluster arm against the chunk grid, one lane per cluster
        rule_l = cg_cuda_mb.merged_arm(lanes, n, 2, 1, dev, coarse=True)[0]
        outs = {C: tuple(t.clone() for t in raw(bs, x0s, tol, C)())
                for C in (1, rule_l)}
        torch.cuda.synchronize()
        bits[label] = dict(cluster=rule_l, iterations=outs[1][1].tolist(),
                           bit_equal=all(torch.equal(u, v) for u, v in
                                         zip(outs[1], outs[rule_l])))
        check(bits[label]["bit_equal"], f"{name} {label}: C={rule_l} is not "
              f"bit-equal to C=1 (iterations {outs[rule_l][1].tolist()} vs "
              f"{outs[1][1].tolist()})")
    kern, plain, _ = pair(b1, g1, case["tol_p"], {})
    ms = cuda_ms(torch, kern, 10)
    plain_ms = cuda_ms(torch, plain, case["plain_reps"])
    # the wrapper's two parts: the coarse inverse from the operator (every
    # call, as in the JAX package) and the kernel launch itself, at C = 1
    # and at the rule's C in turns
    einv_ms = cuda_ms(torch, lambda: coarse_strips.coarse_inverse(plan, sp, mops), 10)
    launches = {C: raw(b1, g1, case["tol_p"], C) for C in (1, rule)}
    t = dict.fromkeys(launches, 0.0)
    for C in (1, rule, rule, 1):
        t[C] += cuda_ms(torch, launches[C], 10) / 2
    launch_ms, launch_ms_1 = t[rule], t[1]
    k3_rule = cg_cuda_mb.default_cluster(1, n, 2, 1, dev)
    jacobi_launch_ms = cuda_ms(torch, raw(b1, g1, case["tol_p"], k3_rule,
                                          coarse=None), 10)
    warm_it = its["warm (deflated guess)"]
    us = lambda v, it: v * 1e3 / max(it, 1)
    b, by, stream = bound_ms(n, 1, 2, warm_it, "cg", True, True, seam, sp.K)
    log(f"phase {ph} {name} ok: {ms:.3f} ms/solve warm (plain {plain_ms:.3f} ms, "
        f"bound {b * 1e3:.3f} us by {by}, streamed {stream * 1e3:.3f} us) at "
        f"{warm_it} iterations: coarse inverse {einv_ms:.3f} ms + launch at "
        f"C={rule} {launch_ms:.3f} ms = {us(launch_ms, warm_it):.2f} us/iteration "
        f"(C=1 {launch_ms_1:.3f} ms = {us(launch_ms_1, warm_it):.2f} us/iteration, "
        f"{launch_ms_1 / launch_ms:.2f}x; in turns); the rule's C bit-equal to "
        f"C=1 on every run {bits}; Jacobi-only K3 launch on the same warm "
        f"system at C={k3_rule} {jacobi_launch_ms:.3f} ms = "
        f"{us(jacobi_launch_ms, jac['warm (deflated guess)']):.2f} "
        f"us/iteration; K = {sp.K} strips; iterations with strips {its}, "
        f"Jacobi-only K3 on the same systems {jac}")
    kernels[name] = dict(
        name=f"{name} fused_cg_mb(coarse_strips=True) (strip-coarse two-level "
             f"PCG, merged frame{case['k3_form']}, whole solve; cluster arm, "
             f"one lane over C = {rule} SMs)",
        route="cuda", source="fluidgym_tpu_torch/csrc/cg.cu",
        replaces="fluidgym_tpu/ops/cg_pallas_mb.py:284", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
        streamed_ms=stream, coarse_inverse_ms=einv_ms, cluster=rule,
        launch_ms=launch_ms, us_per_it=us(launch_ms, warm_it),
        launch_ms_cluster_1=launch_ms_1,
        us_per_it_cluster_1=us(launch_ms_1, warm_it), cluster_bits=bits,
        jacobi_launch_ms=jacobi_launch_ms,
        iterations=warm_it, iterations_by_run=its, jacobi_iterations=jac,
        K=sp.K, shape=f"(1, {n}) pressure, K = {sp.K}")


def _counters():
    """Every launch counter and plain-version call counter of the port, as
    ``(object, attribute)`` pairs."""
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb, stencil_cuda

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    launches = [(k3, "launches"), (k3, "flip_launches"), (k3, "coarse_launches"),
                (k3, "coarse_flip_launches"), (k2, "launches"),
                (k2, "merged_launches"), (k2, "merged_flip_launches"),
                (cg_cuda.fused_cg, "launches"),
                (stencil_cuda.stencil_apply, "launches")]
    plains = [(f, "calls") for f in (
        cg_cuda.fused_cg_plain, cg_cuda_mb.fused_cg_mb_plain,
        cg_cuda_mb.fused_bicgstab_plain, stencil_cuda.stencil_apply_plain)]
    return launches, plains


def _strips_main_path(dev, kernels, piso, linsolve) -> None:
    """Phase 17: the slice's main path: ``make`` at the registered defaults,
    ``reset(seed=0)``, then the strips (``SimConfig.pressure_coarse_strips``)
    and K4 switched on; 3 steps of the cylinder and 1 of the airfoil with
    phases 9 and 12's actions.  In every step K3-coarse(-flip) launches
    exactly twice per substep, every launch on the cluster arm
    (``fused_cg_mb.cluster_launches``), K2-mb(-flip) once, K4 once per
    block per ``domain_apply`` (the deflation setup and the two warm-start
    gates), and no other kernel form, plain version or ``linsolve`` loop
    runs."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb, stencil_cuda

    launches, plains = _counters()
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    k4 = stencil_cuda.stencil_apply
    k4_total = 0
    for case in MERGED_CASES:
        env_id, name = case["env_id"], case["k3c"]
        watched = {name: (k3, case["k3c_count"]), case["k2"]: (k2, case["k2_count"]),
                   "K4": (k4, "launches")}
        calls, restore = count_calls(piso, linsolve)

        def counts():
            out = {k: getattr(*v) for k, v in watched.items()}
            out["other"] = sum(getattr(*c) for c in launches) - sum(out.values())
            out[f"{name} cluster"] = k3.cluster_launches
            out["plain"] = sum(getattr(*c) for c in plains)
            out["linsolve"] = calls["cg"] + calls["bicgstab"]
            out["substeps"] = calls["piso_substep_info"]
            return out

        for c in launches + plains + [(k3, "cluster_launches")]:
            setattr(*c, 0)
        torch.cuda.synchronize()
        try:
            env = fluidgym_tpu_torch.make(env_id, **case["make_kw"])
            env.reset(seed=0)
            env._cfg = dataclasses.replace(env._cfg, pressure_coarse_strips=True)
            stencil_cuda.set_stencil_kernel(True)
            cfg = env._cfg
            check(cfg.pressure_deflation and cfg.pressure_warm_start,
                  f"{env_id}: K4's count assumes deflation and warm start")
            k4_per_sub = len(env._topo.blocks) * (1 + cfg.corrector_steps)
            rng = np.random.default_rng(0)
            actions = [rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
                       for _ in range(3)][:case["k3c_steps"]]
            step_s, per_step, p_its, drags = [], [], [], []
            for a in actions:
                c0 = counts()
                t = time.perf_counter()
                obs, reward, term, trunc, info = env.step(a)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                d = {k: v - c0[k] for k, v in counts().items()}
                per_step.append(d)
                sub = d["substeps"]
                expect = {name: cfg.corrector_steps * sub,
                          f"{name} cluster": cfg.corrector_steps * sub,
                          case["k2"]: sub, "K4": k4_per_sub * sub, "other": 0,
                          "plain": 0, "linsolve": 0}
                check(sub > 0 and all(d[k] == v for k, v in expect.items()),
                      f"{env_id} step with strips + K4: launches {d}, expected "
                      f"{expect}")
                for k, v in obs.items():
                    check(tuple(v.shape) == env.observation_space[k].shape,
                          f"obs {k} shape {tuple(v.shape)}")
                    check(bool(torch.isfinite(v).all()), f"obs {k} not finite")
                check(bool(torch.isfinite(reward).all()), "reward not finite")
                drags.append(float(info["drag"]))
                p_its.append(int(info["pressure_iterations"]))
                check(math.isfinite(drags[-1]) and math.isfinite(float(info["lift"])),
                      "drag/lift not finite")
        finally:
            stencil_cuda.set_stencil_kernel(False)
            restore()
        total = counts()
        ms_step = 1e3 * sum(step_s) / len(step_s)
        ref = kernels[case["k3"]]
        n = len(actions)
        ref_ms = sum(ref["step_ms"][:n]) / n
        ref_its = ref["pressure_iterations_per_step"][:n]
        subs = [d["substeps"] for d in per_step]
        log(f"phase 17 main path with strips + K4 ok: {env_id} steps "
            f"{[round(x, 3) for x in step_s]} s, {ms_step:.1f} ms/env step (phase "
            f"{case['phases'][2]}, Jacobi-only, same actions: {ref_ms:.1f}), "
            f"substeps {subs} (phase {case['phases'][2]}: "
            f"{ref['substeps_per_step'][:n]}), pressure iterations per step "
            f"{p_its} (phase {case['phases'][2]}: {ref_its}), drag "
            f"{[round(x, 5) for x in drags]}, per-step launches {per_step}, "
            f"totals {total}, K4 {k4_per_sub} per substep")
        kernels[name].update(
            launches=total[name],
            cluster_launches=sum(d[f"{name} cluster"] for d in per_step),
            launches_per_env_step=total[name] / n,
            ms_per_env_step=ms_step, jacobi_ms_per_env_step=ref_ms,
            pressure_iterations_per_step=p_its,
            jacobi_pressure_iterations_per_step=ref_its, substeps_per_step=subs)
        k4_total += total["K4"]
        kernels["K4"][f"launches_per_env_step {env_id}"] = total["K4"] / n
    kernels["K4"]["launches"] = k4_total


def _strips_card_vs_host(dev, piso) -> None:
    """Phase 18: the card against the host for the cylinder with the strips
    and K4 on: 1 env step (25 sim steps) at full width from the bundled
    snapshot, the card's solves as the rule picks them (K3-coarse and K2-mb
    on the cluster arm); obs and reward to 1e-3.

    With the strips on, this float32 step is decided by rounding: on the
    host alone, 1 against 8 threads moves the pressure obs 1.5e-4, the
    velocity obs 1.2e-4 and the reward 4.8e-4 and the step's pressure
    iterations from 820 to 811 (4.8e-6, 2.2e-7, 6.1e-7 and no change with
    Jacobi alone), and 1 against 4 threads moves the pressure obs 1.98e-3
    (``scripts/port_strips_rounding.py``; ROADMAP Queue 3).  The cluster
    arm's sums are the one-block form's, bit for bit, so the card's step
    is the chunk grid's whatever C the rule picks.  Phases 15-16 hold the
    kernel itself to its plain version."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb, stencil_cuda

    case = MERGED_CASES[0]
    t = time.perf_counter()
    outs = {}
    k3 = cg_cuda_mb.fused_cg_mb
    # every K3 launch of the card run (the reset's Jacobi-only ones, then
    # K3-coarse) and its count on the cluster arm
    k3_all = lambda: (k3.launches + k3.flip_launches + k3.coarse_launches
                      + k3.coarse_flip_launches)
    before = (k3.coarse_launches, k3_all(), k3.cluster_launches,
              cg_cuda_mb.fused_bicgstab_mb.cluster_launches)
    stencil_cuda.set_stencil_kernel(True)
    try:
        for where in (dev, torch.device("cpu")):
            e = fluidgym_tpu_torch.make(case["env_id"], device=where,
                                        **case["host_kw"])
            e.reset(seed=0)
            e._cfg = dataclasses.replace(e._cfg, pressure_coarse_strips=True)
            a = np.linspace(0.4, -0.4, e.action_space.shape[0]).astype(np.float32)
            o, r, *_ = e.step(a)
            outs[where.type] = dict(o, reward=r)
    finally:
        stencil_cuda.set_stencil_kernel(False)
    check(k3.coarse_launches > before[0],
          "phase 18's card run did not launch K3-coarse")
    check(k3.cluster_launches - before[2] == k3_all() - before[1]
          and cg_cuda_mb.fused_bicgstab_mb.cluster_launches > before[3],
          "phase 18's card run did not take the cluster arm for every K3 "
          "and K3-coarse launch and for K2-mb")
    og, oc = outs[dev.type], outs["cpu"]
    diffs = {k: float((og[k].cpu() - oc[k]).abs().max()
                      / oc[k].abs().max().clamp(min=1e-30)) for k in og}
    log(f"phase 18 {case['env_id']} with strips + K4, full width, 1 step from "
        f"the bundled snapshot ({e.n_sim_steps} sim steps), card (cluster "
        f"rule) vs host: relative diffs {diffs} (bar 1e-3) in "
        f"{time.perf_counter() - t:.2f}s")
    check(all(v <= 1e-3 for v in diffs.values()),
          f"card and host disagree with strips + K4 on {case['env_id']}")


# ---------------------------------------------------------------------------
# phases 19-22: the chunk grid and the batched env
# ---------------------------------------------------------------------------

#: lanes and forced chunk of phase 19: 4 blocks of 33, 33, 33 and 31 lanes
CHUNK_LANES, CHUNK_FORCED = 130, 33


def _lane_forms(dev, piso, rbc) -> list:
    """Phase 19's systems, one per kernel form, at CHUNK_LANES lanes with
    one operator per lane (the main-path operator scaled by 0.5..2, as a
    batch of envs brings): ``A_l x_l`` for random ``x_l`` scaled 1e-3..1,
    lane 2 zero.  Each form: ``launch(L, chunk)`` / ``plain(L, chunk)`` on
    the first L lanes -> ``(x, iterations, residual_sum)``, and
    ``vmapped(chunk)``: the wrapper under ``torch.func.vmap`` over the
    lanes' systems (envs of C lanes each) -> x of every lane."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge, coarse_strips

    L = CHUNK_LANES
    g = torch.Generator().manual_seed(19)
    scale = torch.logspace(-3, 0, L, device=dev)
    scale[2] = 0.0
    lane = lambda v, t: v.reshape((-1,) + (1,) * (t.dim() - 1))
    forms = []

    def add(name, algo, C, diag0, off0, plan, tol, coarse=False):
        """``diag0``/``off0``: one env's operator, spatial (single block) or
        flat ``(n,)`` / ``(nf, n)`` (merged ``plan``)."""
        E = L // C
        s_env = torch.linspace(0.5, 2.0, E, device=dev)
        s = s_env.repeat_interleave(C)
        diag = diag0.unsqueeze(0) * lane(s, diag0.unsqueeze(0))
        off = off0.unsqueeze(0) * lane(s, off0.unsqueeze(0))
        nd = 2
        x = torch.randn(tuple(diag.shape), generator=g).to(dev)
        if plan is None:
            ax = cg_cuda.roll_matvec(diag, off, x, nd)
            n = math.prod(diag0.shape)
        else:
            ax = cg_cuda_mb._merged_mv(plan, diag, off)(x)
            n = diag0.shape[0]
        # the checks' lanes span scales 1e-3..1 (different speeds, lane 2
        # zero); the timings' lanes are all A x (equal difficulty, so that
        # 1, 64 and 130 lanes do the same work per lane)
        b, b_time = ax * lane(scale, x), ax
        tol2 = cg_cuda.tol2_sum_f32(tol, n)
        kw = dict(tol2_sum=tol2, maxiter=5000, stall_iters=250,
                  precondition=True, return_best=algo == "cg")
        sp = coarse_strips.strip_plan(plan) if coarse else None
        nf = off0.shape[0]

        def per_sb(t):  # flat (L, [nf,] n) -> per-super-block (L, [nf,] *s)
            if t.dim() == 2:
                return cg_cuda_mb.unflatten_fields(plan, t)
            return tuple(u.reshape((t.shape[0], nf) + tuple(u.shape[1:]))
                         for u in cg_cuda_mb.unflatten_fields(
                             plan, t.reshape(t.shape[0] * nf, -1)))

        einv = None
        if coarse:
            einv = torch.func.vmap(lambda d, o: coarse_strips.coarse_inverse(
                plan, sp, tuple(zip(d, o))))(per_sb(diag), per_sb(off))

        def chunk_of(Ln, chunk):
            return cg_cuda.default_chunk(Ln, dev) if chunk is None else chunk

        def roll_launcher(Ln, resident, rhs=b, chunk=1):
            """K1 / K2: one launch on preallocated buffers, in either arm."""
            mod = cg_cuda if algo == "cg" else cg_cuda_mb
            return mod.launcher(diag[:Ln], off[:Ln], rhs[:Ln], None, ndims=nd,
                                chunk=chunk, resident=resident, **kw)

        def launch(Ln, chunk=None, rhs=b):
            """One launch at the card's default chunk (and, for K1 / K2,
            the resident rule's arm), or at a forced chunk."""
            c = chunk_of(Ln, chunk)
            if plan is None:
                res = cg_cuda.default_resident(Ln, n, nd, c, dev)
                return roll_launcher(Ln, res, rhs, c)()
            a = (diag[:Ln], off[:Ln], rhs[:Ln], None)
            cz = None if einv is None else (sp, einv[:Ln])
            return cg_cuda_mb._launch_merged(algo, plan, *a, chunk=c,
                                             coarse=cz, **kw)

        def plain(Ln, chunk=None, rhs=b):
            c = chunk_of(Ln, chunk)
            a = (diag[:Ln], off[:Ln], rhs[:Ln], None)
            if plan is None and algo == "cg":
                return cg_cuda.fused_cg_plain(*a, ndims=nd, chunk=c, **kw)
            if plan is None or algo == "bicgstab":
                return cg_cuda_mb.fused_bicgstab_plain(*a, ndims=nd, plan=plan,
                                                       chunk=c, **kw)
            cz = None if einv is None else (sp, einv[:Ln])
            return cg_cuda_mb.fused_cg_mb_plain(plan, *a, coarse=cz, chunk=c,
                                                **kw)

        wkw = dict(tol=tol, maxiter=5000, stall_iters=250, precondition=True,
                   return_best=algo == "cg")

        def vmapped(chunk=None):
            de, oe = diag[::C], off[::C]
            be = b.reshape((E, C) + tuple(b.shape[1:]))
            if plan is None and algo == "cg":
                f = lambda d, o, bb: cg_cuda.fused_cg(d, o, bb, ndims=nd,
                                                      chunk=chunk, **wkw)[0]
                return torch.func.vmap(f)(de, oe, be).reshape(b.shape)
            if plan is None:
                tp = block_merge.trivial_plan(rbc["topo"])
                f = lambda d, o, bb: cg_cuda_mb.fused_bicgstab_mb(
                    tp, (d,), (o,), (bb,), chunk=chunk, **wkw)[0][0]
                return torch.func.vmap(f)(de, oe, be).reshape(b.shape)
            if algo == "cg":
                f = lambda d, o, bb: cg_cuda_mb.fused_cg_mb(
                    plan, d, o, tuple(t[0] for t in bb), chunk=chunk,
                    coarse_strips=coarse, **wkw)[0]
            else:
                f = lambda d, o, bb: cg_cuda_mb.fused_bicgstab_mb(
                    plan, d, o, bb, chunk=chunk, **wkw)[0]
            xs = torch.func.vmap(f)(per_sb(de), per_sb(oe),
                                    tuple(t.reshape((E, C) + tuple(t.shape[1:]))
                                          for t in per_sb(b)))
            # (E, [C,] *s) per super-block -> (L, n)
            return cg_cuda_mb.flatten_fields(
                plan, tuple(t.reshape((L,) + tuple(t.shape[1 + (C > 1):]))
                            for t in xs))

        forms.append(dict(name=name, algo=algo, C=C, n=n, tol2=tol2, b=b,
                          b_time=b_time, roll_launcher=roll_launcher,
                          launch=launch, plain=plain, vmapped=vmapped,
                          seam=0 if plan is None else _seam_cells(plan),
                          coarse_K=sp.K if coarse else 0))

    po, adv = rbc["po"], rbc["adv"]
    add("K1", "cg", 1, po.diag, po.off, None, 1e-7)
    add("K2", "bicgstab", 2, adv.diag, adv.off, None, 1e-6)
    for case, name, algo, C, tol, coarse in (
            (MERGED_CASES[0], "K3", "cg", 1, 1e-6, False),
            (MERGED_CASES[0], "K2-mb", "bicgstab", 2, 1e-6, False),
            (MERGED_CASES[1], "K3-flip", "cg", 1, 1e-6, False),
            (MERGED_CASES[0], "K3-coarse", "cg", 1, 1e-6, True)):
        sy = _snapshot_system(dev, piso, case)
        plan = sy["plan"]
        ops = sy["p_ops"] if algo == "cg" else sy["adv"]
        mops = block_merge.pack_ops(plan, ops)
        d1, o1 = cg_cuda_mb.flatten_ops(plan, tuple(m[0] for m in mops),
                                        tuple(m[1] for m in mops))
        add(name, algo, C, d1[0], o1[0], plan, tol, coarse)
    return forms


def _seam_cells(plan) -> int:
    return sum(math.prod(hi - lo for K, (lo, hi) in enumerate(fx.window)
                         if K != fx.face // 2) for fx in plan.fixups)


def _chunk_phase(dev, kernels, piso, rbc) -> dict:
    """Phase 19: the chunk grid.  Every kernel form at 130 lanes with one
    operator per lane, in chunks of 33 (4 blocks, the last ragged), against
    its plain version in the same chunks: the same converged flags,
    iterations per lane within the form's bar (CG 3, BiCGStab 2; K3-coarse
    10, see ``tests/test_torch_kernels_cuda.py``), x within the form's bar
    (1e-3 relative, BiCGStab 1e-4), the zero lane exactly 0, the CG forms
    past iteration 100.  The wrapper under ``torch.func.vmap`` equals the
    raw launch bit for bit (one launch for the batch).  ms per solve at 1,
    64 and 130 lanes of equal difficulty at the card's default chunk, the
    plain version on the 64 lanes in one lockstep loop, and the bound of
    the 64-lane batch (this run's per-lane iterations).  K1 and K2 also in
    both arms at 1, 64 and 130 lanes (one lane per block), in turns: ms per
    raw launch on preallocated buffers of the resident arm and of the chunk
    grid.  Returns the K1 and K2 forms (phase 24 holds their arms bit for
    bit)."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    L = CHUNK_LANES
    roll = {}
    for f in _lane_forms(dev, piso, rbc):
        name, cg = f["name"], f["algo"] == "cg"
        xk, ik, rk = f["launch"](L, CHUNK_FORCED)
        xp, ip, rp = f["plain"](L, CHUNK_FORCED)
        torch.cuda.synchronize()
        zero = (f["b"].reshape(L, -1) == 0).all(dim=1)
        ck, cp = (rk <= f["tol2"]) | zero, (rp <= f["tol2"]) | zero
        it_bar = (10 if f["coarse_K"] else 3) if cg else 2
        rel_bar = 1e-3 if cg else 1e-4
        err = float((xk - xp).abs().max())
        scale = float(xp.abs().max())
        dit = int((ik - ip).abs().max())
        log(f"  {name} x{L} in chunks of {CHUNK_FORCED}: iterations per chunk "
            f"{ik[::CHUNK_FORCED].tolist()} (plain {ip[::CHUNK_FORCED].tolist()}), "
            f"converged {int(ck.sum())}/{L} (plain {int(cp.sum())}), max|dx| "
            f"{err:.3e} ({err / max(scale, 1e-30):.2e} of max|x|, bar {rel_bar:g})")
        check(torch.equal(ck, cp), f"{name} x{L}: converged flags differ")
        check(dit <= it_bar, f"{name} x{L}: iterations differ by {dit} > {it_bar}")
        check(err <= rel_bar * max(scale, 1e-30), f"{name} x{L}: solutions differ")
        check(bool(torch.isfinite(xk).all()), f"{name} x{L}: non-finite")
        check(bool((xk[2] == 0).all()), f"{name} x{L}: the zero lane is not 0")
        if cg:
            check(int(ik.max()) > 100, f"{name} x{L}: no lane passed iteration 100")
        x_def = f["launch"](L)[0]
        cl0 = cg_cuda_mb.fused_cg_mb.cluster_launches
        check(torch.equal(f["vmapped"](), x_def),
              f"{name}: the vmapped wrapper differs from its launch")
        # a batch the card cannot hold as clusters keeps the chunk grid
        check(cg_cuda_mb.fused_cg_mb.cluster_launches == cl0,
              f"{name} x{L}: the batch took the cluster arm")
        bt = f["b_time"]
        ms = {Ln: cuda_ms(torch, lambda Ln=Ln: f["launch"](Ln, rhs=bt), 5)
              for Ln in (1, 64, L)}
        arms = {}
        if name in ("K1", "K2"):
            roll[name] = f
            for Ln in (1, 64, L):
                ls = {arm: f["roll_launcher"](Ln, arm, bt) for arm in (False, True)}
                t = {False: 0.0, True: 0.0}
                for arm in (False, True, True, False):
                    t[arm] += cuda_ms(torch, ls[arm], 5) / 2
                arms[Ln] = dict(resident=t[True], chunk_grid=t[False])
            log(f"  {name}: ms per raw launch (one lane per block, in turns), "
                "resident / chunk grid: " + ", ".join(
                    f"{Ln} lanes {a['resident']:.3f} / {a['chunk_grid']:.3f}"
                    for Ln, a in arms.items())
                + f"; 64 lanes cost {arms[64]['resident'] / arms[1]['resident']:.2f}"
                f"x one lane resident, {arms[64]['chunk_grid'] / arms[1]['chunk_grid']:.2f}"
                "x on the chunk grid")
        plain_ms = cuda_ms(torch, lambda: f["plain"](64, 64, rhs=bt), 1)
        it64 = f["launch"](64, rhs=bt)[1].float()
        bnd, by, _ = bound_ms(f["n"], 64, 2, float(it64.mean()), f["algo"],
                              False, False, f["seam"], f["coarse_K"])
        log(f"  {name}: ms per solve at default chunk {cg_cuda.default_chunk(L, dev)} "
            f"(130 lanes) / {cg_cuda.default_chunk(64, dev)} (64): 1 lane "
            f"{ms[1]:.3f}, 64 lanes {ms[64]:.3f}, 130 lanes {ms[L]:.3f} "
            f"(64 lanes: plain in one lockstep loop {plain_ms:.1f} ms, bound "
            f"{bnd * 1e3:.1f} us by {by} at {float(it64.mean()):.1f} mean "
            f"iterations per lane, max {int(it64.max())})")
        chunk_numbers = dict(ms_1_lane=ms[1], ms_64_lanes=ms[64],
                             ms_130_lanes=ms[L], plain_64_lanes_ms=plain_ms,
                             bound_64_lanes_ms=bnd, max_abs_err_130_lanes=err)
        if name in ("K3-flip", "K3-coarse"):
            # not on a batched path yet: the numbers join the form's entry
            kernels[name].update(chunk_numbers)
            continue
        by_arm = {} if not arms else dict(
            raw_ms_1_lane=arms[1]["resident"], raw_ms_64_lanes=arms[64]["resident"],
            raw_ms_130_lanes=arms[L]["resident"],
            raw_ms_global_1_lane=arms[1]["chunk_grid"],
            raw_ms_global_64_lanes=arms[64]["chunk_grid"],
            raw_ms_global_130_lanes=arms[L]["chunk_grid"],
            arm="resident" if cg_cuda.default_resident(64, f["n"], 2, 1, dev)
            else "global")
        kernels[f"{name} lanes"] = dict(
            name=f"{name} lane folding and chunking (LaneFold vmap rule, "
                 "chunk grid of lockstep blocks)",
            route="cuda", source="fluidgym_tpu_torch/csrc/"
            + ("cg.cu" if cg else "bicgstab_mb.cu"),
            replaces=("fluidgym_tpu/ops/cg_pallas.py:232" if name == "K1"
                      else "fluidgym_tpu/ops/cg_pallas_mb.py:602"),
            launches=0, max_abs_err=err, ms=ms[64], plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by, library_ms=None, ms_1_lane=ms[1],
            ms_130_lanes=ms[L], lanes=64, mean_iterations=float(it64.mean()),
            **by_arm)
    log(f"phase 19 chunk grid ok: 6 forms x {L} lanes in "
        f"{time.perf_counter() - t0:.1f}s")
    return roll


#: the batched main paths: phase 20 (RBC) and 21 (the cylinder)
BATCH_CASES = (
    # RBC from a randomized reset (noise, then 1-2 time units of burn-in):
    # its float32 step is decided by rounding at ~1e-4..3e-4 in the obs
    # (117 pressure iterations per solve, past the refresh), as the single
    # env's own card-vs-host difference from the same state shows in the
    # same run; the batch's reductions round differently from the single
    # env's, so lanes are held to 1e-3 in the obs.  The reward nu_ref - Nu
    # is a difference of near-equal numbers: its error is held against Nu.
    dict(env_id="RBC2D-easy-v0", phase=20, steps=3, metric="nusselt",
         obs_bar=1e-3, reward_bar=1e-4,
         per_round={"K1": ("fused_cg", "launches", 2),
                    "K2": ("fused_bicgstab_mb", "launches", 2)},
         # every launch on the resident arm (one lane per block)
         resident=("K1", "K2")),
    dict(env_id="CylinderJet2D-easy-v0", phase=21, steps=2, metric="drag",
         obs_bar=1e-4, reward_bar=1e-4,
         per_round={"K3": ("fused_cg_mb", "launches", 2),
                    "K2-mb": ("fused_bicgstab_mb", "merged_launches", 1)}),
)
BATCH = 64


def _batched_phase(dev, kernels, piso, linsolve, case) -> dict:
    """Phases 20-21: ``BatchedFluidEnv(env_id, 64)`` at its registered full
    width, ``reset(seed=0)``, a few steps with seeded numpy actions.  The
    counters are zeroed just before and read just after; in every step each
    kernel of the path launches exactly its count per lockstep round (a
    vmapped substep), whatever B is; no other kernel form, no plain
    version, no ``linsolve`` loop and no vmap per-lane fallback (an error
    inside ``piso.strict_vmap``).  Lanes 0 and 63 against single envs
    reset from the same seeds and stepped with the same actions: obs and
    reward to 1e-4."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.parallel import BatchedFluidEnv

    env_id, ph = case["env_id"], case["phase"]
    mods = {"fused_cg": cg_cuda.fused_cg, "fused_cg_mb": cg_cuda_mb.fused_cg_mb,
            "fused_bicgstab_mb": cg_cuda_mb.fused_bicgstab_mb}
    watched = {k: (mods[w], a) for k, (w, a, _) in case["per_round"].items()}
    launches, plains = _counters()
    calls, restore = count_calls(piso, linsolve)

    def counts():
        out = {k: getattr(*v) for k, v in watched.items()}
        out["other"] = sum(getattr(*c) for c in launches) - sum(out.values())
        out["plain"] = sum(getattr(*c) for c in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["rounds"] = calls["piso_substep_info"]
        for k in case.get("resident", ()):
            out[f"{k} resident"] = watched[k][0].resident_launches
        return out

    for c in launches + plains:
        setattr(*c, 0)
    for k in case.get("resident", ()):
        watched[k][0].resident_launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        benv = BatchedFluidEnv(env_id, BATCH)
        obs, _ = benv.reset(seed=0)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        rng = np.random.default_rng(case["phase"])
        acts = [rng.uniform(-1, 1, (BATCH,) + tuple(benv.action_space.shape))
                .astype(np.float32) for _ in range(case["steps"])]
        step_s, per_step, outs, p_its, unconverged = [], [], [], [], []
        for a in acts:
            c0 = counts()
            t = time.perf_counter()
            obs, rew, term, trunc, info = benv.step(a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            d = {k: v - c0[k] for k, v in counts().items()}
            per_step.append(d)
            expect = {k: n * d["rounds"] for k, (_, _, n) in case["per_round"].items()}
            check(d["rounds"] > 0 and all(d[k] == v for k, v in expect.items())
                  and d["other"] == 0 and d["plain"] == 0 and d["linsolve"] == 0,
                  f"{env_id} x{BATCH} step launches {d}, expected {expect} and "
                  "no other kernel form, plain version or linsolve loop")
            check(all(d[f"{k} resident"] == d[k] for k in case.get("resident", ())),
                  f"{env_id} x{BATCH}: not every launch took the resident arm: {d}")
            for k, v in obs.items():
                check(tuple(v.shape) == (BATCH,) + benv.observation_space[k].shape,
                      f"obs {k} shape {tuple(v.shape)}")
                check(bool(torch.isfinite(v).all()), f"obs {k} not finite")
            check(tuple(rew.shape) == (BATCH,) and bool(torch.isfinite(rew).all()),
                  "rewards not finite")
            check(not bool(term.any()), f"{env_id}: a lane diverged")
            unconverged.append(int((~info["pressure_converged"]).sum()))
            outs.append((obs, rew, info[case["metric"]]))
            p_its.append(info["pressure_iterations"].tolist())
    finally:
        restore()
    total = counts()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    def diffs(o, r, m, ob, rb, mb, out):
        """Per-key worst relative obs diffs; the reward's against its
        metric's scale (the quantity it is made of)."""
        for k in o:
            out[k] = max(out.get(k, 0.0), rel(ob[k].to(o[k].device), o[k]))
        scale = max(float(r.abs().max()), float(m.abs().max()))
        out["reward"] = max(out.get("reward", 0.0),
                            float((rb.to(r.device) - r).abs().max()) / scale)

    # lanes 0 and 63 against single envs from the same seeds, and (the
    # scale of this state's rounding) lane 0's single env on the card
    # against the host from the same state
    t = time.perf_counter()
    worst, host, single_s, its = {}, {}, [], []
    for l in (0, BATCH - 1):
        env = fluidgym_tpu_torch.make(env_id)
        env.reset(seed=l)
        if l == 0:
            twin = fluidgym_tpu_torch.make(env_id, device="cpu")
            twin.reset(seed=0, randomize=False)
            twin.set_state(env.get_state())
        for i, a in enumerate(acts):
            ts = time.perf_counter()
            o, r, _, _, inf = env.step(a[l])
            torch.cuda.synchronize()
            single_s.append(time.perf_counter() - ts)
            ob, rb, mb = outs[i]
            diffs(o, r.reshape(()), inf[case["metric"]],
                  {k: v[l] for k, v in ob.items()}, rb[l], mb[l], worst)
            its.append((int(inf["pressure_iterations"]), p_its[i][l]))
            if l == 0:
                oh, rh, _, _, ih = twin.step(a[0])
                diffs(oh, rh.reshape(()), ih[case["metric"]], o,
                      r.reshape(()), inf[case["metric"]], host)
    bars = {k: case["reward_bar" if k == "reward" else "obs_bar"] for k in worst}
    check(all(worst[k] <= bars[k] for k in worst),
          f"{env_id}: batched lanes and single envs differ by {worst} "
          f"(bars {bars})")
    rounds = [d["rounds"] for d in per_step]
    ms_step = 1e3 * sum(step_s) / len(step_s)
    single_ms = 1e3 * sum(single_s) / len(single_s)
    log(f"phase {ph} batched main path ok: BatchedFluidEnv({env_id!r}, {BATCH}) "
        f"blocks {[b.shape for b in benv.env._topo.blocks]}, reset {reset_s:.1f}s, "
        f"steps {[round(x, 3) for x in step_s]} s ({ms_step:.1f} ms/step), "
        f"lockstep rounds per step {rounds}, per-step launches {per_step}, "
        f"per round { {k: n for k, (_, _, n) in case['per_round'].items()} }, "
        f"totals "
        f"{total}; lanes with an unconverged pressure solve per step "
        f"{unconverged}; lanes 0 and {BATCH - 1} vs single envs from the same "
        f"seeds: worst relative diffs {worst} (bars {bars}), pressure "
        f"iterations (single, batched lane) {its}; lane 0's single env, card "
        f"vs host from the same state: {host}; single env {single_ms:.1f} "
        f"ms/step in {time.perf_counter() - t:.1f}s")
    for k in case["per_round"]:
        entry = kernels[f"{k} lanes"]
        entry["launches"] = total[k]
        entry["launches_per_env_step"] = (sum(d[k] for d in per_step)
                                          / len(per_step) / BATCH)
        entry["launches_per_round"] = case["per_round"][k][2]
        entry["batched_env"] = env_id
        if k in case.get("resident", ()):
            entry["resident_launches"] = total[f"{k} resident"]
    return dict(env_id=env_id, ms_step=ms_step, single_ms=single_ms,
                rounds=rounds, pressure_iterations=p_its)


def _throughput_phase(kernels, results) -> None:
    """Phase 22: batched env-steps/s beside B x the single env's ms per step
    (the same run, the same card, the same actions)."""
    for r in results:
        batched = BATCH / (r["ms_step"] / 1e3)
        single = 1e3 / r["single_ms"]
        log(f"phase 22 {r['env_id']}: batch {BATCH}: {batched:.1f} env-steps/s "
            f"({r['ms_step']:.1f} ms per batched step); single env "
            f"{single:.2f} env-steps/s ({r['single_ms']:.1f} ms/step, x{BATCH} = "
            f"{BATCH * r['single_ms']:.0f} ms); ratio {batched / single:.1f}")
        kernels.setdefault("batched", {})[r["env_id"]] = dict(
            env_steps_per_s=batched, ms_per_batched_step=r["ms_step"],
            single_env_ms_per_step=r["single_ms"], rounds_per_step=r["rounds"])


# ---------------------------------------------------------------------------
# phase 23: the cluster arm of K3 and K2-mb
# ---------------------------------------------------------------------------

def _cluster_phase(dev, kernels, piso, case) -> None:
    """Phase 23, for one merged case: K3 (warm from the deflated guess, as
    the main path solves it) and K2-mb (the 2-lane velocity system) at the
    main-path shapes, for C = 1 and every cluster size whose clusters the
    card holds for the lanes, in turns.  Each C against the plain version
    (the same converged flags, iterations within 3, x within the phase's
    bar), run twice bit for bit; C = 1 through the wrapper bit-equal to the
    chunk grid's raw launch; every C bit-equal to C = 1 (x, iterations,
    residual).  ms per wrapper call and per raw launch on preallocated
    buffers, us per iteration, the rule's C and the card's occupancy per C;
    the rule's C no slower per raw launch than C = 1."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge
    from fluidgym_tpu_torch.solver import stencil as st

    t0 = time.perf_counter()
    sy = _snapshot_system(dev, piso, case)
    plan, n = sy["plan"], sy["n"]
    nd = plan.ndims
    nf = 2 * nd
    flat = lambda xs: cg_cuda_mb.flatten_fields(plan, xs)
    per_sb = lambda t: cg_cuda_mb.unflatten_fields(plan, t)

    def ops_of(ops):
        m = block_merge.pack_ops(plan, ops)
        return cg_cuda_mb.flatten_ops(plan, tuple(a[0] for a in m),
                                      tuple(a[1] for a in m))

    pd, po = ops_of(sy["p_ops"])
    ad, ao = ops_of(sy["adv"])
    pb = flat(tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, sy["rhs"])))
    px = flat(tuple(p.unsqueeze(0) for p in block_merge.pack_fields(plan, sy["guess"])))
    state = sy["state"]
    vel_rhs = st.advection_rhs_velocity(state, sy["geoms"], sy["topo"],
                                        state.viscosity, sy["dt"])

    def pack2(fields):
        per_c = [flat(tuple(p.unsqueeze(0) for p in block_merge.pack_fields(
            plan, tuple(f[c] for f in fields)))) for c in range(2)]
        return torch.cat(per_c)

    vb = pack2(vel_rhs)
    vx = pack2(tuple(b.velocity for b in state.blocks))
    forms = ((case["k3"], "cg", pd, po, pb, px, case["tol_p"], 1e-3),
             (case["k2"], "bicgstab", ad, ao, vb, vx, 1e-5, 1e-4))
    for name, algo, diag, off, b, x0, tol, rel_bar in forms:
        cg = algo == "cg"
        L = b.shape[0]
        tol2 = cg_cuda.tol2_sum_f32(tol, n)
        kw = dict(tol2_sum=tol2, maxiter=5000, stall_iters=250,
                  precondition=True, return_best=cg)
        occ = {C: cg_cuda_mb.max_active_clusters(algo, nd, C, n, dev)
               for C in cg_cuda_mb.CLUSTER_SIZES if cg_cuda_mb.rows_fit(n, C, nd)}
        rule = cg_cuda_mb.default_cluster(L, n, nd, 1, dev, algo)
        sizes = [1] + [C for C in sorted(occ) if occ[C] >= L]
        if cg:
            xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(plan, diag, off, b, x0, **kw)
        else:
            xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(diag, off, b, x0,
                                                         ndims=nd, plan=plan, **kw)
        flags_p = (rp <= tol2).cpu()
        scale = float(xp.abs().max())
        wdiags = per_sb(diag)
        woffs = tuple(t.reshape((nf,) + tuple(t.shape[1:]))
                      for t in per_sb(off.reshape(nf, n)))
        wdiags = tuple(t[0] for t in wdiags)

        def wrapper(C):
            fn = cg_cuda_mb.fused_cg_mb if cg else cg_cuda_mb.fused_bicgstab_mb
            xs, _ = fn(plan, wdiags, woffs, per_sb(b), per_sb(x0), tol=tol,
                       maxiter=5000, stall_iters=250, precondition=True,
                       return_best=cg, cluster=C)
            return xs

        rows = {}
        for C in sizes:
            launch = cg_cuda_mb.merged_launcher(algo, plan, diag, off, b, x0,
                                                chunk=1, cluster=C, **kw)
            x1, i1, r1 = (t.clone() for t in launch())
            x2, i2, r2 = (t.clone() for t in launch())
            torch.cuda.synchronize()
            same = torch.equal(x1, x2) and torch.equal(i1, i2) and torch.equal(r1, r2)
            check(same, f"{name} C={C}: two runs differ")
            err = float((x1 - xp).abs().max())
            dit = int((i1.long() - ip.long()).abs().max())
            flags = (r1 <= tol2).cpu()
            check(torch.equal(flags, flags_p),
                  f"{name} C={C}: converged {flags.tolist()} vs plain {flags_p.tolist()}")
            check(dit <= 3, f"{name} C={C}: iterations {i1.tolist()} vs plain "
                            f"{ip.tolist()}")
            check(err <= rel_bar * max(scale, 1e-30),
                  f"{name} C={C}: max|dx| {err:.3e} > {rel_bar:g} of {scale:.3e}")
            check(bool(torch.isfinite(x1).all()), f"{name} C={C}: non-finite")
            if C == 1:
                check(torch.equal(flat(wrapper(1)), x1),
                      f"{name}: cluster=1 through the wrapper differs from the "
                      "chunk grid's raw launch")
                ref1 = (x1, i1, r1)
            else:
                check(all(torch.equal(u, v) for u, v in zip((x1, i1, r1), ref1)),
                      f"{name} C={C}: not bit-equal to C=1")
            its = int(i1.max())
            raw_ms = cuda_ms(torch, launch, 10)
            ms = cuda_ms(torch, lambda C=C: wrapper(C), 10)
            rows[C] = dict(iterations=its, raw_ms=raw_ms, ms=ms,
                           us_per_it=raw_ms * 1e3 / max(its, 1),
                           max_abs_err=err)
            log(f"  {name} ({L}, {n}) C={C}: {ms:.3f} ms/call, raw launch "
                f"{raw_ms:.3f} ms = {rows[C]['us_per_it']:.2f} us/iteration at "
                f"{its} iterations (plain {int(ip.max())}), max|dx| {err:.3e} "
                f"({err / max(scale, 1e-30):.2e} of max|x|), two runs "
                f"bit-equal{'' if C == 1 else ', bit-equal to C=1'}")
        log(f"phase 23 {name}: rule picks C={rule} (occupancy per C "
            f"{occ}, sizes run {sizes}); at C={rule} {rows[rule]['raw_ms']:.3f} "
            f"ms per raw launch against {rows[1]['raw_ms']:.3f} at C=1 "
            f"({rows[1]['raw_ms'] / rows[rule]['raw_ms']:.2f}x)")
        check(rows[rule]["raw_ms"] <= rows[1]["raw_ms"],
              f"{name}: the rule's C={rule} is slower per raw launch than C=1")
        kernels[name].update(
            cluster=rule, us_per_it=rows[rule]["us_per_it"],
            raw_ms=rows[rule]["raw_ms"], raw_ms_cluster_1=rows[1]["raw_ms"],
            ms_cluster_1=rows[1]["ms"], us_per_it_cluster_1=rows[1]["us_per_it"],
            occupancy={str(C): v for C, v in occ.items()},
            by_cluster={str(C): r for C, r in rows.items()})
    log(f"phase 23 {case['env_id']} done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 24: the resident arm of K1 and K2
# ---------------------------------------------------------------------------

def _resident_phase(kernels, systems) -> None:
    """Phase 24: the resident arm of K1 and K2 (one lane per block, its rows
    and four vectors in shared memory) against the chunk grid.  On every
    system (``(name, launcher(arm))``: the main path's solves of phases 3
    and 4, and phase 19's 64 and 130 lanes) the arm returns the chunk
    grid's x, iterations and residual bit for bit, twice.  Per raw launch
    (phases 3, 4 and 19, in turns on this card) it is no slower than the
    chunk grid at 1 and 64 lanes."""
    import torch

    t0 = time.perf_counter()
    for name, launcher in systems:
        runs = [tuple(t.clone() for t in launcher(arm)())
                for arm in (False, True, True)]
        torch.cuda.synchronize()
        same = lambda u, v: all(torch.equal(a, c) for a, c in zip(u, v))
        check(same(runs[1], runs[2]), f"{name}: two runs of the resident arm differ")
        check(same(runs[1], runs[0]),
              f"{name}: the resident arm differs from the chunk grid")
        log(f"  {name}: resident arm bit-equal to the chunk grid, iterations "
            f"{sorted(set(runs[1][1].tolist()))}")
    k1, k2, l1, l2 = (kernels[k] for k in ("K1", "K2", "K1 lanes", "K2 lanes"))
    pairs = {
        "K1 pressure, 1 lane (phase 3)": (k1["raw_ms"], k1["raw_ms_global"]),
        "K2 velocity, 2 lanes (phase 4)": (k2["raw_ms"], k2["raw_ms_global"]),
        "K2 temperature, 1 lane (phase 4)": (k2["scalar_in_turns"]["raw_ms"],
                                             k2["scalar_in_turns"]["raw_ms_global"]),
        "K1, 1 lane (phase 19)": (l1["raw_ms_1_lane"], l1["raw_ms_global_1_lane"]),
        "K1, 64 lanes (phase 19)": (l1["raw_ms_64_lanes"],
                                    l1["raw_ms_global_64_lanes"]),
        "K2, 1 lane (phase 19)": (l2["raw_ms_1_lane"], l2["raw_ms_global_1_lane"]),
        "K2, 64 lanes (phase 19)": (l2["raw_ms_64_lanes"],
                                    l2["raw_ms_global_64_lanes"])}
    for what, (res, grid) in pairs.items():
        log(f"  {what}: resident {res:.4f} ms per raw launch, chunk grid "
            f"{grid:.4f} ({grid / res:.2f}x)")
        check(res <= grid, f"{what}: the resident arm is slower per raw launch "
                           f"than the chunk grid ({res:.4f} > {grid:.4f} ms)")
    for e in (k1, k2, l1, l2):
        e["resident_bit_equal"] = True
    log(f"phase 24 resident arm ok: {len(systems)} systems bit-equal to the "
        f"chunk grid, no slower per raw launch at 1 and 64 lanes, in "
        f"{time.perf_counter() - t0:.1f}s")



# ---------------------------------------------------------------------------
# phases 25-30: RBC3D (K1-3D, K2-3D on the spread arm) and the other RBC2D ids
# ---------------------------------------------------------------------------

#: RBC3D's two widths: (64, 41, 64) and (128, 41, 128) cells, (Z, Y, X)
RBC3D_IDS = ("RBC3D-easy-v0", "RBC3D-wide-easy-v0")
#: the RBC2D ids beside RBC2D-easy-v0: (61, 96) blocks (the resident arm)
#: and (61, 192) blocks (the chunk grid)
RBC2D_IDS = ("RBC2D-medium-v0", "RBC2D-hard-v0", "RBC2D-wide-easy-v0",
             "RBC2D-wide-medium-v0", "RBC2D-wide-hard-v0")
#: the RBC3D ids whose bundled datasets this run does not read (the copy of
#: the repository it runs in may leave them out: they are 9-72 MB each)
RBC3D_OTHER_IDS = ("RBC3D-medium-v0", "RBC3D-hard-v0", "RBC3D-wide-medium-v0",
                   "RBC3D-wide-hard-v0")


def _capture_solves(dev, env_id, step_length, wrappers) -> dict:
    """The solves of one sim step of ``env_id`` at full width from its
    bundled ``train_00`` snapshot (no randomization, zero action), captured
    at the wrappers as the solver hands them over: ``wrappers`` maps a name
    to ``(module, attribute)``; returns every call of each as ``(args,
    kwargs)`` with the tensors cloned, in order."""
    import numpy as np

    import fluidgym_tpu_torch

    env = fluidgym_tpu_torch.make(env_id, device=dev, randomize_initial_state=False,
                                  step_length=step_length, episode_length=2)
    env.reset(seed=0)
    seen = {k: [] for k in wrappers}
    keep = lambda v: (tuple(keep(t) for t in v) if isinstance(v, tuple)
                      else v.clone() if hasattr(v, "clone") else v)
    fns = {k: getattr(mod, attr) for k, (mod, attr) in wrappers.items()}
    for k, (mod, attr) in wrappers.items():
        def capture(*a, _fn=fns[k], _k=k, **kw):
            seen[_k].append((keep(a), {n: keep(v) for n, v in kw.items()}))
            return _fn(*a, **kw)

        # the wrapper counts its launches on the object its module's name
        # holds: share the counters with it
        capture.__dict__ = fns[k].__dict__
        setattr(mod, attr, capture)
    a_shape = ((env.n_agents, 1) if env.use_marl
               else tuple(env.action_space.shape))
    try:
        env.step(np.zeros(a_shape, np.float32))
    finally:
        for k, (mod, attr) in wrappers.items():
            setattr(mod, attr, fns[k])
    return seen


def _captured_systems(dev, env_id) -> dict:
    """The solves of the first substep of one sim step of ``env_id``
    (``_capture_solves``): ``"K1"`` the first pressure solve, ``"K2"`` the
    temperature and the velocity solves."""
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    seen = _capture_solves(dev, env_id, 0.05, {
        "K1": (cg_cuda, "fused_cg"),
        "K2": (cg_cuda_mb, "fused_bicgstab_mb")})
    return {"K1": seen["K1"][0], "K2": seen["K2"][:2]}


def spread_arms(torch, cg_cuda, launcher, lanes: int, n: int, ndims: int,
                algo: str, reps: int = 3, extra=None, merged: bool = False,
                runs: int = 1) -> dict:
    """The chunk grid and the spread arm of one system, in turns:
    ``launcher(G, chains)`` gives a raw launch on preallocated buffers (G =
    0: the chunk grid).  The spread arm runs at every G in
    ``cg_cuda.SPREAD_SIZES`` whose grid the card holds for ``lanes`` lanes,
    in both layouts (``chains``: each block the cells of its sum chains;
    else a contiguous range, 3D only); each must return the chunk grid's x,
    iterations and residual bit for bit, ``runs`` times back to back.  Then
    ms per raw launch of every arm, in turns (forward, then backward).
    ``merged``: a 3D merged lane (K3 / K2-mb: the merged instances'
    co-residency and layout rule).  Returns the rule's G and layout, the
    iterations, ms and us per iteration per arm.  ``extra``: more raw
    launches by name (another revision's chunk grid), held and timed
    alike."""
    dev = torch.device("cuda")
    kind = algo + "_mb" if merged else algo
    arms = {"grid": launcher(0, None), **(extra or {})}
    for G in cg_cuda.SPREAD_SIZES:
        if lanes * G > cg_cuda.spread_capacity(kind, ndims, G, True, n, dev):
            continue
        for chains in (True, False) if ndims == 3 else (True,):
            arms[f"G={G} {'chains' if chains else 'range'}"] = launcher(G, chains)
    ref = tuple(t.clone() for t in arms["grid"]())
    torch.cuda.synchronize()
    for name, launch in arms.items():
        for i in range(runs):
            out = launch()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                  f"{name} (run {i}) differs from the chunk grid: max|dx| "
                  f"{float((out[0] - ref[0]).abs().max()):.3e}, iterations "
                  f"{out[1].tolist()} / {ref[1].tolist()}, residual "
                  f"{out[2].tolist()} / {ref[2].tolist()}")
    ms = {k: 0.0 for k in arms}
    for k in list(arms) + list(reversed(list(arms))):
        ms[k] += cuda_ms(torch, arms[k], reps) / 2
    its = int(ref[1].max())
    G = cg_cuda.default_spread(lanes, n, ndims, 1, dev, kind)
    layout = "chains" if cg_cuda.spread_chains(n, G, ndims, merged) else "range"
    rule = f"G={G} {layout}" if G else "grid"
    return dict(iterations=its, rule=rule, raw_ms=ms,
                us_per_it={k: v * 1e3 / max(its, 1) for k, v in ms.items()})


def _k3d_phase(dev, kernels, compare) -> None:
    """Phase 25: K1-3D and K2-3D against their plain versions on the solves
    of a first substep of RBC3D-easy and RBC3D-wide-easy at full width from
    their bundled snapshots (``_captured_systems``), with phases 3 and 4's
    bars: K1 on the pressure system (1 lane) and with a second, random
    right-hand side beside it (2 lanes); K2 on the temperature (1 lane) and
    velocity (3 lanes) systems as the solver starts them.  On each, the
    spread arm at every G the card holds, in both layouts, bit-equal to the
    chunk grid and timed against it in turns (``spread_arms``).  ms per
    wrapper call (the rule's arm: the spread arm), per raw launch of each
    arm, us per iteration, the plain version's ms and the bound."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    rows = {"K1-3D": {}, "K2-3D": {}}
    errs = {"K1-3D": 0.0, "K2-3D": 0.0}

    def timed(name, key, call, plain, launcher, n, lanes, its, algo, warm):
        arms = spread_arms(torch, cg_cuda, launcher, lanes, n, 3, algo)
        b_ms, by, stream = bound_ms(n, lanes, 3, its, algo, warm, True)
        raw, grid = arms["raw_ms"][arms["rule"]], arms["raw_ms"]["grid"]
        row = dict(iterations=its, ms=cuda_ms(torch, call, 3), raw_ms=raw,
                   us_per_it=raw * 1e3 / max(its, 1), raw_ms_grid=grid,
                   us_per_it_grid=grid * 1e3 / max(its, 1),
                   plain_ms=cuda_ms(torch, plain, 1), bound_ms=b_ms,
                   bound_by=by, stream_ms=stream, arms=arms)
        rows[name][key] = row
        log(f"  {name} {key}: {row['ms']:.3f} ms per wrapper call; raw launch "
            f"{arms['rule']} {raw:.3f} ms = {row['us_per_it']:.2f} us/iteration"
            f", chunk grid {grid:.3f} ms = {row['us_per_it_grid']:.2f} "
            f"({grid / raw:.2f}x) at {its} iterations; every arm bit-equal, "
            f"raw ms {json.dumps({k: round(v, 4) for k, v in arms['raw_ms'].items()})}"
            f" (plain {row['plain_ms']:.3f} ms; bound {b_ms * 1e3:.3f} us by "
            f"{by}, streaming {stream * 1e3:.3f} us)")

    for env_id in RBC3D_IDS:
        sy = _captured_systems(dev, env_id)
        (diag, off, p_rhs, x0), kw1 = sy["K1"]
        tol = kw1.pop("tol")
        shape = tuple(p_rhs.shape[1:])
        n = math.prod(shape)
        tol2 = cg_cuda.tol2_sum_f32(tol, n)
        check(kw1["ndims"] == 3 and x0 is None, f"{env_id}: the pressure solve "
              f"is not a cold 3D solve ({kw1})")
        mv_p = lambda v: cg_cuda.roll_matvec(diag[None], off[None], v, 3)
        g = torch.Generator().manual_seed(25)
        other = torch.randn(shape, generator=g).to(dev) * p_rhs.abs().max()
        for b in (p_rhs, torch.stack([p_rhs[0], other - other.mean()])):
            L = b.shape[0]

            def call(b=b):
                x, inf = cg_cuda.fused_cg(diag, off, b, tol=tol, **kw1)
                return x, inf.iterations, inf.residual ** 2 * n

            def plain(b=b):
                return cg_cuda.fused_cg_plain(diag[None], off[None], b, None,
                                              tol2_sum=tol2, chunk=1, **kw1)

            key = f"{shape} {L} lane(s)"
            e, it = compare(f"K1-3D {key}", call, plain, b, tol, 1e-3, 3, mv_p)
            errs["K1-3D"] = max(errs["K1-3D"], e)
            timed("K1-3D", key, call, plain,
                  lambda G, chains, b=b: cg_cuda.launcher(
                      diag[None], off[None], b, None, chunk=1, spread=G,
                      chains=chains, tol2_sum=tol2, **kw1), n, L, it, "cg",
                  False)
        for what, ((plan, diags, offs, bs), kw2) in zip(
                ("temperature", "velocity"), sy["K2"]):
            tol, x0s = kw2.pop("tol"), kw2.pop("x0s", None)
            d, o, b = diags[0], offs[0], bs[0]
            x0 = None if x0s is None else x0s[0]
            mv_a = lambda v, d=d, o=o: cg_cuda.roll_matvec(d[None], o[None], v, 3)

            def call(b=b, x0=x0, d=d, o=o, kw2=kw2, tol=tol):
                xs, inf = cg_cuda_mb.fused_bicgstab_mb(
                    plan, (d,), (o,), (b,), None if x0 is None else (x0,),
                    tol=tol, **kw2)
                return xs[0], inf.iterations.repeat(b.shape[0]), None

            def plain(b=b, x0=x0, d=d, o=o, kw2=kw2, tol=tol):
                return cg_cuda_mb.fused_bicgstab_plain(
                    d[None], o[None], b, x0, ndims=3,
                    tol2_sum=cg_cuda.tol2_sum_f32(tol, n), **kw2)

            key = f"{shape} {what} {b.shape[0]} lane(s)"
            e, it = compare(f"K2-3D {key}", call, plain, b, tol, 1e-4, 2, mv_a)
            errs["K2-3D"] = max(errs["K2-3D"], e)
            timed("K2-3D", key, call, plain,
                  lambda G, chains, b=b, x0=x0, d=d, o=o, kw2=kw2, tol=tol:
                  cg_cuda_mb.launcher(
                      d[None], o[None], b, x0, ndims=3, chunk=1, spread=G,
                      chains=chains, tol2_sum=cg_cuda.tol2_sum_f32(tol, n),
                      **kw2), n, b.shape[0], it, "bicgstab", x0 is not None)
    for name, main, what in (
            ("K1-3D", "(64, 41, 64) 1 lane(s)", "Jacobi-PCG, 7-point roll stencil"),
            ("K2-3D", "(64, 41, 64) velocity 3 lane(s)",
             "right-Jacobi BiCGStab, trivial plan")):
        r = rows[name][main]
        common = dict(
            route="cuda",
            source=("fluidgym_tpu_torch/csrc/cg.cu" if name == "K1-3D"
                    else "fluidgym_tpu_torch/csrc/bicgstab_mb.cu"),
            replaces=("fluidgym_tpu/ops/cg_pallas.py:143" if name == "K1-3D"
                      else "fluidgym_tpu/ops/cg_pallas_mb.py:458"),
            max_abs_err=errs[name], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            iterations=r["iterations"], shape=main)
        # one entry per TPU kernel, of the arm the main path runs (the
        # spread arm); the chunk grid's raw launch, timed beside it in
        # turns, only as raw_ms_grid / us_per_it_grid
        kernels[name] = dict(
            common, name=f"{name} ({what}, the spread arm, "
                         f"{r['arms']['rule']})",
            source=common["source"] + " + fluidgym_tpu_torch/csrc/krylov.cuh",
            ms=r["ms"], raw_ms=r["raw_ms"], us_per_it=r["us_per_it"],
            arm=f"spread {r['arms']['rule']}",
            raw_ms_grid=r["raw_ms_grid"], us_per_it_grid=r["us_per_it_grid"],
            speedup_over_grid=r["raw_ms_grid"] / r["raw_ms"],
            wide={k: {x: v[x] for x in ("raw_ms", "raw_ms_grid", "us_per_it",
                                        "us_per_it_grid", "ms", "plain_ms",
                                        "bound_ms")}
                  for k, v in rows[name].items() if "(128" in k},
            systems=rows[name])
    for name in ("K1-3D", "K2-3D"):
        wide = [v for k, v in rows[name].items()
                if "(128" in k and (name == "K1-3D" or "velocity" in k)][0]
        check(wide["raw_ms"] < wide["raw_ms_grid"],
              f"{name} at (128, 41, 128): the spread arm ({wide['raw_ms']:.3f} "
              f"ms per raw launch) is not faster than the chunk grid "
              f"({wide['raw_ms_grid']:.3f} ms)")
    log(f"phase 25 K1-3D and K2-3D ok on {len(rows['K1-3D'])} + "
        f"{len(rows['K2-3D'])} systems: the spread arm bit-equal to the "
        f"chunk grid at every G and layout, faster at (128, 41, 128), in "
        f"{time.perf_counter() - t0:.1f}s")


def _rbc_main_path(dev, piso, linsolve, env_id, steps, ph, **make_kw) -> dict:
    """``make(env_id, **make_kw)`` on the card at the registered full width,
    ``reset(seed=0)`` (randomized: noise and a 1-2 time-unit burn-in), then
    ``steps`` steps with seeded numpy actions.  Every counter is zeroed just
    before ``make`` and read after each step: in every step K1 launches
    once per pressure corrector per substep and K2 once per advection solve
    (temperature, velocity), in 3D every one of them a 3D launch; the
    resident arm takes them exactly where ``default_resident`` admits the
    block (never in 3D), the spread arm exactly where ``default_spread``
    gives G (every RBC3D solve); no other kernel form, plain version or
    ``linsolve`` loop runs; obs of the space's shapes, obs, reward and
    Nusselt finite."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    k1, k2 = cg_cuda.fused_cg, cg_cuda_mb.fused_bicgstab_mb
    launches, plains = _counters()
    extra = [(k, a) for k in (k1, k2)
             for a in ("launches_3d", "resident_launches", "spread_launches")]
    calls, restore = count_calls(piso, linsolve)

    def counts():
        out = {"K1": k1.launches, "K2": k2.launches, "K1 3d": k1.launches_3d,
               "K2 3d": k2.launches_3d, "K1 resident": k1.resident_launches,
               "K2 resident": k2.resident_launches,
               "K1 spread": k1.spread_launches, "K2 spread": k2.spread_launches}
        out["other"] = sum(getattr(*c) for c in launches) - out["K1"] - out["K2"]
        out["plain"] = sum(getattr(*c) for c in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        return out

    for c in launches + plains + extra:
        setattr(*c, 0)
    torch.cuda.synchronize()
    rows = []
    try:
        t = time.perf_counter()
        env = fluidgym_tpu_torch.make(env_id, **make_kw)
        env.reset(seed=0)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        reset = counts()
        nd, shape = env.ndims, env._topo.blocks[0].shape
        n = math.prod(shape)
        resident = cg_cuda.default_resident(1, n, nd, 1, dev)
        # the arm of each solve: K1 (1 lane), K2's scalars (1 lane) and its
        # velocity (nd lanes)
        spread = {"K1": cg_cuda.roll_arm(1, n, nd, 1, dev)[1],
                  "K2 scalar": cg_cuda.roll_arm(1, n, nd, 1, dev, "bicgstab")[1],
                  "K2 velocity": cg_cuda.roll_arm(nd, n, nd, 1, dev,
                                                  "bicgstab")[1]}
        rng = np.random.default_rng(ph)
        a_shape = ((env.n_agents, 1) if env.use_marl
                   else tuple(env.action_space.shape))
        for i in range(steps):
            a = rng.uniform(-1, 1, a_shape).astype(np.float32)
            c0 = counts()
            t = time.perf_counter()
            obs, reward, _, _, info = env.step(a)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            d = {k: v - c0[k] for k, v in counts().items()}
            sub = d["substeps"]
            expect = {"K1": env._cfg.corrector_steps * sub,
                      "K2": (env._topo.scalar_channels + 1) * sub}
            for k in ("K1", "K2"):
                expect[f"{k} 3d"] = expect[k] if nd == 3 else 0
                expect[f"{k} resident"] = expect[k] if resident else 0
            expect["K1 spread"] = expect["K1"] if spread["K1"] else 0
            expect["K2 spread"] = sub * (
                env._topo.scalar_channels * bool(spread["K2 scalar"])
                + bool(spread["K2 velocity"]))
            expect.update(other=0, plain=0, linsolve=0)
            check(sub > 0 and all(d[k] == v for k, v in expect.items()),
                  f"{env_id} step {i}: launches {d}, expected {expect}")
            for k, v in obs.items():
                want = env.observation_space[k].shape
                if env.use_marl:
                    want = (env.n_agents,) + tuple(want)
                check(tuple(v.shape) == tuple(want), f"{env_id} obs {k} shape "
                      f"{tuple(v.shape)} != {want}")
                check(bool(torch.isfinite(v).all()), f"{env_id} obs {k} not finite")
            nu = float(info["nusselt"])
            check(bool(torch.isfinite(reward).all()) and math.isfinite(nu)
                  and nu > 0, f"{env_id}: reward or Nusselt {nu} not finite")
            rows.append(dict(s=step_s, substeps=sub, K1=d["K1"], K2=d["K2"],
                             pressure_iterations=int(info["pressure_iterations"]),
                             pressure_converged=bool(info["pressure_converged"]),
                             nusselt=nu))
    finally:
        restore()
    total = counts()
    arm = ("resident" if resident else
           f"spread G={spread['K1']}/{spread['K2 scalar']}/"
           f"{spread['K2 velocity']}" if spread["K1"] else "global")
    out = dict(env_id=env_id, shape=tuple(shape), marl=env.use_marl,
               n_agents=env.n_agents, arm=arm,
               reset_s=reset_s, reset_launches={k: reset[k] for k in ("K1", "K2")},
               ms_step=1e3 * sum(r["s"] for r in rows) / len(rows),
               substeps=[r["substeps"] for r in rows],
               pressure_iterations=[r["pressure_iterations"] for r in rows],
               pressure_converged=[r["pressure_converged"] for r in rows],
               nusselt=[round(r["nusselt"], 5) for r in rows],
               launches={k: total[k] for k in (
                   "K1", "K2", "K1 3d", "K2 3d", "K1 resident", "K2 resident",
                   "K1 spread", "K2 spread")},
               step_launches=[{k: r[k] for k in ("K1", "K2")} for r in rows])
    log(f"phase {ph} {env_id} {out['shape']} "
        f"({'MARL, ' + str(env.n_agents) + ' agents' if env.use_marl else 'SARL'}): "
        f"reset {reset_s:.2f}s (launches {out['reset_launches']}), steps "
        f"{[round(r['s'], 3) for r in rows]} s = {out['ms_step']:.1f} ms/env "
        f"step, substeps {out['substeps']}, pressure iterations "
        f"{out['pressure_iterations']} (converged {out['pressure_converged']}), "
        f"Nusselt {out['nusselt']}, per-step launches {out['step_launches']}, "
        f"totals {out['launches']}, arm {out['arm']}; no other form, plain "
        f"version or linsolve loop")
    return out


def _rbc3d_card_vs_host(dev) -> float:
    """Phase 27: one full-width RBC3D-easy-v0 sim step (``step_length`` =
    dt, the bundled ``train_00``, MARL at the registered defaults) on the
    card and on the host: obs and rewards within 1e-4 of each quantity's
    scale (the rollout bar)."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch

    t0 = time.perf_counter()
    kw = dict(randomize_initial_state=False, step_length=0.05, episode_length=2)
    a = np.linspace(-1, 1, 64, dtype=np.float32).reshape(64, 1)
    outs = {}
    for where in (dev, torch.device("cpu")):
        e = fluidgym_tpu_torch.make("RBC3D-easy-v0", device=where, **kw)
        e.reset(seed=0)
        o, r, _, _, info = e.step(a)
        outs[where.type] = dict(o, reward=r, nusselt=info["nusselt"].reshape(1))
    worst = {}
    for k, c in outs["cpu"].items():
        g = outs[dev.type][k].cpu()
        worst[k] = float((g - c).abs().max() / c.abs().max().clamp(min=1e-30))
    log(f"phase 27 RBC3D-easy-v0 full width, 1 sim step from the bundled "
        f"snapshot, card vs host: relative diffs {worst} (bar 1e-4) in "
        f"{time.perf_counter() - t0:.1f}s")
    check(all(v <= 1e-4 for v in worst.values()),
          f"RBC3D card and host disagree: {worst}")
    return max(worst.values())


def _rbc_phases(dev, kernels, compare, piso, linsolve) -> None:
    """Phases 25-31: K1-3D and K2-3D against their plain versions and the
    spread arm against the chunk grid (25); the RBC3D-easy-v0 main path, 3
    MARL steps (its default) and 1 SARL step (26); RBC3D card against host
    (27); RBC3D-wide-easy-v0, 1 step (28), every RBC3D solve on the spread
    arm; the five other RBC2D ids, 2 steps each (29); the other four RBC3D
    ids (30): ``make`` at the registered defaults on the card, then, as
    their datasets need not be present, 1 step from a conduction state at
    full width with phase 26's checks; the spread arm's end-to-end A/B
    (31)."""
    _k3d_phase(dev, kernels, compare)
    runs = [_rbc_main_path(dev, piso, linsolve, "RBC3D-easy-v0", 3, 26),
            _rbc_main_path(dev, piso, linsolve, "RBC3D-easy-v0", 1, 26,
                           use_marl=False)]
    host = _rbc3d_card_vs_host(dev)
    wide = _rbc_main_path(dev, piso, linsolve, "RBC3D-wide-easy-v0", 1, 28)
    for r in runs + [wide]:
        check(r["arm"].startswith("spread") and r["launches"]["K1 spread"]
              == r["launches"]["K1 3d"] > 0 and r["launches"]["K2 spread"]
              == r["launches"]["K2 3d"] > 0,
              f"{r['env_id']}: not every K1-3D / K2-3D launch took the spread "
              f"arm: {r['arm']}, {r['launches']}")
    for name, k in (("K1-3D", "K1"), ("K2-3D", "K2")):
        e = kernels[name]
        # the spread arm's launches in the runs (resets included; every 3D
        # launch, as checked above); per env step without the resets
        e["launches"] = sum(r["launches"][f"{k} spread"] for r in runs)
        steps = [d[k] for r in runs for d in r["step_launches"]]
        e["launches_per_env_step"] = sum(steps) / len(steps)
        e["main_path"] = {
            f"{r['env_id']} {'MARL' if r['marl'] else 'SARL'}":
            {x: r[x] for x in ("ms_step", "reset_s", "substeps",
                               "pressure_iterations", "arm")}
            for r in runs + [wide]}
        e["wide_launches"] = wide["launches"][f"{k} spread"]
        e["card_vs_host"] = host
    t0 = time.perf_counter()
    ids = [_rbc_main_path(dev, piso, linsolve, env_id, 2, 29)
           for env_id in RBC2D_IDS]
    log(f"phase 29 RBC2D ids ok in {time.perf_counter() - t0:.1f}s: "
        + json.dumps({r["env_id"]: {x: r[x] for x in (
            "shape", "arm", "ms_step", "reset_s", "substeps",
            "pressure_iterations", "launches")} for r in ids}))
    t0 = time.perf_counter()
    import fluidgym_tpu_torch

    for env_id in RBC3D_OTHER_IDS:
        env = fluidgym_tpu_torch.make(env_id)
        check(env.device.type == dev.type and env.ndims == 3,
              f"{env_id}: make put it on {env.device}")
        _rbc_main_path(dev, piso, linsolve, env_id, 1, 30,
                       load_initial_domain=False, load_domain_statistics=False,
                       randomize_initial_state=False)
    log(f"phase 30 the other RBC3D ids ok in {time.perf_counter() - t0:.1f}s")
    _spread_ab_phase(dev, kernels)

# ---------------------------------------------------------------------------
# phase 31: the spread arm against the chunk grid, end to end
# ---------------------------------------------------------------------------

#: phase 31's ids and env steps per arm; RBC2D-wide-easy-v0's (61, 192)
#: lanes run the spread arm pinned to G = 32, the rule's G for them (11,712
#: cells: 366 per block, at least SPREAD_MIN_CELLS; too few for G = 64)
SPREAD_AB = (("RBC3D-easy-v0", 2, None), ("RBC3D-wide-easy-v0", 1, None),
             ("RBC2D-wide-easy-v0", 1, 32))


def spread_env_ab(dev, env_id: str, steps: int, pin=None) -> dict:
    """``env_id`` at its registered defaults on the card, ``reset(seed=0)``,
    then four arms in turns from that one state (``set_state``): the chunk
    grid (``cg_cuda.pinned_spread(0)``), the spread arm, the spread arm, the
    chunk grid, each taking the same seeded actions.  ``pin``: the spread
    arm's G (None: the rule's).  Every arm's obs must be bit-equal to the
    first's (the spread arm computes the chunk grid's bits), the chunk
    grid's arms launch no spread arm and the spread arms nothing else.
    Returns ms per env step per arm (host clock around ``step``, ending in
    a device synchronise), the pressure iterations and launches."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    k1, k2 = cg_cuda.fused_cg, cg_cuda_mb.fused_bicgstab_mb
    count = lambda: (k1.launches, k2.launches, k1.spread_launches,
                     k2.spread_launches)
    env = fluidgym_tpu_torch.make(env_id)
    env.reset(seed=0)
    start = env.get_state()
    rng = np.random.default_rng(31)
    a_shape = ((env.n_agents, 1) if env.use_marl
               else tuple(env.action_space.shape))
    actions = [rng.uniform(-1, 1, a_shape).astype(np.float32)
               for _ in range(steps)]
    rows, first = [], None
    for arm in ("grid", "spread", "spread", "grid"):
        with cg_cuda.pinned_spread(0 if arm == "grid" else pin):
            env.set_state(start)
            c0 = count()
            step_ms, its = [], []
            for a in actions:
                torch.cuda.synchronize()
                t = time.perf_counter()
                obs, _, _, _, info = env.step(a)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t))
                its.append(int(info["pressure_iterations"]))
        d = [b - a for a, b in zip(c0, count())]
        first = obs if first is None else first
        check(all(torch.equal(obs[k], first[k]) for k in obs),
              f"{env_id} {arm} arm: obs differ from the first arm's")
        spread_all = d[2] == d[0] > 0 and d[3] == d[1] > 0
        check(spread_all if arm == "spread" else d[2] == d[3] == 0,
              f"{env_id} {arm} arm: launches K1, K2, K1 spread, K2 spread {d}")
        rows.append(dict(arm=arm, ms_per_step=step_ms,
                         mean_ms=sum(step_ms) / len(step_ms),
                         pressure_iterations=its, launches=d))
    mean = lambda a: sum(r["mean_ms"] for r in rows if r["arm"] == a) / 2
    return dict(env_id=env_id, steps=steps, pin=pin, arms=rows,
                grid_ms=mean("grid"), spread_ms=mean("spread"),
                speedup=mean("grid") / mean("spread"))


def _spread_ab_phase(dev, kernels) -> None:
    """Phase 31: ms per env step under the spread arm and the chunk grid,
    in turns from one state (``spread_env_ab``), for RBC3D-easy-v0,
    RBC3D-wide-easy-v0 and RBC2D-wide-easy-v0 (its (61, 192) lanes pinned
    to G = 32); and RBC2D-wide's K1 lane (its first substep's pressure
    solve) per raw launch at every G against the chunk grid
    (``spread_arms``)."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda

    t0 = time.perf_counter()
    ab = {}
    for env_id, steps, pin in SPREAD_AB:
        r = ab[env_id] = spread_env_ab(dev, env_id, steps, pin)
        log(f"  {env_id}: chunk grid {r['grid_ms']:.1f} ms/env step, spread "
            f"arm{'' if pin is None else f' (pinned G = {pin})'} "
            f"{r['spread_ms']:.1f} ({r['speedup']:.2f}x); per arm "
            + ", ".join(f"{x['arm']} {[round(v, 1) for v in x['ms_per_step']]}"
                        for x in r["arms"])
            + f"; pressure iterations {r['arms'][0]['pressure_iterations']}, "
              f"obs bit-equal across the arms")
    (diag, off, b, x0), kw1 = _captured_systems(dev, "RBC2D-wide-easy-v0")["K1"]
    tol = kw1.pop("tol")
    n = math.prod(b.shape[1:])
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    lane = spread_arms(torch, cg_cuda, lambda G, chains: cg_cuda.launcher(
        diag[None], off[None], b, x0, chunk=1, spread=G, chains=chains,
        tol2_sum=tol2, **kw1), 1, n, 2, "cg", reps=10)
    log(f"  RBC2D-wide-easy-v0 K1 lane {tuple(b.shape[1:])} at "
        f"{lane['iterations']} iterations, ms per raw launch "
        + json.dumps({k: round(v, 4) for k, v in lane["raw_ms"].items()})
        + f" (the rule: {lane['rule']})")
    kernels["K1-3D"]["main_path_ab"] = ab
    kernels["K1-3D"]["rbc2d_wide_k1_lane"] = lane
    log(f"phase 31 spread arm A/B ok in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phases 32-35: CylinderJet3D (the 3D merged forms K3-3D and K2-mb-3D)
# ---------------------------------------------------------------------------

CYL3D_EASY, CYL3D_MEDIUM = "CylinderJet3D-easy-v0", "CylinderJet3D-medium-v0"

#: phase 34's bars, relative to each quantity's scale: the rollout bar,
#: except the pressure obs.  A float32 step decides it only to ~1e-4: on
#: the host alone the summation order (1 thread against all of them, which
#: phase 34 measures beside the card) moves it ~6e-5, against ~2e-7 for the
#: velocity; a wrong seam or z wrap moves it O(1), which 1e-3 still catches
CYL3D_HOST_BARS = dict(velocity=1e-4, pressure=1e-3, reward=1e-4)


def _captured_merged(dev, env_id) -> dict:
    """The solves of the first substep of one sim step of ``env_id``
    (``_capture_solves``): ``"K3"`` the first pressure solve (warm from the
    deflated guess), ``"K2"`` the velocity advection solve."""
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    seen = _capture_solves(dev, env_id, 0.01, {
        "K3": (cg_cuda_mb, "fused_cg_mb"),
        "K2": (cg_cuda_mb, "fused_bicgstab_mb")})
    return {"K3": seen["K3"][0], "K2": seen["K2"][0]}


def _cyl3d_kernel_phase(dev, kernels, compare) -> None:
    """Phase 32: K3-3D and K2-mb-3D against their plain versions on the
    captured solves of CylinderJet3D-easy (``_captured_merged``): the
    pressure solve cold and warm, a 3-lane pressure run past iteration 100,
    the velocity solve (3 lanes).  On each, the spread arm at every G the
    card holds for the lanes, in both layouts, bit-equal to the chunk grid
    twice and timed against it per raw launch in turns (``spread_arms``);
    ms per wrapper call (the rule's arm), the plain version's ms, the
    bound.  Then the medium width's first pressure solve (749,568 cells):
    against the plain version and on every arm alike."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    t0 = time.perf_counter()
    sy = _captured_merged(dev, CYL3D_EASY)
    (plan, diags, offs, bs), kw3 = sy["K3"]
    x0s, tol = kw3.pop("x0s"), kw3.pop("tol")
    kw3.pop("coarse_strips", None)
    n = sum(math.prod(sb.shape) for sb in plan.superblocks)
    check(plan.ndims == 3 and plan.identity_seams and len(plan.superblocks) == 2
          and n == 341568 and x0s is not None,
          f"the captured pressure solve is not the 3D merged warm solve: "
          f"{plan.ndims}D, {len(plan.superblocks)} super-blocks, {n} cells")
    C = {algo: cg_cuda_mb.default_cluster(L, n, 3, 1, dev, algo)
         for algo, L in (("cg", 1), ("bicgstab", 3))}
    check(C == {"cg": 1, "bicgstab": 1}, f"default_cluster picks {C}, not 1")
    arm = {algo: cg_cuda_mb.merged_arm(L, n, 3, 1, dev, algo)
           for algo, L in (("cg", 1), ("bicgstab", 3))}
    check(arm == {"cg": (1, 128), "bicgstab": (1, 32)},
          f"merged_arm picks {arm}, not G = 128 for K3 and 32 for K2-mb")
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    b1 = cg_cuda_mb.flatten_fields(plan, tuple(b.unsqueeze(0) for b in bs))
    g1 = cg_cuda_mb.flatten_fields(plan, tuple(x.unsqueeze(0) for x in x0s))
    try:
        cg_cuda_mb.merged_launcher("cg", plan, diag, off, b1, g1, tol2_sum=tol2,
                                   chunk=1, cluster=2, **kw3)
        refused = False
    except ValueError:
        refused = True
    check(refused, "the K3-3D launcher took cluster 2, whose rows do not fit")
    mv3 = cg_cuda_mb._merged_mv(plan, diag, off)
    errs, rows = {"K3-3D": 0.0, "K2-mb-3D": 0.0}, {}

    def run(name, key, algo, plan, b, x0, tol, kw, ops, rel, it_tol, mv, reps):
        """One system on flat ``(lanes, n)`` tensors: the wrapper call
        against the plain version (``compare``, and the same converged
        flags), then every arm bit for bit and per raw launch in turns
        (``spread_arms``), ms per wrapper call and the bound."""
        d, o, dg, of = ops
        nc = b.shape[1]
        last = {}
        wrap = (cg_cuda_mb.fused_cg_mb if algo == "cg"
                else cg_cuda_mb.fused_bicgstab_mb)
        t2 = cg_cuda.tol2_sum_f32(tol, nc)

        def call():
            xs, inf = wrap(plan, dg, of, cg_cuda_mb.unflatten_fields(plan, b),
                           None if x0 is None
                           else cg_cuda_mb.unflatten_fields(plan, x0),
                           tol=tol, chunk=1, **kw)
            x = cg_cuda_mb.flatten_fields(plan, xs)
            if algo == "cg":
                out = (x, inf.iterations, inf.residual ** 2 * nc)
                last["kern"] = inf.converged
            else:
                out = (x, inf.iterations.repeat(b.shape[0]), None)
                last["kern"] = inf.converged.repeat(b.shape[0])
            return out

        def plain():
            if algo == "cg":
                out = cg_cuda_mb.fused_cg_mb_plain(plan, d, o, b, x0,
                                                   tol2_sum=t2, chunk=1, **kw)
            else:
                out = cg_cuda_mb.fused_bicgstab_plain(d, o, b, x0, ndims=3,
                                                      plan=plan, tol2_sum=t2,
                                                      chunk=1, **kw)
            zero = (b == 0).all(dim=1)
            last["plain"] = (out[2] <= t2) | zero
            if algo != "cg":  # the wrapper reports over every component
                last["plain"] = last["plain"].all().repeat(b.shape[0])
                out = (out[0], out[1].max().repeat(b.shape[0]), out[2])
            return out

        e, it = compare(f"{name} {key}", call, plain, b, tol, rel, it_tol, mv)
        check(torch.equal(last["kern"].cpu(), last["plain"].cpu()),
              f"{name} {key}: converged flags {last['kern'].tolist()} (kernel) "
              f"!= {last['plain'].tolist()} (plain)")
        errs[name] = max(errs[name], e)
        L = b.shape[0]
        arms = spread_arms(
            torch, cg_cuda, lambda G, chains: cg_cuda_mb.merged_launcher(
                algo, plan, d, o, b, x0, tol2_sum=t2, chunk=1, spread=G,
                chains=chains, **kw), L, nc, 3, algo, reps=reps, merged=True,
            runs=2)
        raw, grid = arms["raw_ms"][arms["rule"]], arms["raw_ms"]["grid"]
        b_ms, by, stream = bound_ms(nc, L, 3, it, algo, x0 is not None, True,
                                    _seam_cells(plan))
        row = dict(iterations=it, converged=last["kern"].tolist(),
                   ms=cuda_ms(torch, call, reps), raw_ms=raw,
                   us_per_it=raw * 1e3 / max(it, 1), raw_ms_grid=grid,
                   us_per_it_grid=grid * 1e3 / max(it, 1),
                   plain_ms=cuda_ms(torch, plain, 1), bound_ms=b_ms,
                   bound_by=by, stream_ms=stream, arms=arms)
        log(f"  {name} {key}: {row['ms']:.3f} ms per wrapper call; raw launch "
            f"{arms['rule']} {raw:.3f} ms = {row['us_per_it']:.2f} us/iteration"
            f", chunk grid {grid:.3f} ms = {row['us_per_it_grid']:.2f} "
            f"({grid / raw:.2f}x) at {it} iterations; every arm bit-equal "
            f"twice, raw ms "
            f"{json.dumps({k: round(v, 4) for k, v in arms['raw_ms'].items()})}"
            f" (plain {row['plain_ms']:.3f} ms; bound {b_ms * 1e3:.3f} us by "
            f"{by}, streaming {stream * 1e3:.3f} us)")
        rows.setdefault(name, {})[key] = row
        return it

    ops3 = (diag, off, diags, offs)
    run("K3-3D", "cold (1, 341568)", "cg", plan, b1, None, tol, kw3, ops3,
        1e-3, 3, mv3, 3)
    run("K3-3D", "warm (1, 341568)", "cg", plan, b1, g1, tol, kw3, ops3, 1e-3,
        3, mv3, 3)
    g = torch.Generator().manual_seed(32)
    rand = torch.randn(n, generator=g).to(dev) * b1.abs().max()
    b3 = torch.stack([rand - rand.mean(), 1e-3 * b1[0], torch.zeros_like(b1[0])])
    it3 = run("K3-3D", "3 lanes (3, 341568)", "cg", plan, b3, None, tol, kw3,
              ops3, 1e-3, 3, mv3, 1)
    check(it3 > 100, f"the 3-lane K3-3D run stopped at iteration {it3} (<= 100)")
    (plan2, adiags, aoffs, bvs), kw2 = sy["K2"]
    check(plan2 == plan and bvs[0].shape[0] == 3,
          "the captured advection solve is not the 3-lane 3D merged solve")
    xvs, tol_a = kw2.pop("x0s"), kw2.pop("tol")
    adiag, aoff = cg_cuda_mb.flatten_ops(plan, adiags, aoffs)
    bv = cg_cuda_mb.flatten_fields(plan, bvs)
    xv = None if xvs is None else cg_cuda_mb.flatten_fields(plan, xvs)
    run("K2-mb-3D", "velocity (3, 341568)", "bicgstab", plan, bv, xv, tol_a,
        kw2, (adiag, aoff, adiags, aoffs), 1e-4, 2,
        cg_cuda_mb._merged_mv(plan, adiag, aoff), 3)
    # the medium width's first pressure solve (warm from the deflated guess)
    (mplan, mdiags, moffs, mbs), kwm = _captured_merged(dev, CYL3D_MEDIUM)["K3"]
    mx0s, mtol = kwm.pop("x0s"), kwm.pop("tol")
    kwm.pop("coarse_strips", None)
    nm = sum(math.prod(sb.shape) for sb in mplan.superblocks)
    check(nm == 749568 and mplan.ndims == 3 and mx0s is not None,
          f"the medium pressure solve is not the 3D merged warm solve ({nm})")
    check(cg_cuda_mb.merged_arm(1, nm, 3, 1, dev, "cg") == (1, 128),
          "merged_arm does not pick G = 128 for the medium K3 lane")
    mdiag, moff = cg_cuda_mb.flatten_ops(mplan, mdiags, moffs)
    mb = cg_cuda_mb.flatten_fields(mplan, tuple(b.unsqueeze(0) for b in mbs))
    mg = cg_cuda_mb.flatten_fields(mplan, tuple(x.unsqueeze(0) for x in mx0s))
    run("K3-3D", "medium warm (1, 749568)", "cg", mplan, mb, mg, mtol, kwm,
        (mdiag, moff, mdiags, moffs), 1e-3, 3,
        cg_cuda_mb._merged_mv(mplan, mdiag, moff), 3)
    for name, key in (("K3-3D", "warm (1, 341568)"),
                      ("K3-3D", "medium warm (1, 749568)"),
                      ("K2-mb-3D", "velocity (3, 341568)")):
        r = rows[name][key]
        check(r["raw_ms"] < r["raw_ms_grid"],
              f"{name} {key}: the rule's arm {r['arms']['rule']} "
              f"({r['raw_ms']:.3f} ms per raw launch) is not faster than the "
              f"chunk grid ({r['raw_ms_grid']:.3f} ms)")
    for name, key, what, src, rep in (
            ("K3-3D", "warm (1, 341568)", "Jacobi-PCG", "cg.cu", 284),
            ("K2-mb-3D", "velocity (3, 341568)", "right-Jacobi BiCGStab",
             "bicgstab_mb.cu", 458)):
        r = rows[name][key]
        rule = r["arms"]["rule"]
        # one entry per TPU kernel, of the arm the main path runs (the
        # spread arm); the chunk grid's raw launch, timed beside it in
        # turns, only as raw_ms_grid / us_per_it_grid
        kernels[name] = dict(
            name=f"{name} ({what}, 3D merged frame: identity seams, periodic "
                 f"z; the spread arm, {rule})",
            route="cuda",
            source=f"fluidgym_tpu_torch/csrc/{src} + "
                   "fluidgym_tpu_torch/csrc/merged.cuh + "
                   "fluidgym_tpu_torch/csrc/krylov.cuh",
            replaces=f"fluidgym_tpu/ops/cg_pallas_mb.py:{rep}",
            max_abs_err=errs[name], ms=r["ms"], raw_ms=r["raw_ms"],
            us_per_it=r["us_per_it"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            stream_ms=r["stream_ms"], library_ms=None,
            iterations=r["iterations"], arm=f"spread {rule}",
            G=int(rule.split()[0][2:]), layout=rule.split()[1],
            raw_ms_grid=r["raw_ms_grid"], us_per_it_grid=r["us_per_it_grid"],
            speedup_over_grid=r["raw_ms_grid"] / r["raw_ms"], shape=key,
            systems=rows[name])
    m = rows["K3-3D"]["medium warm (1, 749568)"]
    kernels["K3-3D"]["medium"] = {x: m[x] for x in (
        "iterations", "raw_ms", "us_per_it", "raw_ms_grid", "us_per_it_grid",
        "ms", "plain_ms", "bound_ms", "bound_by", "stream_ms")}
    kernels["K3-3D"]["medium"]["rule"] = m["arms"]["rule"]
    log(f"phase 32 K3-3D and K2-mb-3D ok: the spread arm bit-equal to the "
        f"chunk grid at every G and layout on {len(rows['K3-3D'])} + "
        f"{len(rows['K2-mb-3D'])} systems, faster at both widths (C = 1 from "
        f"default_cluster, C = 2 refused; {_seam_cells(plan)} seam cells) "
        f"in {time.perf_counter() - t0:.1f}s")


def _cyl3d_main_path(dev, piso, linsolve, env_id, steps, ph, **make_kw) -> dict:
    """``make(env_id, **make_kw)`` on the card at the registered full width,
    ``reset(seed=0)``, then ``steps`` steps with seeded numpy actions.
    Every counter is zeroed just before ``make`` and read after each step:
    in every step K3 launches twice per substep and K2-mb once, every one a
    3D merged launch on the spread arm (no cluster launch), and no other
    kernel form, plain version or ``linsolve`` loop runs; obs of the
    space's shapes, obs, rewards, drag and lift finite.  The result holds
    the env as the steps left it (phase 36 starts there)."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    launches, plains = _counters()
    extra = [(k3, "launches_3d"), (k2, "merged_launches_3d"),
             (k3, "cluster_launches"), (k2, "cluster_launches"),
             (k3, "spread_launches"), (k2, "merged_spread_launches")]
    calls, restore = count_calls(piso, linsolve)

    def counts():
        out = {"K3": k3.launches, "K2-mb": k2.merged_launches,
               "K3 3d": k3.launches_3d, "K2-mb 3d": k2.merged_launches_3d,
               "K3 spread": k3.spread_launches,
               "K2-mb spread": k2.merged_spread_launches,
               "cluster": k3.cluster_launches + k2.cluster_launches}
        out["other"] = (sum(getattr(*c) for c in launches) - out["K3"]
                        - out["K2-mb"])
        out["plain"] = sum(getattr(*c) for c in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        return out

    for c in launches + plains + extra:
        setattr(*c, 0)
    torch.cuda.synchronize()
    rows = []
    try:
        t = time.perf_counter()
        env = fluidgym_tpu_torch.make(env_id, **make_kw)
        env.reset(seed=0)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t
        reset = counts()
        nb = [b.shape for b in env._topo.blocks]
        cells = sum(math.prod(s_) for s_ in nb)
        rng = np.random.default_rng(ph)
        a_shape = ((env.n_agents, 1) if env.use_marl
                   else tuple(env.action_space.shape))
        for i in range(steps):
            a = rng.uniform(-1, 1, a_shape).astype(np.float32)
            c0 = counts()
            t = time.perf_counter()
            obs, reward, _, _, info = env.step(a)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            d = {k: v - c0[k] for k, v in counts().items()}
            sub = d["substeps"]
            expect = {"K3": 2 * sub, "K3 3d": 2 * sub, "K3 spread": 2 * sub,
                      "K2-mb": sub, "K2-mb 3d": sub, "K2-mb spread": sub,
                      "cluster": 0, "other": 0, "plain": 0, "linsolve": 0}
            check(sub > 0 and all(d[k] == v for k, v in expect.items()),
                  f"{env_id} step {i}: launches {d}, expected {expect}")
            for k, v in obs.items():
                want = env.observation_space[k].shape
                if env.use_marl:
                    want = (env.n_agents,) + tuple(want)
                check(tuple(v.shape) == tuple(want), f"{env_id} obs {k} shape "
                      f"{tuple(v.shape)} != {want}")
                check(bool(torch.isfinite(v).all()), f"{env_id} obs {k} not finite")
            drag, lift = float(info["drag"]), float(info["lift"])
            check(bool(torch.isfinite(reward).all()) and math.isfinite(drag)
                  and math.isfinite(lift), f"{env_id}: reward, drag {drag} or "
                  f"lift {lift} not finite")
            rows.append(dict(s=step_s, substeps=sub, K3=d["K3"], K2=d["K2-mb"],
                             pressure_iterations=int(info["pressure_iterations"]),
                             pressure_converged=bool(info["pressure_converged"]),
                             drag=drag, lift=lift))
    finally:
        restore()
    total = counts()
    out = dict(env_id=env_id, cells=cells, marl=env.use_marl,
               n_agents=env.n_agents, reset_s=reset_s,
               reset_launches={k: reset[k] for k in ("K3", "K2-mb")},
               ms_step=1e3 * sum(r["s"] for r in rows) / len(rows),
               step_ms=[1e3 * r["s"] for r in rows],
               substeps=[r["substeps"] for r in rows],
               pressure_iterations=[r["pressure_iterations"] for r in rows],
               pressure_converged=[r["pressure_converged"] for r in rows],
               drag=[round(r["drag"], 5) for r in rows],
               lift=[round(r["lift"], 5) for r in rows],
               launches={k: total[k] for k in ("K3", "K2-mb", "K3 3d",
                                               "K2-mb 3d", "K3 spread",
                                               "K2-mb spread", "cluster")},
               step_launches=[{k: r[k] for k in ("K3", "K2")} for r in rows],
               env=env)
    log(f"phase {ph} {env_id} {nb} = {cells} cells "
        f"({'MARL, ' + str(env.n_agents) + ' agents' if env.use_marl else 'SARL'}): "
        f"reset {reset_s:.2f}s (launches {out['reset_launches']}), steps "
        f"{[round(r['s'], 3) for r in rows]} s = {out['ms_step']:.1f} ms/env "
        f"step, substeps {out['substeps']}, pressure iterations "
        f"{out['pressure_iterations']} (converged {out['pressure_converged']}), "
        f"drag {out['drag']}, lift {out['lift']}, per-step launches "
        f"{out['step_launches']}, totals {out['launches']}; all 3D merged on "
        f"the spread arm, no other form, plain version or linsolve loop")
    return out


def _cyl3d_card_vs_host(dev) -> dict:
    """Phase 34: one full-width CylinderJet3D-easy-v0 sim step
    (``step_length`` = dt, the bundled ``train_00``, SARL at the registered
    defaults) on the card and on the host: obs and reward within
    ``CYL3D_HOST_BARS`` of each quantity's scale.  Beside it, the host
    against itself on one thread: how far summation order alone moves the
    same step."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch

    t0 = time.perf_counter()
    kw = dict(randomize_initial_state=False, step_length=0.01, episode_length=2)
    a = np.linspace(0.4, -0.4, 8, dtype=np.float32).reshape(8, 1)
    outs = {}
    threads = torch.get_num_threads()
    for label, where, nt in (("card", dev, threads), ("host", torch.device("cpu"),
                                                      threads),
                             ("host 1 thread", torch.device("cpu"), 1)):
        torch.set_num_threads(nt)
        try:
            e = fluidgym_tpu_torch.make(CYL3D_EASY, device=where, **kw)
            e.reset(seed=0)
            o, r, _, _, info = e.step(a)
        finally:
            torch.set_num_threads(threads)
        outs[label] = {k: v.cpu() for k, v in dict(o, reward=r).items()}

    def diffs(x, y):
        return {k: float((x[k] - c).abs().max() / c.abs().max().clamp(min=1e-30))
                for k, c in y.items()}

    worst = diffs(outs["card"], outs["host"])
    order = diffs(outs["host 1 thread"], outs["host"])
    log(f"phase 34 {CYL3D_EASY} full width, 1 sim step from the bundled "
        f"snapshot, card vs host: relative diffs {worst} (bars "
        f"{CYL3D_HOST_BARS}); host on 1 thread vs {threads}: {order}; in "
        f"{time.perf_counter() - t0:.1f}s")
    check(all(v <= CYL3D_HOST_BARS[k] for k, v in worst.items()),
          f"CylinderJet3D card and host disagree: {worst}")
    return dict(card_vs_host=worst, host_threads=order)


# ---------------------------------------------------------------------------
# phase 36: the merged forms' spread arm against the chunk grid, end to end
# ---------------------------------------------------------------------------

#: phase 36's ids, env steps per arm, the arms in turns, and whether the
#: first step runs once more per arm under the profiler (a profiled medium
#: step costs ~30-40 s of host time, so medium's device time comes from
#: ``scripts/port_step_profile.py``)
CYL3D_AB = ((CYL3D_EASY, 2, ("grid", "spread", "spread", "grid"), True),
            (CYL3D_MEDIUM, 1, ("grid", "spread"), False))


def device_ms(torch, fn) -> float:
    """Device time of ``fn()`` in ms: the summed durations of the CUDA
    activities (kernels, copies, sets) that ``torch.profiler`` records with
    the CUDA activity alone (no host operators, so no event tree to
    build)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = sum(ev.duration_ns() for ev in prof.profiler.kineto_results.events()
             if ev.device_type() == DeviceType.CUDA)
    check(ns > 0, "the profiler recorded no device time")
    return ns / 1e6


def cyl3d_env_ab(dev, env_id: str, env, steps: int, arms,
                 profiled: bool) -> dict:
    """``env`` (a CylinderJet3D env made on the card at its registered
    defaults and stepped, phases 33 and 35), then ``arms`` in turns from its
    current state (``set_state``): "grid" pins
    the spread rule to the chunk grid (``cg_cuda.pinned_spread(0)``),
    "spread" leaves the rule free; each takes the same seeded actions.
    Every arm's obs must be bit-equal to the first's (the spread arm
    computes the chunk grid's bits); in the grid arms no merged launch
    takes the spread arm, in the spread arms every one; no plain version
    runs.  Then, if ``profiled``, from the same state the first step once
    more per arm under ``torch.profiler`` (``device_ms``).  Returns ms per
    env step per arm (host clock around ``step``, ending in a device
    synchronise), device ms per step, pressure iterations and launches."""
    import numpy as np
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb

    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    _, plains = _counters()
    count = lambda: (k3.launches_3d, k2.merged_launches_3d, k3.spread_launches,
                     k2.merged_spread_launches,
                     k3.cluster_launches + k2.cluster_launches,
                     sum(getattr(*c) for c in plains))
    start = env.get_state()
    rng = np.random.default_rng(36)
    a_shape = ((env.n_agents, 1) if env.use_marl
               else tuple(env.action_space.shape))
    actions = [rng.uniform(-1, 1, a_shape).astype(np.float32)
               for _ in range(steps)]
    rows, first = [], None
    for arm in arms:
        with cg_cuda.pinned_spread(0 if arm == "grid" else None):
            env.set_state(start)
            c0 = count()
            step_ms, its = [], []
            for a in actions:
                torch.cuda.synchronize()
                t = time.perf_counter()
                obs, _, _, _, info = env.step(a)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t))
                its.append(int(info["pressure_iterations"]))
        d = [b - a for a, b in zip(c0, count())]
        first = obs if first is None else first
        check(all(torch.equal(obs[k], first[k]) for k in obs),
              f"{env_id} {arm} arm: obs differ from the first arm's")
        spread = d[2] == d[0] > 0 and d[3] == d[1] > 0
        check((spread if arm == "spread" else d[2] == d[3] == 0)
              and d[4] == d[5] == 0,
              f"{env_id} {arm} arm: launches K3 3d, K2-mb 3d, K3 spread, "
              f"K2-mb spread, cluster, plain {d}")
        rows.append(dict(arm=arm, ms_per_step=step_ms,
                         mean_ms=sum(step_ms) / len(step_ms),
                         pressure_iterations=its, launches=d))
    dev_ms = {}
    for arm in ("grid", "spread") if profiled else ():
        with cg_cuda.pinned_spread(0 if arm == "grid" else None):
            env.set_state(start)
            dev_ms[arm] = device_ms(torch, lambda: env.step(actions[0]))
    mean = lambda a: (sum(r["mean_ms"] for r in rows if r["arm"] == a)
                      / sum(r["arm"] == a for r in rows))
    return dict(env_id=env_id, steps=steps, arms=rows, grid_ms=mean("grid"),
                spread_ms=mean("spread"),
                speedup=mean("grid") / mean("spread"),
                device_ms_first_step=dev_ms)


def _cyl3d_ab_phase(dev, kernels, envs) -> None:
    """Phase 36: ms per env step of CylinderJet3D-easy (2 SARL steps, four
    arms in turns; and device ms per step) and -medium (1 step, two arms)
    under the merged forms' spread arm and the chunk grid
    (``cyl3d_env_ab``), from the states where phases 33 (SARL) and 35 left
    ``envs`` (by id)."""
    t0 = time.perf_counter()
    ab = {}
    for env_id, steps, arms, profiled in CYL3D_AB:
        r = ab[env_id] = cyl3d_env_ab(dev, env_id, envs[env_id], steps, arms,
                                      profiled)
        log(f"  {env_id}: chunk grid {r['grid_ms']:.1f} ms/env step, spread "
            f"arm {r['spread_ms']:.1f} ({r['speedup']:.2f}x); per arm "
            + ", ".join(f"{x['arm']} {[round(v, 1) for v in x['ms_per_step']]}"
                        for x in r["arms"])
            + f"; device ms of the first step "
              f"{json.dumps({k: round(v, 1) for k, v in r['device_ms_first_step'].items()})}"
              f"; pressure iterations {r['arms'][0]['pressure_iterations']}, "
              f"obs bit-equal across the arms")
    kernels["K3-3D"]["main_path_ab"] = ab
    log(f"phase 36 merged spread arm A/B ok in {time.perf_counter() - t0:.1f}s")


def _cyl3d_phases(dev, kernels, compare, piso, linsolve) -> None:
    """Phases 32-36: K3-3D and K2-mb-3D against their plain versions and the
    spread arm against the chunk grid (32); the CylinderJet3D-easy-v0 main
    path, 3 SARL steps (its default) and 1 MARL step (33); card against host
    (34); CylinderJet3D-medium-v0, 1 step (35); the two arms end to end
    (36)."""
    _cyl3d_kernel_phase(dev, kernels, compare)
    runs = [_cyl3d_main_path(dev, piso, linsolve, CYL3D_EASY, 3, 33),
            _cyl3d_main_path(dev, piso, linsolve, CYL3D_EASY, 1, 33,
                             use_marl=True)]
    host = _cyl3d_card_vs_host(dev)
    medium = _cyl3d_main_path(dev, piso, linsolve, CYL3D_MEDIUM, 1, 35)
    check(runs[0]["cells"] == 341568 and medium["cells"] == 749568,
          f"not the registered widths: {runs[0]['cells']}, {medium['cells']}")
    for name, k in (("K3-3D", "K3"), ("K2-mb-3D", "K2-mb")):
        e = kernels[name]
        # the main path's launches in the easy runs (resets included)
        e["launches"] = sum(r["launches"][f"{k} 3d"] for r in runs)
        steps = [d["K3" if k == "K3" else "K2"] for r in runs
                 for d in r["step_launches"]]
        e["launches_per_env_step"] = sum(steps) / len(steps)
        e["main_path"] = {
            f"{r['env_id']} {'MARL' if r['marl'] else 'SARL'}":
            {x: r[x] for x in ("ms_step", "step_ms", "reset_s", "substeps",
                               "pressure_iterations", "pressure_converged")}
            for r in runs + [medium]}
        e["medium_launches"] = medium["launches"][f"{k} 3d"]
        e["card_vs_host"] = host
    _cyl3d_ab_phase(dev, kernels, {CYL3D_EASY: runs[0]["env"],
                                   CYL3D_MEDIUM: medium["env"]})


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
