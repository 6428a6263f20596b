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
   that passes iteration 100;
4. K2 against its plain version: the snapshot's temperature (1 lane) and
   velocity (2 lanes) advection systems;
5. the main path: ``make("RBC2D-easy-v0")`` at its registered full width,
   ``reset(seed=0)``, 3 steps with fixed numpy actions; the kernels' launch
   counters are zeroed just before and read just after: every substep must
   launch K1 once per pressure corrector and K2 once per advection solve,
   and neither the plain versions nor ``linsolve``'s loops may run;
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
   the same converged flags, iterations within 2; the Jacobi-only K3
   iterations on the same systems beside them;
16. K3-coarse-flip likewise on the airfoil's system (K = 59);
17. the slice's main path: ``make`` of each merged id at its registered
   defaults, ``reset(seed=0)``, then ``SimConfig.pressure_coarse_strips``
   and the K4 switch on; 3 cylinder steps and 1 airfoil step with phases
   9 and 12's actions; in every step K3-coarse(-flip) launches twice per
   substep, K2-mb(-flip) once, K4 once per block per ``domain_apply`` (15
   per cylinder substep, 18 per airfoil substep), and no other kernel form,
   plain version or ``linsolve`` loop; ms and pressure iterations per env
   step beside phases 9 and 12's;
18. the card against the host for the cylinder with the strips and K4 on:
   1 env step at full width from the bundled snapshot; obs and reward to
   1e-3 (with the strips a float32 step is rounding-decided at ~1e-4; see
   ``_strips_card_vs_host``);
19. the chunk grid: K1, K2, K3, K2-mb, K3-flip and K3-coarse at 130 lanes
   with one operator per lane, in chunks of 33 (4 blocks in one launch)
   against their plain versions in the same chunks (the same converged
   flags, iterations and x within each form's bar, a zero lane exactly 0,
   the CG forms past iteration 100); the vmapped wrapper equal to its raw
   launch; ms per solve at 1, 64 and 130 lanes and the bound of the batch;
20. the batched main path: ``BatchedFluidEnv("RBC2D-easy-v0", 64)`` at its
   registered defaults, ``reset(seed=0)``, 3 steps with seeded numpy
   actions; counters zeroed just before and read just after: in every step
   K1 launches exactly 2 and K2 2 per lockstep round, whatever the batch,
   and no other kernel form, plain version, ``linsolve`` loop or vmap
   per-lane fallback runs; lanes 0 and 63 against single envs reset from
   the same seeds (see ``BATCH_CASES`` for the bars);
21. the same for ``CylinderJet2D-easy-v0``, 2 steps: K3 2 and K2-mb 1 per
   round;
22. batched env-steps/s beside the single env's, measured in the same run.

Then a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
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

    def compare(name, wrapper_call, plain_call, b, tol, rel_tol, it_tol,
                matvec):
        """Kernel vs plain on the same inputs: iterations within ``it_tol``,
        max|dx| <= rel_tol * max|x_plain|, converged lanes' true residual
        RMSE <= 2 tol, zero-RHS lanes exactly zero."""
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
    k1_ms = cuda_ms(torch, lambda: k1_call(), 10)
    k1_plain_ms = cuda_ms(torch, lambda: k1_plain(), 3)
    b1, by1, s1 = bound_ms(n, 1, nd, it1, "cg", False, True)
    log(f"phase 3 K1 ok: {k1_ms:.3f} ms/solve (plain {k1_plain_ms:.3f} ms, "
        f"bound {b1 * 1e3:.3f} us by {by1}, streaming {s1 * 1e3:.3f} us) at "
        f"{it1} iterations")
    kernels["K1"] = dict(
        name="K1 fused_cg (Jacobi-PCG, whole solve)", route="cuda",
        source="fluidgym_tpu_torch/csrc/cg.cu",
        replaces="fluidgym_tpu/ops/cg_pallas.py:143", max_abs_err=max(err1, err4),
        ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=b1, bound_by=by1,
        library_ms=None, iterations=it1)

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
    k2_err, k2_ms, k2_plain_ms, k2_it = 0.0, {}, {}, {}
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
        log(f"  K2 {name}: {k2_ms[name]:.3f} ms/solve (plain "
            f"{k2_plain_ms[name]:.3f} ms) at {it} iterations")
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
        scalar_plain_ms=k2_plain_ms["temperature"])

    # ---- 5: the main path ------------------------------------------------------
    calls, restore = count_calls(piso, linsolve)
    cg_cuda.fused_cg.launches = 0
    cg_cuda_mb.fused_bicgstab_mb.launches = 0
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
    plain_calls = (cg_cuda.fused_cg_plain.calls
                   + cg_cuda_mb.fused_bicgstab_plain.calls)
    restore()
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
        f"{reset_launches}), plain calls {plain_calls}, linsolve calls "
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
        _chunk_phase(dev, kernels, piso, dict(po=po, adv=adv_ops[0], topo=topo))
        results = [_batched_phase(dev, kernels, piso, linsolve, case)
                   for case in BATCH_CASES]
    _throughput_phase(kernels, results)
    log(f"phase 22 summary {json.dumps(kernels.pop('batched'))}")

    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernels[k] for k in (
        "K1", "K2", "K2-mb", "K3", "K3-flip", "K2-mb-flip", "K4", "K3-coarse",
        "K3-coarse-flip", "K1 lanes", "K2 lanes", "K3 lanes", "K2-mb lanes")]}),
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
        out["plain"] = sum(f.calls for f in plains)
        out["linsolve"] = calls["cg"] + calls["bicgstab"]
        out["substeps"] = calls["piso_substep_info"]
        return out

    for w, a in forms:
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
    converged flags and iterations within 2.  Also the Jacobi-only K3
    iterations on the same systems."""
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
    errs, its, jac = [], {}, {}
    for label, bs, x0s, tol in runs:
        flags = {}
        kern, plain, jacobi = pair(bs, x0s, tol, flags)
        e, it = compare(f"{name} {label} ({bs[0].shape[0]}, {n})", kern, plain,
                        flat(bs), tol, 1e-3, 2, mv)
        check(torch.equal(flags["kernel"], flags["plain"]),
              f"{name} {label}: converged flags {flags}")
        errs.append(e)
        its[label] = it
        jac[label] = jacobi()
        if label == "3 lanes":
            check(it > 100, f"3-lane {name} run stopped at iteration {it} (<= 100)")
    kern, plain, _ = pair(b1, g1, case["tol_p"], {})
    ms = cuda_ms(torch, kern, 10)
    plain_ms = cuda_ms(torch, plain, case["plain_reps"])
    # the wrapper's two parts: the coarse inverse from the operator (every
    # call, as in the JAX package) and the kernel launch itself
    einv_ms = cuda_ms(torch, lambda: coarse_strips.coarse_inverse(plan, sp, mops), 10)
    tol2 = cg_cuda.tol2_sum_f32(case["tol_p"], n)
    launch = lambda coarse: cuda_ms(torch, lambda: cg_cuda_mb._launch_merged(
        "cg", plan, diag, off, flat(b1), flat(g1), tol2_sum=tol2,
        coarse=coarse, chunk=1, **kw), 10)
    launch_ms, jacobi_launch_ms = launch((sp, einv)), launch(None)
    warm_it = its["warm (deflated guess)"]
    b, by, stream = bound_ms(n, 1, 2, warm_it, "cg", True, True, seam, sp.K)
    log(f"phase {ph} {name} ok: {ms:.3f} ms/solve warm (plain {plain_ms:.3f} ms, "
        f"bound {b * 1e3:.3f} us by {by}, streaming {stream * 1e3:.3f} us) at "
        f"{warm_it} iterations: coarse inverse {einv_ms:.3f} ms + launch "
        f"{launch_ms:.3f} ms = {launch_ms * 1e3 / max(warm_it, 1):.1f} "
        f"us/iteration (Jacobi-only K3 launch on the same warm system "
        f"{jacobi_launch_ms:.3f} ms = "
        f"{jacobi_launch_ms * 1e3 / max(jac['warm (deflated guess)'], 1):.1f} "
        f"us/iteration); K = {sp.K} strips; iterations with strips {its}, "
        f"Jacobi-only K3 on the same systems {jac}")
    kernels[name] = dict(
        name=f"{name} fused_cg_mb(coarse_strips=True) (strip-coarse two-level "
             f"PCG, merged frame{case['k3_form']}, whole solve)",
        route="cuda", source="fluidgym_tpu_torch/csrc/cg.cu",
        replaces="fluidgym_tpu/ops/cg_pallas_mb.py:284", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
        coarse_inverse_ms=einv_ms, launch_ms=launch_ms,
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
    exactly twice per substep, K2-mb(-flip) once, K4 once per block per
    ``domain_apply`` (the deflation setup and the two warm-start gates), and
    no other kernel form, plain version or ``linsolve`` loop runs."""
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
            out["plain"] = sum(getattr(*c) for c in plains)
            out["linsolve"] = calls["cg"] + calls["bicgstab"]
            out["substeps"] = calls["piso_substep_info"]
            return out

        for c in launches + plains:
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
                expect = {name: cfg.corrector_steps * sub, case["k2"]: sub,
                          "K4": k4_per_sub * sub, "other": 0, "plain": 0,
                          "linsolve": 0}
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
            launches=total[name], launches_per_env_step=total[name] / n,
            ms_per_env_step=ms_step, jacobi_ms_per_env_step=ref_ms,
            pressure_iterations_per_step=p_its,
            jacobi_pressure_iterations_per_step=ref_its, substeps_per_step=subs)
        k4_total += total["K4"]
        kernels["K4"][f"launches_per_env_step {env_id}"] = total["K4"] / n
    kernels["K4"]["launches"] = k4_total


def _strips_card_vs_host(dev, piso) -> None:
    """Phase 18: the card against the host for the cylinder with the strips
    and K4 on: 1 env step (25 sim steps) at full width from the bundled
    snapshot; obs and reward to 1e-3.

    With the strips on, this float32 step is decided by rounding at ~1e-4:
    on the host alone, 1 against 8 threads moves the pressure obs 1.5e-4,
    the velocity obs 1.2e-4 and the reward 4.8e-4 and the step's pressure
    iterations from 820 to 811 (4.8e-6, 2.2e-7, 6.1e-7 and no change with
    Jacobi alone; ``scripts/port_strips_rounding.py``), so the card is held
    to the host at 1e-3, as phase 13 holds the airfoil's pressure obs.
    Phases 15-16 hold the kernel itself to its plain version."""
    import numpy as np
    import torch

    import fluidgym_tpu_torch
    from fluidgym_tpu_torch.ops import cg_cuda_mb, stencil_cuda

    case = MERGED_CASES[0]
    t = time.perf_counter()
    outs = {}
    before = cg_cuda_mb.fused_cg_mb.coarse_launches
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
    check(cg_cuda_mb.fused_cg_mb.coarse_launches > before,
          "phase 18's card run did not launch K3-coarse")
    og, oc = outs[dev.type], outs["cpu"]
    diffs = {k: float((og[k].cpu() - oc[k]).abs().max()
                      / oc[k].abs().max().clamp(min=1e-30)) for k in og}
    log(f"phase 18 {case['env_id']} with strips + K4, full width, 1 step from "
        f"the bundled snapshot ({e.n_sim_steps} sim steps), card vs host: "
        f"relative diffs {diffs} (bar 1e-3) in {time.perf_counter() - t:.2f}s")
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

        def launch(Ln, chunk=None, rhs=b):
            c = chunk_of(Ln, chunk)
            a = (diag[:Ln], off[:Ln], rhs[:Ln], None)
            if plan is None and algo == "cg":
                return cg_cuda._launch(*a, ndims=nd, chunk=c, **kw)
            if plan is None:
                return cg_cuda_mb._launch(*a, ndims=nd, chunk=c, **kw)
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
                          b_time=b_time,
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


def _chunk_phase(dev, kernels, piso, rbc) -> None:
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
    the 64-lane batch (this run's per-lane iterations)."""
    import torch

    from fluidgym_tpu_torch.ops import cg_cuda

    t0 = time.perf_counter()
    L = CHUNK_LANES
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
        check(torch.equal(f["vmapped"](), x_def),
              f"{name}: the vmapped wrapper differs from its launch")
        bt = f["b_time"]
        ms = {Ln: cuda_ms(torch, lambda Ln=Ln: f["launch"](Ln, rhs=bt), 5)
              for Ln in (1, 64, L)}
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
        kernels[f"{name} lanes"] = dict(
            name=f"{name} lane folding and chunking (LaneFold vmap rule, "
                 "chunk grid of lockstep blocks)",
            route="cuda", source="fluidgym_tpu_torch/csrc/"
            + ("cg.cu" if cg else "bicgstab_mb.cu"),
            replaces=("fluidgym_tpu/ops/cg_pallas.py:232" if name == "K1"
                      else "fluidgym_tpu/ops/cg_pallas_mb.py:602"),
            launches=0, max_abs_err=err, ms=ms[64], plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by, library_ms=None, ms_1_lane=ms[1],
            ms_130_lanes=ms[L], lanes=64, mean_iterations=float(it64.mean()))
    log(f"phase 19 chunk grid ok: 6 forms x {L} lanes in "
        f"{time.perf_counter() - t0:.1f}s")


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
                    "K2": ("fused_bicgstab_mb", "launches", 2)}),
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
        return out

    for c in launches + plains:
        setattr(*c, 0)
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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
