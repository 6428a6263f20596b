#!/usr/bin/env python3
"""Smoke run of fluidgym_tpu_torch on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds:

1. the card's name and power limit (``nvidia-smi``);
2. build of the CUDA kernels (K1 ``csrc/cg.cu``, K2 ``csrc/bicgstab_mb.cu``)
   with one ``nvcc`` call into ``build/kernels/``;
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
   snapshot for 1 step; observations and rewards must agree to 1e-4.

Then a ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
Any failed check exits non-zero; there is no CPU fallback.  Imports nothing
of JAX or of the JAX package.
"""

import json
import math
import os
import subprocess
import sys
import time

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
             warm: bool, op_shared: bool) -> tuple[float, str, float]:
    """Least time for the same work on an H100 (the larger of: bytes read
    once / written once over HBM rate, and this run's fp32 operations over
    the fp32 rate), and the time if every field went through HBM once per
    pass instead (``stream``: the working set NOT kept on chip)."""
    nf = 2 * ndims
    op_words = (1 + nf) * n_cells * (1 if op_shared else lanes)
    io_words = op_words + lanes * n_cells * (2 + (1 if warm else 0)) + 2 * lanes
    t_bytes = 4 * io_words / H100_BYTES_PER_S * 1e3
    if algo == "cg":
        flops_cell = 4 * ndims + 14       # matvec, 2 axpy, precond, 3 dots, p
        stream_words = n_cells * (nf + 1 + 10)
    else:
        flops_cell = 8 * ndims + 26       # 2 matvecs, 2 precond, 5 dots, updates
        stream_words = n_cells * (2 * (nf + 1) + 22)
    flops = float(iters) * lanes * n_cells * flops_cell
    t_ops = flops / H100_FP32_FLOPS * 1e3
    stream = float(iters) * lanes * 4 * stream_words / H100_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", stream
    return t_bytes, "bytes", stream


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
        res = (b - matvec(xk)).reshape(L, -1)
        rmse = torch.sqrt((res * res).mean(dim=1))
        conv = rp <= tol * tol * n
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
            *cg_cuda.fused_cg(po.diag, po.off, b4, tol=tol4, **kw1)),
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
    # substeps and plain Krylov loops are counted by wrapping the module
    # functions the solver looks up at call time
    calls = {"piso_substep_info": 0, "cg": 0, "bicgstab": 0}
    originals = [(mod, name, getattr(mod, name)) for mod, name in (
        (piso, "piso_substep_info"), (linsolve, "cg"), (linsolve, "bicgstab"))]
    for mod, name, fn in originals:
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)
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
    for mod, name, fn in originals:
        setattr(mod, name, fn)
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

    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({"kernels": [kernels["K1"], kernels["K2"]]}), flush=True)
    log(f"total {time.perf_counter() - T0:.1f}s (build {build_s:.1f}s)")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
