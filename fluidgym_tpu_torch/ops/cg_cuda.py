"""K1: whole-solve lockstep Jacobi-PCG on single-block stencil systems.

Counterpart of ``fluidgym_tpu/ops/cg_pallas.py`` (TPU kernel ``_kernel``,
entry ``fused_cg``).  The CUDA kernel (``csrc/cg.cu``) runs the entire
Krylov loop of every lane in one launch: no host round-trip per iteration.

* ``fused_cg`` is the wrapper.  For CUDA tensors it launches the kernel and
  adds one to ``fused_cg.launches``; for CPU tensors it runs
  ``fused_cg_plain``; any other device raises.  There is no fallback.
* ``fused_cg_plain`` is the plain PyTorch version with the same lockstep
  semantics (one iteration counter shared by the lanes; frozen lanes keep
  getting the 100-iteration true-residual refresh).  ``fused_cg_plain.calls``
  counts its runs.

Bound on the H100 and what the design does about it: see the note at the
top of ``csrc/cg.cu``.
"""

from __future__ import annotations

import math

import torch

from fluidgym_tpu_torch.ops import _build
from fluidgym_tpu_torch.solver.linsolve import SolveInfo

__all__ = ["fused_cg", "fused_cg_plain", "cg_lockstep", "roll_matvec",
           "tol2_sum_f32", "guard", "MAX_LANES"]

_TINY = 1e-30
MAX_LANES = 64  # FG_MAX_LANES in csrc/krylov.cuh


def tol2_sum_f32(tol: float, n: int, dtype=torch.float32) -> float:
    """``tol^2 * n`` rounded to the solve dtype, as the kernels compare it."""
    return float(torch.tensor(float(tol) * float(tol) * n, dtype=dtype))


def roll_matvec(diag, off, v, ndims: int):
    """``diag*v + sum_f off_f * roll_f(v)`` over ``(lanes, *spatial)``; the
    operands broadcast over lanes.  Rolls wrap every axis (FIXED faces carry
    off = 0)."""
    y = diag * v
    for f in range(2 * ndims):
        ax = v.dim() - 1 - f // 2
        y = y + off[:, f] * torch.roll(v, 1 if f % 2 == 0 else -1, dims=ax)
    return y


def guard(x):
    """``x``, with magnitudes under 1e-30 replaced by 1e-30 (the kernels'
    division guard)."""
    return torch.where(x.abs() < _TINY, torch.full_like(x, _TINY), x)


def cg_lockstep(mv, diag, b, x0, *, tol2_sum: float, maxiter: int,
                stall_iters: int, precondition: bool, return_best: bool,
                precond=None):
    """The lockstep Jacobi-PCG loop of K1 and K3 in plain PyTorch, on
    ``(lanes, ...)`` tensors: ``mv`` applies the operator to such a tensor,
    ``diag`` (broadcasting against ``b``) is its diagonal.  ``precond``, when
    given, replaces the Jacobi step ``z = r / diag`` (K3's strip-coarse
    arm); it runs at init and after every residual update, the refresh
    iteration included.  Returns ``(x, iterations (lanes,), residual_sum
    (lanes,))``."""
    L = b.shape[0]
    red = lambda a: a.reshape(L, -1).sum(dim=1)
    lane = lambda s: s.reshape((L,) + (1,) * (b.dim() - 1))
    if precond is None:
        inv_diag = 1.0 / diag if precondition else None
        precond = (lambda v: inv_diag * v) if precondition else (lambda v: v)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    if x0 is not None:
        x = x0.clone()
        r = b - mv(x0)
    else:
        x = torch.zeros_like(b)
        r = b
    z = precond(r)
    p = z
    best = x
    rz = red(r * z)
    rs = red(r * r)
    best_rs = rs
    best_it = torch.zeros(L, dtype=torch.int32, device=b.device)
    it = 0
    while it < maxiter:
        stalled = (it - best_it) >= stall_iters
        if not bool(((rs > tol2_sum) & ~stalled).any()):
            break
        done = (rs <= tol2_sum) | stalled
        recompute = (it + 1) % 100 == 0
        Av = mv(x if recompute else p)
        denom = red(p * Av)
        alpha = torch.where(done | recompute, zero, rz / guard(denom))
        x = x + lane(alpha) * p
        r = b - Av if recompute else r - lane(alpha) * Av
        z = precond(r)
        rz_new = red(r * z)
        rs_new = red(r * r)
        beta = torch.where(done, zero, rz_new / guard(rz))
        p = z + lane(beta) * p
        better = (rs_new < best_rs) & ~done
        if return_best:
            best = torch.where(lane(better), x, best)
        best_rs = torch.where(better, rs_new, best_rs)
        best_it = torch.where(better, torch.full_like(best_it, it + 1), best_it)
        rz, rs = rz_new, rs_new
        it += 1
    if return_best:
        converged = rs <= tol2_sum
        x = torch.where(lane(converged), x, best)
        rs = torch.where(converged, rs, best_rs)
    iters = torch.full((L,), it, dtype=torch.int32, device=b.device)
    return x, iters, rs


def fused_cg_plain(diag, off, b, x0, *, ndims: int, tol2_sum: float,
                   maxiter: int, stall_iters: int, precondition: bool,
                   return_best: bool):
    """Plain PyTorch K1 on ``(lanes, *spatial)`` tensors (``diag``: lanes or
    1 leading; ``off``: ``(lanes or 1, 2*ndims, *spatial)``).  Returns
    ``(x, iterations (lanes,), residual_sum (lanes,))``."""
    fused_cg_plain.calls += 1
    return cg_lockstep(lambda v: roll_matvec(diag, off, v, ndims), diag, b, x0,
                       tol2_sum=tol2_sum, maxiter=maxiter,
                       stall_iters=stall_iters, precondition=precondition,
                       return_best=return_best)


fused_cg_plain.calls = 0


def _launch(diag, off, b, x0, *, ndims, tol2_sum, maxiter, stall_iters,
            precondition, return_best):
    L = b.shape[0]
    spatial = tuple(b.shape[1:])
    if not 1 <= L <= MAX_LANES:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_LANES} lanes, got {L}")
    if len(spatial) != ndims or ndims not in (2, 3):
        raise ValueError(f"b must be (lanes, *spatial) with {ndims} spatial axes")
    dev = b.device
    for name, t in (("diag", diag), ("off", off), ("x0", x0)):
        if t is not None and (t.device != dev or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 on {dev}")
    if b.dtype != torch.float32:
        raise ValueError("the CUDA kernel takes float32 systems")
    op_per_lane = int(diag.shape[0] != 1)
    if op_per_lane and diag.shape[0] != L:
        raise ValueError("diag/off must have 1 or `lanes` leading entries")
    b = b.contiguous()
    diag = diag.contiguous()
    off = off.contiguous()
    x0c = x0.contiguous() if x0 is not None else b
    x = torch.empty_like(b)
    r, p, q, best = (torch.empty_like(b) for _ in range(4))
    iters = torch.empty(L, dtype=torch.int32, device=dev)
    rs = torch.empty(L, dtype=torch.float32, device=dev)
    nz = spatial[0] if ndims == 3 else 1
    ny, nx = spatial[-2], spatial[-1]
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.fg_cg_solve(
            b.data_ptr(), diag.data_ptr(), off.data_ptr(), x0c.data_ptr(),
            x.data_ptr(), iters.data_ptr(), rs.data_ptr(), r.data_ptr(),
            p.data_ptr(), q.data_ptr(), best.data_ptr(), L, nz, ny, nx, ndims,
            op_per_lane, tol2_sum, int(maxiter), int(stall_iters),
            int(precondition), int(return_best), int(x0 is not None), stream)
    _build.check(status, "fused_cg")
    return x, iters, rs


def fused_cg(diag, off, b, x0=None, *, ndims: int, tol: float,
             maxiter: int = 5000, stall_iters: int = 250,
             precondition: bool = True, return_best: bool = True):
    """Whole-solve lockstep CG over ``lanes`` single-block systems.

    ``b``/``x0``: ``(lanes, *spatial)``.  ``diag``: ``(*spatial)`` shared by
    the lanes, or ``(lanes, *spatial)``; ``off`` likewise with a
    ``2*ndims`` face axis after the lane axis.  Returns ``(x, SolveInfo)``
    with per-lane ``(lanes,)`` info; the iteration count is the shared one.
    A lane whose RHS is all zero gets a zero solution."""
    L = b.shape[0]
    if diag.dim() == ndims:
        diag = diag.unsqueeze(0)
        off = off.unsqueeze(0)
    n = math.prod(b.shape[1:])
    tol2 = tol2_sum_f32(tol, n, b.dtype)
    kw = dict(ndims=ndims, tol2_sum=tol2, maxiter=int(maxiter),
              stall_iters=int(stall_iters), precondition=bool(precondition),
              return_best=bool(return_best))
    if b.is_cuda:
        x, iters, rs = _launch(diag, off, b, x0, **kw)
        fused_cg.launches += 1
    elif b.device.type == "cpu":
        x, iters, rs = fused_cg_plain(diag, off, b, x0, **kw)
    else:
        raise ValueError(f"fused_cg runs on CUDA or CPU tensors, not {b.device}")
    b_zero = (b == 0).reshape(L, -1).all(dim=1)
    x = torch.where(b_zero.reshape((L,) + (1,) * ndims), torch.zeros_like(x), x)
    converged = (rs <= tol2) | b_zero
    return x, SolveInfo(converged=converged, iterations=iters,
                        residual=torch.sqrt(rs / n))


fused_cg.launches = 0
