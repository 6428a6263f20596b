"""K2: whole-solve lockstep right-Jacobi BiCGStab in the merged frame.

Counterpart of ``fluidgym_tpu/ops/cg_pallas_mb.py`` (TPU kernel
``_kernel_bicg``, entry ``fused_bicgstab_mb``), for the single-super-block
plans ``block_merge.trivial_plan`` gives single-block domains.  Solve
components (and batch entries) are lanes that share one operator; each lane
stops on its own NORM2_NORMALIZED test (``tol^2 * n_lane``), which is
tighter than ``linsolve.bicgstab``'s joint test over all components.

* ``fused_bicgstab_mb`` is the wrapper.  For CUDA tensors it launches
  ``csrc/bicgstab_mb.cu`` and adds one to ``fused_bicgstab_mb.launches``; for
  CPU tensors it runs ``fused_bicgstab_plain``; any other device raises.
* ``fused_bicgstab_plain`` is the plain PyTorch version with the same
  lockstep semantics; ``fused_bicgstab_plain.calls`` counts its runs.

Not ported yet: plans with more than one super-block (seam fixups, flip
matrices), which raise ``NotImplementedError``.  Bound on the H100 and what
the design does about it: see the note at the top of ``csrc/bicgstab_mb.cu``.
"""

from __future__ import annotations

import math

import torch

from fluidgym_tpu_torch.ops import _build
from fluidgym_tpu_torch.ops.cg_cuda import (MAX_LANES, guard, roll_matvec,
                                            tol2_sum_f32)
from fluidgym_tpu_torch.solver.block_merge import MergePlan
from fluidgym_tpu_torch.solver.linsolve import SolveInfo

__all__ = ["fused_bicgstab_mb", "fused_bicgstab_plain"]


def fused_bicgstab_plain(diag, off, b, x0, *, ndims: int, tol2_sum: float,
                         maxiter: int, stall_iters: int, precondition: bool,
                         return_best: bool):
    """Plain PyTorch K2 on ``(lanes, *spatial)`` tensors (``diag``/``off``
    with a leading lane axis of 1 or ``lanes``).  Returns ``(x, iterations
    (lanes,), residual_sum (lanes,))``."""
    fused_bicgstab_plain.calls += 1
    L = b.shape[0]
    red = lambda a: a.reshape(L, -1).sum(dim=1)
    lane = lambda s: s.reshape((L,) + (1,) * (b.dim() - 1))
    mv = lambda v: roll_matvec(diag, off, v, ndims)
    inv_diag = 1.0 / diag if precondition else None
    pc = (lambda v: inv_diag * v) if precondition else (lambda v: v)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    if x0 is not None:
        x = x0.clone()
        r = b - mv(x0)
    else:
        x = torch.zeros_like(b)
        r = b
    r_hat = r
    p = r
    best = x
    rho = red(r * r)
    rs = rho
    best_rs = rs
    best_it = torch.zeros(L, dtype=torch.int32, device=b.device)
    it = 0
    while it < maxiter:
        stalled = (it - best_it) >= stall_iters
        if not bool(((rs > tol2_sum) & ~stalled).any()):
            break
        done = (rs <= tol2_sum) | stalled
        p_hat = pc(p)
        v = mv(p_hat)
        alpha = torch.where(done, zero, rho / guard(red(r_hat * v)))
        s = r - lane(alpha) * v
        s_hat = pc(s)
        t = mv(s_hat)
        omega = torch.where(done, zero, red(t * s) / guard(red(t * t)))
        x = x + lane(alpha) * p_hat + lane(omega) * s_hat
        r = s - lane(omega) * t
        rho_new = torch.where(done, rho, red(r_hat * r))
        beta = torch.where(done, zero, (rho_new / guard(rho))
                           * (alpha / guard(omega)))
        p = r + lane(beta) * (p - lane(omega) * v)
        rs_new = torch.where(done, rs, red(r * r))
        better = (rs_new < best_rs) & ~done
        if return_best:
            best = torch.where(lane(better), x, best)
        best_rs = torch.where(better, rs_new, best_rs)
        best_it = torch.where(better, torch.full_like(best_it, it + 1), best_it)
        rho, rs = rho_new, rs_new
        it += 1
    if return_best:
        converged = rs <= tol2_sum
        x = torch.where(lane(converged), x, best)
        rs = torch.where(converged, rs, best_rs)
    iters = torch.full((L,), it, dtype=torch.int32, device=b.device)
    return x, iters, rs


fused_bicgstab_plain.calls = 0


def _launch(diag, off, b, x0, *, ndims, tol2_sum, maxiter, stall_iters,
            precondition, return_best):
    L = b.shape[0]
    spatial = tuple(b.shape[1:])
    if not 1 <= L <= MAX_LANES:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_LANES} lanes, got {L}")
    if len(spatial) != ndims or ndims not in (2, 3):
        raise ValueError(f"b must be (lanes, *spatial) with {ndims} spatial axes")
    dev = b.device
    for name, t in (("b", b), ("diag", diag), ("off", off), ("x0", x0)):
        if t is not None and (t.device != dev or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 on {dev}")
    op_per_lane = int(diag.shape[0] != 1)
    if op_per_lane and diag.shape[0] != L:
        raise ValueError("diag/off must have 1 or `lanes` leading entries")
    b = b.contiguous()
    diag = diag.contiguous()
    off = off.contiguous()
    x0c = x0.contiguous() if x0 is not None else b
    x = torch.empty_like(b)
    scratch = [torch.empty_like(b) for _ in range(8)]
    iters = torch.empty(L, dtype=torch.int32, device=dev)
    rs = torch.empty(L, dtype=torch.float32, device=dev)
    nz = spatial[0] if ndims == 3 else 1
    ny, nx = spatial[-2], spatial[-1]
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.fg_bicgstab_solve(
            b.data_ptr(), diag.data_ptr(), off.data_ptr(), x0c.data_ptr(),
            x.data_ptr(), iters.data_ptr(), rs.data_ptr(),
            *[s.data_ptr() for s in scratch], L, nz, ny, nx, ndims,
            op_per_lane, tol2_sum, int(maxiter), int(stall_iters),
            int(precondition), int(return_best), int(x0 is not None), stream)
    _build.check(status, "fused_bicgstab_mb")
    return x, iters, rs


def fused_bicgstab_mb(plan: MergePlan, diags, offs, bs, x0s=None, *,
                      tol: float, maxiter: int = 5000, stall_iters: int = 250,
                      precondition: bool = True, return_best: bool = True):
    """Whole-solve lockstep BiCGStab on a merged stencil operator.

    ``diags``/``offs``: per-super-block ``(*spatial)`` / ``(2*ndims,
    *spatial)`` (``block_merge.pack_ops`` layout); ``bs``/``x0s``:
    per-super-block ``(C, *spatial)`` with a leading component axis.
    Components are independent lanes with per-component stopping.  Returns
    ``(xs, SolveInfo)`` with the info aggregated over components
    (converged = all, iterations = max, residual = joint RMSE)."""
    if len(plan.superblocks) != 1 or plan.fixups:
        raise NotImplementedError(
            "merged multi-super-block plans (seam fixups) are not ported yet")
    ndims = plan.ndims
    b = bs[0]
    x0 = None if x0s is None else x0s[0]
    C = b.shape[0]
    n_lane = math.prod(b.shape[1:])
    tol2 = tol2_sum_f32(tol, n_lane, b.dtype)
    diag = diags[0].unsqueeze(0)
    off = offs[0].unsqueeze(0)
    kw = dict(ndims=ndims, tol2_sum=tol2, maxiter=int(maxiter),
              stall_iters=int(stall_iters), precondition=bool(precondition),
              return_best=bool(return_best))
    if b.is_cuda:
        x, iters, rs = _launch(diag, off, b, x0, **kw)
        fused_bicgstab_mb.launches += 1
    elif b.device.type == "cpu":
        x, iters, rs = fused_bicgstab_plain(diag, off, b, x0, **kw)
    else:
        raise ValueError(
            f"fused_bicgstab_mb runs on CUDA or CPU tensors, not {b.device}")
    # an all-zero RHS over EVERY component gives a zero solution
    b_zero = torch.all(b == 0)
    x = torch.where(b_zero, torch.zeros_like(x), x)
    conv_c = rs <= tol2
    info = SolveInfo(
        converged=conv_c.all() | b_zero,
        iterations=iters.max(),
        residual=torch.sqrt(rs.sum() / (n_lane * C)),
    )
    return (x,), info


fused_bicgstab_mb.launches = 0
