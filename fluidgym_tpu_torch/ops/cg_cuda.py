"""K1: whole-solve lockstep Jacobi-PCG on single-block stencil systems.

Counterpart of ``fluidgym_tpu/ops/cg_pallas.py`` (TPU kernel ``_kernel``,
entry ``fused_cg``).  The CUDA kernel (``csrc/cg.cu``) runs the entire
Krylov loop of every lane in one launch: no host round-trip per iteration.

* ``fused_cg`` is the wrapper.  For CUDA tensors it launches the kernel and
  adds one to ``fused_cg.launches``; for CPU tensors it runs
  ``fused_cg_plain``; any other device raises.  There is no fallback.
* ``fused_cg_plain`` is the plain PyTorch version with the same lockstep
  semantics (one iteration counter shared by the lanes of a chunk; frozen
  lanes keep getting the 100-iteration true-residual refresh).
  ``fused_cg_plain.calls`` counts its runs.

Lane folding and chunking (counterpart of ``cg_pallas._lane_solver``, its
``custom_vmap`` rule and its ``lax.map`` over chunks): the solve runs
through ``LaneFold``, a ``torch.autograd.Function`` whose ``vmap`` rule
folds a ``torch.func.vmap`` batch onto the lane axis, so a batch of envs
costs one launch.  Any number of lanes is taken: they split into lockstep
chunks of ``chunk`` lanes (``default_chunk``), which the card runs side by
side, one thread block each, in that one launch, and the plain version runs
one after another.  Per-lane freeze makes a lane's solution independent of
its chunk mates up to a frozen lane reactivated by the refresh; the shared
iteration count is the chunk's.

Bound on the H100 and what the design does about it: see the note at the
top of ``csrc/cg.cu``.
"""

from __future__ import annotations

import functools
import math

import torch

from fluidgym_tpu_torch.ops import _build
from fluidgym_tpu_torch.solver.linsolve import SolveInfo

__all__ = ["fused_cg", "fused_cg_plain", "cg_lockstep", "roll_matvec",
           "tol2_sum_f32", "guard", "MAX_LANES", "LaneFold", "default_chunk",
           "lockstep_chunks"]

_TINY = 1e-30
MAX_LANES = 64  # FG_MAX_LANES in csrc/krylov.cuh: lanes of one thread block


def default_chunk(lanes: int, device) -> int:
    """Lanes per lockstep chunk.  On the card ``ceil(lanes / min(lanes,
    SMs))`` (at most ``MAX_LANES``): as many chunks as there are SMs, so one
    launch fills the card and every chunk waits only for its own slowest
    lane.  On the CPU 1, the card's layout up to its SM count (the plain
    versions run the chunks in turn): a batched lane then solves exactly as
    the same system alone."""
    device = torch.device(device)
    if device.type != "cuda" or lanes < 1:
        return 1
    return min(MAX_LANES, -(-lanes // min(lanes, _sm_count(device))))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lockstep_chunks(solve, chunk: int | None, b, x0, *ops):
    """``solve(b, x0, *ops) -> (x, iterations, residual_sum)`` over
    consecutive chunks of ``chunk`` lanes, concatenated: the plain form of
    the kernels' chunk grid (one chunk when ``chunk`` is None).  ``b`` and
    ``x0`` (or None) are cut into chunks, and so is every operator tensor
    with a leading lane axis; one with a leading axis of 1 (or None) is
    shared by every chunk."""
    lanes = b.shape[0]
    chunk = lanes if chunk is None else int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    cut = lambda t, sl: None if t is None else t[sl]
    share = lambda t, sl: t if t is None or t.shape[0] == 1 else t[sl]
    outs = []
    for i in range(0, lanes, chunk):
        sl = slice(i, min(i + chunk, lanes))
        outs.append(solve(b[sl], cut(x0, sl), *(share(t, sl) for t in ops)))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


class LaneFold(torch.autograd.Function):
    """``LaneFold.apply(solve, n_lane, *operands)`` calls ``solve(*operands)
    -> (x, iterations, residual_sum)``.  The first ``n_lane`` operands carry
    a leading lane axis (``b``, ``x0``); the rest are the operator (``diag``,
    ``off``, ...), whose leading axis is 1 (shared by the lanes) or lanes.
    ``None`` operands pass through.

    Under ``torch.func.vmap`` the ``vmap`` rule (the counterpart of
    ``cg_pallas._lane_solver``'s ``custom_vmap`` rule) broadcasts unbatched
    operands to the batch, folds batch x lanes onto the lane axis, calls
    ``solve`` once on the folded tensors (the chunked launch on the card, the
    plain lockstep version on the CPU) and unfolds.  An operator that is
    unbatched and shared stays shared.  ``solve`` must only be reached
    through here from vmapped code: a kernel wrapper cannot take a batched
    tensor."""

    generate_vmap_rule = False

    @staticmethod
    def forward(solve, n_lane, *operands):
        return solve(*operands)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, solve, n_lane, *operands):
        B = info.batch_size
        dims = in_dims[2:]
        front = [None if t is None else
                 (t.unsqueeze(0) if d is None else t.movedim(d, 0))
                 for t, d in zip(operands, dims)]
        L = front[0].shape[1]
        ops = [(t, d) for t, d in zip(front[n_lane:], dims[n_lane:])
               if t is not None]
        shared = all(d is None and t.shape[1] == 1 for t, d in ops)
        folded = []
        for i, t in enumerate(front):
            if t is None or (i >= n_lane and shared):
                folded.append(None if t is None else t[0])
                continue
            t = t.expand((B, L) + tuple(t.shape[2:]))
            folded.append(t.reshape((B * L,) + tuple(t.shape[2:])))
        x, iters, rs = solve(*folded)
        return ((x.reshape((B, L) + tuple(x.shape[1:])), iters.reshape(B, L),
                 rs.reshape(B, L)), (0, 0, 0))


def device_kind(b: torch.Tensor, what: str) -> str:
    """``"cuda"`` or ``"cpu"`` for ``b``'s device; any other device
    raises."""
    if b.is_cuda:
        return "cuda"
    if b.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{what} runs on CUDA or CPU tensors, not {b.device}")


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
        # a NaN residual counts as frozen (it never holds the chunk either)
        done = ~(rs > tol2_sum) | stalled
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
                   return_best: bool, chunk: int | None = None):
    """Plain PyTorch K1 on ``(lanes, *spatial)`` tensors (``diag``: lanes or
    1 leading; ``off``: ``(lanes or 1, 2*ndims, *spatial)``), in lockstep
    chunks of ``chunk`` lanes (one chunk when None).  Returns ``(x,
    iterations (lanes,), residual_sum (lanes,))``."""
    fused_cg_plain.calls += 1

    def solve(b, x0, d, o):
        return cg_lockstep(lambda v: roll_matvec(d, o, v, ndims), d, b, x0,
                           tol2_sum=tol2_sum, maxiter=maxiter,
                           stall_iters=stall_iters, precondition=precondition,
                           return_best=return_best)

    return lockstep_chunks(solve, chunk, b, x0, diag, off)


fused_cg_plain.calls = 0


def check_chunk(lanes: int, chunk: int) -> None:
    """The kernels take any lane count, in chunks of 1..MAX_LANES lanes."""
    if lanes < 1 or not 1 <= chunk <= MAX_LANES:
        raise ValueError(f"the CUDA kernels take lanes >= 1 in chunks of "
                         f"1..{MAX_LANES}, got {lanes} lanes, chunk {chunk}")


def _launch(diag, off, b, x0, *, ndims, tol2_sum, maxiter, stall_iters,
            precondition, return_best, chunk):
    L = b.shape[0]
    spatial = tuple(b.shape[1:])
    check_chunk(L, chunk)
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
            p.data_ptr(), q.data_ptr(), best.data_ptr(), L, chunk, nz, ny, nx,
            ndims, op_per_lane, tol2_sum, int(maxiter), int(stall_iters),
            int(precondition), int(return_best), int(x0 is not None), stream)
    _build.check(status, "fused_cg")
    return x, iters, rs


def fused_cg(diag, off, b, x0=None, *, ndims: int, tol: float,
             maxiter: int = 5000, stall_iters: int = 250,
             precondition: bool = True, return_best: bool = True,
             chunk: int | None = None):
    """Whole-solve lockstep CG over ``lanes`` single-block systems.

    ``b``/``x0``: ``(lanes, *spatial)``.  ``diag``: ``(*spatial)`` shared by
    the lanes, or ``(lanes, *spatial)``; ``off`` likewise with a
    ``2*ndims`` face axis after the lane axis.  ``chunk``: lanes per
    lockstep chunk (``default_chunk`` when None).  Returns ``(x,
    SolveInfo)`` with per-lane ``(lanes,)`` info; the iteration count is the
    lane's chunk's.  A lane whose RHS is all zero gets a zero solution.
    Under ``torch.func.vmap`` the batch folds onto the lanes (``LaneFold``)."""
    L = b.shape[0]
    if diag.dim() == ndims:
        diag = diag.unsqueeze(0)
        off = off.unsqueeze(0)
    n = math.prod(b.shape[1:])
    tol2 = tol2_sum_f32(tol, n, b.dtype)
    kw = dict(ndims=ndims, tol2_sum=tol2, maxiter=int(maxiter),
              stall_iters=int(stall_iters), precondition=bool(precondition),
              return_best=bool(return_best))

    def solve(b, x0, diag, off):
        c = default_chunk(b.shape[0], b.device) if chunk is None else chunk
        if device_kind(b, "fused_cg") == "cpu":
            return fused_cg_plain(diag, off, b, x0, chunk=c, **kw)
        out = _launch(diag, off, b, x0, chunk=c, **kw)
        fused_cg.launches += 1
        return out

    x, iters, rs = LaneFold.apply(solve, 2, b, x0, diag, off)
    b_zero = (b == 0).reshape(L, -1).all(dim=1)
    x = torch.where(b_zero.reshape((L,) + (1,) * ndims), torch.zeros_like(x), x)
    converged = (rs <= tol2) | b_zero
    return x, SolveInfo(converged=converged, iterations=iters,
                        residual=torch.sqrt(rs / n))


fused_cg.launches = 0
