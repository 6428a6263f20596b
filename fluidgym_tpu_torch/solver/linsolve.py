"""Matrix-free Krylov solvers (CG / BiCGStab) with the JAX package's
convergence semantics (counterpart of ``fluidgym_tpu/solver/linsolve.py``).

* convergence ``NORM2_NORMALIZED``: ||r||_2 / sqrt(n) <= tol;
* an all-zero RHS gives a zero solution;
* ``return_best``: the iterate with the lowest residual is returned when the
  solve does not converge;
* stall patience: stop when the best residual has not improved for
  ``stall_iters`` iterations;
* CG refreshes the true residual every 100 iterations (spending that
  iteration's single matvec on A@x instead of A@p);
* default tolerances 1e-5 (fp32) / 1e-8 (fp64).

These are the unbatched loops: one solve, the stopping test read on the
host once per iteration.  The hot path of the env does not come here: its
single-block solves run in the whole-solve kernels of ``ops/`` (no host
round-trip per iteration).  Vectors are tensors or tuples of tensors (one
per block).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

Tensor = torch.Tensor

__all__ = ["SolveInfo", "default_tolerance", "posthoc_info", "cg", "bicgstab"]


class SolveInfo(NamedTuple):
    """Result metadata (tensors, left on the solve's device)."""

    converged: Tensor     # bool
    iterations: Tensor    # int32
    residual: Tensor      # final (or best) normalized residual


def default_tolerance(dtype) -> float:
    return 1e-8 if dtype == torch.float64 else 1e-5


def posthoc_info(matvec: Callable, b, x, tol: float) -> SolveInfo:
    """Convergence metadata recomputed from a returned iterate (the
    differentiable solve, whose inner solves report none; counterpart of
    the JAX package's ``piso._posthoc_info``): one matvec at the detached
    ``x``, ``residual`` the RMSE of ``b - A x`` over every component,
    ``converged = residual <= tol``, ``iterations = -1`` (not tracked).
    Nothing here enters the gradient."""
    with torch.no_grad():
        bt = _tup(b)
        r = tuple(bb - ax for bb, ax in zip(
            bt, _tup(matvec(tuple(xx.detach() for xx in _tup(x))))))
        n = sum(bb.numel() for bb in bt)
        rmse = torch.sqrt(_vdot(r, r) / n)
    return SolveInfo(
        converged=rmse <= tol,
        iterations=torch.tensor(-1, dtype=torch.int32, device=bt[0].device),
        residual=rmse.to(bt[0].dtype),
    )


def _tup(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def _vdot(a: Sequence[Tensor], b: Sequence[Tensor]) -> Tensor:
    out = None
    for x, y in zip(a, b):
        s = torch.sum(x * y)
        out = s if out is None else out + s
    return out


def _guard(x: Tensor, tiny: float) -> Tensor:
    return torch.where(x.abs() < tiny, torch.full_like(x, tiny), x)


def _finish(x, rs, converged_rs, best_x, best_rs, b, n, it, return_best,
            like):
    dev = b[0].device
    converged = rs <= converged_rs
    if return_best and not bool(converged):
        x, rs = best_x, best_rs
    b_zero = all(bool(torch.all(bb == 0)) for bb in b)
    if b_zero:
        x = tuple(torch.zeros_like(xx) for xx in x)
    info = SolveInfo(
        converged=torch.as_tensor(bool(converged) or b_zero, device=dev),
        iterations=torch.as_tensor(it, dtype=torch.int32, device=dev),
        residual=torch.sqrt(rs / n),
    )
    return (x if isinstance(like, (tuple, list)) else x[0]), info


def cg(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float | None = None,
    maxiter: int = 5000,
    return_best: bool = True,
    precond: Callable | None = None,
    stall_iters: int = 250,
):
    """(Preconditioned) conjugate gradients on an SPD matrix-free operator.
    ``matvec``/``precond`` take and return the same structure as ``b``."""
    like = b
    bt = _tup(b)
    wrap = (lambda v: v) if isinstance(like, (tuple, list)) else (lambda v: v[0])
    mv = lambda v: _tup(matvec(wrap(v)))
    pc = (lambda v: _tup(precond(wrap(v)))) if precond is not None else (lambda v: v)
    dt = bt[0].dtype
    if tol is None:
        tol = default_tolerance(dt)
    n = sum(x.numel() for x in bt)
    tol2_sum = (tol * tol) * n
    tiny = 1e-30

    if x0 is None:
        x = tuple(torch.zeros_like(bb) for bb in bt)
        r = bt
    else:
        x = _tup(x0)
        r = tuple(bb - ax for bb, ax in zip(bt, mv(x)))
    z = pc(r)
    p = z
    rz = _vdot(r, z)
    rs = _vdot(r, r)
    best_x, best_rs, best_it, it = x, rs, 0, 0
    while it < maxiter and float(rs) > tol2_sum and it - best_it < stall_iters:
        recompute = (it + 1) % 100 == 0
        Av = mv(x if recompute else p)
        denom = _vdot(p, Av)
        alpha = torch.zeros_like(rz) if recompute else rz / _guard(denom, tiny)
        x = tuple(alpha * pp + xx for pp, xx in zip(p, x))
        if recompute:
            r = tuple(bb - av for bb, av in zip(bt, Av))
        else:
            r = tuple(-alpha * av + rr for av, rr in zip(Av, r))
        z = pc(r)
        rz_new = _vdot(r, z)
        rs = _vdot(r, r)
        beta = rz_new / _guard(rz, tiny)
        p = tuple(zz + beta * pp for zz, pp in zip(z, p))
        rz = rz_new
        it += 1
        if float(rs) < float(best_rs):
            best_x, best_rs, best_it = x, rs, it
    return _finish(x, rs, tol2_sum, best_x, best_rs, bt, n, it, return_best,
                   like)


def bicgstab(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float | None = None,
    maxiter: int = 5000,
    return_best: bool = True,
    stall_iters: int = 250,
    precond: Callable | None = None,
):
    """BiCGStab for non-symmetric matrix-free operators, with an optional
    RIGHT preconditioner (``r`` stays the true residual)."""
    like = b
    bt = _tup(b)
    wrap = (lambda v: v) if isinstance(like, (tuple, list)) else (lambda v: v[0])
    mv = lambda v: _tup(matvec(wrap(v)))
    pc = (lambda v: _tup(precond(wrap(v)))) if precond is not None else (lambda v: v)
    dt = bt[0].dtype
    if tol is None:
        tol = default_tolerance(dt)
    n = sum(x.numel() for x in bt)
    tol2_sum = (tol * tol) * n
    tiny = 1e-30

    if x0 is None:
        x = tuple(torch.zeros_like(bb) for bb in bt)
        r = bt
    else:
        x = _tup(x0)
        r = tuple(bb - ax for bb, ax in zip(bt, mv(x)))
    r_hat = r
    rho = _vdot(r_hat, r)
    p = r
    rs = _vdot(r, r)
    best_x, best_rs, best_it, it = x, rs, 0, 0
    while it < maxiter and float(rs) > tol2_sum and it - best_it < stall_iters:
        p_hat = pc(p)
        v = mv(p_hat)
        alpha = rho / _guard(_vdot(r_hat, v), tiny)
        s = tuple(-alpha * vv + rr for vv, rr in zip(v, r))
        s_hat = pc(s)
        t = mv(s_hat)
        tt = _vdot(t, t)
        omega = _vdot(t, s) / _guard(tt, tiny)
        x = tuple(xx + alpha * ph + omega * sh
                  for xx, ph, sh in zip(x, p_hat, s_hat))
        r = tuple(-omega * tt_ + ss for tt_, ss in zip(t, s))
        rho_new = _vdot(r_hat, r)
        beta = (rho_new / _guard(rho, tiny)) * (alpha / _guard(omega, tiny))
        p = tuple(rr + beta * (pp - omega * vv) for rr, pp, vv in zip(r, p, v))
        rho = rho_new
        rs = _vdot(r, r)
        it += 1
        if float(rs) < float(best_rs):
            best_x, best_rs, best_it = x, rs, it
    return _finish(x, rs, tol2_sum, best_x, best_rs, bt, n, it, return_best,
                   like)
