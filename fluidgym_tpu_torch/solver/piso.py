"""PISO time integration, main-path subset (counterpart of
``fluidgym_tpu/solver/piso.py``).

* ``piso_substep_info``: scalar advection solve -> velocity prediction
  solve -> ``corrector_steps`` pressure corrections with the FD velocity
  correction, hooks at the JAX package's phase names;
* ``piso_adaptive_step_info``: CFL-driven substepping that reproduces the
  JAX ``lax.while_loop`` (same ``eps`` cut-off, ``max_substeps``, substep
  count and dt sequence).  The loop runs on the host and reads the
  remaining time once per substep -- the one host sync per substep;
* ``single_step_info`` / ``single_step`` and ``make_divergence_free``.

Solves dispatch as in the JAX package's non-differentiable ``_solve``:
single-block scalar stencils go to the whole-solve kernels (K1 ``fused_cg``
for the SPD pressure system, K2 ``fused_bicgstab_mb`` over ``trivial_plan``
for the advection systems); anything else takes the plain loops of
``linsolve``.  The gate is about validity only (one block, no CONNECTED
face, a scalar stencil); the TPU's VMEM budget has no meaning here.  On the
card a system the gate rejects raises: the plain loops run on CPU tensors
only.

Not ported yet: the differentiable path and non-orthogonal corrections
(``SimConfig`` raises ``NotImplementedError`` for them), and the JAX
package's opt-in solver levers (no ``SimConfig`` field yet).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple

import torch

from fluidgym_tpu_torch.core.domain import (
    BlockGeom,
    BoundKind,
    DomainState,
    DomainTopo,
)
from fluidgym_tpu_torch.solver import linsolve
from fluidgym_tpu_torch.solver import stencil as st

Tensor = torch.Tensor

__all__ = ["SimConfig", "Hooks", "StepInfo", "ADAPTIVE",
           "piso_substep_info", "piso_adaptive_step_info",
           "single_step", "single_step_info", "make_divergence_free",
           "combine_infos", "solver_info_dict"]

Hooks = dict[str, tuple[Callable[..., DomainState], ...]]

ADAPTIVE = -1


class StepInfo(NamedTuple):
    """Solver-convergence metadata aggregated over a (sub)step (tensors on
    the state's device)."""

    pressure_converged: Tensor    # bool: AND over every pressure solve
    pressure_iterations: Tensor   # int32: total Krylov iterations
    pressure_residual: Tensor     # float: max normalized residual
    advection_converged: Tensor   # bool: AND over velocity/scalar solves


def _info_identity(dtype, device) -> StepInfo:
    return StepInfo(
        pressure_converged=torch.tensor(True, device=device),
        pressure_iterations=torch.tensor(0, dtype=torch.int32, device=device),
        pressure_residual=torch.tensor(0.0, dtype=dtype, device=device),
        advection_converged=torch.tensor(True, device=device),
    )


def _info_merge(a: StepInfo, b: StepInfo) -> StepInfo:
    return StepInfo(
        pressure_converged=a.pressure_converged & b.pressure_converged,
        pressure_iterations=a.pressure_iterations + b.pressure_iterations,
        pressure_residual=torch.maximum(a.pressure_residual, b.pressure_residual),
        advection_converged=a.advection_converged & b.advection_converged,
    )


def combine_infos(infos) -> StepInfo:
    """Collapse a sequence of ``StepInfo`` (e.g. one per sim step)."""
    out = infos[0]
    for si in infos[1:]:
        out = _info_merge(out, si)
    return out


def solver_info_dict(si: StepInfo) -> dict[str, Tensor]:
    """The env step ``info`` entries for solver health."""
    return {
        "pressure_converged": si.pressure_converged,
        "pressure_iterations": si.pressure_iterations,
        "pressure_residual": si.pressure_residual,
        "advection_converged": si.advection_converged,
    }


@dataclass(frozen=True)
class SimConfig:
    """Static solver configuration: the fields of the JAX ``SimConfig`` that
    this port's main path reads, with the same defaults.  The JAX package's
    other levers (deflation, coarse/multigrid preconditioners, pressure
    extrapolation and warm start, BiCGStab or full-mode pressure, upwind
    blending, refinement) are not ported yet and have no field here."""

    dt: float = 1.0
    substeps: int = 1  # ADAPTIVE (-1) or a positive count
    corrector_steps: int = 2
    adaptive_cfl: float = 0.8
    advection_tol: float | None = None
    pressure_tol: float | None = None
    advection_maxiter: int = 5000
    pressure_maxiter: int = 5000
    normalize_pressure_result: bool = True
    pressure_return_best_result: bool = False
    pressure_time_step_normalized: bool = False
    velocity_corrector: str = "FD"
    advect_passive_scalar: bool = True
    non_orthogonal: bool = False
    max_substeps: int = 1000
    differentiable: bool = True
    pressure_precondition: bool = True
    warm_start: bool = True
    pressure_stall_iters: int = 250

    def __post_init__(self):
        if self.velocity_corrector not in ("FD",):
            raise NotImplementedError(
                "only the FD velocity corrector is implemented")
        if self.differentiable:
            raise NotImplementedError(
                "SimConfig.differentiable: the differentiable path is not "
                "ported to fluidgym_tpu_torch yet")
        if self.non_orthogonal:
            raise NotImplementedError(
                "SimConfig.non_orthogonal: non-orthogonal corrections are "
                "not ported to fluidgym_tpu_torch yet")


def _run_hooks(hooks: Hooks | None, name: str, state: DomainState, **kw) -> DomainState:
    if hooks and name in hooks and hooks[name]:
        fns = hooks[name]
        if callable(fns):
            fns = (fns,)
        for fn in fns:
            state = fn(state, **kw)
    return state


# ---------------------------------------------------------------------------
# linear solves
# ---------------------------------------------------------------------------

def _kernel_operand_ok(ops, topo: DomainTopo) -> bool:
    """Dispatch gate of the whole-solve kernels (K1 ``ops.cg_cuda.fused_cg``
    and K2 ``ops.cg_cuda_mb.fused_bicgstab_mb``): one block, no CONNECTED
    face, and a scalar (not channel-shaped) stencil.  The kernels' wrappers
    check dtype and device themselves."""
    if len(topo.blocks) != 1:
        return False
    if any(f.kind == BoundKind.CONNECTED for f in topo.blocks[0].faces):
        return False
    return ops[0].diag.dim() == topo.ndims


def _fused_bicg_mb_solve(ops, b, topo: DomainTopo, *, tol, maxiter,
                         stall_iters, precondition, return_best, x0):
    """Pack (optionally component-leading) block fields into the merged
    frame of the trivial single-super-block plan, run K2, and unpack."""
    from fluidgym_tpu_torch.ops import cg_cuda_mb
    from fluidgym_tpu_torch.solver import block_merge

    mplan = block_merge.trivial_plan(topo)
    nblocks = len(topo.blocks)
    S = len(mplan.superblocks)
    chan = b[0].dim() - topo.ndims  # 0 (scalar) or 1 (components)
    C = b[0].shape[0] if chan else 1

    def pack(fields):
        if chan:
            per_c = [block_merge.pack_fields(mplan, tuple(f[c] for f in fields))
                     for c in range(C)]
            return tuple(torch.stack([per_c[c][s] for c in range(C)], dim=0)
                         for s in range(S))
        return tuple(p.unsqueeze(0) for p in block_merge.pack_fields(mplan, tuple(fields)))

    mops = block_merge.pack_ops(mplan, ops)
    xs, inf = cg_cuda_mb.fused_bicgstab_mb(
        mplan, tuple(m[0] for m in mops), tuple(m[1] for m in mops),
        pack(b), x0s=None if x0 is None else pack(x0),
        tol=tol, maxiter=maxiter, stall_iters=stall_iters,
        precondition=precondition, return_best=return_best)
    per_c = [block_merge.unpack_fields(mplan, tuple(x[c] for x in xs))
             for c in range(C)]
    if chan:
        res = tuple(torch.stack([per_c[c][bi] for c in range(C)], dim=0)
                    for bi in range(nblocks))
    else:
        res = tuple(per_c[0])
    return res, inf


def _solve(ops, b, topo: DomainTopo, *, tol, maxiter, symmetric, return_best,
           x0=None, precondition=False, stall_iters=250):
    """Non-differentiable global linear solve over all blocks: CG for the
    SPD pressure system (``symmetric``), else BiCGStab.  Returns ``(x,
    SolveInfo)``."""

    def mv(xs):
        return st.domain_apply(ops, xs, topo)

    dtype = b[0].dtype
    tol_resolved = tol if tol is not None else linsolve.default_tolerance(dtype)
    precond_fn = None
    if precondition:
        inv_diag = tuple(1.0 / op.diag for op in ops)

        def precond_fn(rs):
            return tuple(d * r for d, r in zip(inv_diag, rs))

    usable = _kernel_operand_ok(ops, topo)
    if b[0].is_cuda and not usable:
        raise NotImplementedError(
            "no CUDA kernel for this system yet (multi-block, CONNECTED faces "
            "or a channel-shaped stencil); the plain Krylov loops run on CPU "
            "tensors only")
    if symmetric:
        if usable:
            from fluidgym_tpu_torch.ops import cg_cuda

            x1, inf = cg_cuda.fused_cg(
                ops[0].diag, ops[0].off, b[0].unsqueeze(0),
                None if x0 is None else x0[0].unsqueeze(0),
                ndims=topo.ndims, tol=tol_resolved, maxiter=maxiter,
                stall_iters=stall_iters, precondition=precondition,
                return_best=return_best)
            return (x1[0],), linsolve.SolveInfo(
                converged=inf.converged[0], iterations=inf.iterations[0],
                residual=inf.residual[0])
        return linsolve.cg(mv, b, x0=x0, tol=tol, maxiter=maxiter,
                           return_best=return_best, precond=precond_fn,
                           stall_iters=stall_iters)

    if usable:
        return _fused_bicg_mb_solve(
            ops, b, topo, tol=tol_resolved, maxiter=maxiter,
            stall_iters=stall_iters, precondition=precondition,
            return_best=return_best, x0=x0)
    return linsolve.bicgstab(mv, b, x0=x0, tol=tol, maxiter=maxiter,
                             return_best=return_best, stall_iters=stall_iters,
                             precond=precond_fn)


def _global_mean(xs) -> Tensor:
    """Mean over the concatenation of all block arrays."""
    total = sum(torch.sum(x) for x in xs)
    count = sum(x.numel() for x in xs)
    return total / count


# ---------------------------------------------------------------------------
# PISO substep
# ---------------------------------------------------------------------------

def _advect_scalars(state: DomainState, geoms, topo: DomainTopo,
                    cfg: SimConfig, dt):
    """Implicit advection-diffusion solve of every passive-scalar channel
    with the velocity frozen.  Returns ``(state, converged)``."""
    nblocks = len(topo.blocks)
    new_scalars = [[] for _ in range(nblocks)]
    converged = torch.tensor(True, device=state.blocks[0].velocity.device)
    for c in range(topo.scalar_channels):
        kappa = state.scalar_diffusivity[c]
        ops = st.build_advection_ops(state, geoms, topo, kappa, dt,
                                     for_scalar=True, scalar_channel=c)
        rhs = st.advection_rhs_scalar(state, geoms, topo, kappa, dt, c)
        res, s_info = _solve(
            ops, rhs, topo,
            tol=cfg.advection_tol, maxiter=cfg.advection_maxiter,
            symmetric=False, return_best=False,
            x0=tuple(blk.scalar[c] for blk in state.blocks)
            if cfg.warm_start else None,
        )
        converged = converged & s_info.converged
        for b in range(nblocks):
            new_scalars[b].append(res[b])
    for b in range(nblocks):
        state = state.replace_block(
            b, replace(state.blocks[b], scalar=torch.stack(new_scalars[b], dim=0)))
    return state, converged


def piso_substep_info(state: DomainState, geoms: tuple[BlockGeom, ...],
                      topo: DomainTopo, cfg: SimConfig, dt,
                      hooks: Hooks | None = None) -> tuple[DomainState, StepInfo]:
    """One PISO substep advancing physical time ``dt`` (a 0-d tensor),
    returning the new state and the substep's ``StepInfo``."""
    nblocks = len(topo.blocks)
    dtype = state.blocks[0].velocity.dtype
    info = _info_identity(dtype, state.blocks[0].velocity.device)
    state = _run_hooks(hooks, "PRE", state, time_step=dt)

    # ---- scalar advection ------------------------------------------------
    if (cfg.advect_passive_scalar and topo.has_scalar
            and state.blocks[0].scalar is not None):
        state, sc_conv = _advect_scalars(state, geoms, topo, cfg, dt)
        info = info._replace(
            advection_converged=info.advection_converged & sc_conv)

    # ---- velocity prediction ---------------------------------------------
    state = _run_hooks(hooks, "PRE_VELOCITY_SETUP", state, time_step=dt)
    nu = state.viscosity
    adv_ops = st.build_advection_ops(state, geoms, topo, nu, dt)
    vel_rhs = st.advection_rhs_velocity(state, geoms, topo, nu, dt)
    state = _run_hooks(hooks, "POST_VELOCITY_SETUP", state, time_step=dt)
    u_star, v_info = _solve(
        adv_ops, vel_rhs, topo,
        tol=cfg.advection_tol, maxiter=cfg.advection_maxiter,
        symmetric=False, return_best=False,
        x0=tuple(blk.velocity for blk in state.blocks)
        if cfg.warm_start else None,
    )
    info = info._replace(
        advection_converged=info.advection_converged & v_info.converged)

    # ---- corrector loop --------------------------------------------------
    adiags = tuple(op.diag for op in adv_ops)
    p_ops = st.build_pressure_ops(adiags, geoms, topo)
    pressures = tuple(blk.pressure for blk in state.blocks)
    for _corrector in range(cfg.corrector_steps):
        hbyA = st.pressure_rhs_vec(state, geoms, topo, adv_ops, u_star, nu, dt)
        div = st.divergence_of(hbyA, state, geoms, topo)
        if cfg.pressure_time_step_normalized:
            div = tuple(d / dt for d in div)
        # p_ops is the sign-flipped (positive definite) Poisson operator;
        # every pressure solve starts cold, as in the JAX package's default
        rhs_p = tuple(-d for d in div)
        if cfg.normalize_pressure_result:
            # solvability projection for the singular all-Neumann system
            rhs_mean = _global_mean(rhs_p)
            rhs_p = tuple(r - rhs_mean for r in rhs_p)
        pressures, p_info = _solve(
            p_ops, rhs_p, topo,
            tol=cfg.pressure_tol, maxiter=cfg.pressure_maxiter,
            symmetric=True,
            return_best=cfg.pressure_return_best_result,
            precondition=cfg.pressure_precondition,
            stall_iters=cfg.pressure_stall_iters,
        )
        info = info._replace(
            pressure_converged=info.pressure_converged & p_info.converged,
            pressure_iterations=info.pressure_iterations
            + torch.clamp(p_info.iterations, min=0),
            pressure_residual=torch.maximum(info.pressure_residual,
                                            p_info.residual.to(dtype)),
        )
        if cfg.normalize_pressure_result:
            mean = _global_mean(pressures)
            pressures = tuple(p - mean for p in pressures)
        for b in range(nblocks):
            state = state.replace_block(
                b, replace(state.blocks[b], pressure=pressures[b]))
        state = _run_hooks(hooks, "POST_PRESSURE_RESULT", state, time_step=dt)
        pressures = tuple(blk.pressure for blk in state.blocks)
        u_star = st.correct_velocity_fd(
            hbyA, pressures, adiags, geoms, topo, dt,
            time_step_normalized=cfg.pressure_time_step_normalized)

    for b in range(nblocks):
        state = state.replace_block(
            b, replace(state.blocks[b], velocity=u_star[b], pressure=pressures[b]))
    state = _run_hooks(hooks, "POST", state, time_step=dt)
    return state, info


# ---------------------------------------------------------------------------
# adaptive substepping
# ---------------------------------------------------------------------------

def _cfl_ts(state, geoms, topo, cfg: SimConfig, remaining: Tensor) -> Tensor:
    max_vel = st.max_computational_velocity(state, geoms, topo)
    max_ts = torch.where(max_vel > 1e-30,
                         cfg.adaptive_cfl / torch.clamp(max_vel, min=1e-30),
                         remaining)
    substeps = torch.clamp(torch.ceil(remaining / max_ts), min=1.0)
    return remaining / substeps


def piso_adaptive_step_info(state: DomainState, geoms: tuple[BlockGeom, ...],
                            topo: DomainTopo, cfg: SimConfig, time_target,
                            hooks: Hooks | None = None,
                            dt_log: list | None = None):
    """Advance ``time_target`` with CFL-limited substeps: the JAX
    non-differentiable ``lax.while_loop`` (run while ``remaining > 1e-6 *
    time_target`` and fewer than ``max_substeps`` substeps were taken), in
    the solve dtype.  ``dt_log``, when given, receives each substep's dt (a
    0-d tensor)."""
    blk0 = state.blocks[0].velocity
    dtype, device = blk0.dtype, blk0.device
    time_target = torch.as_tensor(time_target, dtype=dtype, device=device)
    eps = 1e-6 * time_target
    remaining = time_target
    info = _info_identity(dtype, device)
    it = 0
    while it < cfg.max_substeps and bool(remaining > eps):
        ts = _cfl_ts(state, geoms, topo, cfg, remaining)
        state, si = piso_substep_info(state, geoms, topo, cfg, ts, hooks)
        if dt_log is not None:
            dt_log.append(ts)
        remaining = remaining - ts
        info = _info_merge(info, si)
        it += 1
    return state, info


def single_step_info(state: DomainState, geoms: tuple[BlockGeom, ...],
                     topo: DomainTopo, cfg: SimConfig,
                     hooks: Hooks | None = None, dt_log: list | None = None):
    """One env-level simulation step of physical length ``cfg.dt``."""
    blk0 = state.blocks[0].velocity
    dt = torch.tensor(cfg.dt, dtype=blk0.dtype, device=blk0.device)
    if cfg.substeps == ADAPTIVE:
        return piso_adaptive_step_info(state, geoms, topo, cfg, dt, hooks,
                                       dt_log=dt_log)
    sub = dt / cfg.substeps
    info = _info_identity(blk0.dtype, blk0.device)
    for _ in range(cfg.substeps):
        state, si = piso_substep_info(state, geoms, topo, cfg, sub, hooks)
        if dt_log is not None:
            dt_log.append(sub)
        info = _info_merge(info, si)
    return state, info


def single_step(state, geoms, topo, cfg, hooks=None) -> DomainState:
    return single_step_info(state, geoms, topo, cfg, hooks)[0]


def make_divergence_free(state: DomainState, geoms: tuple[BlockGeom, ...],
                         topo: DomainTopo, cfg: SimConfig,
                         iterations: int | None = None, maxiter: int = 1000,
                         hooks: Hooks | None = None) -> DomainState:
    """Pressure-project the current velocity to divergence free (A=1, dt=1,
    hbyA = velocity); orthogonal configs take one projection by default."""
    if iterations is None:
        iterations = 1
    nblocks = len(topo.blocks)
    blk0 = state.blocks[0].velocity
    one = torch.tensor(1.0, dtype=blk0.dtype, device=blk0.device)
    adiags = tuple(torch.ones_like(g.det) for g in geoms)
    p_ops = st.build_pressure_ops(adiags, geoms, topo)
    for _ in range(iterations):
        state = _run_hooks(hooks, "PRE", state, time_step=one)
        hbyA = tuple(blk.velocity for blk in state.blocks)
        div = st.divergence_of(hbyA, state, geoms, topo)
        rhs_p = tuple(-d for d in div)
        if cfg.normalize_pressure_result:
            rhs_mean = _global_mean(rhs_p)
            rhs_p = tuple(r - rhs_mean for r in rhs_p)
        pressures, _info = _solve(
            p_ops, rhs_p, topo,
            tol=cfg.pressure_tol, maxiter=maxiter,
            symmetric=True,
            return_best=cfg.pressure_return_best_result,
            precondition=cfg.pressure_precondition,
        )
        if cfg.normalize_pressure_result:
            mean = _global_mean(pressures)
            pressures = tuple(p - mean for p in pressures)
        vel = st.correct_velocity_fd(
            hbyA, pressures, adiags, geoms, topo, one,
            time_step_normalized=cfg.pressure_time_step_normalized)
        for b in range(nblocks):
            state = state.replace_block(
                b, replace(state.blocks[b], velocity=vel[b], pressure=pressures[b]))
    return state
