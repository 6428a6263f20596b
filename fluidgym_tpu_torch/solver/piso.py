"""PISO time integration, main-path subset (counterpart of
``fluidgym_tpu/solver/piso.py``).

* ``piso_substep_info``: scalar advection solve -> velocity prediction
  solve -> ``corrector_steps`` pressure corrections with the FD velocity
  correction, hooks at the JAX package's phase names; on curvilinear
  domains (``non_orthogonal``) the cross-diffusion matrix terms and the
  deferred RHS corrections (one pressure pass per corrector, the JAX
  package's 2D setting);
* pressure warm starts: the previous pressure (``pressure_warm_start``)
  and/or the coarse-space deflation guess (``pressure_deflation``: per-block
  constant + linear modes, ``W E^+ W^T``, or the aggregation space below),
  self-gated on the device;
* the aggregation coarse space of the pressure solve
  (``pressure_coarse_tile``, ``pressure_coarse_precondition``): the tile
  indicators of every block, the Galerkin matrix ``E = W^T A W`` built once
  from the state at reset (``build_agg_coarse``), ``M^-1 r = D^-1 r + W
  Einv W^T r`` inside the merged pressure kernel (K3-agg / K3-agg-flip) and
  ``W Einv W^T`` in the deflation guess;
* ``piso_adaptive_step_info``: CFL-driven substepping that reproduces the
  JAX ``lax.while_loop`` (same ``eps`` cut-off, ``max_substeps``, substep
  count and dt sequence).  The loop runs on the host and reads the
  remaining time once per substep -- the one host sync per substep;
* ``single_step_info`` / ``single_step`` and ``make_divergence_free``;
* ``batched_step_info``: one sim step of a batch of states (a leading
  batch axis on every tensor of the state), the counterpart of ``jax.vmap``
  over ``single_step_info``: the substep runs under ``torch.func.vmap``
  (every solve folds the batch onto its kernel's lanes), and the adaptive
  loop runs outside it over per-lane ``remaining`` and substep counts, with
  one host sync per lockstep round;
* the differentiable path (``SimConfig.differentiable``, the JAX package's
  default): every solve an implicit-function solve (``_ImplicitSolve``,
  the counterpart of ``lax.custom_linear_solve``) whose backward is one
  transposed solve on the same kernels, the masked adaptive loop of
  ``diff_adaptive_max_substeps``, and ``piso_fixed_steps`` with optional
  checkpointing.

Solves dispatch as in the JAX package's non-differentiable ``_solve``, to
the whole-solve kernels: single-block scalar stencils to K1 ``fused_cg``
(pressure) and K2 ``fused_bicgstab_mb`` over ``trivial_plan`` (advection);
multi-block topologies with a ``merge_plan`` (identity or flip seams) to
K3 ``fused_cg_mb`` and K2 in its merged form.  Anything else takes the
plain loops of ``linsolve``, on CPU tensors only: on the card a system no
kernel takes raises.

Opt-in levers ported: ``pressure_coarse_strips`` (the strip-coarse
preconditioner inside K3), ``advection_upwind_blend`` (the upwind blend
of the velocity advection matrix) and the aggregation coarse space above.

Deliberate difference in the aggregation space: the JAX package keeps the
Galerkin data in a process-global FIFO cache keyed by the operator's
static fields, and on a miss falls back to the constant + linear space.
Here ``build_agg_coarse`` returns an ``AggCoarse`` that the env keeps and
hands the solver on its ``SimConfig`` (``pressure_agg``), built on every
path that sets the state (reset and ``load_initial_domain``) and reused
while the operator's key and viscosity hold; a substep without it, or with
the data of another operator, raises.  Deliberate difference on the
differentiable path: the transposed advection solve runs on K2 over
``stencil.transpose_ops`` (the same kernel and plan as the forward solve),
where the JAX package runs an XLA ``linsolve.bicgstab`` loop on the
transposed matvec.  Not ported yet: the differentiable batched step,
extra inner non-orthogonal pressure passes (3D), the full-mode
non-orthogonal pressure solve and the JAX package's other opt-in solver
levers (no ``SimConfig`` field for them).
"""

from __future__ import annotations

import contextlib
import functools
import math
import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.autograd.function import once_differentiable

from fluidgym_tpu_torch.core.domain import (
    BlockGeom,
    BoundKind,
    DomainState,
    DomainTopo,
    state_from_leaves,
    state_leaves,
)
from fluidgym_tpu_torch.solver import block_merge, linsolve, nonortho
from fluidgym_tpu_torch.solver import stencil as st

Tensor = torch.Tensor

__all__ = ["SimConfig", "Hooks", "StepInfo", "ADAPTIVE", "AggCoarse",
           "piso_substep_info", "piso_adaptive_step_info",
           "piso_fixed_steps", "piso_fixed_steps_info",
           "single_step", "single_step_info", "batched_step_info",
           "strict_vmap", "make_divergence_free", "combine_infos",
           "solver_info_dict", "build_pressure_ops_like_substep",
           "build_agg_coarse", "ensure_agg_coarse", "agg_coarse_fn"]

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
    this port's main paths read, with the same defaults."""

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
    # upwind blend of the VELOCITY advection matrix (stencil.
    # build_advection_ops): 0 = central face interpolation, 1 = first-order
    # upwind; the scalar system stays central, as in the JAX package
    advection_upwind_blend: float = 0.0
    non_orthogonal: bool = False
    max_substeps: int = 1000
    # True: every solve is an implicit-function solve (_ImplicitSolve, the
    # JAX package's lax.custom_linear_solve), reverse-differentiable; the
    # env families that take it pass it (FluidEnv(differentiable=)), the
    # RL path runs with False (warm-started advection, no graph)
    differentiable: bool = True
    pressure_precondition: bool = True
    pressure_deflation: bool = False
    warm_start: bool = True
    pressure_warm_start: bool = False
    pressure_stall_iters: int = 250
    # the strip-coarse correction inside the merged pressure kernel
    # (K3-coarse, solver/coarse_strips.py); only solves routed through the
    # merged kernel take it, others ignore it (as in the JAX package)
    pressure_coarse_strips: bool = False
    # the additive two-level pressure preconditioner D^-1 r + W Einv W^T r
    # over the aggregation space of tile^ndims index-space tiles of every
    # block (pressure_coarse_tile > 0); the tile space also replaces the
    # constant + linear space of the deflation guess
    pressure_coarse_precondition: bool = False
    pressure_coarse_tile: int = 0
    # the aggregation data of this config's operator (build_agg_coarse; the
    # env builds it at reset): not part of the config's identity
    pressure_agg: Any = field(default=None, compare=False, hash=False,
                              repr=False)
    # the bound on CFL substeps per cfg.dt of the differentiable adaptive
    # loop (the JAX package's masked lax.scan length); the last substeps
    # stretch past the CFL limit where the loop would not finish in time
    diff_adaptive_max_substeps: int = 8

    def __post_init__(self):
        if self.velocity_corrector not in ("FD",):
            raise NotImplementedError(
                "only the FD velocity corrector is implemented")
        if self.pressure_coarse_precondition and self.pressure_coarse_tile <= 0:
            raise NotImplementedError(
                "pressure_coarse_precondition without pressure_coarse_tile: "
                "only the aggregation coarse space is ported")


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
    """Gate of the single-block kernels (K1 ``ops.cg_cuda.fused_cg`` and K2
    over ``trivial_plan``): one block, no CONNECTED face, and a scalar (not
    channel-shaped) stencil.  The kernels' wrappers check dtype and device
    themselves."""
    if len(topo.blocks) != 1:
        return False
    if any(f.kind == BoundKind.CONNECTED for f in topo.blocks[0].faces):
        return False
    return ops[0].diag.dim() == topo.ndims


def _merged_plan(ops, topo: DomainTopo):
    """Gate of the merged kernels (K3 ``ops.cg_cuda_mb.fused_cg_mb`` and K2
    in merged form): a scalar stencil over a multi-block topology whose
    ``merge_plan`` exists, with identity or flip (reflected, C-grid) seams,
    in 2D or 3D (CylinderJet3D's extruded O-grid: identity seams, periodic
    z).  Returns the plan or None.

    Deliberate difference: the JAX package's default ``"auto"`` mode
    declines flip-seam plans (``_fused_cg_mb_plan``/``_fused_bicg_mb_plan``)
    and solves them with ``linsolve`` over the blocks.  Here every main-path
    solve on the card goes through a kernel, so flip plans take K3 and K2 in
    merged form too.  The merged operator is an exact permutation of the
    blockwise one, so the iterates agree up to rounding."""
    if len(topo.blocks) < 2 or ops[0].diag.dim() != topo.ndims:
        return None
    return block_merge.merge_plan(topo)


def _fused_bicg_mb_solve(mplan, ops, b, topo: DomainTopo, *, tol, maxiter,
                         stall_iters, precondition, return_best, x0):
    """Pack (optionally component-leading) block fields into the merged
    frame of ``mplan``, run K2, and unpack."""
    from fluidgym_tpu_torch.ops import cg_cuda_mb

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
           x0=None, x0_fn=None, precondition=False, stall_iters=250,
           coarse_strips=False, agg=None, differentiable=False):
    """Global linear solve over all blocks: CG for the SPD pressure system
    (``symmetric``), else BiCGStab.  ``x0``: the initial guess (a warm
    start); ``x0_fn(b)``: a guess computed from the right-hand side (the
    deflation guess), which takes precedence.  ``coarse_strips``: the
    strip-coarse preconditioner, on the merged pressure kernel only
    (K3-coarse; K1 takes none, as the JAX package's ``fused_cg``).
    ``agg``: an ``AggCoarse``, the aggregation coarse space added to the
    preconditioner, on the merged pressure kernel only (K3-agg; a system
    without a merge plan raises).  Returns ``(x, SolveInfo)``.

    ``differentiable``: the JAX package's ``lax.custom_linear_solve`` path
    (``_ImplicitSolve``): the same kernels solve on detached operands, and
    the backward is one transposed solve plus the coefficient gradients.
    As in the JAX package's diff mode, the guesses carry no gradient, the
    pressure's warm start is gated by one matvec (``|b - A x0|^2 <=
    |b|^2``, else zero), the advection solve starts cold, and the info is
    ``linsolve.posthoc_info`` (``iterations = -1``).  It takes no coarse
    space (``coarse_strips`` or ``agg`` raise)."""

    def mv(xs):
        return st.domain_apply(ops, xs, topo)

    if differentiable and (coarse_strips or agg is not None):
        raise NotImplementedError(
            "the differentiable solve with a coarse space (strips or "
            "aggregation) is not ported to fluidgym_tpu_torch yet (ROADMAP "
            "Queue 1 item 4)")
    dtype = b[0].dtype
    tol_resolved = tol if tol is not None else linsolve.default_tolerance(dtype)
    single = agg is None and _kernel_operand_ok(ops, topo)
    mplan = None if single else _merged_plan(ops, topo)
    if agg is not None and agg.plan != mplan:
        raise NotImplementedError(
            "the aggregation coarse space runs in the merged pressure solve "
            "only: this system has no merge plan, or the data was built for "
            "another one")
    if b[0].is_cuda and not single and mplan is None:
        raise NotImplementedError(
            "no CUDA kernel for this system (no merge plan, or a "
            "channel-shaped stencil); the plain Krylov loops run on CPU "
            "tensors only")
    kw = dict(tol=tol_resolved, maxiter=maxiter, stall_iters=stall_iters,
              precondition=precondition, return_best=return_best)

    def run(ops, b, x0, symmetric):
        """One solve of ``ops`` (A, or A^T for the transposed advection
        solve) from ``x0`` through the kernels (their plain versions on CPU
        tensors; ``linsolve``'s loops where no kernel takes the system)."""
        if symmetric and single:
            from fluidgym_tpu_torch.ops import cg_cuda

            x1, inf = cg_cuda.fused_cg(
                ops[0].diag, ops[0].off, b[0].unsqueeze(0),
                None if x0 is None else x0[0].unsqueeze(0),
                ndims=topo.ndims, **kw)
            return (x1[0],), linsolve.SolveInfo(
                converged=inf.converged[0], iterations=inf.iterations[0],
                residual=inf.residual[0])
        if symmetric and mplan is not None:
            from fluidgym_tpu_torch.ops import cg_cuda_mb

            mops = block_merge.pack_ops(mplan, ops)
            xs, inf = cg_cuda_mb.fused_cg_mb(
                mplan, tuple(m[0] for m in mops), tuple(m[1] for m in mops),
                block_merge.pack_fields(mplan, b),
                x0s=None if x0 is None else block_merge.pack_fields(mplan, x0),
                coarse_strips=coarse_strips,
                **(kw if agg is None else dict(kw, agg=agg.space)))
            return block_merge.unpack_fields(mplan, xs), inf
        if single or mplan is not None:
            return _fused_bicg_mb_solve(
                block_merge.trivial_plan(topo) if single else mplan, ops, b,
                topo, x0=x0, **kw)
        precond_fn = None
        if precondition:
            inv_diag = tuple(1.0 / op.diag for op in ops)

            def precond_fn(rs):
                return tuple(d * r for d, r in zip(inv_diag, rs))

        loop = linsolve.cg if symmetric else linsolve.bicgstab
        return loop(lambda xs: st.domain_apply(ops, xs, topo), b, x0=x0,
                    tol=tol, maxiter=maxiter, return_best=return_best,
                    precond=precond_fn, stall_iters=stall_iters)

    if not differentiable:
        return run(ops, b, x0_fn(b) if x0_fn is not None else x0, symmetric)

    def guess(ops, bb):
        """The JAX package's ``diff_guess``: the deflation guess of ``bb``,
        or the warm start where one matvec shows it no worse than zero;
        None for the advection solve (cold)."""
        if not symmetric:
            return None
        if x0_fn is not None:
            return x0_fn(bb)
        if x0 is None:
            return None
        g = tuple(t.detach() for t in x0)
        r = tuple(y - ay for y, ay in zip(bb, st.domain_apply(ops, g, topo)))
        ok = (sum(torch.sum(rr * rr) for rr in r)
              <= sum(torch.sum(y * y) for y in bb))
        return tuple(torch.where(ok, gg, torch.zeros_like(gg)) for gg in g)

    def solve(ops, bb):
        return run(ops, bb, guess(ops, bb), symmetric)[0]

    def solve_t(ops, ct):
        if symmetric:
            return solve(ops, ct)
        return run(st.transpose_ops(ops, topo), ct, None, False)[0]

    n = len(ops)
    x = _ImplicitSolve.apply(
        _Adjoint(solve, solve_t, topo, n),
        *(op.diag for op in ops), *(op.off for op in ops), *b)
    return tuple(x), linsolve.posthoc_info(mv, b, x, tol_resolved)


class _Adjoint(NamedTuple):
    """What ``_ImplicitSolve`` runs: ``solve(ops, b)`` and the transposed
    ``solve_t(ops, ct)`` (both on detached operands, no graph), over the
    ``nblocks`` blocks of ``topo``."""

    solve: Callable
    solve_t: Callable
    topo: DomainTopo
    nblocks: int


def _detached_ops(diags, offs) -> tuple:
    return tuple(st.StencilOp(diag=d.detach(), off=o.detach())
                 for d, o in zip(diags, offs))


class _ImplicitSolve(torch.autograd.Function):
    """``x = A^-1 b`` with the implicit-function VJP, the counterpart of
    ``lax.custom_linear_solve``: ``_ImplicitSolve.apply(adj, *diags,
    *offs, *bs) -> xs`` (per block).  The forward is ``adj.solve`` on
    detached operands (a kernel launch, never a recorded Krylov loop); the
    backward solves ``A^T lam = g`` (``adj.solve_t``: the same SPD solve,
    or K2 on ``stencil.transpose_ops``), and returns ``lam`` for ``b`` and
    the VJP of ``domain_apply(ops, x)`` at ``-lam`` for the coefficients.
    No gradient reaches a guess or a coarse space."""

    @staticmethod
    def forward(ctx, adj: _Adjoint, *tensors):
        n = adj.nblocks
        ops = _detached_ops(tensors[:n], tensors[n:2 * n])
        xs = tuple(adj.solve(ops, tuple(t.detach() for t in tensors[2 * n:])))
        ctx.adj = adj
        ctx.save_for_backward(*tensors[:2 * n], *xs)
        return xs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        adj = ctx.adj
        n = adj.nblocks
        saved = ctx.saved_tensors
        ops = _detached_ops(saved[:n], saved[n:2 * n])
        xs = saved[2 * n:]
        cts = tuple(torch.zeros_like(x) if g is None else g
                    for g, x in zip(grads, xs))
        lam = tuple(adj.solve_t(ops, cts))
        gd = go = (None,) * n
        if any(ctx.needs_input_grad[1:2 * n + 1]):
            gd, go = st.coefficient_vjp(ops, xs, tuple(-l for l in lam),
                                        adj.topo)
        return (None, *gd, *go, *lam)


# ---------------------------------------------------------------------------
# coarse-space deflation of the pressure warm start
# ---------------------------------------------------------------------------

def _deflation_basis(topo: DomainTopo, dtype, device) -> list[Tensor]:
    """Per-block [constant, per-axis linear ramp] deflation vectors:
    ``W[b]`` is ``(k, *block_shape)`` with ``k = nblocks * (ndims + 1)``
    columns (fewer where an axis is periodic), each supported on one
    block."""
    nblocks = len(topo.blocks)
    cols: list[tuple[Tensor, ...]] = []
    for b, bt in enumerate(topo.blocks):
        shp = bt.shape
        nd = len(shp)
        modes = [torch.ones(shp, dtype=dtype, device=device)]
        for ax in range(nd):
            # a ramp is discontinuous across a periodic seam: no such mode
            if bt.faces[2 * (nd - 1 - ax)].kind == BoundKind.PERIODIC:
                continue
            ramp = torch.linspace(-1.0, 1.0, shp[ax], dtype=dtype, device=device)
            modes.append(ramp.reshape((1,) * ax + (-1,) + (1,) * (nd - 1 - ax))
                         .expand(shp))
        for m in modes:
            cols.append(tuple(
                m if bb == b else torch.zeros(topo.blocks[bb].shape,
                                              dtype=dtype, device=device)
                for bb in range(nblocks)))
    return [torch.stack([c[b] for c in cols]) for b in range(nblocks)]


def _make_coarse_solver(p_ops, topo: DomainTopo, dtype):
    """Coarse-space solve ``r -> W E^+ W^T r`` over the deflation basis;
    ``E = W^T A W`` from the k basis columns applied as one batch."""
    device = p_ops[0].diag.device
    Wstack = _deflation_basis(topo, dtype, device)
    k = Wstack[0].shape[0]
    AW = st.domain_apply(p_ops, tuple(Wstack), topo)  # leading axis: columns
    E = sum(w.reshape(k, -1) @ aw.reshape(k, -1).T for w, aw in zip(Wstack, AW))
    # the global constant lies in the operator nullspace -> E is singular;
    # normalize symmetrically and pseudo-invert
    d = 1.0 / torch.sqrt(torch.abs(torch.diagonal(E)) + 1e-30)
    En_inv = torch.linalg.pinv(E * d[:, None] * d[None, :], rtol=1e-5)
    Wflat = [w.reshape(k, -1) for w in Wstack]

    def coarse(r):
        rhs_c = sum(w @ rr.reshape(-1) for w, rr in zip(Wflat, r))
        c = d * (En_inv @ (d * rhs_c))
        return tuple((c @ w).reshape(rr.shape) for w, rr in zip(Wflat, r))

    return coarse


def _make_deflation_x0(p_ops, topo: DomainTopo, dtype, coarse=None):
    """``x0_fn(b, base=None)`` for the pressure solves of one substep:
    without ``base`` the coarse solution ``W E^+ W^T b``; with ``base`` the
    coarse-corrected guess ``base + W E^+ W^T (b - A base)``, self-gated:
    the base is used only when ``||b - A base|| <= ||b||`` (a device-side
    ``torch.where``, no host sync), else the pure coarse start.
    ``coarse``: the coarse solve (the aggregation space's,
    ``agg_coarse_fn``); None: the constant + linear space's."""
    if coarse is None:
        coarse = _make_coarse_solver(p_ops, topo, dtype)

    def x0_fn(b, base=None):
        if base is None:
            return coarse(b)
        Abase = st.domain_apply(p_ops, base, topo)
        rb = tuple(bb - ab for bb, ab in zip(b, Abase))
        use_base = (sum(torch.sum(r * r) for r in rb)
                    <= sum(torch.sum(bb * bb) for bb in b))
        sel = tuple(torch.where(use_base, ba, torch.zeros_like(ba)) for ba in base)
        r = tuple(torch.where(use_base, rr, bb) for rr, bb in zip(rb, b))
        return tuple(ss + cc for ss, cc in zip(sel, coarse(r)))

    return x0_fn


# ---------------------------------------------------------------------------
# the aggregation coarse space
# ---------------------------------------------------------------------------

class AggCoarse(NamedTuple):
    """The aggregation coarse space of one pressure operator
    (``build_agg_coarse``).  ``space`` is the merged frame's view for the
    pressure kernel (``cg_cuda_mb.AggSpace``), and holds the tile count
    ``K`` and ``einv = diag(d) pinv(diag(d) E diag(d)) diag(d)``, folded in
    float64 and cast to the solve dtype: ``W einv W^T`` is the JAX
    package's ``W d (E_n^+ (d W^T r))``."""

    key: tuple          # (topo, tile, dt, upwind blend, non_orthogonal)
    nu: float           # the viscosity E was built at
    specs: tuple        # _agg_tile_specs
    tile: int
    tile_ids: tuple     # per block (*shape) int64: each cell's tile
    plan: Any           # block_merge.merge_plan(topo)
    space: Any          # cg_cuda_mb.AggSpace


def _agg_key(topo: DomainTopo, cfg: SimConfig) -> tuple:
    """Every static field that defines the pressure operator (the JAX
    package's cache key)."""
    return (topo, int(cfg.pressure_coarse_tile), float(cfg.dt),
            float(cfg.advection_upwind_blend), bool(cfg.non_orthogonal))


def _agg_tile_specs(topo: DomainTopo, tile: int):
    """Per block ``(block_shape, coarse_shape, flat_offset)`` of the
    ceil-division tile aggregation, and the coarse dimension k: remainder
    cells form a smaller tail tile per axis."""
    specs, k = [], 0
    for bt in topo.blocks:
        shp = tuple(bt.shape)
        cshp = tuple(-(-n // tile) for n in shp)
        specs.append((shp, cshp, k))
        k += math.prod(cshp)
    return tuple(specs), k


def _agg_restrict(rs, specs, tile: int) -> Tensor:
    """``W^T r``: per block, pad to tile multiples, sum each tile, and
    concatenate (row-major tiles); any leading axes of ``rs`` are kept."""
    parts = []
    for r, (shp, cshp, _off) in zip(rs, specs):
        lead = r.shape[:r.dim() - len(shp)]
        pad = []
        for n, c in zip(reversed(shp), reversed(cshp)):
            pad += [0, c * tile - n]
        rp = torch.nn.functional.pad(r, pad)
        rp = rp.reshape(lead + tuple(x for c in cshp for x in (c, tile)))
        nl = len(lead)
        rp = rp.sum(dim=tuple(nl + 1 + 2 * a for a in range(len(shp))))
        parts.append(rp.reshape(lead + (-1,)))
    return torch.cat(parts, dim=-1)


def _agg_prolong(c: Tensor, specs, tile: int):
    """``W c``: per block, its tiles' values repeated over their cells and
    cropped to the block; any leading axes of ``c`` are kept."""
    lead = c.shape[:-1]
    outs = []
    for shp, cshp, off in specs:
        cb = c[..., off:off + math.prod(cshp)].reshape(lead + cshp)
        for ax in range(len(shp)):
            cb = torch.repeat_interleave(cb, tile, dim=len(lead) + ax)
        outs.append(cb[(Ellipsis,) + tuple(slice(0, n) for n in shp)])
    return tuple(outs)


def agg_tile_ids(specs, tile: int, device) -> list:
    """Each block's cells' tile (``_agg_tile_specs``), flat over all blocks
    (row-major tiles: the order of ``_agg_restrict`` and ``_agg_prolong``):
    per block ``(*shape)`` int64 on ``device``."""
    tile_ids = []
    for shp, cshp, off in specs:
        grids = np.meshgrid(*[np.arange(n) // tile for n in shp],
                            indexing="ij")
        tile_ids.append(torch.from_numpy(
            np.ravel_multi_index(tuple(grids), cshp) + off).to(device))
    return tile_ids


def build_pressure_ops_like_substep(state: DomainState, geoms, topo: DomainTopo,
                                    cfg: SimConfig):
    """The pressure operator as ``piso_substep_info`` assembles it (the
    advection diagonal, with the non-orthogonal matrix terms, into
    ``build_pressure_ops``) at the state's fields and ``cfg.dt``."""
    dtype = state.blocks[0].velocity.dtype
    nu = state.viscosity
    dt = torch.tensor(cfg.dt, dtype=dtype, device=state.blocks[0].velocity.device)
    adv_ops = st.build_advection_ops(state, geoms, topo, nu, dt,
                                     upwind=cfg.advection_upwind_blend)
    if cfg.non_orthogonal:
        nus = tuple(torch.ones_like(g.det) * st._block_nu(state, b, nu, False)
                    for b, g in enumerate(geoms))
        adv_ops = nonortho.apply_matrix_terms(
            adv_ops, geoms, topo, nus, det_divide=True, field="velocity")
    return st.build_pressure_ops(tuple(op.diag for op in adv_ops), geoms, topo)


def build_agg_coarse(state: DomainState, geoms, topo: DomainTopo,
                     cfg: SimConfig, *, chunk: int = 64) -> AggCoarse:
    """The aggregation coarse space of ``cfg.pressure_coarse_tile`` from the
    state's pressure operator (``build_pressure_ops_like_substep``), as the
    JAX package's ``ensure_agg_coarse_cache`` builds it: E row by row from
    ``chunk`` indicator columns at a time (``domain_apply`` over a leading
    column axis, then the restriction), in the solve dtype; then in float64
    symmetrized, ``d = 1 / sqrt(|diag E| + 1e-30)`` and the pseudo-inverse
    of ``diag(d) E diag(d)`` with numpy's ``rcond = 1e-7``.  The space runs
    in the merged pressure solve only: a topology without a merge plan
    raises."""
    from fluidgym_tpu_torch.ops import cg_cuda_mb

    tile = int(cfg.pressure_coarse_tile)
    if tile <= 0:
        raise ValueError("build_agg_coarse needs pressure_coarse_tile > 0")
    plan = block_merge.merge_plan(topo) if len(topo.blocks) > 1 else None
    if plan is None:
        raise NotImplementedError(
            "the aggregation coarse space runs in the merged pressure solve "
            "only, and this topology has no merge plan")
    specs, k = _agg_tile_specs(topo, tile)
    blk0 = state.blocks[0].pressure
    dtype, device = blk0.dtype, blk0.device
    with torch.no_grad():
        p_ops = build_pressure_ops_like_substep(state, geoms, topo, cfg)
        tile_ids = agg_tile_ids(specs, tile, device)
        E = np.zeros((k, k), np.float64)
        for c0 in range(0, k, chunk):
            js = torch.arange(c0, min(c0 + chunk, k), device=device)
            cols = tuple((m[None] == js.reshape((-1,) + (1,) * m.dim()))
                         .to(dtype) for m in tile_ids)
            rows = _agg_restrict(st.domain_apply(p_ops, cols, topo), specs, tile)
            E[c0:c0 + len(js)] = rows.double().cpu().numpy()
    # the rows are operator columns restrict(A W e_j): an identity only for
    # a symmetric operator, so symmetrize (as the JAX package)
    E = 0.5 * (E + E.T)
    d = 1.0 / np.sqrt(np.abs(np.diagonal(E)) + 1e-30)
    En_inv = np.linalg.pinv(E * d[:, None] * d[None, :], rcond=1e-7)
    einv = torch.from_numpy(d[:, None] * En_inv * d[None, :]).to(device, dtype)
    return AggCoarse(key=_agg_key(topo, cfg), nu=float(state.viscosity),
                     specs=specs, tile=tile, tile_ids=tuple(tile_ids),
                     plan=plan,
                     space=cg_cuda_mb.agg_space(plan, tuple(tile_ids), einv))


def ensure_agg_coarse(prev: AggCoarse | None, state: DomainState, geoms,
                      topo: DomainTopo, cfg: SimConfig) -> AggCoarse | None:
    """``prev`` while it holds for this operator (the same key and a
    viscosity within 1e-6 relative, as the JAX package reuses its cache
    entry), else ``build_agg_coarse`` anew; None without a tile space."""
    if cfg.pressure_coarse_tile <= 0:
        return None
    nu = float(state.viscosity)
    if (prev is not None and prev.key == _agg_key(topo, cfg)
            and abs(prev.nu - nu) <= 1e-6 * max(abs(nu), 1e-30)):
        return prev
    return build_agg_coarse(state, geoms, topo, cfg)


def agg_coarse_fn(agg: AggCoarse):
    """The coarse solve ``r -> W einv W^T r`` over the blocks (the JAX
    package's ``_agg_coarse_from_cache``); the matrix product is
    ``torch.matmul``."""
    def coarse(rs):
        rc = _agg_restrict(rs, agg.specs, agg.tile)
        return _agg_prolong(agg.space.einv @ rc, agg.specs, agg.tile)

    return coarse


def _agg_for(cfg: SimConfig, topo: DomainTopo) -> AggCoarse | None:
    """The aggregation data a substep of ``cfg`` uses; raises where the
    config asks for the tile space and holds no data of this operator."""
    if cfg.pressure_coarse_tile <= 0:
        return None
    agg = cfg.pressure_agg
    if agg is None or agg.key != _agg_key(topo, cfg):
        raise ValueError(
            "pressure_coarse_tile needs the aggregation data of this operator "
            "on SimConfig.pressure_agg (piso.build_agg_coarse; FluidEnv "
            "builds it at reset)")
    return agg


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
        if cfg.non_orthogonal:
            ones = tuple(torch.ones_like(g.det) for g in geoms)
            ops = nonortho.apply_matrix_terms(
                ops, geoms, topo, tuple(o * kappa for o in ones),
                det_divide=True, field="scalar", scalar_channel=c)
            S = nonortho.deferred_rhs(
                tuple(blk.scalar[c] for blk in state.blocks), geoms, topo,
                ones, field="scalar",
                bval_fn=lambda b, f, _c=c: state.blocks[b].faces[f].scalar[_c],
                scalar_channel=c)
            rhs = tuple(r - s * kappa / g.det for r, s, g in zip(rhs, S, geoms))
        res, s_info = _solve(
            ops, rhs, topo,
            tol=cfg.advection_tol, maxiter=cfg.advection_maxiter,
            symmetric=False, return_best=False,
            x0=tuple(blk.scalar[c] for blk in state.blocks)
            if cfg.warm_start else None,
            differentiable=cfg.differentiable,
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
    adv_ops = st.build_advection_ops(state, geoms, topo, nu, dt,
                                     upwind=cfg.advection_upwind_blend)
    vel_rhs = st.advection_rhs_velocity(state, geoms, topo, nu, dt)
    if cfg.non_orthogonal:
        # per-cell viscosity reaches the cross-diffusion terms too
        nus = tuple(torch.ones_like(g.det) * st._block_nu(state, b, nu, False)
                    for b, g in enumerate(geoms))
        adv_ops = nonortho.apply_matrix_terms(
            adv_ops, geoms, topo, nus, det_divide=True, field="velocity")
        # deferred correction per velocity component, from the pre-step field
        S_comps = [nonortho.deferred_rhs(
            tuple(blk.velocity[d] for blk in state.blocks), geoms, topo, nus,
            field="velocity",
            bval_fn=lambda b, f, _d=d: state.blocks[b].faces[f].velocity[_d],
            boundary_visc=nu) for d in range(topo.ndims)]
        vel_rhs = tuple(
            vel_rhs[b] - torch.stack([S_comps[d][b] for d in range(topo.ndims)],
                                     dim=0) / geoms[b].det
            for b in range(nblocks))
    state = _run_hooks(hooks, "POST_VELOCITY_SETUP", state, time_step=dt)
    u_star, v_info = _solve(
        adv_ops, vel_rhs, topo,
        tol=cfg.advection_tol, maxiter=cfg.advection_maxiter,
        symmetric=False, return_best=False,
        x0=tuple(blk.velocity for blk in state.blocks)
        if cfg.warm_start else None,
        differentiable=cfg.differentiable,
    )
    info = info._replace(
        advection_converged=info.advection_converged & v_info.converged)

    # ---- corrector loop --------------------------------------------------
    # the pressure matrix stays orthogonal (exactly SPD); all non-orthogonal
    # pressure coupling is deferred to the RHS (flux form)
    adiags = tuple(op.diag for op in adv_ops)
    p_ops = st.build_pressure_ops(adiags, geoms, topo)
    inv_a = tuple(1.0 / a for a in adiags)
    pressures = tuple(blk.pressure for blk in state.blocks)
    agg = _agg_for(cfg, topo)
    # the guess's setup carries no gradient (the JAX package stop-gradients
    # it): the solution does not depend on the guess
    defl = (_make_deflation_x0(_detached_ops([o.diag for o in p_ops],
                                             [o.off for o in p_ops]),
                               topo, dtype,
                               None if agg is None else agg_coarse_fn(agg))
            if cfg.pressure_deflation else None)
    p_agg = agg if cfg.pressure_coarse_precondition else None
    for _corrector in range(cfg.corrector_steps):
        hbyA = st.pressure_rhs_vec(state, geoms, topo, adv_ops, u_star, nu, dt)
        div = st.divergence_of(hbyA, state, geoms, topo)
        if cfg.non_orthogonal:
            # deferred pressure correction from the previous iterate
            Sp = nonortho.deferred_rhs_flux(pressures, geoms, topo, inv_a)
            div = tuple(d + sp for d, sp in zip(div, Sp))
        if cfg.pressure_time_step_normalized:
            div = tuple(d / dt for d in div)
        # p_ops is the sign-flipped (positive definite) Poisson operator
        rhs_p = tuple(-d for d in div)
        if cfg.normalize_pressure_result:
            # solvability projection for the singular all-Neumann system
            rhs_mean = _global_mean(rhs_p)
            rhs_p = tuple(r - rhs_mean for r in rhs_p)
        base = pressures if cfg.pressure_warm_start else None
        pressures, p_info = _solve(
            p_ops, rhs_p, topo,
            tol=cfg.pressure_tol, maxiter=cfg.pressure_maxiter,
            symmetric=True,
            return_best=cfg.pressure_return_best_result,
            x0=base if defl is None else None,
            x0_fn=None if defl is None else functools.partial(defl, base=base),
            differentiable=cfg.differentiable,
            precondition=cfg.pressure_precondition,
            stall_iters=cfg.pressure_stall_iters,
            coarse_strips=cfg.pressure_coarse_strips,
            agg=p_agg,
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
    0-d tensor).

    With ``cfg.differentiable`` the JAX package's masked ``lax.scan``: at
    most ``cfg.diff_adaptive_max_substeps`` substeps, substep ``i`` of ``n``
    taking ``max(cfl_ts, remaining / (n - i))`` (the last ones stretch past
    the CFL limit rather than drop time), ``remaining`` clamped at 0; a
    finished iteration is the identity, so the loop stops there.  ``ts``
    stays in the graph, as in the JAX package."""
    blk0 = state.blocks[0].velocity
    dtype, device = blk0.dtype, blk0.device
    time_target = torch.as_tensor(time_target, dtype=dtype, device=device)
    eps = 1e-6 * time_target
    remaining = time_target
    info = _info_identity(dtype, device)
    if cfg.differentiable:
        n_scan = cfg.diff_adaptive_max_substeps
        for i in range(n_scan):
            if bool(remaining <= eps):
                break
            ts = torch.maximum(_cfl_ts(state, geoms, topo, cfg, remaining),
                               remaining / (n_scan - i))
            state, si = piso_substep_info(state, geoms, topo, cfg, ts, hooks)
            if dt_log is not None:
                dt_log.append(ts)
            remaining = torch.clamp(remaining - ts, min=0.0)
            info = _info_merge(info, si)
        return state, info
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


def piso_fixed_steps_info(state: DomainState, geoms: tuple[BlockGeom, ...],
                          topo: DomainTopo, cfg: SimConfig, dt, n_steps: int,
                          hooks: Hooks | None = None,
                          use_remat: bool = False):
    """``n_steps`` uniform substeps of size ``dt``, reverse-differentiable
    (the JAX package's ``lax.scan``); returns ``(state, StepInfo)``.
    ``use_remat``: each substep runs under
    ``torch.utils.checkpoint.checkpoint`` (``use_reentrant=False``, the
    counterpart of ``jax.checkpoint``), which keeps only the substep's
    inputs and runs it again in the backward: its solves launch their
    kernels again, and being deterministic return the same x."""
    blk0 = state.blocks[0].velocity
    dt = torch.as_tensor(dt, dtype=blk0.dtype, device=blk0.device)
    info = _info_identity(blk0.dtype, blk0.device)

    def substep(s):
        return piso_substep_info(s, geoms, topo, cfg, dt, hooks)

    for _ in range(n_steps):
        if use_remat:
            state, si = torch.utils.checkpoint.checkpoint(
                substep, state, use_reentrant=False)
        else:
            state, si = substep(state)
        info = _info_merge(info, si)
    return state, info


def piso_fixed_steps(state, geoms, topo, cfg, dt, n_steps: int, hooks=None,
                     use_remat: bool = False) -> DomainState:
    """``piso_fixed_steps_info`` without the info."""
    return piso_fixed_steps_info(state, geoms, topo, cfg, dt, n_steps, hooks,
                                 use_remat)[0]


@contextlib.contextmanager
def strict_vmap():
    """Within: ``torch.func.vmap``'s per-lane fallback for an op without a
    batching rule (which it announces with a "performance drop" warning)
    raises instead, so a batched step never quietly loops over its lanes."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


def _lane_where(active: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """Per lane of the leading batch axis: ``new`` where ``active``, else
    ``old``."""
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def batched_step_info(state: DomainState, geoms: tuple[BlockGeom, ...],
                      topo: DomainTopo, cfg: SimConfig,
                      hooks: Hooks | None = None):
    """One env-level simulation step of length ``cfg.dt`` for a batch of
    states: every tensor of ``state`` carries a leading batch axis of B
    lanes.  Returns the new batched state and a ``StepInfo`` of ``(B,)``
    tensors.

    The substep runs under ``torch.func.vmap``, so each solve folds the
    batch onto the lanes of its kernel (one launch per solve for all B).
    With adaptive substeps the loop is the semantics of ``jax.vmap`` over
    ``piso_adaptive_step_info``'s ``lax.while_loop``, run on the host over
    per-lane ``remaining`` and substep counts: while any lane is active (one
    host sync per lockstep round), every lane takes its CFL substep, then
    finished lanes keep their state and info (``where(active, new,
    old)``).  Each lane gets the dt sequence its single env would."""
    if cfg.pressure_coarse_tile:
        raise NotImplementedError(
            "the aggregation coarse space is not ported to the batched step")
    if cfg.differentiable:
        raise NotImplementedError(
            "the differentiable batched step is not ported to "
            "fluidgym_tpu_torch yet (ROADMAP Queue 1 item 4)")
    leaves = state_leaves(state)
    blk0 = state.blocks[0].velocity
    B, dtype, device = blk0.shape[0], blk0.dtype, blk0.device

    def substep(lv, ts):
        s, si = piso_substep_info(state_from_leaves(state, lv), geoms, topo,
                                  cfg, ts, hooks)
        return state_leaves(s), si

    def cfl(lv, remaining):
        return _cfl_ts(state_from_leaves(state, lv), geoms, topo, cfg, remaining)

    vsub = torch.func.vmap(substep)
    dt = torch.full((B,), cfg.dt, dtype=dtype, device=device)
    info = StepInfo(*(v.expand(B).clone()
                      for v in _info_identity(dtype, device)))
    with strict_vmap():
        if cfg.substeps != ADAPTIVE:
            for _ in range(cfg.substeps):
                leaves, si = vsub(leaves, dt / cfg.substeps)
                info = _info_merge(info, si)
            return state_from_leaves(state, leaves), info
        vcfl = torch.func.vmap(cfl)
        eps = 1e-6 * dt
        remaining = dt
        it = torch.zeros(B, dtype=torch.int32, device=device)
        while True:
            active = (remaining > eps) & (it < cfg.max_substeps)
            if not bool(active.any()):
                break
            ts = vcfl(leaves, remaining)
            new, si = vsub(leaves, ts)
            leaves = [_lane_where(active, n, o) for n, o in zip(new, leaves)]
            remaining = torch.where(active, remaining - ts, remaining)
            info = StepInfo(*(torch.where(active, m, o) for m, o in
                              zip(_info_merge(info, si), info)))
            it = it + active.to(it.dtype)
    return state_from_leaves(state, leaves), info


def make_divergence_free(state: DomainState, geoms: tuple[BlockGeom, ...],
                         topo: DomainTopo, cfg: SimConfig,
                         iterations: int | None = None, maxiter: int = 1000,
                         hooks: Hooks | None = None) -> DomainState:
    """Pressure-project the current velocity to divergence free (A=1, dt=1,
    hbyA = velocity).  On curvilinear configs each projection takes two
    inner passes: the deferred non-orthogonal pressure coupling enters the
    RHS from the previous pass's pressure (cold-started solves)."""
    if iterations is None:
        iterations = 1
    n_inner = 2 if cfg.non_orthogonal else 1
    nblocks = len(topo.blocks)
    blk0 = state.blocks[0].velocity
    one = torch.tensor(1.0, dtype=blk0.dtype, device=blk0.device)
    adiags = tuple(torch.ones_like(g.det) for g in geoms)
    p_ops = st.build_pressure_ops(adiags, geoms, topo)
    for _ in range(iterations):
        state = _run_hooks(hooks, "PRE", state, time_step=one)
        hbyA = tuple(blk.velocity for blk in state.blocks)
        div0 = st.divergence_of(hbyA, state, geoms, topo)
        proj_p = tuple(torch.zeros_like(blk.pressure) for blk in state.blocks)
        for _inner in range(n_inner):
            div = div0
            if cfg.non_orthogonal:
                Sp = nonortho.deferred_rhs_flux(proj_p, geoms, topo, adiags)
                div = tuple(d + sp for d, sp in zip(div0, Sp))
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
                coarse_strips=cfg.pressure_coarse_strips,
                differentiable=cfg.differentiable,
            )
            if cfg.normalize_pressure_result:
                mean = _global_mean(pressures)
                pressures = tuple(p - mean for p in pressures)
            proj_p = pressures
        vel = st.correct_velocity_fd(
            hbyA, pressures, adiags, geoms, topo, one,
            time_step_normalized=cfg.pressure_time_step_normalized)
        for b in range(nblocks):
            state = state.replace_block(
                b, replace(state.blocks[b], velocity=vel[b], pressure=pressures[b]))
    return state
