"""Matrix-free finite-volume stencil operators, single-block part
(counterpart of ``fluidgym_tpu/solver/stencil.py``).

Per-block stencil **coefficient tensors** (diagonal + one coefficient per
face) are built once per substep and applied matrix-free with shifted
multiplies.  The numerics are the JAX package's, line for line:

* advective face fluxes: central average of cell contravariant components
  ``flux_f = 0.5 * (C_P + C_N)``, ``C_d = det * (M^-1 u)_d``;
* implicit-Euler advection-diffusion matrix: ``diag = 1/dt + sum_f(0.5 *
  sign_f * flux_f + visc_f)/det (+ wall terms)``, ``off_f = (0.5 * sign_f *
  flux_f - visc_f)/det``, ``visc_f = 0.5*(alpha_P nu_P + alpha_N nu_N)``;
* FIXED faces: matrix entry removed; Dirichlet walls add ``2 nu alpha / det``
  to the diagonal and the matching sources to the RHS;
* pressure matrix (sign-flipped, positive definite): ``off_f = -0.5 *
  (alpha_P/A_P + alpha_N/A_N)``, ``diag = -sum_f off_f``, zero at FIXED faces;
* pressure RHS ``hbyA = (u_old/dt - H u* + S)/A``; divergence from
  contravariant face fluxes; FD velocity correction ``u = hbyA - (1/A) M^-T
  grad_xi p`` with one-sided differences at FIXED faces.

Layout invariants kept from the JAX package: the face order is
-x,+x,-y,+y[,-z,+z], and physical axis d is array axis ``rank-1-d`` (x is the
minor axis).  Every neighbour is a periodic roll: exact for interior cells
and PERIODIC faces, masked by ``off = 0`` (or overwritten) at FIXED faces.
At CONNECTED faces the rolled boundary layer is overwritten by a halo slab
gathered from the neighbour block and remapped into this block's axis
frame (``FaceSpec.axes``: transposes and flips); contravariant fluxes
across a same-side connection change sign.  Curvilinear blocks carry the
full inverse metric ``minv (*s, d, d)``.

The JAX package's opt-in fused stencil kernel is K4
(``ops/stencil_cuda.py``), behind the same default-off switch.  The
advection matrix takes the JAX package's optional upwind blend
(``build_advection_ops(upwind=)``, the velocity system of the high-Re
tiers).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fluidgym_tpu_torch.core.domain import (
    BCType,
    BlockGeom,
    BlockState,
    BlockTopo,
    BoundKind,
    DomainState,
    DomainTopo,
    FaceSpec,
    face_axis,
    face_sign,
)

Tensor = torch.Tensor
BlockVec = tuple  # tuple of per-block tensors

__all__ = [
    "StencilOp",
    "stencil_apply",
    "stencil_off_apply",
    "domain_apply",
    "domain_off_apply",
    "contravariant",
    "build_advection_ops",
    "advection_rhs_velocity",
    "advection_rhs_scalar",
    "build_pressure_ops",
    "pressure_rhs_vec",
    "divergence_of",
    "pressure_gradient",
    "correct_velocity_fd",
    "max_computational_velocity",
    "velocity_divergence",
]


@dataclass
class StencilOp:
    """Per-block matrix-free stencil: ``(A x)_i = diag_i x_i + sum_f off_f[i]
    * x_{neighbor_f(i)}``.  ``off`` has shape ``(2*ndims, *spatial)`` with face
    order -x,+x,-y,+y[,-z,+z]; coefficients are zero at prescribed faces."""

    diag: Tensor
    off: Tensor


# ---------------------------------------------------------------------------
# shift / slicing helpers
# ---------------------------------------------------------------------------

def _axis(rank: int, d: int) -> int:
    """Array axis of physical axis d for an array of given rank."""
    return rank - 1 - d


def _roll_nbr(x: Tensor, f: int) -> Tensor:
    """Face-f neighbour values by periodic roll (lower face -> i-1)."""
    d = face_axis(f)
    shift = 1 if f % 2 == 0 else -1
    return torch.roll(x, shift, dims=_axis(x.dim(), d))


def _face_slab(rank: int, f: int):
    """Index tuple selecting the slab of cells adjacent to face f."""
    d = face_axis(f)
    idx = [slice(None)] * rank
    idx[_axis(rank, d)] = slice(-1, None) if f % 2 else slice(0, 1)
    return tuple(idx)


def _slab(x: Tensor, f: int) -> Tensor:
    return x[_face_slab(x.dim(), f)]


def set_region(x: Tensor, idx, val) -> Tensor:
    """Functional ``x.at[idx].set(val)`` for an index of unit-step slices
    (optionally led by ``Ellipsis``), out of place: nested
    ``torch.slice_scatter``, one per cut axis, so that a batched ``val`` may
    land in an unbatched ``x`` under ``torch.func.vmap``.  The values are
    copied exactly, as an in-place write would."""
    idx = tuple(idx)
    if idx and idx[0] is Ellipsis:
        idx = (slice(None),) * (x.dim() - len(idx) + 1) + idx[1:]
    src = (val.to(x.dtype) if torch.is_tensor(val)
           else torch.tensor(val, dtype=x.dtype, device=x.device))
    src = src.expand(x[idx].shape)
    cut = [d for d, sl in enumerate(idx) if sl != slice(None)]
    if not cut:
        return src.clone()
    d = cut[0]
    start, end, step = idx[d].indices(x.shape[d])
    if step != 1:
        raise ValueError(f"set_region takes unit-step slices, got {idx}")
    if len(cut) > 1:
        inner = idx[:d] + (slice(None),) + idx[d + 1:]
        src = set_region(x.narrow(d, start, end - start), inner, src)
    return torch.slice_scatter(x, src, d, start, end)


_set = set_region


def _add(x: Tensor, idx, val) -> Tensor:
    """Functional ``x.at[idx].add(val)``, out of place like ``set_region``."""
    return set_region(x, idx, x[idx] + val)


def _slab_trailing(x: Tensor, f: int, n_trailing: int) -> Tensor:
    """Face slab of a tensor whose LAST ``n_trailing`` axes are non-spatial
    (e.g. ``minv (*s, d, d)``)."""
    rank = x.dim() - n_trailing
    idx = [slice(None)] * x.dim()
    ax = rank - 1 - face_axis(f)
    idx[ax] = slice(-1, None) if f % 2 else slice(0, 1)
    return x[tuple(idx)]


def _halo(other: Tensor, spec: FaceSpec, f: int, ndims: int) -> Tensor:
    """The neighbour block's boundary slab for this block's face ``f``,
    remapped into this block's axis frame.  ``other`` may carry leading
    channel axes; the result is shaped like this block's face slab."""
    if not spec.axes:
        raise ValueError("CONNECTED face is missing its axes mapping")
    rank = other.dim()
    a0, up0 = spec.axes[0] >> 1, spec.axes[0] & 1
    idx = [slice(None)] * rank
    idx[_axis(rank, a0)] = slice(-1, None) if up0 else slice(0, 1)
    slab = other[tuple(idx)]

    d = face_axis(f)
    src_for_my = {d: a0}
    for i in range(1, ndims):
        k = (d + i) % ndims
        ai, upi = spec.axes[i] >> 1, spec.axes[i] & 1
        if upi:
            slab = torch.flip(slab, dims=(_axis(rank, ai),))
        src_for_my[k] = ai
    perm = list(range(rank))
    for k, a in src_for_my.items():
        perm[_axis(rank, k)] = _axis(rank, a)
    return slab.permute(perm)


def _neighbor_field(xs: BlockVec, b: int, f: int, topo: DomainTopo) -> Tensor:
    """Neighbour values of ``xs[b]`` across face f, with the CONNECTED halo."""
    nbr = _roll_nbr(xs[b], f)
    spec = topo.blocks[b].faces[f]
    if spec.kind == BoundKind.CONNECTED:
        vals = _halo(xs[spec.connected_block], spec, f, topo.ndims)
        nbr = _set(nbr, _face_slab(nbr.dim(), f), vals)
    return nbr


def _halo_axis_component(per_axis: BlockVec, spec: FaceSpec, f: int,
                         ndims: int) -> Tensor:
    """Halo of an axis-indexed quantity (e.g. alpha ``(d, *s)``) taken along
    the neighbour's face-normal axis (this face's axis maps to
    ``axes[0] >> 1`` there)."""
    a0 = spec.axes[0] >> 1
    return _halo(per_axis[spec.connected_block][a0], spec, f, ndims)


# ---------------------------------------------------------------------------
# operator application
# ---------------------------------------------------------------------------

def stencil_apply(op: StencilOp, x: Tensor, ndims: int) -> Tensor:
    """Single-block apply (no CONNECTED faces)."""
    out = op.diag * x
    for f in range(2 * ndims):
        out = out + op.off[f] * _roll_nbr(x, f)
    return out


def stencil_off_apply(op: StencilOp, x: Tensor, ndims: int) -> Tensor:
    """Single-block off-diagonal apply (the reference's ``H u*``)."""
    out = torch.zeros_like(x * op.diag)
    for f in range(2 * ndims):
        out = out + op.off[f] * _roll_nbr(x, f)
    return out


def _halo_layer(xs: BlockVec, b: int, f: int, topo: DomainTopo) -> Tensor:
    """Boundary-neighbour layer of nbr_f(x): the CONNECTED halo slab, or the
    wrapped opposite layer (PERIODIC; FIXED layers are masked by off = 0)."""
    spec = topo.blocks[b].faces[f]
    if spec.kind == BoundKind.CONNECTED:
        return _halo(xs[spec.connected_block], spec, f, topo.ndims)
    return _slab(xs[b], f ^ 1)


def domain_apply(ops: tuple[StencilOp, ...], xs: BlockVec,
                 topo: DomainTopo) -> BlockVec:
    """Multi-block apply with halo exchange at CONNECTED faces.

    With ``ops.stencil_cuda.set_stencil_kernel(True)``, a 2D apply of scalar
    stencils (``diag (ny, nx)``) to fields of at most one leading axis goes
    through K4, one launch per block, after gathering the four halo layers.
    The JAX package gates its kernel on ``all(x.ndim == 2)``: scalar fields,
    and under its vmap over the deflation columns each column.  Here the
    columns are written out as a leading axis of ``(k, ny, nx)``, which K4
    takes as k columns of the shared stencil; on the card's main path those
    (the deflation setup) and the scalar warm-start gates are the only
    callers.  The one apply with a leading velocity-component axis is the
    matvec of ``linsolve``'s loops, which run on CPU tensors only: there the
    column form computes the roll formulation's numbers bit for bit."""
    from fluidgym_tpu_torch.ops import stencil_cuda

    if (stencil_cuda.stencil_kernel_enabled() and topo.ndims == 2
            and all(op.diag.dim() == 2 for op in ops)
            and all(x.dim() in (2, 3) for x in xs)):
        return tuple(
            stencil_cuda.stencil_apply(
                op.diag, op.off, x,
                tuple(_halo_layer(xs, b, f, topo) for f in range(4)))
            for b, (op, x) in enumerate(zip(ops, xs)))
    out = []
    for b, (op, x) in enumerate(zip(ops, xs)):
        y = op.diag * x
        for f in range(2 * topo.ndims):
            y = y + op.off[f] * _neighbor_field(xs, b, f, topo)
        out.append(y)
    return tuple(out)


def domain_off_apply(ops: tuple[StencilOp, ...], xs: BlockVec,
                     topo: DomainTopo) -> BlockVec:
    """Off-diagonal part of ``domain_apply`` (the reference's ``H u*``)."""
    out = []
    for b, (op, x) in enumerate(zip(ops, xs)):
        y = torch.zeros_like(x * op.diag)
        for f in range(2 * topo.ndims):
            y = y + op.off[f] * _neighbor_field(xs, b, f, topo)
        out.append(y)
    return tuple(out)


# ---------------------------------------------------------------------------
# metric helpers
# ---------------------------------------------------------------------------

def contravariant(u: Tensor, geom: BlockGeom, topo: BlockTopo) -> Tensor:
    """Contravariant velocity components ``C_d = det * (M^-1 u)_d``."""
    if topo.orthogonal:
        return geom.det * geom.minv_diag * u
    return geom.det * torch.einsum("...ki,i...->k...", geom.minv, u)


def computational_velocity(u: Tensor, geom: BlockGeom, topo: BlockTopo) -> Tensor:
    """Index-space velocity ``(M^-1 u)`` used for CFL estimation."""
    if topo.orthogonal:
        return geom.minv_diag * u
    return torch.einsum("...ki,i...->k...", geom.minv, u)


def max_computational_velocity(state: DomainState, geoms: tuple[BlockGeom, ...],
                               topo: DomainTopo) -> Tensor:
    """Max abs component of index-space velocity over all blocks, cells and
    FIXED bounds (a 0-d tensor on the state's device)."""
    m = None
    for blk, geom, btopo in zip(state.blocks, geoms, topo.blocks):
        mb = torch.max(torch.abs(computational_velocity(blk.velocity, geom, btopo)))
        for f, spec in enumerate(btopo.faces):
            if spec.kind == BoundKind.FIXED and blk.faces[f].velocity is not None:
                if btopo.orthogonal:
                    bvel = _slab(geom.minv_diag, f) * blk.faces[f].velocity
                else:
                    bvel = torch.einsum("...ki,i...->k...",
                                        _slab_trailing(geom.minv, f, 2),
                                        blk.faces[f].velocity)
                mb = torch.maximum(mb, torch.max(torch.abs(bvel)))
        m = mb if m is None else torch.maximum(m, mb)
    return m


def _boundary_flux(blk: BlockState, geom: BlockGeom, btopo: BlockTopo,
                   f: int) -> Tensor:
    """Unsigned contravariant flux through FIXED face f (slab shape)."""
    d = face_axis(f)
    bvel = blk.faces[f].velocity  # (ndims, *slab)
    if btopo.orthogonal:
        return _slab(geom.det * geom.minv_diag[d], f) * bvel[d]
    minv_row = _slab_trailing(geom.minv, f, 2)[..., d, :]  # (*slab, i)
    return _slab(geom.det, f) * torch.einsum("...i,i...->...", minv_row, bvel)


def _field_contravariants(fields: BlockVec, geoms, topo) -> BlockVec:
    return tuple(contravariant(x, geom, btopo)
                 for x, geom, btopo in zip(fields, geoms, topo.blocks))


def _face_flux(Cs: BlockVec, state: DomainState, geoms, topo, b: int,
               f: int) -> Tensor:
    """Unsigned advective flux through face f of block b."""
    d = face_axis(f)
    C = Cs[b][d]
    flux = 0.5 * (C + _roll_nbr(C, f))
    spec = topo.blocks[b].faces[f]
    if spec.kind == BoundKind.FIXED:
        bflux = _boundary_flux(state.blocks[b], geoms[b], topo.blocks[b], f)
        flux = _set(flux, _face_slab(flux.dim(), f), bflux)
    elif spec.kind == BoundKind.CONNECTED:
        velN = _halo_axis_component(Cs, spec, f, topo.ndims)
        if (spec.axes[0] & 1) == (f & 1):
            # same-side connection: the neighbour's flux direction inverts
            velN = -velN
        slab = _face_slab(flux.dim(), f)
        flux = _set(flux, slab, 0.5 * (C[slab] + velN))
    return flux


# ---------------------------------------------------------------------------
# advection-diffusion system (prediction step)
# ---------------------------------------------------------------------------

def _block_nu(state: DomainState, b: int, nu, for_scalar: bool):
    """Per-cell block viscosity when set (velocity only), else ``nu``."""
    if not for_scalar and state.blocks[b].viscosity is not None:
        return state.blocks[b].viscosity
    return nu


def build_advection_ops(
    state: DomainState,
    geoms: tuple[BlockGeom, ...],
    topo: DomainTopo,
    nu: Tensor,
    dt,
    for_scalar: bool = False,
    scalar_channel: int = 0,
    upwind: float = 0.0,
) -> tuple[StencilOp, ...]:
    """Implicit-Euler advection-diffusion matrix for all blocks, already
    divided by ``det``.  ``upwind``: blend factor gamma in [0, 1] between
    central face interpolation (0) and first-order upwind (1), which adds
    ``gamma * |0.5 s F|`` to the diagonal and subtracts it from the face
    coefficient; 0 leaves the central matrix bit for bit."""
    ndims = topo.ndims
    Cs = _field_contravariants(tuple(b.velocity for b in state.blocks), geoms, topo)
    nus = tuple(_block_nu(state, b, nu, for_scalar) for b in range(len(geoms)))
    alpha_nu = tuple(g.alpha * nus[b] for b, g in enumerate(geoms))

    ops = []
    for b, (geom, btopo) in enumerate(zip(geoms, topo.blocks)):
        det = geom.det
        diag = det / dt
        offs = []
        for f in range(2 * ndims):
            d = face_axis(f)
            spec = btopo.faces[f]
            adv = (0.5 * face_sign(f)) * _face_flux(Cs, state, geoms, topo, b, f)
            an_n = _roll_nbr(alpha_nu[b][d], f)
            if spec.kind == BoundKind.CONNECTED:
                halo_a = _halo_axis_component(alpha_nu, spec, f, ndims)
                an_n = _set(an_n, _face_slab(an_n.dim(), f), halo_a)
            visc = 0.5 * (alpha_nu[b][d] + an_n)
            au = upwind * torch.abs(adv) if upwind else 0.0
            off = adv - au - visc
            diag_c = adv + au + visc
            if spec.kind == BoundKind.FIXED:
                slab = _face_slab(off.dim(), f)
                off = _set(off, slab, 0.0)
                bctype = (spec.scalar_types[scalar_channel] if for_scalar
                          else spec.vel_type)
                wall = (2.0 * alpha_nu[b][d][slab] if bctype == BCType.DIRICHLET
                        else torch.zeros_like(geom.alpha[d][slab]))
                diag_c = _set(diag_c, slab, wall)
            diag = diag + diag_c
            offs.append(off / det)
        ops.append(StencilOp(diag=diag / det, off=torch.stack(offs, dim=0)))
    return tuple(ops)


def _boundary_rhs_terms(blk: BlockState, geom: BlockGeom, btopo: BlockTopo,
                        nu, values_fn, bctype_fn,
                        neumann_source: bool = False) -> Tensor:
    """Boundary source accumulation for the advection RHS; returns
    ``(C, *spatial)`` (to be divided by det)."""
    ndims = btopo.ndims
    out = None
    for f in range(2 * ndims):
        spec = btopo.faces[f]
        if spec.kind != BoundKind.FIXED:
            continue
        d = face_axis(f)
        vals = values_fn(f)  # (C, *slab)
        bflux = _boundary_flux(blk, geom, btopo, f) * face_sign(f)
        alpha_b = _slab(geom.alpha[d], f)
        nu_slab = _slab(nu, f) if torch.is_tensor(nu) and nu.dim() else nu
        term = -vals * bflux
        if bctype_fn(f) == BCType.DIRICHLET:
            term = term + vals * (2.0 * nu_slab) * alpha_b
        elif neumann_source:
            term = term + vals * nu_slab
        if out is None:
            out = torch.zeros(vals.shape[: -len(btopo.shape)] + btopo.shape,
                              dtype=term.dtype, device=term.device)
        out = _add(out, (slice(None),) * (out.dim() - len(btopo.shape))
                   + _face_slab(len(btopo.shape), f), term)
    if out is None:
        out = torch.zeros((1,) + btopo.shape, dtype=geom.det.dtype,
                          device=geom.det.device)
    return out


def advection_rhs_velocity(state: DomainState, geoms: tuple[BlockGeom, ...],
                           topo: DomainTopo, nu: Tensor, dt) -> BlockVec:
    """RHS of the velocity prediction system per block."""
    out = []
    for b, (blk, geom, btopo) in enumerate(zip(state.blocks, geoms, topo.blocks)):
        bterms = _boundary_rhs_terms(
            blk, geom, btopo, _block_nu(state, b, nu, False),
            values_fn=lambda f, _b=blk: _b.faces[f].velocity,
            bctype_fn=lambda f, _t=btopo: _t.faces[f].vel_type,
        )
        rhs = blk.velocity / dt + bterms / geom.det
        if blk.velocity_source is not None:
            rhs = rhs + blk.velocity_source
        out.append(rhs)
    return tuple(out)


def advection_rhs_scalar(state: DomainState, geoms: tuple[BlockGeom, ...],
                         topo: DomainTopo, kappa: Tensor, dt,
                         channel: int) -> BlockVec:
    """RHS of the scalar prediction system for one channel, per block."""
    out = []
    for blk, geom, btopo in zip(state.blocks, geoms, topo.blocks):
        bterms = _boundary_rhs_terms(
            blk, geom, btopo, kappa,
            values_fn=lambda f, _b=blk: _b.faces[f].scalar[channel: channel + 1],
            bctype_fn=lambda f, _t=btopo: _t.faces[f].scalar_types[channel],
            neumann_source=True,
        )
        out.append(blk.scalar[channel] / dt + bterms[0] / geom.det)
    return tuple(out)


# ---------------------------------------------------------------------------
# pressure system (corrector step)
# ---------------------------------------------------------------------------

def build_pressure_ops(adiags: BlockVec, geoms: tuple[BlockGeom, ...],
                       topo: DomainTopo) -> tuple[StencilOp, ...]:
    """Pressure Poisson matrix, sign-flipped (positive definite):
    ``off_f = -0.5 * (alpha_P/A_P + alpha_N/A_N)``, ``diag = -sum_f off_f``;
    zero (Neumann) at FIXED faces."""
    ndims = topo.ndims
    ras = tuple(g.alpha / a for g, a in zip(geoms, adiags))
    ops = []
    for b, btopo in enumerate(topo.blocks):
        diag = torch.zeros_like(adiags[b])
        offs = []
        for f in range(2 * ndims):
            d = face_axis(f)
            spec = btopo.faces[f]
            ra_n = _roll_nbr(ras[b][d], f)
            if spec.kind == BoundKind.CONNECTED:
                halo_ra = _halo_axis_component(ras, spec, f, ndims)
                ra_n = _set(ra_n, _face_slab(ra_n.dim(), f), halo_ra)
            coef = 0.5 * (ras[b][d] + ra_n)
            if spec.kind == BoundKind.FIXED:
                coef = _set(coef, _face_slab(coef.dim(), f), 0.0)
            diag = diag + coef
            offs.append(-coef)
        ops.append(StencilOp(diag=diag, off=torch.stack(offs, dim=0)))
    return tuple(ops)


def pressure_rhs_vec(state: DomainState, geoms: tuple[BlockGeom, ...],
                     topo: DomainTopo, adv_ops: tuple[StencilOp, ...],
                     u_star: BlockVec, nu: Tensor, dt) -> BlockVec:
    """``hbyA = (u_old/dt - H u* + S)/A`` per block."""
    H = domain_off_apply(adv_ops, u_star, topo)
    out = []
    for b, (blk, geom, btopo) in enumerate(zip(state.blocks, geoms, topo.blocks)):
        bterms = _boundary_rhs_terms(
            blk, geom, btopo, _block_nu(state, b, nu, False),
            values_fn=lambda f, _b=blk: _b.faces[f].velocity,
            bctype_fn=lambda f, _t=btopo: _t.faces[f].vel_type,
        )
        S = bterms / geom.det
        if blk.velocity_source is not None:
            S = S + blk.velocity_source
        out.append((blk.velocity / dt - H[b] + S) / adv_ops[b].diag)
    return tuple(out)


def divergence_of(fields: BlockVec, state: DomainState,
                  geoms: tuple[BlockGeom, ...], topo: DomainTopo) -> BlockVec:
    """Divergence of a colocated vector field from contravariant face
    fluxes; FIXED faces use the prescribed boundary velocity flux."""
    Cs = _field_contravariants(fields, geoms, topo)
    out = []
    for b, geom in enumerate(geoms):
        div = torch.zeros_like(geom.det)
        for f in range(2 * topo.ndims):
            div = div + face_sign(f) * _face_flux(Cs, state, geoms, topo, b, f)
        out.append(div)
    return tuple(out)


def velocity_divergence(state: DomainState, geoms, topo) -> BlockVec:
    """Divergence of the current velocity (diagnostic)."""
    return divergence_of(tuple(b.velocity for b in state.blocks), state,
                         geoms, topo)


def pressure_gradient(ps: BlockVec, geoms: tuple[BlockGeom, ...],
                      topo: DomainTopo) -> BlockVec:
    """FD pressure gradient per block: central differences in index space,
    one-sided at FIXED faces, CONNECTED/PERIODIC neighbours resolved, mapped
    to physical space with ``M^-T``.  ``(d, *s)``."""
    out = []
    for b, (geom, btopo) in enumerate(zip(geoms, topo.blocks)):
        p = ps[b]
        grads = []
        for d in range(topo.ndims):
            f_lo, f_hi = 2 * d, 2 * d + 1
            val_n = _neighbor_field(ps, b, f_lo, topo)
            val_p = _neighbor_field(ps, b, f_hi, topo)
            fac = torch.full_like(p, 0.5)
            if btopo.faces[f_lo].kind == BoundKind.FIXED:
                slab = _face_slab(p.dim(), f_lo)
                val_n = _set(val_n, slab, p[slab])
                fac = _set(fac, slab, 1.0)
            if btopo.faces[f_hi].kind == BoundKind.FIXED:
                slab = _face_slab(p.dim(), f_hi)
                val_p = _set(val_p, slab, p[slab])
                fac = _set(fac, slab, 1.0)
            grads.append((val_p - val_n) * fac)
        g = torch.stack(grads, dim=0)  # index-space gradient (d, *s)
        if btopo.orthogonal:
            out.append(geom.minv_diag * g)
        else:
            out.append(torch.einsum("...ki,k...->i...", geom.minv, g))
    return tuple(out)


def correct_velocity_fd(hbyA: BlockVec, ps: BlockVec, adiags: BlockVec,
                        geoms: tuple[BlockGeom, ...], topo: DomainTopo, dt,
                        time_step_normalized: bool = False) -> BlockVec:
    """FD velocity corrector per block: ``u = hbyA - (1/A) grad p``."""
    grads = pressure_gradient(ps, geoms, topo)
    out = []
    for b in range(len(hbyA)):
        upd = grads[b] / adiags[b]
        if time_step_normalized:
            upd = upd * dt
        out.append(hbyA[b] - upd)
    return tuple(out)
