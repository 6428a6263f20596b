"""Non-orthogonal grid corrections for the FV stencil operators (counterpart
of ``fluidgym_tpu/solver/nonortho.py``).

* cross metric coefficients ``beta(a, t) = det * (M^-1 row_a . M^-1 row_t)``,
  face-interpolated as ``faceAlpha = 0.5 * (beta_P * ra_P + beta_N * ra_N)``;
* matrix contributions (DIRECT | CENTER): for each face f and tangential face
  tf, interior corners add ``cno = sign_f * sign_tf * faceAlpha / 4`` as
  ``diag -= cno; off[f] -= cno; off[tf] -= cno``; gradient-type corners (a
  Neumann field BC at a FIXED tf face, or pressure) use the one-sided
  variant ``diag -= 3 cno; off[f] -= 3 cno; off[tf_other] += cno``;
* deferred diagonal-neighbour terms on the RHS from the previous iterate
  (``deferred_rhs``), including Dirichlet corner values and the
  boundary-tangential-gradient source at prescribed faces;
* the fully deferred pressure correction in flux form
  (``deferred_rhs_flux``), which telescopes exactly so the singular
  all-Neumann pressure system keeps a solvable RHS.

The arithmetic is the JAX package's, line for line, including its
documented simplifications at seam/boundary corners.  All corrections vanish
on orthogonal blocks and are skipped there.
"""

from __future__ import annotations

from typing import Callable

import torch

from fluidgym_tpu_torch.core.domain import (
    BCType,
    BlockGeom,
    BoundKind,
    DomainTopo,
    face_axis,
    face_sign,
)
from fluidgym_tpu_torch.solver.stencil import (
    StencilOp,
    _add,
    _face_slab,
    _halo,
    _neighbor_field,
    _roll_nbr,
    _set,
    _slab,
)

Tensor = torch.Tensor
BlockVec = tuple

__all__ = [
    "cross_coefficients",
    "apply_matrix_terms",
    "deferred_rhs",
    "deferred_rhs_flux",
]

# corner types at a FIXED tf face
_VALUE, _GRAD = "value", "grad"


def _vel_bct(btopo, f):
    return btopo.faces[f].vel_type


def _scalar_bct(channel):
    def fn(btopo, f):
        return btopo.faces[f].scalar_types[channel]

    return fn


def _pressure_bct(btopo, f):
    return None  # pressure corners are always gradient-type


def bctype_for(field: str, scalar_channel: int = 0):
    if field == "velocity":
        return _vel_bct
    if field == "scalar":
        return _scalar_bct(scalar_channel)
    if field == "pressure":
        return _pressure_bct
    raise ValueError(field)


def _corner_type(btopo, tf: int, bct_fn) -> str:
    return _VALUE if bct_fn(btopo, tf) == BCType.DIRICHLET else _GRAD


def cross_coefficients(geom: BlockGeom, orthogonal: bool) -> Tensor | None:
    """``beta[a, t] (*s) = det * sum_i Minv[a,i] Minv[t,i]``; None if the
    block is orthogonal (all cross terms vanish)."""
    if orthogonal or geom.minv is None:
        return None
    return torch.einsum("...ai,...ti->at...", geom.minv, geom.minv) * geom.det


def _betas(geoms, topo) -> tuple[Tensor | None, ...]:
    return tuple(cross_coefficients(g, bt.orthogonal)
                 for g, bt in zip(geoms, topo.blocks))


def _face_alpha(betas, ras, topo: DomainTopo, b: int, f: int, t: int) -> Tensor:
    """Face-interpolated cross coefficient ``0.5*(beta_P ra_P + beta_N ra_N)``
    for face f (axis a), tangential axis t, of block b."""
    a = face_axis(f)
    prod = betas[b][a, t] * ras[b]
    beta_n = _roll_nbr(prod, f)
    spec = topo.blocks[b].faces[f]
    slab = _face_slab(beta_n.dim(), f)
    if spec.kind == BoundKind.CONNECTED:
        nb = spec.connected_block
        if betas[nb] is not None:
            nd = topo.ndims
            a_n = spec.axes[0] >> 1
            t_n = spec.axes[(t - a) % nd] >> 1
            # inverted mapped axes flip the sign of the cross term
            sign = 1.0
            if (spec.axes[0] & 1) == (f & 1):
                sign = -sign
            if spec.axes[(t - a) % nd] & 1:
                sign = -sign
            halo = _halo(betas[nb][a_n, t_n] * ras[nb], spec, f, nd) * sign
            beta_n = _set(beta_n, slab, halo)
        else:
            beta_n = _set(beta_n, slab, 0.0)
    elif spec.kind == BoundKind.FIXED:
        beta_n = _set(beta_n, slab, 0.0)
    return 0.5 * (prod + beta_n)


def apply_matrix_terms(ops: tuple[StencilOp, ...], geoms, topo: DomainTopo,
                       ras: BlockVec, det_divide: bool, field: str,
                       scalar_channel: int = 0) -> tuple[StencilOp, ...]:
    """Add the DIRECT | CENTER matrix contributions.

    ``ras``: per-block per-cell factor inside the interpolated coefficient
    (velocity: nu; scalar: diffusivity; pressure: 1/A).  ``det_divide``: True
    for the advection matrix (the whole row is /det), False for pressure.
    """
    betas = _betas(geoms, topo)
    bct_fn = bctype_for(field, scalar_channel)
    nd = topo.ndims
    out = []
    for b, (op, geom, btopo) in enumerate(zip(ops, geoms, topo.blocks)):
        if betas[b] is None:
            out.append(op)
            continue
        diag = op.diag
        offs = [op.off[f] for f in range(2 * nd)]
        det = geom.det if det_divide else torch.ones_like(geom.det)
        for f in range(2 * nd):
            a = face_axis(f)
            f_fixed = btopo.faces[f].kind == BoundKind.FIXED
            for i in range(1, nd):
                t = (a + i) % nd
                fa = _face_alpha(betas, ras, topo, b, f, t) / det
                for tu in (0, 1):
                    tf = 2 * t + tu
                    tf_other = tf ^ 1
                    cno = (face_sign(f) * face_sign(tf) * 0.25) * fa
                    if f_fixed:
                        # face-f terms skipped at the prescribed slab
                        cno = _set(cno, _face_slab(cno.dim(), f), 0.0)
                    d_diag = -cno
                    d_off_f = -cno
                    d_off_tf = -cno
                    d_off_tfo = torch.zeros_like(cno)
                    if btopo.faces[tf].kind == BoundKind.FIXED:
                        slab = _face_slab(cno.dim(), tf)
                        if _corner_type(btopo, tf, bct_fn) == _VALUE:
                            # prescribed corner value -> RHS; nothing here
                            d_diag = _set(d_diag, slab, 0.0)
                            d_off_f = _set(d_off_f, slab, 0.0)
                            d_off_tf = _set(d_off_tf, slab, 0.0)
                        else:  # gradient corner: one-sided variant
                            d_diag = _set(d_diag, slab, -3.0 * cno[slab])
                            d_off_f = _set(d_off_f, slab, -3.0 * cno[slab])
                            d_off_tf = _set(d_off_tf, slab, 0.0)
                            d_off_tfo = _set(d_off_tfo, slab, cno[slab])
                    diag = diag + d_diag
                    offs[f] = offs[f] + d_off_f
                    offs[tf] = offs[tf] + d_off_tf
                    offs[tf_other] = offs[tf_other] + d_off_tfo
        out.append(StencilOp(diag=diag, off=torch.stack(offs, dim=0)))
    return tuple(out)


def _diagonal_value(xs: BlockVec, b: int, f: int, tf: int,
                    topo: DomainTopo) -> Tensor:
    """Value of the diagonal neighbour across face f then face tf, with
    halo fixups along CONNECTED faces; ``xs`` holds per-block (*s) fields."""
    z = _neighbor_field(xs, b, f, topo)
    corner = _roll_nbr(z, tf)
    spec_tf = topo.blocks[b].faces[tf]
    if spec_tf.kind == BoundKind.CONNECTED:
        halo_tf = _halo(xs[spec_tf.connected_block], spec_tf, tf, topo.ndims)
        slab = _face_slab(corner.dim(), tf)
        corner = _set(corner, slab, _roll_nbr(halo_tf, f)[slab])
    return corner


def _tangential_cd(xs: BlockVec, topo: DomainTopo, b: int, t: int) -> Tensor:
    """Cell-centred tangential central difference ``0.5*(x_T+ - x_T-)`` along
    axis t, with CONNECTED/PERIODIC halos and one-sided differences at FIXED
    walls."""
    x = xs[b]
    btopo = topo.blocks[b]
    up = _neighbor_field(xs, b, 2 * t + 1, topo)
    lo = _neighbor_field(xs, b, 2 * t, topo)
    cd = 0.5 * (up - lo)
    if btopo.faces[2 * t + 1].kind == BoundKind.FIXED:
        slab = _face_slab(cd.dim(), 2 * t + 1)
        cd = _set(cd, slab, (x - lo)[slab])
    if btopo.faces[2 * t].kind == BoundKind.FIXED:
        slab = _face_slab(cd.dim(), 2 * t)
        cd = _set(cd, slab, (up - x)[slab])
    return cd


def deferred_rhs_flux(xs: BlockVec, geoms, topo: DomainTopo,
                      ras: BlockVec) -> BlockVec:
    """Fully deferred non-orthogonal correction in FLUX form (pressure):
    per-face fluxes ``F_f = faceAlpha_f * 0.5*(CD_P + CD_N)`` differenced per
    cell, so seam and interior faces cancel pairwise and wall faces carry no
    flux."""
    betas = _betas(geoms, topo)
    nd = topo.ndims
    nblocks = len(geoms)
    cds = [tuple(_tangential_cd(xs, topo, b, t) for t in range(nd))
           for b in range(nblocks)]
    out = []
    for b, (geom, btopo) in enumerate(zip(geoms, topo.blocks)):
        if betas[b] is None:
            out.append(torch.zeros(btopo.shape, dtype=geom.det.dtype,
                                   device=geom.det.device))
            continue
        S = torch.zeros(btopo.shape, dtype=geom.det.dtype, device=geom.det.device)
        for f in range(2 * nd):
            a = face_axis(f)
            spec = btopo.faces[f]
            for i in range(1, nd):
                t = (a + i) % nd
                fa = _face_alpha(betas, ras, topo, b, f, t)
                cd = cds[b][t]
                cd_n = _roll_nbr(cd, f)
                if spec.kind == BoundKind.CONNECTED:
                    nb = spec.connected_block
                    t_idx = spec.axes[(t - a) % nd]
                    halo = _halo(cds[nb][t_idx >> 1], spec, f, nd)
                    if t_idx & 1:  # inverted t mapping flips the derivative
                        halo = -halo
                    cd_n = _set(cd_n, _face_slab(cd_n.dim(), f), halo)
                F = fa * (0.5 * (cd + cd_n))
                if spec.kind == BoundKind.FIXED:
                    F = _set(F, _face_slab(F.dim(), f), 0.0)
                S = S - face_sign(f) * F
        out.append(S)
    return tuple(out)


def deferred_rhs(xs: BlockVec, geoms, topo: DomainTopo, ras: BlockVec,
                 field: str, bval_fn: Callable[[int, int], Tensor] | None = None,
                 scalar_channel: int = 0, boundary_visc=1.0,
                 include_direct: bool = False) -> BlockVec:
    """Deferred non-orthogonal correction ``S`` per block.

    ``include_direct=False``: the diagonal corner cells only (used together
    with the DIRECT/CENTER matrix terms); ``True``: the full cross coupling
    deferred.  ``xs``: per-block (*s) previous-iterate field (one
    component).  ``bval_fn(b, f) -> (*slab)`` prescribed boundary values
    (None for pressure).  Usage: velocity RHS ``-= S`` (nu inside via ras),
    scalar RHS ``-= S * kappa`` (ras = 1), pressure RHS ``+= S`` (ras = 1/A).
    """
    betas = _betas(geoms, topo)
    bct_fn = bctype_for(field, scalar_channel)
    nd = topo.ndims
    out = []
    for b, (geom, btopo) in enumerate(zip(geoms, topo.blocks)):
        dt, dev = geom.det.dtype, geom.det.device
        if betas[b] is None:
            out.append(torch.zeros(btopo.shape, dtype=dt, device=dev))
            continue
        S = torch.zeros(btopo.shape, dtype=dt, device=dev)
        for f in range(2 * nd):
            a = face_axis(f)
            f_fixed = btopo.faces[f].kind == BoundKind.FIXED
            for i in range(1, nd):
                t = (a + i) % nd
                fa = _face_alpha(betas, ras, topo, b, f, t)
                tgrad = torch.zeros(btopo.shape, dtype=dt, device=dev)
                for tu in (0, 1):
                    tf = 2 * t + tu
                    tf_other = tf ^ 1
                    corner = 0.25 * _diagonal_value(xs, b, f, tf, topo)
                    if include_direct:
                        corner = corner + 0.25 * (
                            _neighbor_field(xs, b, f, topo)
                            + _neighbor_field(xs, b, tf, topo))
                    if btopo.faces[tf].kind == BoundKind.FIXED:
                        slab = _face_slab(corner.dim(), tf)
                        if (_corner_type(btopo, tf, bct_fn) == _VALUE
                                and bval_fn is not None):
                            bval = bval_fn(b, tf)  # (*slab), slab along tf
                            # 0.5*(bval(pos) + bval(pos + sign_f along f));
                            # one-sided at the f extreme
                            cv = 0.5 * (bval + _roll_nbr(bval, f))
                            end = _face_slab(bval.dim(), f)
                            cv = _set(cv, end, bval[end])
                            corner = _set(corner, slab, 0.0)
                            tgrad = _add(tgrad, slab, face_sign(tf) * cv[slab])
                        else:
                            # gradient corner: one-sided treatment
                            diag_o = 0.25 * _diagonal_value(xs, b, f, tf_other,
                                                            topo)
                            repl = face_sign(tf_other) * diag_o
                            if include_direct:
                                nbr_f = _neighbor_field(xs, b, f, topo)
                                nbr_to = _neighbor_field(xs, b, tf_other, topo)
                                repl = repl + face_sign(tf) * 0.75 * nbr_f
                                repl = repl + face_sign(tf_other) * 0.25 * nbr_to
                            corner = _set(corner, slab, 0.0)
                            tgrad = _add(tgrad, slab, repl[slab])
                    tgrad = tgrad + face_sign(tf) * corner
                contrib = face_sign(f) * fa * tgrad
                if f_fixed:
                    contrib = _set(contrib, _face_slab(contrib.dim(), f), 0.0)
                S = S - contrib

            # prescribed-face tangential-gradient source
            if (f_fixed and field != "pressure" and bval_fn is not None
                    and bct_fn(btopo, f) == BCType.DIRICHLET):
                bval = bval_fn(b, f)  # (*slab) along f
                for i in range(1, nd):
                    t = (a + i) % nd
                    beta_slab = _slab(betas[b][a, t], f)
                    up = _roll_nbr(bval, 2 * t + 1)
                    lo = _roll_nbr(bval, 2 * t)
                    g = 0.5 * (up - lo)
                    lo_end = _face_slab(bval.dim(), 2 * t)
                    hi_end = _face_slab(bval.dim(), 2 * t + 1)
                    g = _set(g, lo_end, (up - bval)[lo_end])
                    g = _set(g, hi_end, (bval - lo)[hi_end])
                    term = face_sign(f) * beta_slab * _slab(g, f) * boundary_visc
                    S = _add(S, _face_slab(S.dim(), f), -term)
        out.append(S)
    return tuple(out)
