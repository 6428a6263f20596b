"""Merged super-block frame (counterpart of
``fluidgym_tpu/solver/block_merge.py``).

A multi-block topology stores its blocks in per-block local frames, and the
CONNECTED halo exchange pays a transpose or flip per seam per matvec.  The
merge rewrites the TOPOLOGY instead: a BFS assigns every block a dihedral
transform (axis permutation + reversals) into one canonical frame, and
chains of face-adjacent blocks merge into rectangles ("super-blocks").  For
the cylinder O-grid (4 ring blocks + wake) that gives two super-blocks: the
closed ring, whose seams become a plain periodic roll, and the wake, joined
by windowed identity-orientation seams.  The operator is unchanged: the
merge is a permutation P of unknowns and ``merged_apply`` computes
``P A P^T`` (per-super-block rolls plus static slab fixups for the residual
seams).

The plan logic is numpy/python, copied from the JAX package.  Every plan is
self-checked when it is built: ``merged_apply`` (this module's PyTorch
version, in float64 on the CPU) against a direct numpy mirror of the halo
semantics of ``stencil.domain_apply`` on random coefficients; a plan that
fails is not used (``merge_plan`` returns None).

``trivial_plan`` serves single-block domains (one super-block, identity
placement, no fixups).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from fluidgym_tpu_torch.core.domain import BoundKind, DomainTopo, face_axis
from fluidgym_tpu_torch.solver.stencil import set_region

__all__ = ["Placement", "SuperBlockPlan", "SeamFixup", "MergePlan",
           "merge_plan", "trivial_plan", "pack_fields", "unpack_fields",
           "pack_ops", "merged_apply"]


@dataclass(frozen=True)
class Placement:
    """One original block placed in the canonical frame of its super-block."""

    block: int
    perm: tuple[int, ...]    # local physical axis d -> canonical axis perm[d]
    inv: tuple[int, ...]     # 1 if local axis d runs reversed in canonical
    offset: tuple[int, ...]  # canonical cell offset (per canonical axis)
    shape: tuple[int, ...]   # canonical extents (per canonical axis)


@dataclass(frozen=True)
class SuperBlockPlan:
    shape: tuple[int, ...]          # canonical extents (per physical axis)
    members: tuple[Placement, ...]


@dataclass(frozen=True)
class SeamFixup:
    """One directional residual-seam correction.

    The merged matvec rolls as if every face wrapped periodically; for the
    cells in ``window`` of face ``face`` of super-block ``sb`` the wrapped
    value is wrong and is replaced by the source super-block's boundary
    layer: ``y[slab] += off[face][slab] * (src - wrapped)``.  ``flip`` marks
    tangential axes whose direction reverses across the seam (C-grid cuts).
    """

    sb: int
    face: int
    window: tuple[tuple[int, int], ...]      # (lo, hi) per canonical axis;
                                             # the face axis entry is ignored
    src_sb: int
    src_face: int                            # source's own seam face
    src_window: tuple[tuple[int, int], ...]
    flip: tuple[bool, ...]                   # per canonical axis


@dataclass(frozen=True)
class MergePlan:
    ndims: int
    superblocks: tuple[SuperBlockPlan, ...]
    fixups: tuple[SeamFixup, ...] = ()

    @property
    def identity_seams(self) -> bool:
        return all(not any(fx.flip) for fx in self.fixups)


def _array_axis(rank: int, d: int) -> int:
    """Array axis of physical axis d (spatial axes ordered (z,)y,x)."""
    return rank - 1 - d


def _transform_array(a: torch.Tensor, perm, inv) -> torch.Tensor:
    """Map a pure-spatial local array into the canonical frame."""
    n = len(perm)
    inv_perm = [0] * n
    for d, D in enumerate(perm):
        inv_perm[D] = d
    order = [_array_axis(n, inv_perm[D]) for D in range(n - 1, -1, -1)]
    a = a.permute(order)
    for d in range(n):
        if inv[d]:
            a = torch.flip(a, dims=(_array_axis(n, perm[d]),))
    return a


def _untransform_array(a: torch.Tensor, perm, inv) -> torch.Tensor:
    n = len(perm)
    for d in range(n):
        if inv[d]:
            a = torch.flip(a, dims=(_array_axis(n, perm[d]),))
    order = [_array_axis(n, perm[d]) for d in range(n - 1, -1, -1)]
    return a.permute(order)


def _member_slices(pl: Placement, rank: int):
    idx = [slice(None)] * rank
    for D in range(len(pl.offset)):
        idx[_array_axis(rank, D)] = slice(pl.offset[D],
                                          pl.offset[D] + pl.shape[D])
    return tuple(idx)


def _local_face(pl: Placement, canonical_face: int) -> int:
    D, u = face_axis(canonical_face), canonical_face & 1
    d = pl.perm.index(D)
    return 2 * d + (u ^ pl.inv[d])


def _canonical_face(pl: Placement, local_face: int) -> int:
    """Canonical face index of a member's local face."""
    d, u = face_axis(local_face), local_face & 1
    return 2 * pl.perm[d] + (u ^ pl.inv[d])


# ---------------------------------------------------------------------------
# plan construction (numpy/python, as in the JAX package)
# ---------------------------------------------------------------------------

def _extents(topo: DomainTopo, b: int, perm) -> tuple[int, ...]:
    """Canonical extents of block b under axis permutation ``perm`` (topo
    shapes are array-ordered (z,)y,x)."""
    nd = topo.ndims
    shp = topo.blocks[b].shape
    ext = [0] * nd
    for d in range(nd):
        ext[perm[d]] = shp[_array_axis(nd, d)]
    return tuple(ext)


def _implied_placement(topo: DomainTopo, pb: Placement, f: int,
                       spec) -> Placement:
    """The placement seam (pb, f) demands for its neighbour."""
    nd = len(pb.perm)
    c = spec.connected_block
    d, u = face_axis(f), f & 1
    a0, u0 = spec.axes[0] >> 1, spec.axes[0] & 1
    perm_c = [0] * nd
    inv_c = [0] * nd
    perm_c[a0] = pb.perm[d]
    inv_c[a0] = u0 ^ 1 ^ u ^ pb.inv[d]
    for i in range(1, nd):
        k = (d + i) % nd
        ai, upi = spec.axes[i] >> 1, spec.axes[i] & 1
        perm_c[ai] = pb.perm[k]
        inv_c[ai] = pb.inv[k] ^ upi
    ext_c = _extents(topo, c, tuple(perm_c))
    D = pb.perm[d]
    off_c = list(pb.offset)
    if u ^ pb.inv[d]:
        off_c[D] = pb.offset[D] + pb.shape[D]
    else:
        off_c[D] = pb.offset[D] - ext_c[D]
    return Placement(c, tuple(perm_c), tuple(inv_c), tuple(off_c), ext_c)


def _place_blocks(topo: DomainTopo):
    """BFS over CONNECTED seams assigning canonical transforms + offsets.
    Returns the placements per block, or None (disconnected graph or
    mismatched seam extents)."""
    nd = topo.ndims
    nb = len(topo.blocks)
    placements: list[Placement | None] = [None] * nb
    ident = tuple(range(nd))
    placements[0] = Placement(0, ident, (0,) * nd, (0,) * nd,
                              _extents(topo, 0, ident))
    queue = [0]
    seen: set[tuple[int, int]] = set()
    while queue:
        b = queue.pop(0)
        pb = placements[b]
        for f, spec in enumerate(topo.blocks[b].faces):
            if spec.kind != BoundKind.CONNECTED or (b, f) in seen:
                continue
            c = spec.connected_block
            seen.add((b, f))
            seen.add((c, spec.axes[0]))
            d = face_axis(f)
            if placements[c] is None:
                placements[c] = _implied_placement(topo, pb, f, spec)
                queue.append(c)
            # tangential extents must match (full-face seams only)
            for i in range(1, nd):
                K = pb.perm[(d + i) % nd]
                if placements[c].shape[K] != pb.shape[K]:
                    return None
    if any(p is None for p in placements):
        return None
    return placements


def _group_superblocks(placements):
    """Group placements into perfect rectangles by greedy face-adjacent
    merging; None if some group is not a perfect rectangle."""
    nd = len(placements[0].perm)
    groups = [[p] for p in placements]

    def bbox(group):
        lo = [min(p.offset[D] for p in group) for D in range(nd)]
        hi = [max(p.offset[D] + p.shape[D] for p in group) for D in range(nd)]
        return lo, hi

    def area(lo, hi):
        out = 1
        for a, b in zip(lo, hi):
            out *= b - a
        return out

    def rectangular(group):
        lo, hi = bbox(group)
        return area(lo, hi) == sum(
            area(p.offset, [o + s for o, s in zip(p.offset, p.shape)])
            for p in group)

    merged = True
    while merged:
        merged = False
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                g = groups[i] + groups[j]
                if rectangular(g):
                    groups[i] = g
                    del groups[j]
                    merged = True
                    break
            if merged:
                break
    if not all(rectangular(g) for g in groups):
        return None
    out = []
    for g in groups:
        lo, hi = bbox(g)
        members = tuple(
            Placement(p.block, p.perm, p.inv,
                      tuple(o - l for o, l in zip(p.offset, lo)), p.shape)
            for p in g)
        out.append(SuperBlockPlan(tuple(h - l for l, h in zip(lo, hi)),
                                  members))
    return tuple(out)


def _build_fixups(topo: DomainTopo, sbs) -> tuple[SeamFixup, ...] | None:
    """Residual fixups: every CONNECTED seam side whose neighbour value the
    merged roll does NOT already produce (concatenation adjacency or an
    exact ring wrap).  Emitted per side (directional)."""
    nd = topo.ndims
    place = {}
    for si, sb in enumerate(sbs):
        for pl in sb.members:
            place[pl.block] = (si, pl)

    def window(pl: Placement):
        return tuple((pl.offset[D], pl.offset[D] + pl.shape[D])
                     for D in range(nd))

    fixups = []
    for b, bt in enumerate(topo.blocks):
        si, pl = place[b]
        for f, spec in enumerate(bt.faces):
            if spec.kind != BoundKind.CONNECTED:
                continue
            sj, pc = place[spec.connected_block]
            F = _canonical_face(pl, f)
            CF = _canonical_face(pc, spec.axes[0])
            D, u = face_axis(F), F & 1
            implied = _implied_placement(topo, pl, f, spec)
            if implied.perm != pc.perm:
                return None  # rotated residual seam: not expressible by rolls
            if si == sj and (implied.inv, implied.offset) == (pc.inv, pc.offset):
                continue  # realized by in-super-block concatenation
            # both seam slabs must lie on their super-block boundary, along
            # a shared axis
            my_edge = pl.offset[D] + (pl.shape[D] if u else 0)
            CD = face_axis(CF)
            nbr_edge = pc.offset[CD] + (pc.shape[CD] if CF & 1 else 0)
            if my_edge != (sbs[si].shape[D] if u else 0):
                return None
            if nbr_edge != (sbs[sj].shape[CD] if CF & 1 else 0):
                return None
            if CD != D:
                return None
            flip = tuple(
                bool(implied.inv[pc.perm.index(K)] ^ pc.inv[pc.perm.index(K)])
                if K != D else False
                for K in range(nd))
            w_me, w_src = window(pl), window(pc)
            if (si == sj and not any(flip)
                    and w_me[:D] + w_me[D + 1:] == w_src[:D] + w_src[D + 1:]):
                continue  # exact ring wrap: the merged roll is already right
            fixups.append(SeamFixup(sb=si, face=F, window=w_me, src_sb=sj,
                                    src_face=CF, src_window=w_src, flip=flip))
    return tuple(fixups)


@functools.lru_cache(maxsize=None)
def merge_plan(topo: DomainTopo) -> MergePlan | None:
    """Build and self-check the merge plan for a multi-block ``topo``; None
    when there is nothing to merge, the topology cannot be put into
    axis-aligned form, or the self-check fails."""
    if len(topo.blocks) < 2:
        return None
    if not any(s.kind == BoundKind.CONNECTED
               for bt in topo.blocks for s in bt.faces):
        return None
    placed = _place_blocks(topo)
    if placed is None:
        return None
    sbs = _group_superblocks(placed)
    if sbs is None:
        return None
    fixups = _build_fixups(topo, sbs)
    if fixups is None:
        return None
    plan = MergePlan(ndims=topo.ndims, superblocks=sbs, fixups=fixups)
    if not _self_check(topo, plan):
        return None
    return plan


@functools.lru_cache(maxsize=None)
def trivial_plan(topo: DomainTopo) -> MergePlan | None:
    """Identity plan for SINGLE-block topologies with no CONNECTED faces:
    one super-block, no fixups, identity placement.  Rolls handle PERIODIC
    faces and FIXED faces carry zero off-coefficients, so the merged
    operator IS the block operator (nothing to self-check)."""
    if len(topo.blocks) != 1:
        return None
    bt = topo.blocks[0]
    if any(s.kind == BoundKind.CONNECTED for s in bt.faces):
        return None
    nd = topo.ndims
    shape_pa = tuple(bt.shape[::-1])  # per PHYSICAL axis extents
    return MergePlan(
        ndims=nd,
        superblocks=(SuperBlockPlan(
            shape=shape_pa,
            members=(Placement(block=0, perm=tuple(range(nd)),
                               inv=(0,) * nd, offset=(0,) * nd,
                               shape=shape_pa),)),),
        fixups=(),
    )


def _sb_array_shape(plan: MergePlan, sb: SuperBlockPlan) -> tuple[int, ...]:
    nd = plan.ndims
    return tuple(sb.shape[D] for D in range(nd - 1, -1, -1))


def _pack_one(plan: MergePlan, sb: SuperBlockPlan, fields) -> torch.Tensor:
    """One canonical array for one super-block; ``fields`` indexed by
    member order."""
    nd = plan.ndims
    parts = [_transform_array(f, pl.perm, pl.inv)
             for f, pl in zip(fields, sb.members)]
    if len(sb.members) == 1 and parts[0].shape == _sb_array_shape(plan, sb):
        return parts[0].contiguous()
    buf = torch.zeros(_sb_array_shape(plan, sb), dtype=parts[0].dtype,
                      device=parts[0].device)
    for part, pl in zip(parts, sb.members):
        buf = set_region(buf, _member_slices(pl, nd), part)
    return buf


def pack_fields(plan: MergePlan, xs) -> tuple[torch.Tensor, ...]:
    """Per-block spatial fields -> per-super-block canonical arrays."""
    return tuple(_pack_one(plan, sb, [xs[pl.block] for pl in sb.members])
                 for sb in plan.superblocks)


def unpack_fields(plan: MergePlan, ys) -> tuple[torch.Tensor, ...]:
    nd = plan.ndims
    n_blocks = sum(len(sb.members) for sb in plan.superblocks)
    out = [None] * n_blocks
    for si, sb in enumerate(plan.superblocks):
        for pl in sb.members:
            sub = ys[si][_member_slices(pl, nd)]
            out[pl.block] = _untransform_array(sub, pl.perm, pl.inv)
    return tuple(out)


def pack_ops(plan: MergePlan, ops) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """Per-block StencilOps -> per-super-block ``(diag, off)``; ``off`` keeps
    the ``(2*ndims, *spatial)`` face layout in the canonical frame."""
    nd = plan.ndims
    out = []
    for sb in plan.superblocks:
        diag = _pack_one(plan, sb, [ops[pl.block].diag for pl in sb.members])
        offs = [_pack_one(plan, sb, [ops[pl.block].off[_local_face(pl, F)]
                                     for pl in sb.members])
                for F in range(2 * nd)]
        out.append((diag, torch.stack(offs, dim=0)))
    return tuple(out)


# ---------------------------------------------------------------------------
# merged matvec
# ---------------------------------------------------------------------------

def _face_slab_idx(rank: int, F: int, window, shape):
    """Index tuple of the boundary slab of face F, windowed to ``window`` on
    the tangential axes (``shape``: per canonical axis)."""
    D, u = face_axis(F), F & 1
    idx = [slice(None)] * rank
    for K in range(len(window)):
        ax = _array_axis(rank, K)
        if K == D:
            idx[ax] = slice(shape[K] - 1, shape[K]) if u else slice(0, 1)
        else:
            idx[ax] = slice(window[K][0], window[K][1])
    return tuple(idx)


def fixup_slabs(plan: MergePlan, fx: SeamFixup):
    """``(slab, src_slab, wrap_slab)`` index tuples of one fixup: the cells
    corrected, the source layer, and the layer the roll wrapped in (the
    opposite edge of the same window)."""
    nd = plan.ndims
    sh = plan.superblocks[fx.sb].shape
    return (_face_slab_idx(nd, fx.face, fx.window, sh),
            _face_slab_idx(nd, fx.src_face, fx.src_window,
                           plan.superblocks[fx.src_sb].shape),
            _face_slab_idx(nd, fx.face ^ 1, fx.window, sh))


def merged_apply(plan: MergePlan, merged_ops, ys) -> tuple[torch.Tensor, ...]:
    """Matvec in the merged frame: per-super-block roll stencil plus the
    residual-seam fixups.  ``ys``: per-super-block tensors ``(..., *spatial)``
    (leading lane axes broadcast against ``merged_ops``, whose ``diag`` may
    carry the same leading axes, and ``off`` after its face axis); equals
    ``stencil.domain_apply`` composed with pack/unpack."""
    nd = plan.ndims
    out = []
    for si in range(len(plan.superblocks)):
        diag, off = merged_ops[si]
        y = diag * ys[si]
        for F in range(2 * nd):
            y = y + off[F] * torch.roll(ys[si], 1 if F % 2 == 0 else -1,
                                        dims=-1 - face_axis(F))
        out.append(y)
    for fx in plan.fixups:
        slab, src_slab, wrap_slab = fixup_slabs(plan, fx)
        src = ys[fx.src_sb][(Ellipsis,) + src_slab]
        flips = tuple(-1 - K for K in range(nd) if fx.flip[K])
        if flips:
            src = torch.flip(src, dims=flips)
        delta = merged_ops[fx.sb][1][fx.face][(Ellipsis,) + slab] * (
            src - ys[fx.sb][(Ellipsis,) + wrap_slab])
        y = out[fx.sb].clone()
        y[(Ellipsis,) + slab] = y[(Ellipsis,) + slab] + delta
        out[fx.sb] = y
    return tuple(out)


# ---------------------------------------------------------------------------
# plan-time self-check (float64 on the CPU)
# ---------------------------------------------------------------------------

def _np_halo(other, spec, f, ndims):
    """Numpy mirror of ``stencil._halo``."""
    rank = other.ndim
    a0, up0 = spec.axes[0] >> 1, spec.axes[0] & 1
    idx = [slice(None)] * rank
    idx[_array_axis(rank, a0)] = slice(-1, None) if up0 else slice(0, 1)
    slab = other[tuple(idx)]
    d = face_axis(f)
    src_for_my = {d: a0}
    for i in range(1, ndims):
        k = (d + i) % ndims
        ai, upi = spec.axes[i] >> 1, spec.axes[i] & 1
        if upi:
            slab = np.flip(slab, axis=_array_axis(rank, ai))
        src_for_my[k] = ai
    perm = list(range(rank))
    for k, a in src_for_my.items():
        perm[_array_axis(rank, k)] = _array_axis(rank, a)
    return np.transpose(slab, perm)


def _np_domain_apply(topo, ops_np, xs):
    nd = topo.ndims
    out = []
    for b, bt in enumerate(topo.blocks):
        diag, off = ops_np[b]
        y = diag * xs[b]
        for f in range(2 * nd):
            ax = _array_axis(nd, face_axis(f))
            nbr = np.roll(xs[b], 1 if f % 2 == 0 else -1, axis=ax)
            spec = bt.faces[f]
            if spec.kind == BoundKind.CONNECTED:
                vals = _np_halo(xs[spec.connected_block], spec, f, nd)
                idx = [slice(None)] * nd
                idx[ax] = slice(-1, None) if f % 2 else slice(0, 1)
                nbr[tuple(idx)] = vals
            y = y + off[f] * nbr
        out.append(y)
    return out


class _Op:
    def __init__(self, diag, off):
        self.diag, self.off = diag, off


def _self_check(topo: DomainTopo, plan: MergePlan) -> bool:
    """``merged_apply`` against the numpy halo mirror on random float64
    coefficients (FIXED faces carry zero off-coefficients, as in use)."""
    rng = np.random.default_rng(0)
    nd = topo.ndims
    xs, ops_np = [], []
    for bt in topo.blocks:
        shape = bt.shape
        xs.append(rng.standard_normal(shape))
        diag = rng.standard_normal(shape)
        off = rng.standard_normal((2 * nd,) + shape)
        for f, spec in enumerate(bt.faces):
            if spec.kind == BoundKind.FIXED:
                idx = [slice(None)] * nd
                idx[_array_axis(nd, face_axis(f))] = (
                    slice(-1, None) if f % 2 else slice(0, 1))
                off[(f,) + tuple(idx)] = 0.0
        ops_np.append((diag, off))
    ref = _np_domain_apply(topo, ops_np, xs)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ops_t = tuple(_Op(t(d), t(o)) for d, o in ops_np)
    got = merged_apply(plan, pack_ops(plan, ops_t),
                       pack_fields(plan, tuple(t(x) for x in xs)))
    back = unpack_fields(plan, got)
    return all(np.allclose(r, g.numpy(), rtol=1e-12, atol=1e-12)
               for r, g in zip(ref, back))
