"""Merged super-block frame, single-super-block part (counterpart of
``fluidgym_tpu/solver/block_merge.py``).

The JAX package rewrites a multi-block topology into a few axis-aligned
super-blocks whose operator is an exact permutation of the original, so one
resident kernel serves every domain.  This slice ports the plan structures,
``trivial_plan`` (one block, no CONNECTED faces: one super-block, identity
placement, no seam fixups) and the pack/unpack helpers the BiCGStab kernel
dispatch uses.  ``merge_plan`` for multi-block topologies comes with the
multi-block slice.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from fluidgym_tpu_torch.core.domain import BoundKind, DomainTopo, face_axis

__all__ = ["Placement", "SuperBlockPlan", "MergePlan",
           "trivial_plan", "pack_fields", "unpack_fields", "pack_ops"]


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
class MergePlan:
    ndims: int
    superblocks: tuple[SuperBlockPlan, ...]
    # residual-seam corrections of multi-block plans; always empty here
    fixups: tuple = ()


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
        buf[_member_slices(pl, nd)] = part
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
