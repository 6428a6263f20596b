"""Two-level strip-aggregation coarse space for merged pressure solves
(counterpart of ``fluidgym_tpu/solver/coarse_strips.py``).

The slow CG modes of the elongated cylinder/airfoil pressure systems are
smooth along the LONG axis of each super-block (the wake's downstream
direction, the ring's angular direction).  Per super-block, a
piecewise-constant STRIP basis ``W`` partitions that long axis (strips 16
cells wide), and the exact Galerkin coarse matrix ``E = W^T A W`` of the
merged operator (rolls + seam fixups) is assembled in closed form: 1D
coefficient reductions for the in-space band, small static scatters for the
seam couplings, no fine-grid matvec.

The preconditioner ``z = D^-1 r + W (E + eps I)^-1 W^T r`` (additive
Jacobi + coarse correction; SPD since A is SPSD) runs inside K3's coarse
arm (``csrc/cg.cu``, ``ops/cg_cuda_mb.fused_cg_mb(..., coarse_strips=True)``);
``restrict`` and ``prolong`` here are the TPU kernel's arithmetic (a sum
over the short axis, then the strip indicator matrix) and serve the plain
version.

Differences from the JAX module: ``restrict``/``prolong`` take fields with
leading lane axes; ``assemble_E`` sums in float64 and rounds ``E`` to the
operators' dtype once (the JAX module forces full-float32 matmuls because a
bf16-rounded E stalls CG; float64 sums are immune to any TF32 setting);
``coarse_inverse`` inverts in float64 with ``torch.linalg.inv_ex`` (errors
unchecked: ``torch.linalg.inv`` would read ``info`` on the host, one sync
per solve) and projects the constant mode out of the inverse (see its
docstring: the JAX form stalls CG on the airfoil in float32).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from fluidgym_tpu_torch.solver.block_merge import MergePlan, fixup_slabs

__all__ = ["StripSpace", "StripPlan", "strip_plan", "restriction_matrices",
           "restrict", "prolong", "assemble_E", "coarse_inverse"]

STRIP_WIDTH = 16


@dataclass(frozen=True)
class StripSpace:
    sb: int
    axis: int      # ARRAY axis of the sb field that the strips partition
    width: int     # strip width (the last strip may be short)
    n: int         # number of strips
    offset: int    # offset of this space in the concatenated coarse vector


@dataclass(frozen=True)
class StripPlan:
    K: int
    spaces: tuple[StripSpace, ...]

    def space_of(self, sb: int) -> StripSpace | None:
        for sp in self.spaces:
            if sp.sb == sb:
                return sp
        return None


def sb_array_shapes(plan: MergePlan) -> list[tuple[int, ...]]:
    """Array shapes of the super-blocks (major..minor)."""
    nd = plan.ndims
    return [tuple(sb.shape[D] for D in range(nd - 1, -1, -1))
            for sb in plan.superblocks]


@functools.lru_cache(maxsize=None)
def strip_plan(plan: MergePlan, width: int = STRIP_WIDTH) -> StripPlan | None:
    """One strip space per 2D super-block, partitioning its LONGEST array
    axis; super-blocks shorter than two strips get none.  None for 3D plans
    (as in the JAX package) or when no super-block has a space."""
    if plan.ndims != 2:
        return None
    spaces = []
    off = 0
    for s, shape in enumerate(sb_array_shapes(plan)):
        axis = 0 if shape[0] >= shape[1] else 1
        n = -(-shape[axis] // width)
        if n < 2:
            continue
        spaces.append(StripSpace(sb=s, axis=axis, width=width, n=n, offset=off))
        off += n
    if not spaces:
        return None
    return StripPlan(K=off, spaces=tuple(spaces))


@functools.lru_cache(maxsize=None)
def _restriction_matrix(dim: int, width: int, n: int) -> np.ndarray:
    P = np.zeros((n, dim), np.float32)
    for i in range(n):
        P[i, i * width:(i + 1) * width] = 1.0
    return P


def restriction_matrices(plan: MergePlan, sp: StripPlan) -> list[np.ndarray]:
    """Static ``(n, dim)`` strip indicator matrices per space (numpy fp32)."""
    shapes = sb_array_shapes(plan)
    return [_restriction_matrix(shapes[s.sb][s.axis], s.width, s.n)
            for s in sp.spaces]


@functools.lru_cache(maxsize=32)
def _P_tensors(plan: MergePlan, sp: StripPlan, device, dtype):
    return tuple(torch.from_numpy(P).to(device=device, dtype=dtype)
                 for P in restriction_matrices(plan, sp))


# ---------------------------------------------------------------------------
# restriction / prolongation (the plain version's arithmetic; the kernel
# restricts through per-strip cell lists instead)
# ---------------------------------------------------------------------------

def restrict(plan: MergePlan, sp: StripPlan, rs) -> torch.Tensor:
    """``(..., K)`` coarse vector ``W^T r`` for per-super-block fields
    ``rs[s]`` of shape ``(..., H_s, W_s)``."""
    Ps = _P_tensors(plan, sp, rs[0].device, rs[0].dtype)
    segs = []
    for s, P in zip(sp.spaces, Ps):
        # sum over the other (short) array axis, then the indicator rows
        t = rs[s.sb].sum(dim=-1 if s.axis == 0 else -2)
        segs.append(t @ P.T)
    return torch.cat(segs, dim=-1)


def prolong(plan: MergePlan, sp: StripPlan, xc: torch.Tensor):
    """Per-super-block fields ``W xc`` of shape ``(..., H_s, W_s)`` for a
    coarse vector ``xc`` of shape ``(..., K)``."""
    Ps = _P_tensors(plan, sp, xc.device, xc.dtype)
    lead = tuple(xc.shape[:-1])
    outs = [torch.zeros(lead + sh, dtype=xc.dtype, device=xc.device)
            for sh in sb_array_shapes(plan)]
    for s, P in zip(sp.spaces, Ps):
        seg = xc[..., s.offset:s.offset + s.n] @ P          # (..., dim)
        outs[s.sb] = outs[s.sb] + (seg[..., :, None] if s.axis == 0
                                   else seg[..., None, :])
    return tuple(outs)


# ---------------------------------------------------------------------------
# exact Galerkin coarse matrix E = W^T A W of the merged operator
# ---------------------------------------------------------------------------

def _strip_of(space: StripSpace | None, idx: np.ndarray) -> np.ndarray:
    """Coarse index of each cell of ``idx`` ``(cells, nd)`` (0 without a
    space: such rows or columns are dropped by the caller)."""
    if space is None:
        return np.zeros(len(idx), np.int64)
    return space.offset + np.minimum(idx[:, space.axis] // space.width,
                                     space.n - 1)


def _slab_cells(slab, nd: int) -> np.ndarray:
    """``(cells, nd)`` array indices of a slab (row-major over the slab)."""
    return np.stack(np.meshgrid(*[np.arange(sl.start, sl.stop) for sl in slab],
                                indexing="ij"), axis=-1).reshape(-1, nd)


def _seam_pairs(plan: MergePlan, sp: StripPlan):
    """Static index lists of every fixup's contribution to E: fixup cell i
    couples strip ``rows[i]`` (target side) to strip ``cols[i]`` (source
    side), REPLACING the roll-wrapped coupling to strip ``wraps[i]`` --
    ``merged_apply`` computes ``off * (src - wrapped)`` on the slab.
    Returns per fixup ``(slab, has_u, has_v, rows, cols, wraps)``."""
    nd = plan.ndims
    out = []
    for fx in plan.fixups:
        su = sp.space_of(fx.sb)
        sv = sp.space_of(fx.src_sb)
        slab, src_slab, wrap_slab = fixup_slabs(plan, fx)
        tgt_idx = _slab_cells(slab, nd)
        # source enumeration aligned with the target's: merged_apply reads
        # the source slab, flips it along the flipped array axes and adds it
        # elementwise onto the target slab -- flip the coordinate grids the
        # same way before flattening
        src_grids = np.meshgrid(
            *[np.arange(sl.start, sl.stop) for sl in src_slab], indexing="ij")
        for K_ax in range(nd):
            if fx.flip[K_ax]:
                arr_ax = nd - 1 - K_ax
                src_grids = [np.flip(g, axis=arr_ax) for g in src_grids]
        src_idx = np.stack(src_grids, axis=-1).reshape(-1, nd)
        wrap_idx = _slab_cells(wrap_slab, nd)
        rows = _strip_of(su, tgt_idx)
        cols = _strip_of(sv, src_idx)
        wraps = _strip_of(su, wrap_idx)
        out.append((slab, su is not None, sv is not None, rows, cols, wraps))
    return out


@functools.lru_cache(maxsize=16)
def _seam_scatter(plan: MergePlan, sp: StripPlan, device):
    """The seam part of E as one static linear map: ``E.view(-1) += S @ (G @
    cat(off slabs))``, with ``G`` the float64 +-1 matrix that sums each slab
    cell into the distinct flat (row, col) entries it touches (a
    deterministic sum, where a scatter-add would race) and ``S`` the 0/1
    matrix that places those entries in the flat ``(K*K,)`` E (an exact,
    out-of-place scatter, so the assembly maps under ``torch.func.vmap``).
    Returns ``(slabs, S, G)`` with ``slabs`` the ``(sb, face, slab)`` to
    read, or None."""
    K = sp.K
    slabs, flat_rows, flat_cols, signs = [], [], [], []
    m = 0
    for (slab, has_u, has_v, rows, cols, wraps), fx in zip(
            _seam_pairs(plan, sp), plan.fixups):
        if not has_u:
            continue
        slabs.append((fx.sb, fx.face, slab))
        cells = np.arange(m, m + len(rows))
        if has_v:
            flat_rows.append(rows * K + cols)
            flat_cols.append(cells)
            signs.append(np.ones(len(rows)))
        flat_rows.append(rows * K + wraps)
        flat_cols.append(cells)
        signs.append(-np.ones(len(rows)))
        m += len(rows)
    if not slabs:
        return None
    flat = np.concatenate(flat_rows)
    idx, inv = np.unique(flat, return_inverse=True)
    G = np.zeros((len(idx), m), np.float64)
    np.add.at(G, (inv, np.concatenate(flat_cols)), np.concatenate(signs))
    S = np.zeros((K * K, len(idx)), np.float64)
    S[idx, np.arange(len(idx))] = 1.0
    return (tuple(slabs), torch.from_numpy(S).to(device),
            torch.from_numpy(G).to(device))


def assemble_E(plan: MergePlan, sp: StripPlan, merged_ops) -> torch.Tensor:
    """Exact dense ``E = W^T A W`` ``(K, K)`` from the merged ``(diag,
    off)`` pairs (``block_merge.pack_ops`` layout), summed in float64 and
    returned in the operators' dtype."""
    return _assemble_E64(plan, sp, merged_ops).to(merged_ops[0][0].dtype)


def _assemble_E64(plan: MergePlan, sp: StripPlan, merged_ops) -> torch.Tensor:
    device = merged_ops[0][0].device
    f64 = torch.float64
    Ps = _P_tensors(plan, sp, device, f64)
    K = sp.K
    nd = plan.ndims
    E = torch.zeros((K, K), dtype=f64, device=device)
    for s, P in zip(sp.spaces, Ps):
        diag, off = (t.to(f64) for t in merged_ops[s.sb])
        a = s.axis                      # strip axis (array axis)
        o = 1 - a                       # reduced axis
        # faces whose roll moves along the strip axis shift the strip id;
        # all others keep it.  The array axis of face f is (nd-1) - f//2.
        shift_faces = [f for f in range(2 * nd) if (nd - 1 - f // 2) == a]
        keep_faces = [f for f in range(2 * nd) if (nd - 1 - f // 2) != a]
        m_keep = diag.sum(dim=o)
        for f in keep_faces:
            m_keep = m_keep + off[f].sum(dim=o)
        Eb = (P * m_keep[None, :]) @ P.T
        for f in shift_faces:
            m = off[f].sum(dim=o)
            # roll +1 (f even) reads index i-1: cell i couples to i-1, so
            # the source indicator is P shifted by +1
            P_src = torch.roll(P, 1 if f % 2 == 0 else -1, dims=1)
            Eb = Eb + (P * m[None, :]) @ P_src.T
        # E's diagonal block of this space (the spaces are disjoint), out
        # of place so that the assembly maps under torch.func.vmap
        lo, hi = s.offset, K - s.offset - s.n
        E = E + torch.nn.functional.pad(Eb, (lo, hi, lo, hi))
    seam = _seam_scatter(plan, sp, device)
    if seam is not None:
        slabs, S, G = seam
        vals = torch.cat([merged_ops[sb][1][face][slab].reshape(-1)
                          for sb, face, slab in slabs]).to(f64)
        E = E + (S @ (G @ vals)).reshape(K, K)
    return E


def coarse_inverse(plan: MergePlan, sp: StripPlan, merged_ops,
                   eps_rel: float = 1e-6) -> torch.Tensor:
    """Regularized dense inverse ``(E + eps I)^-1``, ``eps = eps_rel *
    trace(E) / K`` (the strip basis shares the constant mode with null(A);
    eps keeps it SPD), in the operators' dtype.

    Deliberate difference from the JAX package: the inverse is returned as
    ``Q (E + eps I)^-1 Q`` with ``Q = I - 1_K 1_K^T / K``.  Where the strips
    cover every cell (``W 1_K = 1``; the cylinder and the airfoil) and the
    pressure operator's rows sum to zero (to the rounding of its
    coefficients, ~1e-8 in float32), ``1_K`` is E's (near-)null vector,
    which ``(E + eps I)^-1`` scales by ~``1/eps`` (~1e6 x the other modes),
    while a residual of the consistent system has ``1_K^T W^T r = sum(r) =
    0``: on an exactly singular operator ``Q`` changes nothing.  In float32
    ``sum(r)`` is rounding noise, and the JAX package's form amplifies it
    into a large constant in ``z`` that stalls CG on the airfoil's pressure
    system (unconverged after 291 iterations, where Jacobi alone converges
    in 184; ``scripts/port_strips_rounding.py``); with ``Q`` the same solve
    converges in 147.  Elsewhere ``Q`` drops one coarse direction; the
    preconditioner stays SPD either way."""
    E = _assemble_E64(plan, sp, merged_ops)
    K = sp.K
    eps = eps_rel * torch.trace(E) / K
    eye = torch.eye(K, dtype=torch.float64, device=E.device)
    inv, _info = torch.linalg.inv_ex(E + eps * eye)
    Q = eye - torch.full_like(eye, 1.0 / K)
    return (Q @ inv @ Q).to(merged_ops[0][0].dtype)
