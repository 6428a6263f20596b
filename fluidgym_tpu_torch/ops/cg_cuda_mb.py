"""K2 and K3: whole-solve lockstep Krylov kernels in the merged frame.

Counterpart of ``fluidgym_tpu/ops/cg_pallas_mb.py``:

* K3 (TPU kernel ``_kernel``, entry ``fused_cg_mb``): Jacobi-PCG over the
  super-blocks of a ``block_merge.merge_plan``, every dot product joint over
  the super-blocks of a lane, true-residual refresh every 100 iterations,
  warm start, stall patience, return-best, zero-RHS short-circuit;
* K2 (TPU kernel ``_kernel_bicg``, entry ``fused_bicgstab_mb``):
  right-Jacobi BiCGStab, in the single-super-block form of
  ``block_merge.trivial_plan`` (one grid, roll-form matvec) and in the
  merged multi-super-block form ("K2-mb").

Lanes are solve components sharing one operator, and the envs of a
``torch.func.vmap`` batch (``cg_cuda.LaneFold``: one operator per env); each
lane stops on its own NORM2_NORMALIZED test (``tol^2 * n_lane``), with one
iteration counter shared by the lanes of a lockstep chunk (``chunk``, as in
``cg_cuda``).

On the card a multi-super-block plan is ONE flat buffer per lane (the
super-blocks back to back), and its seam fixups live in a per-cell
neighbour table built once per plan (``neighbor_table``; see
``csrc/merged.cuh``).  The wrappers take per-super-block tensors in
``block_merge.pack_ops`` / ``pack_fields`` layout and flatten them:

* ``fused_cg_mb`` (K3) and ``fused_bicgstab_mb`` (K2, both forms) launch the
  CUDA kernels for CUDA tensors (``csrc/cg.cu`` ``fg_cg_mb_solve``,
  ``csrc/bicgstab_mb.cu``) and count each launch, per form:
  ``fused_cg_mb.launches`` (identity seams; ``.launches_3d`` those of them
  in 3D, CylinderJet3D's "K3-3D") and ``.flip_launches`` (a plan with flip
  seams, the reflected C-grid cut; ``.flip_launches_3d`` those of them in
  3D, Airfoil3D's "K3-3D-flip"); ``fused_bicgstab_mb.launches`` (single
  super-block; ``.launches_3d`` those of them in 3D, RBC3D's "K2-3D"),
  ``.merged_launches`` (``.merged_launches_3d`` those of them in 3D,
  "K2-mb-3D") and ``.merged_flip_launches`` (``.merged_flip_launches_3d``,
  "K2-mb-3D-flip").  A 3D merged plan's lanes
  take the spread arm (below): their rows do not fit a cluster's shared
  memory.
  CPU tensors run the plain versions; any other device raises.  A flip seam
  needs nothing of its own in the kernels: the neighbour table reverses the
  source slab once, when it is built.
* ``fused_cg_mb(..., coarse_strips=True)`` is K3-coarse (TPU kernel
  ``_kernel`` with ``coarse=``): the strip-coarse two-level preconditioner
  of ``solver/coarse_strips.py`` inside the solve (``csrc/cg.cu``
  ``fg_cg_mb_coarse_solve``), counted as ``fused_cg_mb.coarse_launches``
  (identity seams) and ``.coarse_flip_launches`` (flip seams).  ``Einv`` is
  computed from the operator on every call, as in the JAX package; the
  kernel restricts through per-strip cell lists (``strip_lists``, built once
  per plan).  A single env's lane takes the cluster arm (below), as K3's.
* ``fused_cg_mb(..., agg=space)`` is K3-agg (no TPU kernel: the JAX
  package solves this system with ``linsolve.cg`` and the aggregation
  ``coarse_fn``): the additive two-level preconditioner ``z = D^-1 r + W
  Einv W^T r`` over the tiles of ``solver/piso.py``'s aggregation space,
  ``Einv`` fixed (built once per env from the state at reset and folded with
  ``d`` in float64, ``piso.build_agg_coarse``), the restriction through
  per-tile cell lists and the prolongation through each cell's tile
  (``agg_space``, built once with the space).  Counted as
  ``fused_cg_mb.agg_launches`` (identity seams) and ``.agg_flip_launches``
  (flip seams: the airfoil's "K3-agg-flip", k = 1,194 tiles).  A single
  env's lane takes the cluster arm (``merged_arm(..., "cg_coarse",
  coarse_k=K)``).
* ``fused_cg_mb_plain`` and ``fused_bicgstab_plain`` are the plain PyTorch
  versions, with ``.calls`` counters; in the merged frame their matvec is
  ``block_merge.merged_apply`` (rolls plus slab fixups, the TPU kernel's
  arithmetic), independent of the neighbour table, and the coarse term of
  ``fused_cg_mb_plain(..., coarse=...)`` is ``coarse_strips.restrict`` /
  ``prolong``, independent of the cell lists; with an ``AggSpace`` it
  sums and spreads through each cell's tile (``cidx``), independent of the
  per-tile lists.

The cluster arm (K3, K3-coarse and K2-mb, both seam forms): a lane can be
spread over a thread-block cluster of C blocks (C in 2, 4, 8, 16), one per
SM, each owning a contiguous range of the flat buffer (``cluster_ranges``)
with its operator rows in shared memory (``stage_bytes``; a C whose rows
do not fit is refused).  Its sums are the one-block form's, bit for bit (K3-coarse's
strip sums too: one warp per strip, gathered through distributed shared
memory), so it computes what a one-lane launch of the chunk grid
computes.
``default_cluster`` picks C by shape from the card's own occupancy answer
(``max_active_clusters``); C = 1 is the chunk grid, unchanged, and stays
the shape of a batch with more lanes than the card holds clusters.
``cluster=`` on ``fused_cg_mb`` / ``fused_bicgstab_mb`` forces C, as
``chunk=`` forces the chunk; ``pinned_cluster`` pins the rule's answer
inside a ``with`` block (an A/B of the two arms on the main path).  Every
launch still counts as its form; ``.cluster_launches`` on each wrapper
counts those with C > 1.

K2 over the trivial plan takes ``cg_cuda``'s resident arm at one lane per
block where a lane fits (``cg_cuda.default_resident``; its launches count
in ``fused_bicgstab_mb.resident_launches`` too), else its spread arm where
``cg_cuda.default_spread`` gives G (RBC3D's lanes;
``fused_bicgstab_mb.spread_launches``).

The spread arm of the merged forms (K3 and K2-mb over a 3D plan:
CylinderJet3D's 341,568- and 749,568-cell lanes, whose rows no cluster
holds): one lane over G co-resident blocks of a cooperative launch, as
``cg_cuda``'s spread arm, the operator rows and the neighbour table read
from L2, every sum the one-block form's, so it returns the chunk grid's
x, iterations and residual bit for bit.  ``merged_arm`` picks the arm of a
merged solve: the cluster rule first, then the spread rule
(``cg_cuda.default_spread`` over the merged instances, pinned by
``cg_cuda.pinned_spread``), and where no G holds all the lanes of a solve
at once but one holds a single lane, one lane per launch at that G
(CylinderJet3D-hard's 2,481,408-cell velocity lanes: each lane stops on
its own, so that too is the chunk grid's bits); ``merged_launcher(...,
spread=G, chains=)``
gives a raw launch; ``fused_cg_mb.spread_launches`` and
``fused_bicgstab_mb.merged_spread_launches`` count the launches that took
it, one per lane where the lanes go one per launch.  A one-lane launch whose
chain terms no G's shared memory holds (Airfoil3D's 7,051,776-cell lanes)
keeps them in global memory (``cg_cuda.spread_global_terms``, pinned by
``cg_cuda.pinned_global_terms``; ``merged_launcher(..., global_terms=)``),
counted in ``fused_cg_mb.global_terms_launches`` and
``fused_bicgstab_mb.merged_global_terms_launches``.

Bound on the H100 and what the design does about it: see the notes at the
top of ``csrc/cg.cu`` and ``csrc/bicgstab_mb.cu``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from fluidgym_tpu_torch.core.domain import face_axis
from fluidgym_tpu_torch.ops import _build
from fluidgym_tpu_torch.ops.cg_cuda import (SMEM_PER_BLOCK, SMEM_STATIC,
                                            LaneFold,
                                            block_ranges, block_seg,
                                            cg_lockstep, check_chunk,
                                            check_resident, check_spread,
                                            default_chunk, default_spread,
                                            device_kind, guard,
                                            lockstep_chunks, roll_arm,
                                            roll_matvec, split_spread,
                                            spread_buffers, spread_chains,
                                            spread_global_terms,
                                            tol2_sum_f32, CHAINS_GLOBAL)
from fluidgym_tpu_torch.solver import coarse_strips as cs
from fluidgym_tpu_torch.solver.block_merge import (MergePlan, fixup_slabs,
                                                   merged_apply)
from fluidgym_tpu_torch.solver.linsolve import SolveInfo

__all__ = ["fused_bicgstab_mb", "fused_bicgstab_plain", "fused_cg_mb",
           "fused_cg_mb_plain", "neighbor_table", "strip_lists",
           "AggSpace", "agg_space", "AGG_MAX_K",
           "flatten_fields", "unflatten_fields", "flatten_ops",
           "default_cluster", "cluster_ranges", "stage_bytes", "pinned_cluster",
           "max_active_clusters", "rows_fit", "CLUSTER_SIZES", "merged_arm",
           "MergedArm", "merged_launcher", "roll_form_arm"]


# ---------------------------------------------------------------------------
# the merged frame as one flat buffer per lane
# ---------------------------------------------------------------------------

def flatten_fields(plan: MergePlan, xs) -> torch.Tensor:
    """Per-super-block ``(L, *shape_s)`` -> one ``(L, n)`` buffer."""
    L = xs[0].shape[0]
    return torch.cat([x.reshape(L, -1) for x in xs], dim=1)


def unflatten_fields(plan: MergePlan, flat: torch.Tensor):
    """``(L, n)`` -> per-super-block ``(L, *shape_s)`` views."""
    shapes = cs.sb_array_shapes(plan)
    parts = torch.split(flat, [math.prod(s) for s in shapes], dim=1)
    return tuple(p.reshape((flat.shape[0],) + s) for p, s in zip(parts, shapes))


def flatten_ops(plan: MergePlan, diags, offs):
    """Per-super-block ``diag (*shape_s)`` / ``off (2*ndims, *shape_s)`` ->
    ``diag (1, n)`` and ``off (1, 2*ndims, n)``."""
    nf = 2 * plan.ndims
    diag = torch.cat([d.reshape(-1) for d in diags])
    off = torch.cat([o.reshape(nf, -1) for o in offs], dim=1)
    return diag.unsqueeze(0), off.unsqueeze(0)


@functools.lru_cache(maxsize=16)
def neighbor_table(plan: MergePlan, device) -> torch.Tensor:
    """``(2*ndims, n)`` int32 on ``device``: flat index of every cell's
    neighbour across each face in the merged frame (the circular roll of its
    super-block, replaced on seam slabs by the source super-block's cell).
    Built once per plan and device."""
    nd = plan.ndims
    shapes = cs.sb_array_shapes(plan)
    bases = np.cumsum([0] + [math.prod(s) for s in shapes])
    idx = [bases[s] + np.arange(math.prod(sh)).reshape(sh)
           for s, sh in enumerate(shapes)]
    tab = [[np.roll(ix, 1 if F % 2 == 0 else -1, axis=nd - 1 - face_axis(F))
            for ix in idx] for F in range(2 * nd)]
    # merged_apply ADDS each fixup's delta where the table REPLACES the
    # neighbour: the two agree only if no two fixups write one entry
    written = [[np.zeros(sh, bool) for sh in shapes] for _ in range(2 * nd)]
    for fx in plan.fixups:
        slab, src_slab, _ = fixup_slabs(plan, fx)
        if written[fx.face][fx.sb][slab].any():
            raise ValueError(
                f"seam fixups overlap on super-block {fx.sb}, face {fx.face}")
        written[fx.face][fx.sb][slab] = True
        src = idx[fx.src_sb][src_slab]
        flips = tuple(nd - 1 - K for K in range(nd) if fx.flip[K])
        if flips:
            src = np.flip(src, axis=flips)
        tab[fx.face][fx.sb][slab] = src
    table = np.stack([np.concatenate([t.reshape(-1) for t in per])
                      for per in tab]).astype(np.int32)
    return torch.from_numpy(table).to(device)


@functools.lru_cache(maxsize=16)
def strip_lists(plan: MergePlan, device):
    """K3-coarse's view of ``cs.strip_plan(plan)`` on ``device``,
    built once per plan: ``(strip_ptr (K+1,), strip_cells, cidx (n,))``
    int32, the strips' flat cell indices in CSR form (ascending within a
    strip) and every cell's strip (-1 in a super-block without a space)."""
    sp = cs.strip_plan(plan)
    shapes = cs.sb_array_shapes(plan)
    bases = np.cumsum([0] + [math.prod(s) for s in shapes])
    cidx = np.full(int(bases[-1]), -1, np.int64)
    cells, ptr = [], [0]
    for space in sp.spaces:
        sh = shapes[space.sb]
        idx = bases[space.sb] + np.arange(math.prod(sh)).reshape(sh)
        sid = np.minimum(np.arange(sh[space.axis]) // space.width, space.n - 1)
        for i in range(space.n):
            sel = idx[sid == i] if space.axis == 0 else idx[:, sid == i]
            c = np.sort(sel.reshape(-1))
            cells.append(c)
            ptr.append(ptr[-1] + len(c))
            cidx[c] = space.offset + i
    return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                 for a in (np.asarray(ptr), np.concatenate(cells), cidx))


#: the most tiles K3-agg takes: two floats per tile of a block's dynamic
#: shared memory beside the cluster arm's rows (``stage_bytes``;
#: ``FG_MAX_AGG_K`` in ``csrc/cg.cu``)
AGG_MAX_K = 2048


class AggSpace(NamedTuple):
    """K3-agg's view of an aggregation space in the merged frame of a plan
    (``agg_space``): every cell's tile and the tiles' cell lists in CSR
    form, and the fixed ``(K, K)`` coarse inverse."""

    cidx: torch.Tensor    # (n,) int32: each flat cell's tile (-1: none)
    ptr: torch.Tensor     # (K + 1,) int32: tile k owns cells[ptr[k]:ptr[k+1]]
    cells: torch.Tensor   # (n,) int32: flat cell indices, ascending per tile
    einv: torch.Tensor    # (K, K)
    K: int


def agg_space(plan: MergePlan, tile_ids, einv: torch.Tensor) -> AggSpace:
    """The merged frame's view of per-block tile ids (``tile_ids``: per
    block ``(*shape)`` integers in ``[0, K)``): packed like any field
    (``block_merge.pack_fields``; a flip seam reverses cells, so a tile's
    cells need not be contiguous), then grouped by tile.  Built once per
    space, on the device of ``einv``."""
    from fluidgym_tpu_torch.solver.block_merge import pack_fields

    K = einv.shape[-1]
    # +1: a cell of a super-block that no block covers packs as 0 -> -1
    packed = pack_fields(plan, tuple(t.to(torch.int64) + 1 for t in tile_ids))
    cidx = (torch.cat([p.reshape(-1) for p in packed]) - 1).cpu()
    if int(cidx.max()) >= K:
        raise ValueError(f"a tile id is out of range for K = {K}")
    covered = torch.nonzero(cidx >= 0).reshape(-1)
    order = torch.argsort(cidx[covered], stable=True)
    cells = covered[order]
    counts = torch.bincount(cidx[covered], minlength=K)
    ptr = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
    dev = einv.device
    return AggSpace(cidx=cidx.to(torch.int32).to(dev),
                    ptr=ptr.to(torch.int32).to(dev),
                    cells=cells.to(torch.int32).to(dev), einv=einv, K=K)


def _coarse_precond(plan: MergePlan, sp, einv, diag, precondition: bool):
    """``z = D^-1 r + W Einv W^T r`` on flat ``(lanes, n)`` residuals
    (``einv``: ``(1|lanes, K, K)``), through ``coarse_strips.restrict`` /
    ``prolong`` for a strip plan (the TPU kernel's ``apply_precond``), or
    each cell's tile for an ``AggSpace``."""
    inv_diag = 1.0 / diag if precondition else None
    if isinstance(sp, AggSpace):
        cidx = sp.cidx.to(torch.int64)
        inside = (cidx >= 0).to(einv.dtype)
        cid = cidx.clamp(min=0)

        def restrict(r):
            rc = torch.zeros(r.shape[:-1] + (sp.K,), dtype=r.dtype,
                             device=r.device)
            return rc.index_add_(-1, cid, r * inside)

        def prolong(xc):
            return xc[..., cid] * inside
    else:
        def restrict(r):
            return cs.restrict(plan, sp, unflatten_fields(plan, r))

        def prolong(xc):
            return flatten_fields(plan, cs.prolong(plan, sp, xc))

    def precond(r):
        z = inv_diag * r if precondition else r
        xc = (einv @ restrict(r).unsqueeze(-1)).squeeze(-1)
        return z + prolong(xc)

    return precond


def _merged_mv(plan: MergePlan, diag, off):
    """Plain merged-frame matvec on flat ``(L, n)`` tensors
    (``block_merge.merged_apply`` on the unflattened super-blocks), for one
    shared operator (``diag (1, n)``, ``off (1, 2*ndims, n)``) or one per
    lane (leading axis L)."""
    nf = 2 * plan.ndims
    L = diag.shape[0]
    dg = unflatten_fields(plan, diag)
    of = [o.reshape((L, nf) + tuple(o.shape[1:])).movedim(1, 0)
          for o in unflatten_fields(plan, off.reshape(L * nf, -1))]
    if L == 1:
        dg, of = [d[0] for d in dg], [o[:, 0] for o in of]
    mops = tuple(zip(dg, of))

    def mv(v):
        return flatten_fields(plan, merged_apply(plan, mops,
                                                 unflatten_fields(plan, v)))

    return mv


# ---------------------------------------------------------------------------
# the cluster arm: the partition and the rule that picks C
# ---------------------------------------------------------------------------

#: cluster sizes of the merged-frame kernels' cluster arm, largest first
#: (C = 1 is the chunk grid)
CLUSTER_SIZES = (16, 8, 4, 2)
#: the rule keeps at least one cell per thread of a 1024-thread block
MIN_CELLS_PER_BLOCK = 1024

_PINNED: int | None = None


class MergedArm(NamedTuple):
    """``merged_arm``'s answer: blocks per lane of the cluster arm (1: no
    cluster), G of the spread arm (0: none) and whether the lanes go one
    per launch (``per_lane``)."""

    cluster: int
    spread: int
    per_lane: bool


#: the cells ``[c0, c1)`` that each block of a C-block cluster owns in a
#: lane of ``n`` cells (``cluster_ranges(n, C)``)
cluster_ranges = block_ranges


def stage_bytes(n: int, C: int, ndims: int, coarse_k: int = 0) -> int:
    """Dynamic shared memory of one block in the cluster arm: the operator
    rows of its range (diag, ``2*ndims`` off and ``2*ndims`` int32
    neighbours per cell), then two floats for each cell of its 1024 / C
    sum chains (``fg_stage_bytes``), then K3-agg's two floats per tile
    (``coarse_k`` tiles, 0 for the other forms; ``fg_agg_bytes``)."""
    chains = 2 * (1024 // C) * -(-n // 1024)
    return (block_seg(n, C) * (1 + 4 * ndims) + chains + 2 * coarse_k) * 4


def rows_fit(n: int, C: int, ndims: int, coarse_k: int = 0) -> bool:
    """Whether a block's operator rows (and K3-agg's ``coarse_k`` tiles)
    fit in its shared memory at C."""
    return stage_bytes(n, C, ndims, coarse_k) <= SMEM_PER_BLOCK - SMEM_STATIC


@functools.lru_cache(maxsize=None)
def max_active_clusters(algo: str, ndims: int, C: int, n: int,
                        device: torch.device, coarse_k: int = 0) -> int:
    """How many C-block clusters of the cluster arm of ``algo`` (``"cg"``:
    K3, ``"cg_coarse"``: K3-coarse, or K3-agg over ``coarse_k`` > 0 tiles,
    ``"bicgstab"``: K2-mb) over ``n``-cell lanes the card holds at once:
    ``cudaOccupancyMaxActiveClusters`` (C's rows must fit, ``rows_fit``)."""
    lib = _build.library()
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        if algo == "cg_coarse":
            status = lib.fg_cg_mb_coarse_cluster_occupancy(
                ndims, C, n, coarse_k, ctypes.addressof(out))
        else:
            entry = {"cg": lib.fg_cg_mb_cluster_occupancy,
                     "bicgstab": lib.fg_bicgstab_mb_cluster_occupancy}[algo]
            status = entry(ndims, C, n, ctypes.addressof(out))
    _build.check(status, f"{algo} cluster occupancy at C = {C}")
    return out.value


def default_cluster(lanes: int, n: int, ndims: int, chunk: int, device,
                    algo: str = "cg", coarse_k: int = 0) -> int:
    """Blocks per lane of a merged-frame solve of ``lanes`` lanes of ``n``
    cells: the largest C in ``CLUSTER_SIZES`` with one lane per cluster
    (``chunk == 1``), every lane's cluster co-resident on the card
    (``max_active_clusters >= lanes``), a block's operator rows in its
    shared memory (``stage_bytes``), and at least ``MIN_CELLS_PER_BLOCK``
    cells per block; else 1 (the chunk grid), as on the CPU.  A dispatch by
    shape: 1 stays the shape of a batch with more lanes than the card holds
    clusters.  ``pinned_cluster`` overrides it.  ``coarse_k``: K3-agg's
    tiles (``algo="cg_coarse"``; 0: K3-coarse's strips), whose two floats
    per tile share the rows' memory."""
    if torch.device(device).type != "cuda" or chunk != 1:
        return 1
    if _PINNED is not None:
        return _PINNED
    for C in CLUSTER_SIZES:
        if n < MIN_CELLS_PER_BLOCK * C or not rows_fit(n, C, ndims, coarse_k):
            continue
        if max_active_clusters(algo, ndims, C, n, torch.device(device),
                               coarse_k) >= lanes:
            return C
    return 1


@contextlib.contextmanager
def pinned_cluster(C: int | None):
    """Inside the ``with`` block ``default_cluster`` answers C for the
    card's one-lane-per-cluster solves (None: the rule), and afterwards
    what it answered before: an A/B of the cluster arm against the chunk
    grid on the main path, which picks C itself."""
    if C is not None and C not in (1,) + CLUSTER_SIZES:
        raise ValueError(f"cluster must be 1 or one of {CLUSTER_SIZES}, got {C}")
    global _PINNED
    before, _PINNED = _PINNED, C
    try:
        yield
    finally:
        _PINNED = before


def merged_arm(lanes: int, n: int, ndims: int, chunk: int, device,
               algo: str = "cg", coarse_k: int = 0) -> MergedArm:
    """The arm of a merged-frame solve (K3: ``algo="cg"``, K3-coarse and
    K3-agg: ``"cg_coarse"``, K2-mb: ``"bicgstab"``) of ``lanes`` lanes of
    ``n`` cells: ``(C, G,
    per_lane)``.  The cluster rule first (``default_cluster``): a lane it
    spreads over C > 1 blocks keeps the cluster arm (the 2D cylinder at
    C = 8 or 16, the airfoil at 16).  Else, for a 3D plan with one lane per
    block, the spread rule (``cg_cuda.default_spread`` over the merged
    instances: the largest G with ``lanes * G`` blocks co-resident and
    ``SPREAD_MIN_CELLS`` cells per block; ``cg_cuda.pinned_spread`` pins
    it).  Where no G holds the lanes at once but one holds a single lane
    with ``SPLIT_BLOCKS_PER_LANE`` blocks per lane of the solve, the lanes
    go one per launch at that G (``per_lane``: CylinderJet3D-hard's 3
    velocity lanes of 2,481,408 cells at G = 128); each lane stops on its
    own, so that is the chunk grid's bits.  A one-lane launch whose chain
    terms fit no G's shared memory takes G = 128 with the terms in global
    memory (``cg_cuda.spread_global_terms``: Airfoil3D's 7,051,776-cell
    pressure lane, and its 3 velocity lanes one per launch).  The coarse
    forms (2D plans only) ask the cluster rule over their own instance
    (K3-coarse's strips: ``coarse_k = 0``; K3-agg: ``coarse_k`` tiles) and
    have no spread arm.  ``(1, 0, False)`` is the chunk grid: the answer on
    the CPU, for chunks of several lanes, in 2D where no cluster fits, and
    with ``pinned_spread(0)``."""
    if algo == "cg_coarse":
        return MergedArm(default_cluster(lanes, n, ndims, chunk, device,
                                         algo, coarse_k) if ndims == 2 else 1,
                         0, False)
    C = default_cluster(lanes, n, ndims, chunk, device, algo)
    if C > 1 or ndims != 3:
        return MergedArm(C, 0, False)
    G = default_spread(lanes, n, ndims, chunk, device, algo + "_mb")
    if G:
        return MergedArm(1, G, False)
    G1 = split_spread(lanes, n, ndims, chunk, device, algo + "_mb")
    return MergedArm(1, G1, G1 > 0)


def roll_form_arm(lanes: int, n: int, ndims: int, chunk: int,
                  device) -> tuple[bool, int, bool]:
    """The arm of K2 over the trivial plan (RBC's and the channel's
    solves) of ``lanes`` lanes of ``n`` cells: ``(resident, G,
    per_lane)``.  ``cg_cuda.roll_arm`` first (the resident arm, then the
    spread arm with every lane at once); where it answers the chunk grid,
    ``cg_cuda.split_spread`` may send the lanes one per launch at the G that
    holds one lane (TCFLarge's 3 velocity lanes of 1,048,576 cells at G =
    128: a block's chain terms need 262,144 B at G = 32, over its shared
    memory, and 3 lanes at G = 64 need 192 co-resident blocks).  K2 stops
    per component, so that is the chunk grid's bits."""
    res, G = roll_arm(lanes, n, ndims, chunk, device, "bicgstab")
    if res or G:
        return res, G, False
    G = split_spread(lanes, n, ndims, chunk, device, "bicgstab")
    return False, G, G > 0


def check_cluster(cluster: int, chunk: int, arm_ok: bool = True) -> None:
    """The kernels take C = 1, or C in ``CLUSTER_SIZES`` with chunk 1 on a
    form that has the cluster arm (``arm_ok``)."""
    if cluster not in (1,) + CLUSTER_SIZES:
        raise ValueError(f"cluster must be 1 or one of {CLUSTER_SIZES}, "
                         f"got {cluster}")
    if cluster > 1 and chunk != 1:
        raise ValueError(f"the cluster arm takes one lane per cluster "
                         f"(chunk 1), got chunk {chunk}")
    if cluster > 1 and not arm_ok:
        raise ValueError("this kernel form has no cluster arm (K2 over the "
                         "trivial plan takes cluster 1)")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bicgstab_lockstep(mv, diag, b, x0, *, tol2_sum: float, maxiter: int,
                      stall_iters: int, precondition: bool, return_best: bool):
    """The lockstep right-Jacobi BiCGStab loop of K2 in plain PyTorch, on
    ``(lanes, ...)`` tensors.  Returns ``(x, iterations (lanes,),
    residual_sum (lanes,))``."""
    L = b.shape[0]
    red = lambda a: a.reshape(L, -1).sum(dim=1)
    lane = lambda s: s.reshape((L,) + (1,) * (b.dim() - 1))
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
        # a NaN residual counts as frozen (it never holds the chunk either)
        done = ~(rs > tol2_sum) | stalled
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


def fused_bicgstab_plain(diag, off, b, x0, *, ndims: int, tol2_sum: float,
                         maxiter: int, stall_iters: int, precondition: bool,
                         return_best: bool, plan: MergePlan | None = None,
                         chunk: int | None = None):
    """Plain PyTorch K2.  Without ``plan`` (the single-super-block form):
    ``(lanes, *spatial)`` tensors, ``diag``/``off`` with a leading lane axis
    of 1 or ``lanes``.  With a multi-super-block ``plan`` (K2-mb): the flat
    merged layout, ``b``/``x0`` ``(lanes, n)``, ``diag (1|lanes, n)``, ``off
    (1|lanes, 2*ndims, n)``.  Lockstep chunks of ``chunk`` lanes (one chunk
    when None).  Returns ``(x, iterations (lanes,), residual_sum
    (lanes,))``."""
    fused_bicgstab_plain.calls += 1

    def solve(b, x0, d, o):
        mv = (_merged_mv(plan, d, o) if plan is not None
              else lambda v: roll_matvec(d, o, v, ndims))
        return bicgstab_lockstep(mv, d, b, x0, tol2_sum=tol2_sum,
                                 maxiter=maxiter, stall_iters=stall_iters,
                                 precondition=precondition,
                                 return_best=return_best)

    return lockstep_chunks(solve, chunk, b, x0, diag, off)


fused_bicgstab_plain.calls = 0


def fused_cg_mb_plain(plan: MergePlan, diag, off, b, x0, *, tol2_sum: float,
                      maxiter: int, stall_iters: int, precondition: bool,
                      return_best: bool, coarse=None,
                      chunk: int | None = None):
    """Plain PyTorch K3 on the flat merged layout (``b``/``x0`` ``(lanes,
    n)``, ``diag (1|lanes, n)``, ``off (1|lanes, 2*ndims, n)``); with
    ``coarse = (sp, einv)`` (a ``coarse_strips.StripPlan`` and ``(1|lanes,
    K, K)`` like ``diag``) K3-coarse, with ``(AggSpace, einv)`` K3-agg.
    Lockstep chunks of ``chunk`` lanes
    (one chunk when None).  Returns ``(x, iterations (lanes,), residual_sum
    (lanes,))``."""
    fused_cg_mb_plain.calls += 1
    sp, einv = coarse if coarse is not None else (None, None)

    def solve(b, x0, d, o, e):
        precond = (None if e is None
                   else _coarse_precond(plan, sp, e, d, precondition))
        return cg_lockstep(_merged_mv(plan, d, o), d, b, x0, tol2_sum=tol2_sum,
                           maxiter=maxiter, stall_iters=stall_iters,
                           precondition=precondition, return_best=return_best,
                           precond=precond)

    return lockstep_chunks(solve, chunk, b, x0, diag, off, einv)


fused_cg_mb_plain.calls = 0


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _check_operands(b, diag, off, x0, L, chunk):
    check_chunk(L, chunk)
    dev = b.device
    for name, t in (("b", b), ("diag", diag), ("off", off), ("x0", x0)):
        if t is not None and (t.device != dev or t.dtype != torch.float32):
            raise ValueError(f"{name} must be float32 on {dev}")
    op_per_lane = int(diag.shape[0] != 1)
    if op_per_lane and diag.shape[0] != L:
        raise ValueError("diag/off must have 1 or `lanes` leading entries")
    return op_per_lane


def _launch(diag, off, b, x0, per_lane: bool = False, **kw):
    """K2 over the trivial plan: one launch of ``launcher``, or with
    ``per_lane`` one launch per lane in turn (``cg_cuda.split_spread``).
    Returns ``(x, iterations, residual_sum)``."""
    if not per_lane:
        return launcher(diag, off, b, x0, **kw)()
    one = lambda t, l: t if t is None or t.shape[0] == 1 else t[l:l + 1]
    outs = [launcher(one(diag, l), one(off, l), b[l:l + 1], one(x0, l), **kw)()
            for l in range(b.shape[0])]
    return tuple(torch.cat(t) for t in zip(*outs))


def launcher(diag, off, b, x0, *, ndims, tol2_sum, maxiter, stall_iters,
             precondition, return_best, chunk, resident=False, spread=0,
             chains=None):
    """K2, single-super-block form, on ``(lanes, *spatial)`` tensors: check
    and lay out the operands, allocate the outputs and scratch once, and
    return ``launch()``, one kernel launch into those buffers returning
    ``(x, iterations, residual_sum)`` (as ``cg_cuda.launcher``).
    ``resident``: the resident arm (chunk 1, a 2D lane whose bytes fit);
    ``spread``, ``chains``: the spread arm, as ``cg_cuda.launcher``."""
    L = b.shape[0]
    spatial = tuple(b.shape[1:])
    if len(spatial) != ndims or ndims not in (2, 3):
        raise ValueError(f"b must be (lanes, *spatial) with {ndims} spatial axes")
    op_per_lane = _check_operands(b, diag, off, x0, L, chunk)
    check_resident(resident, chunk, math.prod(spatial), ndims)
    chains = (spread_chains(math.prod(spatial), spread, ndims)
              if chains is None else bool(chains))
    check_spread(spread, chunk, resident, ndims, chains)
    b = b.contiguous()
    diag = diag.contiguous()
    off = off.contiguous()
    x0c = x0.contiguous() if x0 is not None else b
    x = torch.empty_like(b)
    scratch = [torch.empty_like(b) for _ in range(8)]
    iters = torch.empty(L, dtype=torch.int32, device=b.device)
    rs = torch.empty(L, dtype=torch.float32, device=b.device)
    nz = spatial[0] if ndims == 3 else 1
    ny, nx = spatial[-2], spatial[-1]
    lib = _build.library()
    # the closure holds every buffer it hands the kernel by pointer
    bufs = (b, diag, off, x0c, x, iters, rs, *scratch,
            *spread_buffers(L, spread, b.device))
    args = (L, chunk, int(resident), int(spread), int(chains), nz, ny, nx,
            ndims, op_per_lane, tol2_sum, int(maxiter), int(stall_iters),
            int(precondition), int(return_best), int(x0 is not None))

    def launch():
        with torch.cuda.device(b.device):
            status = lib.fg_bicgstab_solve(
                *[0 if t is None else t.data_ptr() for t in bufs], *args,
                torch.cuda.current_stream(b.device).cuda_stream)
        _build.check(status, "fused_bicgstab_mb")
        return x, iters, rs

    return launch


def _launch_merged(algo: str, plan: MergePlan, diag, off, b, x0,
                   per_lane: bool = False, **kw):
    """K3 (``algo="cg"``; K3-coarse with ``coarse = (sp, einv)``) or K2-mb
    (``"bicgstab"``) on the flat merged layout: one launch of
    ``merged_launcher``, or with ``per_lane`` one launch per lane in turn
    (``merged_arm``).  Returns ``(x, iterations, residual_sum)``."""
    if not per_lane:
        return merged_launcher(algo, plan, diag, off, b, x0, **kw)()
    one = lambda t, l: t if t is None or t.shape[0] == 1 else t[l:l + 1]
    outs = [merged_launcher(algo, plan, one(diag, l), one(off, l), b[l:l + 1],
                            None if x0 is None else x0[l:l + 1], **kw)()
            for l in range(b.shape[0])]
    return tuple(torch.cat(t) for t in zip(*outs))


def check_merged_spread(spread: int, chunk: int, cluster: int, coarse: bool,
                        ndims: int, chains: bool,
                        global_terms: bool = False) -> None:
    """The merged forms' spread arm: as ``cg_cuda.check_spread``, and with
    no cluster, over a 3D plan (a 2D merged lane keeps the cluster arm),
    not K3-coarse or K3-agg; chain terms in global memory in the chains
    layout only."""
    check_spread(spread, chunk, False, ndims, chains)
    if global_terms and not chains:
        raise ValueError("chain terms in global memory take the chains "
                         "layout, not a range")
    if spread and cluster > 1:
        raise ValueError("a launch takes the cluster arm or the spread arm, "
                         "not both")
    if spread and coarse:
        raise ValueError("K3-coarse and K3-agg have no spread arm")
    if spread and ndims != 3:
        raise ValueError("the merged forms' spread arm takes 3D plans only "
                         "(a 2D merged lane keeps the cluster arm)")


def merged_launcher(algo: str, plan: MergePlan, diag, off, b, x0, *, tol2_sum,
                    maxiter, stall_iters, precondition, return_best, chunk,
                    coarse=None, cluster: int = 1, spread: int = 0,
                    chains=None, global_terms=None):
    """Check and lay out the operands of K3 / K3-coarse / K2-mb on the flat
    merged layout (``b``/``x0`` ``(lanes, n)``, ``diag (1|lanes, n)``,
    ``off (1|lanes, 2*ndims, n)``, ``coarse = (sp, einv)`` with ``einv
    (1|lanes, K, K)`` like ``diag``: K3-coarse for a strip plan, K3-agg for
    an ``AggSpace``),
    allocate the outputs and scratch once, and return ``launch()``: one
    kernel launch on the current stream into those buffers, returning ``(x,
    iterations, residual_sum)`` (the same tensors on every call; a timing
    loop of raw launches).  ``cluster``: blocks per lane (1: the chunk
    grid; C > 1: the cluster arm, chunk 1, whose rows must fit).
    ``spread``: G > 0 for the spread arm (chunk 1, cluster 1, a 3D plan,
    not K3-coarse), in the chains layout or not (``chains``; None:
    ``cg_cuda.spread_chains`` for a merged lane), the chain terms in global
    memory or not (``global_terms``; None: ``cg_cuda.spread_global_terms``
    over this launch's lanes)."""
    ndims = plan.ndims
    L, n = b.shape
    if ndims not in (2, 3) or off.shape[-2:] != (2 * ndims, n):
        raise ValueError("b must be (lanes, n) and off (1|lanes, 2*ndims, n)")
    op_per_lane = _check_operands(b, diag, off, x0, L, chunk)
    check_cluster(cluster, chunk)
    gterms = bool(spread) and (
        spread_global_terms(L, n, ndims) if global_terms is None
        else bool(global_terms))
    chains = (spread_chains(n, spread, ndims, merged=True) if chains is None
              else bool(chains))
    check_merged_spread(spread, chunk, cluster, coarse is not None, ndims,
                        chains, gterms)
    agg = coarse is not None and isinstance(coarse[0], AggSpace)
    coarse_k = coarse[0].K if agg else 0
    if agg and (ndims != 2 or not 1 <= coarse_k <= AGG_MAX_K):
        raise ValueError(f"K3-agg takes 2D plans and 1 to {AGG_MAX_K} tiles, "
                         f"got ndims {ndims}, K = {coarse_k}")
    if cluster > 1 and not rows_fit(n, cluster, ndims, coarse_k):
        raise ValueError(f"a block's operator rows "
                         f"({stage_bytes(n, cluster, ndims, coarse_k)} B) do "
                         f"not fit in shared memory at cluster {cluster}")
    nbr = neighbor_table(plan, b.device)
    b = b.contiguous()
    diag = diag.contiguous()
    off = off.contiguous()
    x0c = x0.contiguous() if x0 is not None else b
    x = torch.empty_like(b)
    scratch = [torch.empty_like(b) for _ in range(4 if algo == "cg" else 8)]
    iters = torch.empty(L, dtype=torch.int32, device=b.device)
    rs = torch.empty(L, dtype=torch.float32, device=b.device)
    lib = _build.library()
    # the closure holds every buffer it hands the kernel by pointer
    bufs = (b, diag, off, nbr, x0c, x, iters, rs, *scratch)
    tail = (tol2_sum, int(maxiter), int(stall_iters), int(precondition),
            int(return_best), int(x0 is not None))
    if coarse is not None:
        sp, einv = coarse
        if (einv.shape != (diag.shape[0], sp.K, sp.K) or einv.device != b.device
                or einv.dtype != torch.float32):
            raise ValueError("einv must be float32 (1|lanes, K, K) like diag")
        if agg:
            if sp.cidx.device != b.device or sp.cidx.numel() != n:
                raise ValueError("the aggregation space is not this plan's "
                                 "on this device")
            # row-major: a warp reads row k of Einv whole
            bufs += (einv.contiguous(), sp.ptr, sp.cells, sp.cidx)
            entry = lib.fg_cg_mb_agg_solve
        else:
            bufs += (einv.transpose(-1, -2).contiguous(),
                     *strip_lists(plan, b.device))
            entry = lib.fg_cg_mb_coarse_solve
        shape = (L, chunk, cluster, n, ndims, op_per_lane, sp.K)
    else:
        bufs += spread_buffers(L, spread, b.device, n, gterms)
        shape = (L, chunk, cluster, int(spread),
                 CHAINS_GLOBAL if gterms else int(chains), n, ndims,
                 op_per_lane)
        entry = (lib.fg_cg_mb_solve if algo == "cg"
                 else lib.fg_bicgstab_mb_solve)
    what = "fused_cg_mb" if algo == "cg" else "fused_bicgstab_mb"

    def launch():
        with torch.cuda.device(b.device):
            status = entry(*[0 if t is None else t.data_ptr() for t in bufs],
                           *shape, *tail,
                           torch.cuda.current_stream(b.device).cuda_stream)
        _build.check(status, what)
        return x, iters, rs

    return launch


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def fused_cg_mb(plan: MergePlan, diags, offs, bs, x0s=None, *, tol: float,
                maxiter: int = 5000, stall_iters: int = 250,
                precondition: bool = True, return_best: bool = True,
                coarse_strips: bool = False, agg: AggSpace | None = None,
                chunk: int | None = None, cluster: int | None = None):
    """K3: whole-solve lockstep CG on a merged multi-block stencil operator.

    ``diags``/``offs``: per-super-block ``(*spatial_s)`` / ``(2*ndims,
    *spatial_s)`` (``block_merge.pack_ops`` layout); ``bs``/``x0s``:
    per-super-block ``(*spatial_s)`` (one lane, as the JAX entry) or
    ``(lanes, *spatial_s)``.  ``coarse_strips``: add the strip-coarse
    correction to the preconditioner (K3-coarse); a plan without strip
    spaces (3D) keeps Jacobi alone, as in the JAX package.  ``agg``: an
    ``AggSpace`` of this plan (``agg_space``), the aggregation coarse space
    added to the preconditioner (K3-agg; not with ``coarse_strips``).
    ``chunk``:
    lanes per lockstep chunk (``default_chunk`` when None).  ``cluster``:
    the cluster arm's blocks per lane on the card (1: the chunk grid);
    None: ``merged_arm`` picks the arm (the cluster arm, K3-coarse's and
    K3-agg's too, the spread arm of a 3D plan, or the chunk grid).
    Returns ``(xs, SolveInfo)`` in the same layout, the info per
    lane (scalars for one unbatched lane).  A lane whose RHS is all zero
    over every super-block gets a zero solution.  Under ``torch.func.vmap`` the batch folds onto
    the lanes (``cg_cuda.LaneFold``)."""
    if cluster is not None:  # before the coarse inverse is built
        check_cluster(cluster, 1 if chunk is None else chunk)
    if agg is not None and coarse_strips:
        raise ValueError("one coarse space per solve: the strips or the "
                         "aggregation tiles")
    batched = bs[0].dim() == plan.ndims + 1
    if not batched:
        bs = tuple(b.unsqueeze(0) for b in bs)
        x0s = None if x0s is None else tuple(x.unsqueeze(0) for x in x0s)
    b = flatten_fields(plan, bs)
    x0 = None if x0s is None else flatten_fields(plan, x0s)
    diag, off = flatten_ops(plan, diags, offs)
    L, n = b.shape
    tol2 = tol2_sum_f32(tol, n, b.dtype)
    sp = cs.strip_plan(plan) if coarse_strips else None
    einv = None
    if sp is not None:
        einv = cs.coarse_inverse(plan, sp, tuple(zip(diags, offs))).unsqueeze(0)
    elif agg is not None:
        sp, einv = agg, agg.einv.to(b.dtype).unsqueeze(0)
    kw = dict(tol2_sum=tol2, maxiter=int(maxiter), stall_iters=int(stall_iters),
              precondition=bool(precondition), return_best=bool(return_best))

    def solve(b, x0, diag, off, einv):
        c = default_chunk(b.shape[0], b.device) if chunk is None else chunk
        coarse = None if einv is None else (sp, einv)
        if cluster is None:
            cl, G, per_lane = merged_arm(
                b.shape[0], n, plan.ndims, c, b.device,
                "cg" if coarse is None else "cg_coarse",
                0 if agg is None else agg.K)
        else:
            cl, G, per_lane = cluster, 0, False
        check_cluster(cl, c)
        if device_kind(b, "fused_cg_mb") == "cpu":
            return fused_cg_mb_plain(plan, diag, off, b, x0, coarse=coarse,
                                     chunk=c, **kw)
        out = _launch_merged("cg", plan, diag, off, b, x0, per_lane,
                             coarse=coarse, chunk=c, cluster=cl, spread=G,
                             **kw)
        k = b.shape[0] if per_lane else 1  # launches
        if cl > 1:
            fused_cg_mb.cluster_launches += k
        fused_cg_mb.spread_launches += k * int(G > 0)
        fused_cg_mb.global_terms_launches += k * int(
            G > 0 and spread_global_terms(1 if per_lane else b.shape[0], n,
                                          plan.ndims))
        if coarse is None and plan.identity_seams:
            fused_cg_mb.launches += k
            fused_cg_mb.launches_3d += k * int(plan.ndims == 3)
        elif coarse is None:
            fused_cg_mb.flip_launches += k
            fused_cg_mb.flip_launches_3d += k * int(plan.ndims == 3)
        elif agg is not None and plan.identity_seams:
            fused_cg_mb.agg_launches += k
        elif agg is not None:
            fused_cg_mb.agg_flip_launches += k
        elif plan.identity_seams:
            fused_cg_mb.coarse_launches += k
        else:
            fused_cg_mb.coarse_flip_launches += k
        return out

    x, iters, rs = LaneFold.apply(solve, 2, b, x0, diag, off, einv)
    b_zero = (b == 0).all(dim=1)
    x = torch.where(b_zero.unsqueeze(1), torch.zeros_like(x), x)
    info = SolveInfo(converged=(rs <= tol2) | b_zero, iterations=iters,
                     residual=torch.sqrt(rs / n))
    xs = unflatten_fields(plan, x)
    if not batched:
        xs = tuple(x_[0] for x_ in xs)
        info = SolveInfo(*(v[0] for v in info))
    return xs, info


fused_cg_mb.launches = 0
fused_cg_mb.launches_3d = 0
fused_cg_mb.flip_launches = 0
fused_cg_mb.coarse_launches = 0
fused_cg_mb.coarse_flip_launches = 0
fused_cg_mb.agg_launches = 0
fused_cg_mb.agg_flip_launches = 0
fused_cg_mb.flip_launches_3d = 0
fused_cg_mb.cluster_launches = 0
fused_cg_mb.spread_launches = 0
fused_cg_mb.global_terms_launches = 0


def fused_bicgstab_mb(plan: MergePlan, diags, offs, bs, x0s=None, *,
                      tol: float, maxiter: int = 5000, stall_iters: int = 250,
                      precondition: bool = True, return_best: bool = True,
                      chunk: int | None = None, cluster: int | None = None):
    """K2: whole-solve lockstep BiCGStab on a merged stencil operator.

    ``diags``/``offs``: per-super-block ``(*spatial_s)`` / ``(2*ndims,
    *spatial_s)``; ``bs``/``x0s``: per-super-block ``(C, *spatial_s)`` with a
    leading component axis.  Components are independent lanes with
    per-component stopping, in lockstep chunks of ``chunk`` lanes
    (``default_chunk`` when None), ``cluster`` blocks per lane of the
    cluster arm on the card (1: the chunk grid; None: ``merged_arm``, the
    cluster arm or, over a 3D plan, the spread arm; the
    single-super-block form takes 1, and at one lane per block the
    resident arm where a lane fits, ``cg_cuda.default_resident``, else the
    spread arm where ``cg_cuda.default_spread`` gives G, or one lane per
    launch where ``cg_cuda.split_spread`` does: ``roll_form_arm``).
    Returns ``(xs, SolveInfo)`` with the info aggregated over components
    (converged = all, iterations = max,
    residual = joint RMSE).  Under ``torch.func.vmap`` the batch folds onto
    the lanes (``cg_cuda.LaneFold``): B envs of C components are B*C
    lanes."""
    ndims = plan.ndims
    C = bs[0].shape[0]
    single = len(plan.superblocks) == 1 and not plan.fixups
    if single:
        b = bs[0]
        x0 = None if x0s is None else x0s[0]
        diag, off = diags[0].unsqueeze(0), offs[0].unsqueeze(0)
    else:
        b = flatten_fields(plan, bs)
        x0 = None if x0s is None else flatten_fields(plan, x0s)
        diag, off = flatten_ops(plan, diags, offs)
    n_lane = math.prod(b.shape[1:])
    tol2 = tol2_sum_f32(tol, n_lane, b.dtype)
    kw = dict(tol2_sum=tol2, maxiter=int(maxiter), stall_iters=int(stall_iters),
              precondition=bool(precondition), return_best=bool(return_best))

    def solve(b, x0, diag, off):
        c = default_chunk(b.shape[0], b.device) if chunk is None else chunk
        cl, G, per_lane = 1, 0, False
        if cluster is not None:
            cl = cluster
        elif not single:
            cl, G, per_lane = merged_arm(b.shape[0], n_lane, ndims, c,
                                         b.device, "bicgstab")
        check_cluster(cl, c, not single)
        if device_kind(b, "fused_bicgstab_mb") == "cpu":
            return fused_bicgstab_plain(diag, off, b, x0, ndims=ndims,
                                        plan=None if single else plan,
                                        chunk=c, **kw)
        if single:
            res, G, per_lane = roll_form_arm(b.shape[0], n_lane, ndims, c,
                                             b.device)
            out = _launch(diag, off, b, x0, per_lane, ndims=ndims, chunk=c,
                          resident=res, spread=G, **kw)
            k = b.shape[0] if per_lane else 1  # launches
            fused_bicgstab_mb.launches += k
            fused_bicgstab_mb.launches_3d += k * int(ndims == 3)
            fused_bicgstab_mb.resident_launches += int(res)
            fused_bicgstab_mb.spread_launches += k * int(G > 0)
        else:
            out = _launch_merged("bicgstab", plan, diag, off, b, x0, per_lane,
                                 chunk=c, cluster=cl, spread=G, **kw)
            k = b.shape[0] if per_lane else 1  # launches
            if cl > 1:
                fused_bicgstab_mb.cluster_launches += k
            fused_bicgstab_mb.merged_spread_launches += k * int(G > 0)
            fused_bicgstab_mb.merged_global_terms_launches += k * int(
                G > 0 and spread_global_terms(
                    1 if per_lane else b.shape[0], n_lane, ndims))
            if plan.identity_seams:
                fused_bicgstab_mb.merged_launches += k
                fused_bicgstab_mb.merged_launches_3d += k * int(ndims == 3)
            else:
                fused_bicgstab_mb.merged_flip_launches += k
                fused_bicgstab_mb.merged_flip_launches_3d += k * int(ndims == 3)
        return out

    x, iters, rs = LaneFold.apply(solve, 2, b, x0, diag, off)
    # an all-zero RHS over EVERY component gives a zero solution
    b_zero = torch.all(b == 0)
    x = torch.where(b_zero, torch.zeros_like(x), x)
    info = SolveInfo(
        converged=(rs <= tol2).all() | b_zero,
        iterations=iters.max(),
        residual=torch.sqrt(rs.sum() / (n_lane * C)),
    )
    return ((x,) if single else unflatten_fields(plan, x)), info


fused_bicgstab_mb.launches = 0
fused_bicgstab_mb.launches_3d = 0
fused_bicgstab_mb.merged_launches = 0
fused_bicgstab_mb.merged_launches_3d = 0
fused_bicgstab_mb.merged_flip_launches = 0
fused_bicgstab_mb.merged_flip_launches_3d = 0
fused_bicgstab_mb.cluster_launches = 0
fused_bicgstab_mb.resident_launches = 0
fused_bicgstab_mb.spread_launches = 0
fused_bicgstab_mb.merged_spread_launches = 0
fused_bicgstab_mb.merged_global_terms_launches = 0
