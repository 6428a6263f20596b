"""K1: whole-solve lockstep Jacobi-PCG on single-block stencil systems.

Counterpart of ``fluidgym_tpu/ops/cg_pallas.py`` (TPU kernel ``_kernel``,
entry ``fused_cg``).  The CUDA kernel (``csrc/cg.cu``) runs the entire
Krylov loop of every lane in one launch: no host round-trip per iteration.

* ``fused_cg`` is the wrapper.  For CUDA tensors it launches the kernel and
  adds one to ``fused_cg.launches`` (and, for a 3D system, RBC3D's "K1-3D",
  to ``fused_cg.launches_3d``); for CPU tensors it runs
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

The resident arm (K1 here, K2 over the trivial plan in ``cg_cuda_mb``):
with one lane per block (``chunk == 1``) a lane small enough for one SM
(an RBC2D lane: 5,856 cells) keeps its operator rows and four vectors in
the block's shared memory for the whole solve (``resident_bytes``), with
the chunk grid's arithmetic and sums, so it returns the same bits.
``default_resident`` picks it by shape; ``pinned_resident`` pins the
answer inside a ``with`` block (tests and A/B scripts);
``fused_cg.resident_launches`` counts the launches that took it.

The spread arm (K1 and K2 over the trivial plan, for lanes too big for one
SM: RBC3D's; K3 and K2-mb over a 3D merged plan take it through
``cg_cuda_mb.merged_arm``): one lane over G co-resident blocks (G in
``SPREAD_SIZES``)
of one cooperative launch, the operator rows read from global memory,
each block its share of the lane's cells (the cells of its sum chains,
``chain_cells``, or a contiguous range, ``block_ranges``: ``spread_chains``
picks by shape), its blocks meeting at a barrier in global memory.  Its
sums are the one-block form's, bit for bit, so it returns the chunk grid's
x, iterations and residual.  ``default_spread`` picks G by shape after the
resident rule (``roll_arm``); ``pinned_spread`` pins it;
``fused_cg.spread_launches`` counts the launches that took it.  A block
keeps its chain terms in shared memory, or, for a one-lane launch of a 3D
merged form whose terms no G's shared memory holds (Airfoil3D's
7,051,776-cell lanes), in a scratch buffer in global memory
(``spread_global_terms``, pinned by ``pinned_global_terms``), with the same
arithmetic in the same order.

Bound on the H100 and what the design does about it: see the note at the
top of ``csrc/cg.cu``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from fluidgym_tpu_torch.ops import _build
from fluidgym_tpu_torch.solver.linsolve import SolveInfo

__all__ = ["fused_cg", "fused_cg_plain", "cg_lockstep", "roll_matvec",
           "tol2_sum_f32", "guard", "MAX_LANES", "LaneFold", "default_chunk",
           "lockstep_chunks", "default_resident", "pinned_resident",
           "resident_bytes", "resident_fits", "launcher", "default_spread",
           "pinned_spread", "spread_bytes", "spread_fits", "spread_capacity",
           "block_ranges", "chain_cells", "roll_arm", "spread_chains",
           "split_spread", "SPREAD_SIZES", "SPLIT_BLOCKS_PER_LANE",
           "spread_global_terms", "pinned_global_terms", "CHAINS_GLOBAL"]

_TINY = 1e-30
MAX_LANES = 64  # FG_MAX_LANES in csrc/krylov.cuh: lanes of one thread block
#: shared memory one block may opt into on the H100 (227 KB)
SMEM_PER_BLOCK = 232_448
#: room kept for the kernels' static shared arrays (at most 7.25 KB today:
#: K3-coarse's cluster instance)
SMEM_STATIC = 8_192
#: a lane's vectors the resident arm keeps in shared memory
#: (FG_RESIDENT_VECS in csrc/krylov.cuh)
RESIDENT_VECS = 4

#: threads of a kernel block (FG_THREADS in csrc/krylov.cuh): the one-block
#: form's sum chains
THREADS = 1024
#: blocks per lane of the spread arm, largest first (``fg_spread_ok``)
SPREAD_SIZES = (128, 64, 32)
#: the spread rule keeps at least this many cells per block: a quarter per
#: thread.  On the H100 RBC2D-wide's 11,712-cell lanes ran faster at G = 32
#: (366 cells per block) than on the chunk grid: K1 0.56 against 0.88 ms
#: per raw launch, K2 0.10 against 0.15 (scripts/port_spread_ab.py)
SPREAD_MIN_CELLS = 256
#: cells per thread from which a G = 128 spread lane of a roll form takes
#: the range layout (``spread_chains``)
SPREAD_RANGE_CELLS = 4

#: the entries' ``chains`` for the chains layout with its chain terms in
#: global memory (``FG_CHAINS_GLOBAL`` in ``csrc/krylov.cuh``; 0 is the
#: range layout, 1 the chains with their terms in shared memory)
CHAINS_GLOBAL = 2

_PINNED_RESIDENT: bool | None = None
_PINNED_SPREAD: int | None = None
_PINNED_GLOBAL_TERMS: bool | None = None


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


def resident_bytes(n: int, ndims: int) -> int:
    """Dynamic shared memory of the resident arm over an ``n``-cell lane:
    its diag and ``2*ndims`` off rows, then ``RESIDENT_VECS`` vectors
    (``csrc/krylov.cuh`` ``fg_resident_bytes``)."""
    return n * (1 + 2 * ndims + RESIDENT_VECS) * 4


def resident_fits(n: int, ndims: int) -> bool:
    """Whether the resident arm takes a lane: 2D (no 3D id's lane fits one
    SM), its bytes within one block's shared memory less the room kept for
    the static arrays (``csrc/krylov.cuh`` ``fg_resident_ok``)."""
    return ndims == 2 and resident_bytes(n, ndims) <= SMEM_PER_BLOCK - SMEM_STATIC


def default_resident(lanes: int, n: int, ndims: int, chunk: int,
                     device) -> bool:
    """Whether a roll-form solve (K1, or K2 over the trivial plan) of
    ``lanes`` lanes of ``n`` cells takes the resident arm: on the card,
    with one lane per block (``chunk == 1``, batches up to the SM count),
    for a 2D lane whose bytes fit (``resident_fits``); else the chunk grid,
    as on the CPU.  A dispatch by shape: nothing falls back on a failed launch.
    ``pinned_resident`` overrides it where the arm can run (the card,
    chunk 1)."""
    if torch.device(device).type != "cuda" or chunk != 1 or lanes < 1:
        return False
    if _PINNED_RESIDENT is not None:
        return _PINNED_RESIDENT
    return resident_fits(n, ndims)


@contextlib.contextmanager
def pinned_resident(arm: bool | None):
    """Inside the ``with`` block ``default_resident`` answers ``arm`` (True:
    the resident arm, False: the chunk grid, None: the rule) for the card's
    one-lane-per-block roll-form solves, and afterwards what it answered
    before: an A/B of the two arms on the main path.  A pinned True on a
    lane that does not fit raises at its launch."""
    if arm is not None and not isinstance(arm, bool):
        raise ValueError(f"arm must be True, False or None, got {arm!r}")
    global _PINNED_RESIDENT
    before, _PINNED_RESIDENT = _PINNED_RESIDENT, arm
    try:
        yield
    finally:
        _PINNED_RESIDENT = before


def block_seg(n: int, G: int) -> int:
    """Cells per block of a lane of ``n`` cells over ``G`` blocks in a range
    layout: ``ceil(n / G)`` rounded up to 32 (``csrc/krylov.cuh``
    ``fg_cluster_seg``)."""
    return -(-(-(-n // G)) // 32) * 32


def block_ranges(n: int, G: int) -> list[tuple[int, int]]:
    """The cells ``[c0, c1)`` that each of the ``G`` blocks of a lane owns in
    a range layout (the cluster arm, the spread arm's range layout):
    contiguous, ``block_seg`` per block, cut at ``n``."""
    seg = block_seg(n, G)
    return [(min(n, r * seg), min(n, (r + 1) * seg)) for r in range(G)]


def chain_cells(n: int, G: int, r: int) -> np.ndarray:
    """The cells of block ``r``'s sum chains in a lane of ``n`` cells over
    ``G`` blocks, in the order of its chain terms ``e``: row ``k = e //
    per`` of its chains ``[r per, (r + 1) per)``, ``per = THREADS // G``,
    is cell ``k THREADS + r per + (e - k per)`` (``csrc/krylov.cuh``
    ``fg_chain_cell``), cells past ``n`` left out.  The spread arm's chains
    layout gives block ``r`` these cells."""
    per = THREADS // G
    e = np.arange(per * -(-n // THREADS))
    k = e // per
    c = k * THREADS + r * per + (e - k * per)
    return c[c < n]


def spread_bytes(n: int, G: int) -> int:
    """Dynamic shared memory of a spread-arm block over an ``n``-cell lane:
    two floats for each cell of its ``THREADS / G`` sum chains
    (``csrc/krylov.cuh`` ``fg_spread_bytes``)."""
    return 2 * (THREADS // G) * -(-n // THREADS) * 4


def spread_fits(n: int, G: int) -> bool:
    """Whether a spread-arm block's chain terms fit its shared memory."""
    return spread_bytes(n, G) <= SMEM_PER_BLOCK - SMEM_STATIC


#: the C entry that answers the spread arm's co-residency, by ``algo``: the
#: roll forms (K1, K2 over the trivial plan) and the 3D merged forms (K3,
#: K2-mb), whose instances' registers differ
_SPREAD_CAPACITY = {"cg": "fg_cg_spread_capacity",
                    "bicgstab": "fg_bicgstab_spread_capacity",
                    "cg_mb": "fg_cg_mb_spread_capacity",
                    "bicgstab_mb": "fg_bicgstab_mb_spread_capacity"}


@functools.lru_cache(maxsize=None)
def spread_capacity(algo: str, ndims: int, G: int, chains: bool, n: int,
                    device: torch.device) -> int:
    """How many blocks of the spread arm of ``algo`` (``"cg"``: K1,
    ``"bicgstab"``: K2 over the trivial plan, ``"cg_mb"``: K3 and
    ``"bicgstab_mb"``: K2-mb over a 3D merged plan) the card holds at once:
    blocks per SM (the occupancy API) times SMs.  A cooperative launch of
    more is refused."""
    entry = getattr(_build.library(), _SPREAD_CAPACITY[algo])
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        status = entry(ndims, G, int(chains), n, ctypes.addressof(out))
    _build.check(status, f"{algo} spread capacity at G = {G}")
    return out.value


def default_spread(lanes: int, n: int, ndims: int, chunk: int, device,
                   algo: str = "cg") -> int:
    """Blocks per lane G of a spread-arm form (K1 ``"cg"``, K2 over the
    trivial plan ``"bicgstab"``, K3 / K2-mb over a 3D merged plan
    ``"cg_mb"`` / ``"bicgstab_mb"``) over ``lanes`` lanes of
    ``n`` cells: on the card with one lane per block (``chunk == 1``), the
    largest G in ``SPREAD_SIZES`` with at least ``SPREAD_MIN_CELLS`` cells
    per block, its chain terms in shared memory (``spread_fits``) and
    ``lanes * G`` blocks co-resident (``spread_capacity``); else 0 (the
    chunk grid), as on the CPU.  A dispatch by shape: nothing falls back on
    a refused launch.  ``pinned_spread`` overrides it where the arm can run
    (the card, chunk 1).  The wrappers ask it only for a lane the resident
    arm (``roll_arm``) or the cluster arm (``cg_cuda_mb.merged_arm``) does
    not take."""
    if torch.device(device).type != "cuda" or chunk != 1 or lanes < 1:
        return 0
    if _PINNED_SPREAD is not None:
        return _PINNED_SPREAD
    merged = algo.endswith("_mb")
    gterms = spread_global_terms(lanes, n, ndims, merged)
    for G in SPREAD_SIZES:
        if n < SPREAD_MIN_CELLS * G or not (gterms or spread_fits(n, G)):
            continue
        layout = (CHAINS_GLOBAL if gterms
                  else int(spread_chains(n, G, ndims, merged)))
        if lanes * G <= spread_capacity(algo, ndims, G, layout, n,
                                        torch.device(device)):
            return G
    return 0


def spread_global_terms(lanes: int, n: int, ndims: int,
                        merged: bool = True) -> bool:
    """Whether a spread-arm launch of ``lanes`` lanes of ``n`` cells keeps
    its blocks' chain terms in global memory rather than in shared memory:
    a one-lane launch of a 3D merged form (K3, K2-mb) whose terms fit a
    block's shared memory at no G (``spread_fits``): Airfoil3D's
    7,051,776-cell lanes, 440,768 B per block at G = 128.  Its sums are the
    shared form's, bit for bit (the arm holds them against the chunk
    grid).  Every registered lane that fits keeps shared memory (at most
    2,481,408 cells, CylinderJet3D-hard).  ``pinned_global_terms`` pins
    the answer for the 3D merged forms; the roll forms have no such
    layout."""
    if not merged or ndims != 3:
        return False
    if _PINNED_GLOBAL_TERMS is not None:
        return _PINNED_GLOBAL_TERMS
    return lanes == 1 and not any(spread_fits(n, G) for G in SPREAD_SIZES)


@contextlib.contextmanager
def pinned_global_terms(arm: bool | None):
    """Inside the ``with`` block ``spread_global_terms`` answers ``arm`` for
    the 3D merged forms' spread launches (True: chain terms in global
    memory, False: in shared memory, None: the rule), and afterwards what
    it answered before: an A/B of the two places on the main path.  A
    pinned False on a lane whose terms do not fit leaves it no G (the chunk
    grid, as before the global form existed)."""
    if arm is not None and not isinstance(arm, bool):
        raise ValueError(f"arm must be True, False or None, got {arm!r}")
    global _PINNED_GLOBAL_TERMS
    before, _PINNED_GLOBAL_TERMS = _PINNED_GLOBAL_TERMS, arm
    try:
        yield
    finally:
        _PINNED_GLOBAL_TERMS = before


def spread_chains(n: int, G: int, ndims: int, merged: bool = False) -> bool:
    """The spread arm's layout over ``n``-cell lanes at G blocks per lane:
    each block the cells of its sum chains (True), or, in 3D, a contiguous
    range (False) at G = 128 from ``SPREAD_RANGE_CELLS`` cells per thread
    of a block (the range layout is built for 3D lanes only).  The chains
    layout puts each pass's terms of a sum straight into shared memory: one
    lane barrier per sum where the range layout needs two and a second read
    of the vectors.  But a row of a block's chains is a run of only THREADS
    / G cells, 8 (one 32-byte sector) at G = 128, so a stencil pass reads
    about twice the L2 sectors of a contiguous range; on a big lane that
    outweighs the barrier.  On the H100 (phase 25): (128, 41, 128) at G =
    128, K1 1.02 ms per raw launch in the range layout against 1.18 in the
    chains layout, K2's temperature 0.36 against 0.40; at (64, 41, 64), and
    at G = 32 or 64 on either block, the chains layout wins (K1 0.47
    against 0.53 ms at G = 128).  ``merged``: a 3D merged lane (K3, K2-mb)
    takes the chains layout at every G: on the H100 (phase 32) it won at
    every G on both CylinderJet3D widths, K3 at G = 128 3.27 against 4.38
    ms per raw launch at 341,568 cells and 7.64 against 9.14 at 749,568
    (5.7 cells per thread, where a roll-form lane takes the range), K2-mb's
    velocity at G = 32 0.39 against 0.51; its range instances also spill
    (``scripts/port_spread_sass.py``)."""
    if merged:
        return True
    return not (ndims == 3 and G == 128
                and n >= SPREAD_RANGE_CELLS * THREADS * G)


#: a solve whose lanes no G holds at once goes one lane per launch at the G
#: that holds one lane, while that G gives each lane at least this many
#: blocks: on the H100 a merged lane over 128 blocks ran 15-21x faster per
#: iteration than on the chunk grid's one block (K3-3D, 341,568 and 749,568
#: cells), so up to 16 lanes in turn beat the chunk grid's concurrent lanes,
#: and a batch keeps the chunk grid
SPLIT_BLOCKS_PER_LANE = 8


def split_spread(lanes: int, n: int, ndims: int, chunk: int, device,
                 algo: str = "cg") -> int:
    """G of the spread arm with the lanes one per launch, for ``lanes`` lanes
    of ``n`` cells that ``default_spread`` holds at no G at once: the G
    that holds a single lane, where it gives every lane of the solve at
    least ``SPLIT_BLOCKS_PER_LANE`` blocks; else 0 (the chunk grid).
    TCFLarge's 3 velocity lanes of 1,048,576 cells (K2-3D) and
    CylinderJet3D-hard's of 2,481,408 (K2-mb-3D) go at G = 128.  Each lane
    stops on its own, so that is the chunk grid's bits.  ``pinned_spread(0)``
    pins the chunk grid here too."""
    if lanes < 2:
        return 0
    G1 = default_spread(1, n, ndims, chunk, device, algo)
    return G1 if G1 and lanes * SPLIT_BLOCKS_PER_LANE <= G1 else 0


def roll_arm(lanes: int, n: int, ndims: int, chunk: int, device,
             algo: str = "cg") -> tuple[bool, int]:
    """The arm of a roll-form solve: ``(resident, G)``, the resident rule
    first (a lane it takes keeps it), then the spread rule; ``(False, 0)``
    is the chunk grid."""
    if default_resident(lanes, n, ndims, chunk, device):
        return True, 0
    return False, default_spread(lanes, n, ndims, chunk, device, algo)


@contextlib.contextmanager
def pinned_spread(G: int | None):
    """Inside the ``with`` block ``default_spread`` answers ``G`` (a size of
    ``SPREAD_SIZES``, 0: the chunk grid, None: the rule) for the card's
    one-lane-per-block roll-form solves that the resident arm does not
    take, and afterwards what it answered before: an A/B of the spread arm
    on the main path.  A pinned G whose grid the card cannot hold raises at
    its launch."""
    if G is not None and G not in (0,) + SPREAD_SIZES:
        raise ValueError(f"G must be 0, None or one of {SPREAD_SIZES}, got {G!r}")
    global _PINNED_SPREAD
    before, _PINNED_SPREAD = _PINNED_SPREAD, G
    try:
        yield
    finally:
        _PINNED_SPREAD = before


def check_spread(spread: int, chunk: int, resident: bool, ndims: int,
                 chains: bool) -> None:
    """The spread arm takes G in ``SPREAD_SIZES``, one lane per G blocks,
    is not the resident arm, and takes the range layout in 3D only."""
    if spread not in (0,) + SPREAD_SIZES:
        raise ValueError(f"spread must be 0 or one of {SPREAD_SIZES}, got {spread}")
    if spread and chunk != 1:
        raise ValueError(f"the spread arm takes one lane per G blocks "
                         f"(chunk 1), got chunk {chunk}")
    if spread and resident:
        raise ValueError("a launch takes the resident arm or the spread arm, "
                         "not both")
    if spread and ndims == 2 and not chains:
        raise ValueError("the spread arm's range layout is 3D only")


def spread_buffers(L: int, spread: int, device, n: int = 0,
                   global_terms: bool = False) -> tuple:
    """The spread arm's global memory for ``L`` lanes: the barrier counters
    (``L`` int32, zeroed by the entry on the stream before every launch)
    and the chain slots (``L x 2 x THREADS`` float2), followed, where the
    chain terms live in global memory, by every block's terms (``L x G``
    blocks of ``spread_bytes(n, G)``: 56.4 MB for a 7,051,776-cell lane at
    G = 128); None for the other arms.  Each solve takes its buffers from
    the caching allocator, so the per-lane launches of a solve reuse one
    block of scratch."""
    if not spread:
        return None, None
    terms = L * spread * spread_bytes(n, spread) // 4 if global_terms else 0
    return (torch.empty(L, dtype=torch.int32, device=device),
            torch.empty(L * 2 * THREADS * 2 + terms, dtype=torch.float32,
                        device=device))


def check_resident(resident: bool, chunk: int, n: int, ndims: int) -> None:
    """The resident arm takes one lane per block, whose bytes must fit."""
    if resident and chunk != 1:
        raise ValueError(f"the resident arm takes one lane per block "
                         f"(chunk 1), got chunk {chunk}")
    if resident and not resident_fits(n, ndims):
        raise ValueError(f"the resident arm takes 2D lanes whose bytes fit one "
                         f"block's shared memory, not {ndims}D with "
                         f"{resident_bytes(n, ndims)} B")


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


def _launch(diag, off, b, x0, **kw):
    """One K1 launch (``launcher``): ``(x, iterations, residual_sum)``."""
    return launcher(diag, off, b, x0, **kw)()


def launcher(diag, off, b, x0, *, ndims, tol2_sum, maxiter, stall_iters,
             precondition, return_best, chunk, resident=False, spread=0,
             chains=None):
    """Check and lay out K1's operands (``(lanes, *spatial)``; ``diag`` /
    ``off`` with a leading axis of 1 or lanes), allocate the outputs and
    scratch once, and return ``launch()``: one kernel launch on the current
    stream into those buffers, returning ``(x, iterations, residual_sum)``
    (the same tensors on every call; a timing loop of raw launches).
    ``resident``: the resident arm (chunk 1, a 2D lane whose bytes fit).
    ``spread``: G > 0 for the spread arm (chunk 1), in the chains layout or
    not (``chains``; None: ``spread_chains``)."""
    L = b.shape[0]
    spatial = tuple(b.shape[1:])
    check_chunk(L, chunk)
    if len(spatial) != ndims or ndims not in (2, 3):
        raise ValueError(f"b must be (lanes, *spatial) with {ndims} spatial axes")
    n = math.prod(spatial)
    check_resident(resident, chunk, n, ndims)
    chains = spread_chains(n, spread, ndims) if chains is None else bool(chains)
    check_spread(spread, chunk, resident, ndims, chains)
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
    # the closure holds every buffer it hands the kernel by pointer
    bufs = (b, diag, off, x0c, x, iters, rs, r, p, q, best,
            *spread_buffers(L, spread, dev))
    args = (L, chunk, int(resident), int(spread), int(chains), nz, ny, nx,
            ndims, op_per_lane, tol2_sum, int(maxiter), int(stall_iters),
            int(precondition), int(return_best), int(x0 is not None))

    def launch():
        with torch.cuda.device(dev):
            status = lib.fg_cg_solve(
                *[0 if t is None else t.data_ptr() for t in bufs], *args,
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(status, "fused_cg")
        return x, iters, rs

    return launch


def fused_cg(diag, off, b, x0=None, *, ndims: int, tol: float,
             maxiter: int = 5000, stall_iters: int = 250,
             precondition: bool = True, return_best: bool = True,
             chunk: int | None = None):
    """Whole-solve lockstep CG over ``lanes`` single-block systems.

    ``b``/``x0``: ``(lanes, *spatial)``.  ``diag``: ``(*spatial)`` shared by
    the lanes, or ``(lanes, *spatial)``; ``off`` likewise with a
    ``2*ndims`` face axis after the lane axis.  ``chunk``: lanes per
    lockstep chunk (``default_chunk`` when None); with one lane per block
    the card takes the resident arm where a lane fits
    (``default_resident``), else the spread arm where the rule gives G
    (``default_spread``).  Returns ``(x,
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
        res, G = roll_arm(b.shape[0], n, ndims, c, b.device)
        out = _launch(diag, off, b, x0, chunk=c, resident=res, spread=G, **kw)
        fused_cg.launches += 1
        fused_cg.launches_3d += int(ndims == 3)
        fused_cg.resident_launches += int(res)
        fused_cg.spread_launches += int(G > 0)
        return out

    x, iters, rs = LaneFold.apply(solve, 2, b, x0, diag, off)
    b_zero = (b == 0).reshape(L, -1).all(dim=1)
    x = torch.where(b_zero.reshape((L,) + (1,) * ndims), torch.zeros_like(x), x)
    converged = (rs <= tol2) | b_zero
    return x, SolveInfo(converged=converged, iterations=iters,
                        residual=torch.sqrt(rs / n))


fused_cg.launches = 0
fused_cg.launches_3d = 0
fused_cg.resident_launches = 0
fused_cg.spread_launches = 0
