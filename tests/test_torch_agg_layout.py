"""K3-agg's layouts on the host: what ``cg_cuda_mb.agg_space`` hands the
kernel (each tile's runs of cells, Einv padded to 16 B rows), the order
in which the kernel's lanes reach a tile's cells and its ring's rows, and
what ``stage_bytes`` counts for it.

The systems are the bundled snapshots the card tests solve: the airfoil's
Re 3000 ``train_00`` (six blocks, a flip seam at the wake cut; 8 x 8
tiles, k = 1,194) and the cylinder's res-24 ``test_00`` (identity seams,
k = 228).  Only the topologies are read: the tiles need no operator, so
Einv is a seeded random matrix.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidgym_tpu_torch.core.domain_io import load_domain
from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge, piso
from fluidgym_tpu_torch.utils import data_utils

SYSTEMS = {"airfoil": ("airfoil_2D_Re3000", "train_00", 1194, 73456),
           "cylinder": ("cylinder_2D_Re100_Res24", "test_00", 228, 14232)}
TILE = 8


@pytest.fixture(scope="module")
def spaces():
    out = {}
    for name, (data_id, split, K, n) in SYSTEMS.items():
        topo, _, _ = load_domain(data_utils.initial_domain_dir(data_id) / split,
                                 device="cpu")
        specs, k = piso._agg_tile_specs(topo, TILE)
        ids = tuple(piso.agg_tile_ids(specs, TILE, "cpu"))
        einv = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (k, k)).astype(np.float32))
        plan = block_merge.merge_plan(topo)
        out[name] = (plan, ids, cg_cuda_mb.agg_space(plan, ids, einv))
        assert (k, out[name][2].cidx.numel()) == (K, n)
    return out


def _csr(cidx: np.ndarray, K: int) -> list:
    """Each tile's cells in CSR form: ascending within a tile."""
    order = np.argsort(cidx, kind="stable")
    order = order[cidx[order] >= 0]
    bounds = np.cumsum(np.bincount(cidx[order], minlength=K))
    return np.split(order, bounds[:-1])


def _from_runs(runs: np.ndarray, k: int) -> np.ndarray:
    """Tile k's cells as a lane of the kernel finds them: position i in the
    first run whose end is past i (the kernel walks the runs from the last
    down), its cell i + (cell - position) of that run."""
    end, d = runs[k, :, 0].astype(np.int64), runs[k, :, 1].astype(np.int64)
    out = []
    for i in range(int(end[-1])):
        cell = -1
        for j in range(len(end) - 1, -1, -1):
            if i < end[j]:
                cell = i + d[j]
        out.append(cell)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_runs_give_each_tile_its_cells_in_csr_order(spaces, name):
    """Every tile's runs give its cells in the order of a cell list in CSR
    form (the order the restriction adds them in), at most 8 runs to a
    tile of 8 x 8, the unused runs ending at the tile's size."""
    _, _, sp = spaces[name]
    cidx = sp.cidx.numpy()
    runs = sp.runs.numpy()
    assert runs.dtype == np.int32 and runs.shape[0] == sp.K
    assert 1 <= runs.shape[1] <= 8
    for k, cells in enumerate(_csr(cidx, sp.K)):
        assert np.array_equal(_from_runs(runs, k), cells), k
        assert (np.diff(runs[k, :, 0]) >= 0).all()
        assert runs[k, -1, 0] == len(cells)


def test_runs_of_a_scattered_tile():
    """A tile whose cells lie in gaps (a reversed seam's) gives one run per
    stretch, and a tile with no cell none."""
    cidx = np.array([0, 0, 1, 1, 0, 2, 2, -1, 1, 0, 2, 2, 2, 1, 1, -1, 0, 0,
                     0, 2])
    runs = cg_cuda_mb.agg_runs(cidx, 4)
    assert runs.shape == (4, 4, 2)
    for k, cells in enumerate(_csr(cidx, 4)):
        assert np.array_equal(_from_runs(runs, k), cells), k
    assert runs[3].tolist() == [[0, 0]] * 4
    assert runs[0, :, 0].tolist() == [2, 3, 4, 7]


def test_a_tile_of_too_many_runs_is_refused(spaces):
    """More runs than a warp has lanes: ``agg_space`` raises."""
    plan, ids, sp = spaces["cylinder"]
    # every other cell of block 0 in tile 0: ~half its cells in gaps
    odd = ids[0].clone()
    flat = odd.reshape(-1)
    flat[::2] = 0
    with pytest.raises(ValueError, match="runs"):
        cg_cuda_mb.agg_space(plan, (odd,) + ids[1:], sp.einv)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_padded_einv_holds_einv(spaces, name):
    """Einv's rows padded to ``agg_kp(K)`` = K rounded up to 4 floats (16
    B): the space keeps one padded copy, which holds Einv's entries at
    their places and zeros after, and its Einv is a view of it (what the
    launcher hands the kernel, with no copy of its own)."""
    plan, ids, sp = spaces[name]
    kp = cg_cuda_mb.agg_kp(sp.K)
    assert kp % 4 == 0 and sp.K <= kp < sp.K + 4
    assert sp.rows.shape == (sp.K, kp) and sp.rows.is_contiguous()
    assert not bool(sp.rows[:, sp.K:].any())
    assert sp.einv.shape == (sp.K, sp.K) and sp.einv.stride() == (kp, 1)
    assert sp.einv.data_ptr() == sp.rows.data_ptr()
    # the entries of the Einv the space was built from, at their places
    einv = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (sp.K, sp.K)).astype(np.float32))
    got = cg_cuda_mb.agg_space(plan, ids, einv)
    assert torch.equal(got.einv, einv) and torch.equal(got.rows[:, :sp.K],
                                                       einv)
    # a copy of the space (its tensors cloned) keeps the layout
    clone = cg_cuda_mb.AggSpace(*(t.clone() if torch.is_tensor(t) else t
                                  for t in got))
    assert clone.einv.stride() == (kp, 1) and torch.equal(clone.einv, einv)


def test_padded_einv_of_several_lanes():
    """One Einv per lane (the chunk grid's per-lane operators): each lane's
    rows padded in place, the lanes back to back (``agg_pad``), as the
    kernel steps from lane to lane by K rows of ``agg_kp(K)`` floats."""
    einv = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 6, 6)).astype(np.float32))
    got = cg_cuda_mb.agg_pad(einv)
    assert got.shape == (3, 6, 8) and got.is_contiguous()
    assert torch.equal(got[..., :6], einv) and not bool(got[..., 6:].any())


def _lane_order_sum(cells: np.ndarray, r: np.ndarray) -> np.float32:
    """A warp's float32 sum over a tile's cells: lane l adds the cells at
    positions l, l + 32, ... in turn from 0, then the butterfly (lane l
    adds lane l ^ o for o = 16, 8, 4, 2, 1)."""
    lanes = np.zeros(32, np.float32)
    for i, c in enumerate(cells):
        lanes[i % 32] = np.float32(lanes[i % 32] + r[c])
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
    assert (lanes == lanes[0]).all()
    return lanes[0]


def _popc(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1")


def _kernel_positions(runs: np.ndarray, k: int) -> list:
    """Tile k's cells in the order a lane of fg_agg_precond reaches them
    (positions wl and wl + 32 of each window of 64 in turn), each found as
    ``fg_run_cells`` finds it: the run of position p is the count of runs
    ending at or before p, those ending at or before the window's base by
    a ballot, the others by a mask of their ends in two 32-bit words;
    laid out by the positions they stand for."""
    nruns = runs.shape[1]
    end = [int(x) for x in runs[k, :, 0]]
    d = [int(x) for x in runs[k, :, 1]] + [0] * (32 - nruns)
    size = end[-1]
    out = {}
    for base in range(0, max(size, 1), 64):
        e = [x - base for x in end]
        below = sum(x <= 0 for x in e)
        lo = hi = 0
        for x in e:
            if 0 < x < 32:
                lo |= 1 << x
            elif 32 <= x < 64:
                hi |= 1 << (x - 32)
        for wl in range(32):
            upto = (2 << wl) - 1
            j0 = below + _popc(lo & upto)
            j1 = below + _popc(lo) + _popc(hi & upto)
            for p_, j in ((base + wl, j0), (base + 32 + wl, j1)):
                if p_ < size:
                    out[p_] = p_ + d[min(j, 31)]
    return [out[i] for i in range(size)]


def _big_tiles() -> tuple:
    """16 x 16 tiles of a 48 x 40 block whose columns come reversed after
    column 20 (as a flip seam packs them): 256 cells and more than 8 runs
    a tile."""
    ny, nx = 48, 40
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    ids = (j // 16) * 3 + i // 16
    ids[:, 20:] = ids[:, 20:][:, ::-1]
    return ids.reshape(-1), 9


@pytest.mark.parametrize("name", list(SYSTEMS) + ["16 x 16 tiles"])
def test_restriction_by_runs_gives_the_cell_list_sums(spaces, name):
    """Every tile's float32 warp sum over the cells as the kernel finds
    them from the runs is bit-equal to the sum over the tile's cell list in
    CSR form (the order the cell-list form added them in), on a random r;
    tiles of 256 cells take the kernel's positions past 64."""
    if name in SYSTEMS:
        cidx, K = spaces[name][2].cidx.numpy(), spaces[name][2].K
    else:
        cidx, K = _big_tiles()
    runs = cg_cuda_mb.agg_runs(cidx, K)
    r = np.random.default_rng(11).standard_normal(len(cidx)).astype(np.float32)
    for k, cells in enumerate(_csr(cidx, K)):
        mine = _kernel_positions(runs, k)
        assert mine == cells.tolist(), k
        assert _lane_order_sum(np.asarray(mine), r).tobytes() \
            == _lane_order_sum(cells, r).tobytes(), k
    if name not in SYSTEMS:
        assert runs.shape[1] > 8 and max(len(c) for c in _csr(cidx, K)) == 256


@pytest.mark.parametrize("K,C,S", [(1194, 16, 10), (228, 8, 16), (2048, 2, 1),
                                   (5, 16, 10)])
def test_ring_stages_take_every_row_once_in_phase_order(K, C, S):
    """The cluster arm's rows: block r forms rows k = r + C m (m < M =
    ceil((K - r) / C)), stage warp w < S the rows m = w, w + S, ...; its
    mbarrier's phase for row m at the kernel's c-th call is c * uses + m /
    S with uses the stage's rows per call, so that over calls every wait
    is for the phase right after the ones already completed."""
    seen = []
    for rank in range(C):
        M = (K - rank + C - 1) // C
        for w in range(min(S, M)):
            uses = (M - 1 - w) // S + 1
            assert uses == len(range(w, M, S))
            done = 0  # phases of this stage completed so far
            for calls in range(3):
                for j, m in enumerate(range(w, M, S)):
                    assert calls * uses + j == done
                    done += 1
                    if calls == 0:
                        seen.append(rank + C * m)
    assert sorted(seen) == list(range(K))


def test_rows_per_block_at_16():
    """The airfoil at C = 16: block r forms the ceil((1,194 - r) / 16)
    rows k = r mod 16, 74 or 75, K in all, each once."""
    K, C = 1194, 16
    per = [(K - r + C - 1) // C for r in range(C)]
    assert (min(per), max(per), sum(per)) == (74, 75, K)


def test_stage_bytes_count_the_ring_and_the_airfoil_fits_at_16():
    """K3-agg's cluster block: the rows, two coarse vectors of ``agg_kp``
    floats, then the chain terms with the ring over them: 10 rows of Einv
    on the airfoil at C = 16 (223,296 B of the 224,256 a block may take;
    at C = 8 its rows alone do not fit), the cylinder's capped at 16."""
    K, n = 1194, 73456
    kp = cg_cuda_mb.agg_kp(K)
    assert kp == 1196
    S = cg_cuda_mb.agg_ring_stages(n, 16, K)
    assert S == 10
    rows = cg_cuda.block_seg(n, 16) * 9
    chains = 2 * 64 * 72
    assert rows * 4 == 165_888 and chains * 4 == 36_864
    assert cg_cuda_mb.stage_bytes(n, 16, 2, K) == (rows + 2 * kp
                                                   + S * kp) * 4 == 223_296
    assert cg_cuda_mb.stage_bytes(n, 16, 2, K) > cg_cuda_mb.stage_bytes(
        n, 16, 2) + 2 * K * 4
    budget = cg_cuda.SMEM_PER_BLOCK - cg_cuda.SMEM_STATIC
    assert budget == 224_256
    assert cg_cuda_mb.rows_fit(n, 16, 2, K)
    assert (cg_cuda_mb.stage_bytes(n, 16, 2, K) + kp * 4) > budget  # S is all
    assert not cg_cuda_mb.rows_fit(n, 8, 2, K)
    assert cg_cuda_mb.agg_ring_stages(14232, 8, 228) == 16
    assert cg_cuda_mb.agg_ring_stages(n, 1, K) == 0
    # a block whose rows leave no room for a row still takes one (the
    # chain terms' memory)
    assert cg_cuda_mb.agg_ring_stages(200_000, 16, 2048) == 1


def test_ring_constants_match_the_kernel():
    """The host's mirrors of ``csrc/cg.cu``'s caps (the most runs, the most
    ring rows); the host alone sizes the padding and the ring, which the
    entries take and check."""
    src = (Path(cg_cuda_mb.__file__).resolve().parents[1] / "csrc"
           / "cg.cu").read_text()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))
    assert define("FG_AGG_MAX_RUNS") == cg_cuda_mb.AGG_MAX_RUNS == 32
    assert define("FG_AGG_RING_MAX") == cg_cuda_mb.AGG_RING_MAX == 16
    assert re.search(r"fg_agg_layout_ok\(K, kp, cluster, stages\)", src)
