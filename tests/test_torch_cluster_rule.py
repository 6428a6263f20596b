"""The cluster arm of K3 and K2-mb (``fluidgym_tpu_torch.ops.cg_cuda_mb``)
on the host: the rule that picks the cluster size, the partition of a lane
over the blocks of a cluster, the shared memory a block stages, the
``cluster=`` argument's checks, ``pinned_cluster``, and the wrappers' plain
versions on CPU tensors.  The card's occupancy answer is stubbed here; the kernels
themselves run in ``tests/test_torch_kernels_cuda.py`` on the card.
"""

import numpy as np
import pytest
import torch

from fluidgym_tpu_torch.core import geometry
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.envs.cylinder.grid import \
    make_vortex_street_domain as cylinder_grid
from fluidgym_tpu_torch.ops import cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge, coarse_strips
from torch_port_helpers import nonsym_stencil

torch.set_num_threads(1)

CUDA = torch.device("cuda")  # a device name only: nothing runs on it here
#: an H100's co-resident clusters of 1024-thread blocks, by cluster size
#: (one block per SM; 16-block clusters fit 7 of the card's GPCs)
H100_CLUSTERS = {16: 7, 8: 16, 4: 33, 2: 66}
AIRFOIL_N, CYLINDER_N = 73_456, 14_232
GRID_KW = dict(ndims=2, viscosity=0.01, domain_height=4.1, domain_length=22.0,
               cylinder_radius=0.5, cylinder_offset_y=0.05, circle_thickness=0.5,
               quad_thickness_x=1.0, vortex_street_refinement_base=0.95,
               vortex_street_refinement_axes=("+y", "-y"))


@pytest.fixture
def occupancy(monkeypatch):
    """Stub ``max_active_clusters`` with a table (default: the H100's);
    records every query."""
    state = {"table": dict(H100_CLUSTERS), "calls": []}

    def fake(algo, ndims, C, n, device):
        state["calls"].append((algo, ndims, C, n))
        return state["table"][C]

    monkeypatch.setattr(cg_cuda_mb, "max_active_clusters", fake)
    return state


@pytest.mark.parametrize("what,lanes,n,expected", [
    ("airfoil K3-flip", 1, AIRFOIL_N, 16),
    ("airfoil K2-mb-flip", 2, AIRFOIL_N, 16),
    ("cylinder K3", 1, CYLINDER_N, 8),
    ("cylinder K2-mb", 2, CYLINDER_N, 8),
    # at C = 2 a block's 7,136 cylinder cells stage 257 KB > 227 KB, and
    # 4- or 8-block clusters are too few for 64 lanes: the chunk grid
    ("batch-64 cylinder K3", 64, CYLINDER_N, 1),
    ("30 cylinder lanes", 30, CYLINDER_N, 4),
    ("batch-64 cylinder K2-mb", 128, CYLINDER_N, 1),
    ("130 lanes", 130, CYLINDER_N, 1),
    ("130 airfoil lanes", 130, AIRFOIL_N, 1),
    ("RBC-sized lane", 1, 5_856, 4),
    ("under one block's worth", 1, 2_000, 1),
])
def test_default_cluster_on_the_main_path_shapes(occupancy, what, lanes, n,
                                                 expected):
    for algo in ("cg", "bicgstab"):
        assert cg_cuda_mb.default_cluster(lanes, n, 2, 1, CUDA, algo) == expected, what
    # the rule asks the card only about sizes whose rows fit
    assert all(cg_cuda_mb.rows_fit(n_, C, nd)
               for _, nd, C, n_ in occupancy["calls"])


def test_default_cluster_is_one_off_the_card_and_for_chunks(occupancy):
    assert cg_cuda_mb.default_cluster(1, AIRFOIL_N, 2, 1, "cpu") == 1
    assert cg_cuda_mb.default_cluster(4, AIRFOIL_N, 2, 2, CUDA) == 1
    assert occupancy["calls"] == []


def test_default_cluster_reads_the_cards_answer(occupancy):
    """What the card holds decides, not an assumption: fewer 8-block
    clusters than lanes, then too few 16-block ones."""
    occupancy["table"][8] = 1
    assert cg_cuda_mb.default_cluster(2, CYLINDER_N, 2, 1, CUDA) == 4
    occupancy["table"][4] = 0
    # C = 2 would not stage the cylinder's rows: the chunk grid
    assert cg_cuda_mb.default_cluster(2, CYLINDER_N, 2, 1, CUDA) == 1
    occupancy["table"][16] = 1
    assert cg_cuda_mb.default_cluster(1, AIRFOIL_N, 2, 1, CUDA) == 16
    assert cg_cuda_mb.default_cluster(2, AIRFOIL_N, 2, 1, CUDA) == 1


@pytest.mark.parametrize("n,ndims,expected", [
    (AIRFOIL_N, 3, 1),      # 4,608 cells x 52 B = 240 KB at C = 16
    (80_000, 2, 16),        # 5,024 cells x 36 B + 79 x 64 x 8 B = 216 KB
    (90_000, 2, 1),         # 5,632 cells x 36 B + 88 x 64 x 8 B = 242 KB
    (40_000, 3, 16),        # 2,528 cells x 52 B + 40 x 64 x 8 B = 148 KB
    (400_000, 2, 1),
    (120_000, 2, 1),
])
def test_default_cluster_needs_the_rows_to_fit(occupancy, n, ndims, expected):
    C = cg_cuda_mb.default_cluster(1, n, ndims, 1, CUDA)
    assert C == expected
    if C > 1:
        assert cg_cuda_mb.stage_bytes(n, C, ndims) <= cg_cuda_mb.SMEM_PER_BLOCK


def test_pinned_cluster(occupancy):
    rule = lambda: cg_cuda_mb.default_cluster(1, AIRFOIL_N, 2, 1, CUDA)
    with cg_cuda_mb.pinned_cluster(1):
        assert rule() == 1
        with cg_cuda_mb.pinned_cluster(4):
            assert rule() == 4
            # a chunk of several lanes, or the CPU, stays 1 whatever is pinned
            assert cg_cuda_mb.default_cluster(8, AIRFOIL_N, 2, 2, CUDA) == 1
            assert cg_cuda_mb.default_cluster(1, AIRFOIL_N, 2, 1, "cpu") == 1
        assert rule() == 1  # the outer pin again
        with cg_cuda_mb.pinned_cluster(None):
            assert rule() == 16
    assert rule() == 16
    with pytest.raises(ValueError):
        with cg_cuda_mb.pinned_cluster(3):
            pass
    # an exception inside the block restores the rule too
    with pytest.raises(RuntimeError):
        with cg_cuda_mb.pinned_cluster(2):
            raise RuntimeError
    assert rule() == 16


@pytest.mark.parametrize("n", [1, 31, 1_000, 5_856, CYLINDER_N, AIRFOIL_N, 100_003])
@pytest.mark.parametrize("C", [2, 4, 8, 16])
def test_cluster_ranges_cover_the_lane_once(n, C):
    ranges = cg_cuda_mb.cluster_ranges(n, C)
    assert len(ranges) == C
    seg = ranges[0][1] - ranges[0][0] if n > 32 * C else None
    covered = np.concatenate([np.arange(a, b) for a, b in ranges])
    assert np.array_equal(covered, np.arange(n))
    for a, b in ranges:
        assert a % 32 == 0 or a == n
        assert 0 <= b - a <= -(-(-(-n // C)) // 32) * 32
    if seg is not None:
        assert seg % 32 == 0 and seg * C >= n > seg * (C - 1) - 32 * C


@pytest.mark.parametrize("n", [5_856, CYLINDER_N, 40_000, AIRFOIL_N, 110_000])
@pytest.mark.parametrize("lanes", [1, 2])
def test_staged_bytes_at_the_chosen_cluster_fit(occupancy, n, lanes):
    C = cg_cuda_mb.default_cluster(lanes, n, 2, 1, CUDA)
    if C > 1:
        assert cg_cuda_mb.stage_bytes(n, C, 2) <= 227 * 1024
        # every block's rows and its chains' terms are within it
        rows = max(b - a for a, b in cg_cuda_mb.cluster_ranges(n, C))
        chains = (1024 // C) * -(-n // 1024)
        assert rows * 9 * 4 + chains * 2 * 4 <= cg_cuda_mb.stage_bytes(n, C, 2)


def test_stage_bytes_of_the_main_path():
    # rows of 36 B per cell, then 8 B per term of 64 (128) chains of 72 (14)
    assert cg_cuda_mb.stage_bytes(AIRFOIL_N, 16, 2) == 4_608 * 36 + 64 * 72 * 8 == 202_752
    assert cg_cuda_mb.stage_bytes(CYLINDER_N, 8, 2) == 1_792 * 36 + 128 * 14 * 8 == 78_848


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors: argument checks, plain versions
# ---------------------------------------------------------------------------

def _merged_system(lanes=1, seed=0):
    """The CylinderJet2D O-grid at resolution 8, merged (2 super-blocks,
    2 seam fixups), with a shifted-Laplacian operator (SPD) and a
    diagonally dominant nonsymmetric one on its super-blocks, and ``lanes``
    random right-hand sides."""
    topo = cylinder_grid(circle_resolution_angular=8, **GRID_KW)[0].build()[0]
    plan = block_merge.merge_plan(topo)
    assert len(plan.superblocks) == 2
    shapes = coarse_strips.sb_array_shapes(plan)
    rng = np.random.default_rng(seed)
    spd = [(torch.full(s, 4.1), torch.full((4,) + s, -1.0)) for s in shapes]
    nsym = [(torch.full(s, 4.5), torch.tensor([-1.2, -0.8, -1.1, -0.9]).reshape(
        4, 1, 1).expand((4,) + s).contiguous()) for s in shapes]
    bs = tuple(torch.from_numpy(rng.normal(size=(lanes,) + s).astype(np.float32))
               for s in shapes)
    return (plan, tuple(d for d, _ in spd), tuple(o for _, o in spd),
            tuple(d for d, _ in nsym), tuple(o for _, o in nsym), bs)


def test_cluster_argument_is_checked():
    plan, pd, po, ad, ao, bs = _merged_system(lanes=2)
    kw = dict(tol=1e-6, maxiter=50)
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="cluster"):
            cg_cuda_mb.fused_cg_mb(plan, pd, po, bs, cluster=bad, **kw)
        with pytest.raises(ValueError, match="cluster"):
            cg_cuda_mb.fused_bicgstab_mb(plan, ad, ao, bs, cluster=bad, **kw)
    # one lane per cluster: a chunk of several lanes takes cluster 1 only
    with pytest.raises(ValueError, match="chunk"):
        cg_cuda_mb.fused_cg_mb(plan, pd, po, bs, cluster=2, chunk=2, **kw)
    with pytest.raises(ValueError, match="chunk"):
        cg_cuda_mb.fused_bicgstab_mb(plan, ad, ao, bs, cluster=4, chunk=2, **kw)
    # K3-coarse and K2 over the trivial plan have no cluster arm
    with pytest.raises(ValueError, match="no cluster arm"):
        cg_cuda_mb.fused_cg_mb(plan, pd, po, tuple(b[:1] for b in bs),
                               coarse_strips=True, cluster=2, **kw)
    dom = DomainBuilder(ndims=2, viscosity=0.01)
    dom.create_block(geometry.make_uniform_grid((12, 8), (0, 0), (1.0, 1.0)))
    tplan = block_merge.trivial_plan(dom.build()[0])
    d, o = (torch.from_numpy(x) for x in nonsym_stencil((8, 12), 2, 1))
    with pytest.raises(ValueError, match="no cluster arm"):
        cg_cuda_mb.fused_bicgstab_mb(tplan, (d,), (o,), (torch.ones(2, 8, 12),),
                                     cluster=2, **kw)
    # the raw launch checks before it reaches the library
    b = cg_cuda_mb.flatten_fields(plan, bs)
    diag, off = cg_cuda_mb.flatten_ops(plan, pd, po)
    with pytest.raises(ValueError, match="chunk"):
        cg_cuda_mb._launch_merged("cg", plan, diag, off, b, None, tol2_sum=1.0,
                                  maxiter=5, stall_iters=5, precondition=True,
                                  return_best=True, chunk=2, cluster=8)
    # a cluster size whose operator rows do not fit in shared memory (400k
    # cells: 25,024 per block at C = 16, 901 KB) is refused, not run unstaged
    big = torch.ones(1, 400_000)
    with pytest.raises(ValueError, match="do not fit"):
        cg_cuda_mb._launch_merged("bicgstab", plan, big, big.expand(4, -1)[None],
                                  big, None, tol2_sum=1.0, maxiter=5,
                                  stall_iters=5, precondition=True,
                                  return_best=True, chunk=1, cluster=16)


@pytest.mark.parametrize("algo", ["cg", "bicgstab"])
def test_cpu_wrappers_run_the_plain_versions_whatever_the_cluster(algo):
    """On CPU tensors a forced cluster size runs the plain version, bit-equal
    to the default, and launches nothing."""
    plan, pd, po, ad, ao, bs = _merged_system(lanes=2, seed=3)
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    counters = lambda: (k3.launches, k3.flip_launches, k3.cluster_launches,
                        k2.merged_launches, k2.merged_flip_launches,
                        k2.cluster_launches)
    before = counters()
    if algo == "cg":
        plain, call = cg_cuda_mb.fused_cg_mb_plain, (
            lambda C: k3(plan, pd, po, tuple(b[:1] for b in bs), tol=1e-6,
                         maxiter=200, cluster=C))
    else:
        plain, call = cg_cuda_mb.fused_bicgstab_plain, (
            lambda C: k2(plan, ad, ao, bs, tol=1e-6, maxiter=200, cluster=C))
    calls = plain.calls
    ref_x, ref_info = call(None)
    for C in (1, 2, 4, 8, 16):
        xs, info = call(C)
        for a, r in zip(xs, ref_x):
            assert torch.equal(a, r), C
        assert torch.equal(torch.as_tensor(info.iterations),
                           torch.as_tensor(ref_info.iterations))
    assert plain.calls == calls + 6
    assert counters() == before
    assert bool(torch.as_tensor(ref_info.converged).all())
