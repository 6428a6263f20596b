"""The cluster arm of K3, K3-coarse and K2-mb
(``fluidgym_tpu_torch.ops.cg_cuda_mb``) on the host: the rule that picks
the cluster size (K3-coarse's over its own kernel instance), the partition
of a lane over the blocks of a cluster, the shared memory a block stages,
the ``cluster=`` argument's checks, ``pinned_cluster``, the coarse entries'
C signatures against the loader's argtypes, and the wrappers' plain
versions on CPU tensors.  The card's occupancy answer is stubbed here; the
kernels themselves run in ``tests/test_torch_kernels_cuda.py`` on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidgym_tpu_torch.core import geometry
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.envs.cylinder.grid import \
    make_vortex_street_domain as cylinder_grid
from fluidgym_tpu_torch.ops import _build, cg_cuda_mb
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
    """Stub ``max_active_clusters`` with a table (default: the H100's; a
    table per kernel instance under ``"by_algo"`` overrides it for that
    instance); records every query."""
    state = {"table": dict(H100_CLUSTERS), "by_algo": {}, "calls": []}

    def fake(algo, ndims, C, n, device, coarse_k=0):
        state["calls"].append((algo, ndims, C, n))
        return state["by_algo"].get(algo, state["table"])[C]

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


# ---------------------------------------------------------------------------
# K3-coarse: the cluster rule over its own kernel instance
# ---------------------------------------------------------------------------

CSRC = Path(cg_cuda_mb.__file__).resolve().parents[1] / "csrc"


def _coarse_static_bytes():
    """Static shared memory of K3-coarse's cluster instance
    (``fg_cg_kernel<2, true, true, true>`` in ``csrc/cg.cu``): ``sh[64]``,
    ``s_rc`` and ``s_xc`` (``FG_MAX_K`` each), seven per-lane arrays
    (``FG_MAX_LANES`` each) and the cluster sum's ``FG_THREADS / 2``
    float2 slots, and the 256 B that ptxas adds to every instance (7,424 B
    in all on the H100 build)."""
    const = {}
    for src in ("cg.cu", "krylov.cuh"):
        for name, v in re.findall(r"#define (FG_MAX_K|FG_MAX_LANES|FG_THREADS)"
                                  r" (\d+)", (CSRC / src).read_text()):
            const[name] = int(v)
    return 256 + 4 * (64 + 2 * const["FG_MAX_K"] + 7 * const["FG_MAX_LANES"]
                      + 2 * (const["FG_THREADS"] // 2))


@pytest.mark.parametrize("what,lanes,n,expected", [
    ("airfoil K3-coarse-flip", 1, AIRFOIL_N, 16),
    ("cylinder K3-coarse", 1, CYLINDER_N, 8),
    ("batch-64 cylinder K3-coarse", 64, CYLINDER_N, 1),
    ("130 cylinder lanes", 130, CYLINDER_N, 1),
    ("batch-64 airfoil K3-coarse-flip", 64, AIRFOIL_N, 1),
    ("130 airfoil lanes", 130, AIRFOIL_N, 1),
    ("30 cylinder lanes", 30, CYLINDER_N, 4),
])
def test_coarse_rule_on_the_main_path_shapes(occupancy, what, lanes, n,
                                             expected):
    """A single env's K3-coarse lane takes the cluster arm where K3's does
    (the airfoil 16, the cylinder 8), a batch the card cannot hold as
    clusters the chunk grid; the rule asks the card about the coarse
    instance only, only at sizes whose rows fit, and the chosen C's staged
    rows and chain terms fit beside the instance's static arrays."""
    assert cg_cuda_mb.merged_arm(lanes, n, 2, 1, CUDA, "cg_coarse") \
        == (expected, 0, False), what
    assert occupancy["calls"]
    assert all(a == "cg_coarse" and nd == 2 and cg_cuda_mb.rows_fit(n_, C, nd)
               for a, nd, C, n_ in occupancy["calls"])
    if expected > 1:
        assert (cg_cuda_mb.stage_bytes(n, expected, 2) + _coarse_static_bytes()
                <= cg_cuda_mb.SMEM_PER_BLOCK)


def test_coarse_static_arrays_fit_the_reserve():
    """``rows_fit`` keeps ``SMEM_STATIC`` for the static arrays: the coarse
    cluster instance's (7.25 KB: its strip sums on top of K3's) fit in it."""
    assert _coarse_static_bytes() == 7_424
    assert _coarse_static_bytes() <= cg_cuda_mb.SMEM_STATIC


def test_coarse_rule_reads_the_coarse_instances_answer(occupancy):
    """The coarse instance's own occupancy decides K3-coarse's C, and K3's
    decides K3's: fewer coarse clusters leave K3 where it was."""
    occupancy["by_algo"]["cg_coarse"] = {16: 0, 8: 1, 4: 33, 2: 66}
    arm = lambda lanes, n, coarse=False: cg_cuda_mb.merged_arm(
        lanes, n, 2, 1, CUDA, "cg_coarse" if coarse else "cg")
    # at C = 8 the airfoil's rows (9,184 cells x 36 B) do not fit: one block
    assert arm(1, AIRFOIL_N, coarse=True) == (1, 0, False)
    assert arm(1, AIRFOIL_N) == (16, 0, False)
    assert arm(1, CYLINDER_N, coarse=True) == (8, 0, False)
    assert arm(2, CYLINDER_N, coarse=True) == (4, 0, False)
    assert arm(2, CYLINDER_N) == (8, 0, False)


def test_coarse_rule_off_the_card_for_chunks_and_pinned(occupancy):
    """The CPU, a chunk of several lanes and a 3D plan (which has no strip
    plan) take the chunk grid without asking the card; ``pinned_cluster``
    pins K3-coarse's C as K3's."""
    arm = lambda lanes, n, nd, chunk, dev: cg_cuda_mb.merged_arm(
        lanes, n, nd, chunk, dev, "cg_coarse")
    assert arm(1, AIRFOIL_N, 2, 1, "cpu") == (1, 0, False)
    assert arm(3, CYLINDER_N, 2, 3, CUDA) == (1, 0, False)
    assert arm(1, 341_568, 3, 1, CUDA) == (1, 0, False)
    assert occupancy["calls"] == []
    with cg_cuda_mb.pinned_cluster(1):
        assert arm(1, AIRFOIL_N, 2, 1, CUDA) == (1, 0, False)
        with cg_cuda_mb.pinned_cluster(4):
            assert arm(1, AIRFOIL_N, 2, 1, CUDA) == (4, 0, False)
            assert arm(1, AIRFOIL_N, 2, 1, "cpu") == (1, 0, False)
    assert arm(1, AIRFOIL_N, 2, 1, CUDA) == (16, 0, False)


def test_max_active_clusters_asks_each_instance(monkeypatch):
    """``max_active_clusters`` reads the occupancy entry of the instance it
    is asked about (``"cg_coarse"``: ``fg_cg_mb_coarse_cluster_occupancy``)
    and returns what the entry wrote."""
    import contextlib
    import ctypes
    from types import SimpleNamespace

    asked = []

    def entry(name):
        def occupancy(ndims, C, n, *k_out):
            asked.append(name)
            ctypes.c_int.from_address(k_out[-1]).value = 100 + C
            return 0
        return occupancy

    names = {"cg": "fg_cg_mb_cluster_occupancy",
             "cg_coarse": "fg_cg_mb_coarse_cluster_occupancy",
             "bicgstab": "fg_bicgstab_mb_cluster_occupancy"}
    lib = SimpleNamespace(**{nm: entry(nm) for nm in names.values()})
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    cg_cuda_mb.max_active_clusters.cache_clear()
    try:
        for algo, name in names.items():
            assert cg_cuda_mb.max_active_clusters(algo, 2, 8, 5_000, CUDA) == 108
            assert asked[-1] == name
    finally:
        cg_cuda_mb.max_active_clusters.cache_clear()


def _c_params(entry):
    """``(type, name)`` of each parameter of an ``extern "C"`` entry of
    ``csrc/cg.cu``."""
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{",
                    (CSRC / "cg.cu").read_text(), re.S).group(1)
    return [(" ".join(p.split()[:-1]), p.split()[-1])
            for p in sig.replace("\n", " ").split(",")]


@pytest.mark.parametrize("entry", ["fg_cg_mb_coarse_solve",
                                   "fg_cg_mb_coarse_cluster_occupancy"])
def test_coarse_entry_signature_matches_the_ctypes_argtypes(entry):
    """The loader's argtypes follow the C signature one for one (pointers
    and the stream as void*, int, float); the coarse solve takes
    ``cluster`` after ``chunk``, as ``merged_launcher`` passes it."""
    params = _c_params(entry)
    kinds = {"int": "c_int", "float": "c_float"}
    assert ([t.__name__ for t in _build._ARGTYPES[entry]]
            == [kinds.get(t, "c_void_p") for t, _ in params])
    names = [nm for _, nm in params]
    if "occupancy" in entry:
        assert names == ["ndims", "cluster", "n", "K", "kp", "stages", "out"]
    else:
        i = names.index("cluster")
        assert names[i - 2:i + 6] == ["lanes", "chunk", "cluster", "n",
                                      "ndims", "op_per_lane", "K", "tol2"]


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
    # K3-coarse has the cluster arm (CPU tensors run its plain version) and
    # one lane per cluster; K2 over the trivial plan has no cluster arm
    one = tuple(b[:1] for b in bs)
    xs, info = cg_cuda_mb.fused_cg_mb(plan, pd, po, one, coarse_strips=True,
                                      cluster=2, **kw)
    assert all(bool(torch.isfinite(x).all()) for x in xs)
    with pytest.raises(ValueError, match="chunk"):
        cg_cuda_mb.fused_cg_mb(plan, pd, po, bs, coarse_strips=True, cluster=2,
                               chunk=2, **kw)
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


@pytest.mark.parametrize("algo", ["cg", "cg_coarse", "bicgstab"])
def test_cpu_wrappers_run_the_plain_versions_whatever_the_cluster(algo):
    """On CPU tensors a forced cluster size runs the plain version, bit-equal
    to the default, and launches nothing (K3-coarse: its strips on the
    resolution-8 cylinder plan, K = 14)."""
    plan, pd, po, ad, ao, bs = _merged_system(lanes=2, seed=3)
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    counters = lambda: (k3.launches, k3.flip_launches, k3.coarse_launches,
                        k3.coarse_flip_launches, k3.cluster_launches,
                        k2.merged_launches, k2.merged_flip_launches,
                        k2.cluster_launches)
    before = counters()
    if algo != "bicgstab":
        assert coarse_strips.strip_plan(plan).K == 14
        plain, call = cg_cuda_mb.fused_cg_mb_plain, (
            lambda C: k3(plan, pd, po, tuple(b[:1] for b in bs), tol=1e-6,
                         maxiter=200, coarse_strips=algo == "cg_coarse",
                         cluster=C))
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
