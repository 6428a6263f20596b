"""The spread arm of K3 and K2-mb over a 3D merged plan
(``fluidgym_tpu_torch.ops.cg_cuda_mb``) on the host: the rule
``merged_arm`` that picks the cluster arm, the spread arm (all lanes in
one launch, or one lane per launch where no G holds them all:
CylinderJet3D-hard's 2,481,408-cell velocity lanes) or the chunk grid by
shape (the card's SM count, co-residency and cluster occupancy stubbed),
``cg_cuda.pinned_spread`` over it, the wrappers' one-lane-per-launch path
with the launcher stubbed by the plain version, the merged lanes' shared
memory and layout, the C entry points' signatures (against
``ops/_build.py``), ``merged_launcher``'s refusals, and the wrappers' plain
versions on CPU tensors whatever the pin, against the JAX package's kernels
in interpret mode on a small 3D cylinder plan.  The kernels themselves run
in ``tests/test_torch_kernels_cuda.py`` on the card (``-k merged_spread``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidgym_tpu.envs.cylinder.grid import \
    make_vortex_street_domain as jcylinder_grid
from fluidgym_tpu.ops import cg_pallas_mb
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu_torch.envs.cylinder.grid import \
    make_vortex_street_domain as cylinder_grid
from fluidgym_tpu_torch.ops import _build, cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge, coarse_strips
from torch_port_helpers import assert_rel, nonsym_stencil, spd_stencil

torch.set_num_threads(1)

CUDA = torch.device("cuda")  # a device name only: nothing runs on it here
H100_SMS = 132
#: an H100's co-resident clusters of 1024-thread blocks, by cluster size
H100_CLUSTERS = {16: 7, 8: 16, 4: 33, 2: 66}
EASY_N, MEDIUM_N = 341_568, 749_568      # CylinderJet3D-easy / -medium
HARD_N = 2_481_408                       # CylinderJet3D-hard
CYLINDER_N, AIRFOIL_N = 14_232, 73_456   # the 2D merged lanes
CYLINDER32_N = 23_424                    # CylinderJet2D / Rot2D medium, hard
CSRC = Path(cg_cuda.__file__).resolve().parents[1] / "csrc"
GRID_KW = dict(viscosity=0.01, domain_height=4.1, domain_length=22.0,
               cylinder_radius=0.5, cylinder_offset_y=0.05, circle_thickness=0.5,
               quad_thickness_x=1.0, circle_resolution_angular=8,
               vortex_street_refinement_base=0.95,
               vortex_street_refinement_axes=("+y", "-y"))


@pytest.fixture
def h100(monkeypatch):
    """The card's SM count, its co-resident spread blocks (one 1024-thread
    block per SM) and cluster occupancy for the rules (no card here);
    records the co-residency queries."""
    asked = []

    def capacity(algo, ndims, G, chains, n, device):
        asked.append((algo, ndims, G, chains, n))
        return H100_SMS

    monkeypatch.setattr(cg_cuda, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(cg_cuda, "spread_capacity", capacity)
    monkeypatch.setattr(cg_cuda_mb, "max_active_clusters",
                        lambda algo, ndims, C, n, device, coarse_k=0:
                        H100_CLUSTERS[C])
    return asked


def _arm(lanes, n, ndims, algo="cg", chunk=None, device=CUDA, coarse=False):
    c = cg_cuda.default_chunk(lanes, device) if chunk is None else chunk
    return cg_cuda_mb.merged_arm(lanes, n, ndims, c, device,
                                 "cg_coarse" if coarse else algo)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what,lanes,n,ndims,algo,arm", [
    ("CylinderJet3D-easy K3-3D", 1, EASY_N, 3, "cg", (1, 128, False)),
    ("CylinderJet3D-medium K3-3D", 1, MEDIUM_N, 3, "cg", (1, 128, False)),
    ("CylinderJet3D-easy K2-mb-3D velocity", 3, EASY_N, 3, "bicgstab", (1, 32, False)),
    ("CylinderJet3D-medium K2-mb-3D velocity", 3, MEDIUM_N, 3, "bicgstab",
     (1, 32, False)),
    ("CylinderJet3D-hard K3-3D", 1, HARD_N, 3, "cg", (1, 128, False)),
    ("CylinderJet3D-hard K2-mb-3D velocity: one lane per launch", 3, HARD_N,
     3, "bicgstab", (1, 128, True)),
    ("K3-3D at the hard width with 3 lanes", 3, HARD_N, 3, "cg",
     (1, 128, True)),
    ("K3-3D with a second right-hand side", 2, EASY_N, 3, "cg", (1, 64, False)),
    ("CylinderJet2D-medium K3 (the cluster arm)", 1, CYLINDER32_N, 2, "cg",
     (16, 0, False)),
    ("CylinderJet2D-medium K2-mb (the cluster arm)", 2, CYLINDER32_N, 2,
     "bicgstab", (16, 0, False)),
    ("CylinderJet2D K3 (the cluster arm)", 1, CYLINDER_N, 2, "cg", (8, 0, False)),
    ("CylinderJet2D K2-mb (the cluster arm)", 2, CYLINDER_N, 2, "bicgstab",
     (8, 0, False)),
    ("Airfoil2D K3-flip (the cluster arm)", 1, AIRFOIL_N, 2, "cg", (16, 0, False)),
    ("Airfoil2D K2-mb-flip (the cluster arm)", 2, AIRFOIL_N, 2, "bicgstab",
     (16, 0, False)),
    ("a batch of 64 CylinderJet2D lanes", 64, CYLINDER_N, 2, "cg", (1, 0, False)),
    ("a batch of 64 CylinderJet3D lanes", 64, EASY_N, 3, "cg", (1, 0, False)),
    ("5 lanes x 32 blocks > 132: one lane per launch at G = 128", 5, EASY_N,
     3, "bicgstab", (1, 128, True)),
    ("17 lanes: fewer than 8 blocks per lane at G = 128", 17, EASY_N, 3,
     "bicgstab", (1, 0, False)),
])
def test_merged_arm_on_the_main_path_shapes(h100, what, lanes, n, ndims, algo,
                                            arm):
    """A lane the cluster rule spreads keeps the cluster arm; a 3D merged
    lane whose rows no cluster holds takes the spread arm at the largest G
    with ``lanes * G`` co-resident; a batch too big for either takes the
    chunk grid.  The spread rule asks about the merged instances only."""
    assert _arm(lanes, n, ndims, algo) == arm, what
    assert all(a == algo + "_mb" and nd == 3 for a, nd, *_ in h100)


@pytest.mark.parametrize("n", [EASY_N, MEDIUM_N])
def test_merged_arm_keeps_the_chunk_grid(h100, n):
    """K3-coarse over a 3D plan (which has no strip plan), a chunk of
    several lanes and the CPU take the chunk grid, whatever is pinned; a 3D lane too small for a cluster of 2 (2 x 1,024
    cells) and for 32 spread blocks (32 x 256) too."""
    for G in (None, 128, 32):
        with cg_cuda.pinned_spread(G):
            assert _arm(1, n, 3, coarse=True) == (1, 0, False)
            assert _arm(3, n, 3, chunk=3) == (1, 0, False)
            assert _arm(1, n, 3, device="cpu") == (1, 0, False)
            assert _arm(3, n, 3, "bicgstab", device=torch.device("cpu")) == (1, 0, False)
    assert _arm(1, 2_000, 3) == (1, 0, False)
    # a 3D lane a cluster holds keeps the cluster arm
    assert _arm(1, 8_000, 3) == (4, 0, False)


def test_pinned_spread_over_the_merged_rule(h100):
    """``pinned_spread`` pins G for the 3D merged lanes (0: the chunk grid)
    and leaves the 2D merged lanes on the cluster rule's answer;
    ``pinned_cluster`` still pins C first."""
    with cg_cuda.pinned_spread(0):
        assert _arm(1, EASY_N, 3) == (1, 0, False)
        assert _arm(3, MEDIUM_N, 3, "bicgstab") == (1, 0, False)
        with cg_cuda.pinned_spread(64):
            assert _arm(1, EASY_N, 3) == (1, 64, False)
            # a pin reaches a lane the rule leaves on the chunk grid
            assert _arm(1, 2_000, 3) == (1, 64, False)
            # the 2D lanes keep the cluster arm, or the chunk grid
            assert _arm(1, CYLINDER_N, 2) == (8, 0, False)
            assert _arm(64, CYLINDER_N, 2) == (1, 0, False)
            with cg_cuda_mb.pinned_cluster(1):
                assert _arm(1, CYLINDER_N, 2) == (1, 0, False)
                assert _arm(1, EASY_N, 3) == (1, 64, False)
            with cg_cuda.pinned_spread(None):
                assert _arm(1, EASY_N, 3) == (1, 128, False)
        assert _arm(1, EASY_N, 3) == (1, 0, False)
    assert _arm(1, EASY_N, 3) == (1, 128, False)
    assert cg_cuda._PINNED_SPREAD is None


def test_merged_arm_follows_co_residency(h100, monkeypatch):
    """G is the largest size whose grid the card holds for the lanes; where
    none holds them all, the largest that holds one lane, one lane per
    launch."""
    for room, arm in ((132, (1, 32, False)), (96, (1, 32, False)),
                      (95, (1, 64, True)), (63, (1, 32, True)),
                      (31, (1, 0, False))):
        monkeypatch.setattr(cg_cuda, "spread_capacity",
                            lambda *a, room=room, **k: room)
        assert _arm(3, EASY_N, 3, "bicgstab") == arm, room
    for room, G in ((127, 64), (63, 32), (31, 0)):
        monkeypatch.setattr(cg_cuda, "spread_capacity",
                            lambda *a, room=room, **k: room)
        assert _arm(1, MEDIUM_N, 3) == (1, G, False), room


def test_hard_width_goes_one_lane_per_launch(h100):
    """At 2,481,408 cells a spread block's chain terms fill one SM (155,136
    B at G = 128; G = 64 and 32 do not fit), so 3 lanes need 384
    co-resident blocks and no G holds them: the rule launches the lanes
    one at a time at G = 128.  ``pinned_spread(0)`` still pins the chunk
    grid, a pinned G is taken as given, and the easy and medium widths keep
    their answers."""
    assert cg_cuda.spread_bytes(HARD_N, 128) == 2 * 8 * 2424 * 4 == 155_136
    assert cg_cuda.spread_fits(HARD_N, 128)
    assert not cg_cuda.spread_fits(HARD_N, 64)
    assert not cg_cuda.spread_fits(HARD_N, 32)
    assert cg_cuda.default_spread(3, HARD_N, 3, 1, CUDA, "bicgstab_mb") == 0
    assert _arm(3, HARD_N, 3, "bicgstab") == (1, 128, True)
    with cg_cuda.pinned_spread(0):
        assert _arm(3, HARD_N, 3, "bicgstab") == (1, 0, False)
        assert _arm(1, HARD_N, 3) == (1, 0, False)
    with cg_cuda.pinned_spread(128):
        assert _arm(3, HARD_N, 3, "bicgstab") == (1, 128, False)
    for n in (EASY_N, MEDIUM_N):
        assert _arm(3, n, 3, "bicgstab") == (1, 32, False)
        assert _arm(1, n, 3) == (1, 128, False)
    # a batch of hard lanes, or a chunk of several, keeps the chunk grid
    assert _arm(17, HARD_N, 3, "bicgstab") == (1, 0, False)
    assert _arm(3, HARD_N, 3, "bicgstab", chunk=3) == (1, 0, False)
    assert _arm(3, HARD_N, 3, "bicgstab", device="cpu") == (1, 0, False)
    arm = cg_cuda_mb.merged_arm(3, HARD_N, 3, 1, CUDA, "bicgstab")
    assert (arm.cluster, arm.spread, arm.per_lane) == (1, 128, True)


# ---------------------------------------------------------------------------
# shared memory and layout of the merged lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,G,nbytes", [
    (EASY_N, 128, 2 * 8 * 334 * 4), (EASY_N, 64, 2 * 16 * 334 * 4),
    (EASY_N, 32, 2 * 32 * 334 * 4), (MEDIUM_N, 128, 2 * 8 * 732 * 4),
    (MEDIUM_N, 32, 2 * 32 * 732 * 4),
])
def test_spread_bytes_of_the_merged_lanes(n, G, nbytes):
    """A merged spread block keeps only its chains' terms in shared memory
    (2 floats x 1024 / G chains x ceil(n / 1024) rows): the rows and the
    neighbour table stay in L2, so every G fits, where no cluster size
    holds the rows."""
    assert cg_cuda.spread_bytes(n, G) == nbytes
    assert cg_cuda.spread_fits(n, G)
    assert not any(cg_cuda_mb.rows_fit(n, C, 3) for C in cg_cuda_mb.CLUSTER_SIZES)


@pytest.mark.parametrize("n", [EASY_N, MEDIUM_N, 15_872])
@pytest.mark.parametrize("G", cg_cuda.SPREAD_SIZES)
def test_merged_lanes_take_the_chains_layout(n, G):
    """The chains layout at every G on both widths (measured on the H100:
    it won every G there; ``cg_cuda.spread_chains``), where a roll-form
    lane of 749,568 cells would take the range layout at G = 128."""
    assert cg_cuda.spread_chains(n, G, 3, merged=True) is True
    assert cg_cuda.spread_chains(MEDIUM_N, 128, 3) is False


# ---------------------------------------------------------------------------
# the C entries and the launcher
# ---------------------------------------------------------------------------

def _c_params(source, entry):
    """``(type, name)`` of each parameter of an ``extern "C"`` entry."""
    src = (CSRC / source).read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                    re.S).group(1)
    return [(" ".join(p.split()[:-1]), p.split()[-1])
            for p in sig.replace("\n", " ").split(",")]


@pytest.mark.parametrize("source,entry", [
    ("cg.cu", "fg_cg_mb_solve"), ("bicgstab_mb.cu", "fg_bicgstab_mb_solve"),
    ("cg.cu", "fg_cg_mb_spread_capacity"),
    ("bicgstab_mb.cu", "fg_bicgstab_mb_spread_capacity")])
def test_merged_entry_signature_matches_the_ctypes_argtypes(source, entry):
    """The loader's argtypes follow the C signature one for one (pointers
    and the stream as void*, int, float); the merged solves take the spread
    arm's buffers before ``lanes`` and its G and layout after
    ``cluster``."""
    params = _c_params(source, entry)
    kinds = {"int": "c_int", "float": "c_float"}
    want = [kinds.get(t, "c_void_p") for t, _ in params]
    assert [t.__name__ for t in _build._ARGTYPES[entry]] == want
    names = [nm for _, nm in params]
    if "capacity" in entry:
        assert names == ["ndims", "spread", "chains", "n", "out"]
    else:
        i = names.index("cluster")
        assert names[i - 4:i + 5] == ["bar", "slot", "lanes", "chunk",
                                      "cluster", "spread", "chains", "n",
                                      "ndims"]


def test_merged_args_check_keeps_the_spread_arm_3d():
    """``fg_merged_args_ok`` (``csrc/krylov.cuh``) takes the spread arm with
    chunk 1, no cluster, a 3D plan and its buffers, as the launcher's
    checks do."""
    src = (CSRC / "krylov.cuh").read_text()
    body = re.search(r"inline bool fg_merged_args_ok\(.*?\n\}", src, re.S).group(0)
    for clause in ("fg_spread_ok(spread)", "chunk == 1", "cluster == 1",
                   "ndims == 3", "bar != nullptr", "slot != nullptr",
                   "fg_spread_layout_ok(ndims, chains)"):
        assert clause in body, clause
    for source, entry in (("cg.cu", "fg_cg_mb_solve"),
                          ("bicgstab_mb.cu", "fg_bicgstab_mb_solve")):
        text = (CSRC / source).read_text()
        assert "fg_merged_args_ok(" in text.split(f'extern "C" int {entry}(')[1]


def _small_plans():
    """The CylinderJet3D grid at resolution 8 (5 blocks, 15,872 cells,
    periodic z) merged into 2 super-blocks, in both packages."""
    tp = block_merge.merge_plan(cylinder_grid(ndims=3, **GRID_KW)[0].build()[0])
    jp = jbm.merge_plan(jcylinder_grid(ndims=3, **GRID_KW)[0].build()[0])
    assert tp.ndims == 3 and tp.identity_seams and len(tp.superblocks) == 2
    return jp, tp


@pytest.fixture(scope="module")
def plans():
    return _small_plans()


def test_merged_launcher_refuses_what_the_spread_arm_does_not_take(plans):
    """Refused before the plan's table is built or the library is loaded:
    an unknown G, chunk > 1, the cluster arm and the spread arm at once,
    K3-coarse, and a 2D plan."""
    _, tp = plans
    n = 15_872
    diag, off, b = torch.ones(1, n), torch.zeros(1, 6, n), torch.ones(3, n)
    kw = dict(tol2_sum=1e-6, maxiter=10, stall_iters=5, precondition=True,
              return_best=True)
    launch = lambda **k: cg_cuda_mb.merged_launcher(
        "cg", tp, diag, off, k.pop("b", b), None, **dict(kw, **k))
    with pytest.raises(ValueError, match="spread must be"):
        launch(chunk=1, spread=16)
    with pytest.raises(ValueError, match="chunk 1"):
        launch(chunk=3, spread=32)
    with pytest.raises(ValueError, match="not both"):
        launch(chunk=1, cluster=8, spread=32)
    with pytest.raises(ValueError, match="K3-coarse"):
        launch(chunk=1, spread=32, coarse=(None, torch.zeros(1, 1, 1)))
    topo2 = cylinder_grid(ndims=2, **GRID_KW)[0].build()[0]
    p2 = block_merge.merge_plan(topo2)
    n2 = sum(int(np.prod(s)) for s in coarse_strips.sb_array_shapes(p2))
    with pytest.raises(ValueError, match="3D plans only"):
        cg_cuda_mb.merged_launcher("bicgstab", p2, torch.ones(1, n2),
                                   torch.zeros(1, 4, n2), torch.ones(2, n2),
                                   None, chunk=1, spread=32, **kw)


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors against the JAX package
# ---------------------------------------------------------------------------

def _operators(plan, nonsym, seed):
    """Per-super-block ``diag`` / ``off`` (numpy) of an SPD or a diagonally
    dominant nonsymmetric stencil on the plan's super-blocks."""
    make = nonsym_stencil if nonsym else spd_stencil
    ops = [make(s, 3, seed + i)
           for i, s in enumerate(coarse_strips.sb_array_shapes(plan))]
    return [d for d, _ in ops], [o for _, o in ops]


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_cpu_k3_3d_runs_the_plain_version_whatever_the_pin(plans, warm):
    """K3 on the small 3D plan: the plain version under any pin (no launch
    counted, the same bits), against the Pallas K3 in interpret mode."""
    jp, tp = plans
    d, o = _operators(tp, False, 60)
    rng = np.random.default_rng(61)
    b = [rng.normal(size=dd.shape).astype(np.float32) for dd in d]
    x0 = [(0.5 * bb).astype(np.float32) for bb in b] if warm else None
    kw = dict(tol=1e-6, maxiter=2000, stall_iters=250, precondition=True,
              return_best=True)
    f = cg_cuda_mb.fused_cg_mb
    T = lambda xs: None if xs is None else tuple(torch.from_numpy(x) for x in xs)
    counters = lambda: (f.launches, f.spread_launches, f.cluster_launches)
    before, calls = counters(), cg_cuda_mb.fused_cg_mb_plain.calls
    outs = []
    for G in (None, 0, 32, 128):
        with cg_cuda.pinned_spread(G):
            outs.append(f(tp, T(d), T(o), T(b), T(x0), **kw))
    assert counters() == before
    assert cg_cuda_mb.fused_cg_mb_plain.calls == calls + 4
    for xs, info in outs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(xs, outs[0][0]))
        assert int(info.iterations) == int(outs[0][1].iterations)
    J = lambda xs: None if xs is None else tuple(jnp.asarray(x) for x in xs)
    xj, ij = cg_pallas_mb.fused_cg_mb(jp, J(d), J(o), J(b), J(x0),
                                      interpret=True, **kw)
    xt, it = outs[0]
    assert bool(ij.converged) and bool(it.converged)
    assert int(it.iterations) > 20
    assert abs(int(it.iterations) - int(ij.iterations)) <= 3
    for a, c in zip(xt, xj):
        assert_rel(a.numpy(), np.asarray(c), 2e-4, f"K3-3D warm={warm}")


def test_cpu_k2_mb_3d_runs_the_plain_version_whatever_the_pin(plans):
    """K2-mb on the small 3D plan, 3 component lanes warm-started (the
    velocity solve): the plain version under any pin, against the Pallas
    K2 in interpret mode."""
    jp, tp = plans
    d, o = _operators(tp, True, 70)
    rng = np.random.default_rng(71)
    b = [rng.normal(size=(3,) + dd.shape).astype(np.float32) for dd in d]
    x0 = [(0.3 * bb).astype(np.float32) for bb in b]
    kw = dict(tol=1e-6, maxiter=400, stall_iters=250, precondition=True,
              return_best=False)
    f = cg_cuda_mb.fused_bicgstab_mb
    T = lambda xs: tuple(torch.from_numpy(x) for x in xs)
    counters = lambda: (f.merged_launches, f.merged_spread_launches,
                        f.spread_launches, f.cluster_launches)
    before, calls = counters(), cg_cuda_mb.fused_bicgstab_plain.calls
    outs = []
    for G in (None, 0, 32):
        with cg_cuda.pinned_spread(G):
            outs.append(f(tp, T(d), T(o), T(b), T(x0), **kw))
    assert counters() == before
    assert cg_cuda_mb.fused_bicgstab_plain.calls == calls + 3
    for xs, _ in outs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(xs, outs[0][0]))
    J = lambda xs: tuple(jnp.asarray(x) for x in xs)
    xj, ij = cg_pallas_mb.fused_bicgstab_mb(jp, J(d), J(o), J(b), J(x0),
                                            interpret=True, **kw)
    xt, it = outs[0]
    assert bool(ij.converged) and bool(it.converged)
    assert int(it.iterations) >= 2
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    for a, c in zip(xt, xj):
        assert_rel(a.numpy(), np.asarray(c), 1e-4, "K2-mb-3D")


@pytest.mark.parametrize("algo", ["cg", "bicgstab"])
def test_per_lane_launches_are_the_chunk_grids_lanes(plans, monkeypatch, algo):
    """The wrappers' one-lane-per-launch path on the host, with the card's
    pieces stubbed: ``merged_arm`` answers ``(1, 128, True)``, the tensors
    count as the card's, and each launch runs the plain version of the
    lanes it is given.  The wrapper must launch each lane alone at G = 128
    (its operator shared), in order, count every launch on its form and
    on the spread arm, and return what the plain version returns for the
    lanes in chunks of one (the chunk grid at one lane per block), bit for
    bit."""
    _, tp = plans
    d, o = _operators(tp, algo == "bicgstab", 80)
    rng = np.random.default_rng(81)
    b = [rng.normal(size=(3,) + dd.shape).astype(np.float32) for dd in d]
    b[1][1] *= 1e-3
    x0 = [(0.3 * bb).astype(np.float32) for bb in b]
    T = lambda xs: tuple(torch.from_numpy(x) for x in xs)
    launched = []

    def launcher(algo_, plan, diag, off, b_, x0_, *, tol2_sum, maxiter,
                 stall_iters, precondition, return_best, chunk, cluster=1,
                 spread=0, coarse=None, chains=None):
        launched.append((algo_, tuple(b_.shape), diag.shape[0], off.shape[0],
                         chunk, cluster, spread))
        kw = dict(tol2_sum=tol2_sum, maxiter=maxiter, stall_iters=stall_iters,
                  precondition=precondition, return_best=return_best, chunk=1)
        if algo_ == "cg":
            return lambda: cg_cuda_mb.fused_cg_mb_plain(plan, diag, off, b_,
                                                        x0_, **kw)
        return lambda: cg_cuda_mb.fused_bicgstab_plain(
            diag, off, b_, x0_, ndims=3, plan=plan, **kw)

    monkeypatch.setattr(cg_cuda_mb, "merged_arm",
                        lambda *a, **k: cg_cuda_mb.MergedArm(1, 128, True))
    monkeypatch.setattr(cg_cuda_mb, "device_kind", lambda b_, what: "cuda")
    monkeypatch.setattr(cg_cuda_mb, "merged_launcher", launcher)
    kw = dict(tol=1e-6, maxiter=400, stall_iters=250, precondition=True,
              return_best=algo == "cg")
    if algo == "cg":
        f, counters = cg_cuda_mb.fused_cg_mb, ("launches", "launches_3d",
                                               "spread_launches")
    else:
        f, counters = cg_cuda_mb.fused_bicgstab_mb, (
            "merged_launches", "merged_launches_3d", "merged_spread_launches")
    before = [getattr(f, c) for c in counters]
    xs, info = f(tp, T(d), T(o), T(b), T(x0), **kw)
    assert [getattr(f, c) - v for c, v in zip(counters, before)] == [3, 3, 3]
    n = sum(int(np.prod(s_)) for s_ in coarse_strips.sb_array_shapes(tp))
    assert launched == [(algo, (1, n), 1, 1, 1, 1, 128)] * 3
    flat = lambda xs_: cg_cuda_mb.flatten_fields(tp, xs_)
    diag, off = cg_cuda_mb.flatten_ops(tp, T(d), T(o))
    pkw = dict(tol2_sum=cg_cuda.tol2_sum_f32(1e-6, n), maxiter=400,
               stall_iters=250, precondition=True, return_best=algo == "cg",
               chunk=1)
    if algo == "cg":
        xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(tp, diag, off, flat(T(b)),
                                                  flat(T(x0)), **pkw)
        assert torch.equal(info.iterations.to(ip.dtype), ip)
    else:
        xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(
            diag, off, flat(T(b)), flat(T(x0)), ndims=3, plan=tp, **pkw)
        assert int(info.iterations) == int(ip.max())
    assert torch.equal(flat(xs), xp)
    assert int(ip.min()) < int(ip.max()) or algo == "bicgstab"
