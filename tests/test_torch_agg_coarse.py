"""The aggregation coarse space of the pressure solve (``solver/piso.py``
``build_agg_coarse``, ``agg_coarse_fn``; K3-agg's plain version in
``ops/cg_cuda_mb.py``) against the JAX package.

Twins of ``tests/test_coarse_agg.py`` on the same small multi-block system
(CylinderJet2D at resolution 12, tile 4), in float64 where they compare
with the JAX package: both packages hold one state (the port's after
``reset``, handed over as numpy) and the JAX side builds its
process-global Galerkin cache from it with ``force=True`` (an env of an
earlier test with the same operator key would otherwise hand it another
state's E).  Then the airfoil's space (k = 1,194 tiles on 73,456 cells)
and K3-agg's plain version against ``linsolve.cg`` with the two-level
preconditioner at the Krylov bar, and the env's reuse of its data.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.solver import linsolve as jlinsolve
from fluidgym_tpu.solver import piso as jpiso
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.envs.fluid_env import env_state_to_numpy
from fluidgym_tpu_torch.ops import cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge, linsolve, piso
from fluidgym_tpu_torch.solver import stencil as st
from torch_port_helpers import assert_rel, jax_domain_state

torch.set_num_threads(1)
TILE = 4
CYL = dict(resolution=12, load_initial_domain=False,
           load_domain_statistics=False, randomize_initial_state=False,
           episode_length=5)
AIRFOIL = dict(randomize_initial_state=False, load_domain_statistics=False,
               episode_length=5, step_length=0.05, dt=0.05)


def _tile_cfg(cfg):
    return replace(cfg, pressure_coarse_tile=TILE,
                   pressure_coarse_precondition=True)


def _both(env_id, kw, tile_cfg=None):
    """The port's env (float64, after ``reset(seed=0)``), its aggregation
    data, and the JAX package's topo / geoms / state / config of the same
    env and state with the Galerkin cache built from that state."""
    t = fluidgym_tpu_torch.make(env_id, device="cpu", dtype=torch.float64, **kw)
    t.reset(seed=0)
    tcfg = tile_cfg(t._cfg) if tile_cfg else t._cfg
    agg = piso.build_agg_coarse(t._state, t._geoms, t._topo, tcfg)
    host = env_state_to_numpy(t.get_state()).domain
    with jax.enable_x64(True):
        j = fluidgym_tpu.make(env_id, dtype=jnp.float64, **kw)
        # the JAX env's topo and geoms as its reset builds them
        if kw.get("load_initial_domain", True):
            from fluidgym_tpu.types import EnvMode

            jtopo, jgeoms, _ = j._load_initial_domain(EnvMode.TRAIN, 0)
        else:
            jtopo, jgeoms, _ = j._get_domain()
        jstate = jax_domain_state(host, np.float64)
        jcfg = tile_cfg(j._get_simulation()) if tile_cfg else j._get_simulation()
        jpiso.ensure_agg_coarse_cache(jstate, jgeoms, jtopo, jcfg, force=True)
    return dict(t=t, tcfg=tcfg, agg=agg, jtopo=jtopo, jgeoms=jgeoms,
                jstate=jstate, jcfg=jcfg)


@pytest.fixture(scope="module")
def cyl():
    return _both("CylinderJet2D-easy-v0", CYL, _tile_cfg)


@pytest.fixture(scope="module")
def airfoil():
    return _both("Airfoil2D-medium-v0", AIRFOIL)


def _rand_fields(specs, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s[0]).astype(dtype) for s in specs]


def test_tile_specs_match_jax(cyl):
    assert piso._agg_tile_specs(cyl["t"]._topo, TILE) == jpiso._agg_tile_specs(
        cyl["jtopo"], TILE)


def test_restrict_prolong_adjoint_and_match_jax(cyl):
    """Twin of test_coarse_agg.py:40 (``W^T`` is the adjoint of ``W``), and
    both against the JAX package on the same numpy inputs."""
    specs, k = piso._agg_tile_specs(cyl["t"]._topo, TILE)
    r = _rand_fields(specs, 0)
    c = np.random.default_rng(1).standard_normal(k)
    tr = piso._agg_restrict(tuple(torch.from_numpy(x) for x in r), specs, TILE)
    tp = piso._agg_prolong(torch.from_numpy(c), specs, TILE)
    lhs = float(torch.dot(tr, torch.from_numpy(c)))
    rhs = float(sum(torch.sum(torch.from_numpy(a) * b) for a, b in zip(r, tp)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs), "W^T must be the adjoint of W"
    with jax.enable_x64(True):
        jr = jpiso._agg_restrict(tuple(jnp.asarray(x) for x in r), specs, TILE)
        jp = jpiso._agg_prolong(jnp.asarray(c), specs, TILE)
    assert_rel(tr.numpy(), np.asarray(jr), 1e-6, "restrict")
    for a, b in zip(tp, jp):
        assert_rel(a.numpy(), np.asarray(b), 1e-6, "prolong")


def test_restriction_partitions_cells(cyl):
    """Twin of test_coarse_agg.py:53: restricting a constant-1 field gives
    the tile cell counts, which sum to the cell count."""
    specs, k = piso._agg_tile_specs(cyl["t"]._topo, TILE)
    ones = tuple(torch.ones(s[0], dtype=torch.float64) for s in specs)
    counts = piso._agg_restrict(ones, specs, TILE).numpy()
    assert counts.shape == (k,)
    assert counts.min() >= 1.0
    assert int(counts.sum()) == sum(int(np.prod(s[0])) for s in specs)


def test_coarse_matches_jax(cyl):
    """``W einv W^T r`` (the port folds d into einv in float64) against the
    JAX package's ``d * (E_n^+ (d * W^T r))`` from the same state."""
    agg, t = cyl["agg"], cyl["t"]
    r = _rand_fields(agg.specs, 2)
    got = piso.agg_coarse_fn(agg)(tuple(torch.from_numpy(x) for x in r))
    with jax.enable_x64(True):
        coarse = jpiso._agg_coarse_from_cache(cyl["jtopo"], cyl["jcfg"])
        want = coarse(tuple(jnp.asarray(x) for x in r))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6 * scale
    assert agg.space.K == jpiso._agg_tile_specs(t._topo, TILE)[1]


def test_agg_coarse_cuts_iterations_and_matches_solution(cyl):
    """Twin of test_coarse_agg.py:65 on the port: the two-level
    preconditioner cuts plain-loop PCG iterations below a quarter of
    Jacobi's and finds the same solution."""
    t, agg = cyl["t"], cyl["agg"]
    p_ops = piso.build_pressure_ops_like_substep(t._state, t._geoms, t._topo,
                                                 cyl["tcfg"])
    rng = np.random.default_rng(1)
    b = [rng.standard_normal(tuple(o.diag.shape)) for o in p_ops]
    mean = sum(x.sum() for x in b) / sum(x.size for x in b)
    b = tuple(torch.from_numpy(x - mean) for x in b)

    def mv(xs):
        return st.domain_apply(p_ops, xs, t._topo)

    inv_d = tuple(1.0 / o.diag for o in p_ops)
    coarse = piso.agg_coarse_fn(agg)

    def jac(rs):
        return tuple(d * r for d, r in zip(inv_d, rs))

    def two_level(rs):
        return tuple(d * r + c for d, r, c in zip(inv_d, rs, coarse(rs)))

    x1, i1 = linsolve.cg(mv, b, tol=1e-5, precond=jac, stall_iters=500,
                         maxiter=4000)
    x2, i2 = linsolve.cg(mv, b, tol=1e-5, precond=two_level, stall_iters=500,
                         maxiter=4000)
    assert bool(i2.converged)
    assert int(i2.iterations) < 0.25 * int(i1.iterations), (
        int(i2.iterations), int(i1.iterations))
    d1 = [a.numpy() - a.numpy().mean() for a in x1]
    d2 = [a.numpy() - a.numpy().mean() for a in x2]
    num = max(float(np.abs(a - c).max()) for a, c in zip(d1, d2))
    den = max(float(np.abs(a).max()) for a in d1)
    assert num / den < 5e-3


def test_stale_data_is_rebuilt_or_refused(cyl):
    """Twin of test_coarse_agg.py:105: the data is keyed by every static
    field of the operator.  Where the JAX package misses its cache and
    falls back to the constant + linear space, the port rebuilds
    (``ensure_agg_coarse``) or, handed another operator's data, raises."""
    t, agg, cfg = cyl["t"], cyl["agg"], cyl["tcfg"]
    assert piso.ensure_agg_coarse(agg, t._state, t._geoms, t._topo, cfg) is agg
    for other in (replace(cfg, pressure_coarse_tile=TILE + 1),
                  replace(cfg, dt=cfg.dt * 0.5)):
        assert piso._agg_key(t._topo, other) != agg.key
        with pytest.raises(ValueError, match="aggregation data"):
            piso._agg_for(replace(other, pressure_agg=agg), t._topo)
    new = piso.ensure_agg_coarse(agg, t._state, t._geoms, t._topo,
                                 replace(cfg, pressure_coarse_tile=TILE + 1))
    assert new is not agg and new.tile == TILE + 1
    with pytest.raises(ValueError, match="aggregation data"):
        piso._agg_for(cfg, t._topo)  # asks for tiles, holds no data


def test_rebuild_on_viscosity_change(cyl):
    """Twin of test_coarse_agg.py:115: a viscosity more than 1e-6 relative
    away rebuilds, one within it reuses (as the JAX package's cache)."""
    t, agg, cfg = cyl["t"], cyl["agg"], cyl["tcfg"]
    nu0 = t._state.viscosity
    near = replace(t._state, viscosity=nu0 * (1 + 1e-7))
    assert piso.ensure_agg_coarse(agg, near, t._geoms, t._topo, cfg) is agg
    far = replace(t._state, viscosity=nu0 * 2.0)
    new = piso.ensure_agg_coarse(agg, far, t._geoms, t._topo, cfg)
    assert new is not agg
    assert abs(new.nu - float(nu0) * 2.0) <= 1e-12
    assert not torch.equal(new.space.einv, agg.space.einv)
    fresh = piso.build_agg_coarse(t._state, t._geoms, t._topo, cfg)
    assert fresh is not agg and torch.equal(fresh.space.einv, agg.space.einv)


def test_env_step_with_agg_coarse_matches_plain():
    """Twin of test_coarse_agg.py:130: one env step with the two-level
    preconditioner (and the tile space in the deflation guess) reproduces
    the plain-Jacobi step's reward."""
    kw = dict(CYL, step_length=0.02, dt=0.01)
    a = np.array([0.4], np.float32)
    env = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu", **kw)
    env.reset(seed=3)
    _, r_plain, *_ = env.step(a)
    env2 = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu", **kw)
    env2.reset(seed=3)
    env2._cfg = _tile_cfg(env2._cfg)
    env2._ensure_agg_coarse()
    assert env2._cfg.pressure_agg is not None
    calls = cg_cuda_mb.fused_cg_mb_plain.calls
    _, r_agg, *_ = env2.step(a)
    assert cg_cuda_mb.fused_cg_mb_plain.calls > calls
    assert np.isfinite(float(r_agg))
    assert abs(float(r_agg) - float(r_plain)) <= 5e-3 * max(1.0, abs(float(r_plain)))


def test_airfoil_space_covers_every_cell_once(airfoil):
    """k = 1,194 tiles of 8 x 8 over the 6 blocks; in the merged frame
    (the wake cut a flip seam) the tiles' runs of cells hold every one of
    the 73,456 cells once, each under its own tile, at most 64 to a tile
    and at most 8 runs to a tile, ascending within a tile."""
    agg, t = airfoil["agg"], airfoil["t"]
    assert agg.tile == 8 and agg.space.K == 1194
    sp = agg.space
    n = sum(int(np.prod(b.shape)) for b in t._topo.blocks)
    assert n == 73456 and sp.K == 1194 and sp.cidx.numel() == n
    assert sp.runs.shape[1] <= 8
    lists = _tile_cells(sp)
    cells = torch.from_numpy(np.concatenate(lists)).long()
    sizes = torch.tensor([len(c) for c in lists])
    cidx = sp.cidx.long()
    assert torch.equal(torch.sort(cells).values, torch.arange(n))
    assert int(sizes.min()) >= 1 and int(sizes.max()) <= 64
    owner = torch.repeat_interleave(torch.arange(sp.K), sizes)
    assert torch.equal(cidx[cells], owner)
    for seg in lists:  # ascending within a tile
        assert bool((seg[1:] > seg[:-1]).all())
    # the packed tile ids are the blocks' tile ids moved into the frame
    back = block_merge.unpack_fields(agg.plan, tuple(
        x[0] for x in cg_cuda_mb.unflatten_fields(agg.plan, cidx[None])))
    for a, b in zip(back, agg.tile_ids):
        assert torch.equal(a.long(), b)


def _tile_cells(sp) -> list:
    """Each tile's cells as the kernel finds them from its runs: position i
    is in the first run whose end is past i, its cell i + (cell -
    position) of that run."""
    runs = sp.runs.cpu().numpy().astype(np.int64)
    out = []
    for k in range(sp.K):
        end, d = runs[k, :, 0], runs[k, :, 1]
        i = np.arange(end[-1])
        j = np.searchsorted(end, i, side="right")
        out.append(i + d[j])
    return out


@pytest.mark.parametrize("case", ["cyl", "airfoil"])
def test_plain_k3_agg_matches_jax_cg(case, cyl, airfoil):
    """K3-agg's plain version (``fused_cg_mb(..., agg=)`` on CPU tensors)
    against the JAX package's ``linsolve.cg`` with the two-level
    preconditioner on the same float64 pressure operator and RHS: both
    converge, the iterations agree within 3, the solutions within what the
    tolerance allows."""
    sy = {"cyl": cyl, "airfoil": airfoil}[case]
    t, agg = sy["t"], sy["agg"]
    p_ops = piso.build_pressure_ops_like_substep(t._state, t._geoms, t._topo,
                                                 sy["tcfg"])
    rng = np.random.default_rng(5)
    b = [rng.standard_normal(tuple(o.diag.shape)) for o in p_ops]
    mean = sum(x.sum() for x in b) / sum(x.size for x in b)
    b = [x - mean for x in b]
    tol = 1e-7
    plan = agg.plan
    mops = block_merge.pack_ops(plan, p_ops)
    calls = cg_cuda_mb.fused_cg_mb_plain.calls
    xs, inf = cg_cuda_mb.fused_cg_mb(
        plan, tuple(m[0] for m in mops), tuple(m[1] for m in mops),
        block_merge.pack_fields(plan, tuple(torch.from_numpy(x) for x in b)),
        tol=tol, agg=agg.space)
    assert cg_cuda_mb.fused_cg_mb_plain.calls == calls + 1
    tx = block_merge.unpack_fields(plan, xs)
    with jax.enable_x64(True):
        jtopo = sy["jtopo"]
        jops = jpiso.build_pressure_ops_like_substep(sy["jstate"], sy["jgeoms"],
                                                     jtopo, sy["jcfg"])
        coarse = jpiso._agg_coarse_from_cache(jtopo, sy["jcfg"])
        inv_d = tuple(1.0 / o.diag for o in jops)

        def two_level(rs):
            return tuple(d * r + c for d, r, c in zip(inv_d, rs, coarse(rs)))

        jx, jinf = jlinsolve.cg(lambda v: jst.domain_apply(jops, v, jtopo),
                                tuple(jnp.asarray(x) for x in b), tol=tol,
                                precond=two_level)
    assert bool(inf.converged) and bool(jinf.converged)
    assert abs(int(inf.iterations) - int(jinf.iterations)) <= 3, (
        int(inf.iterations), int(jinf.iterations))
    # both residuals <= tol * sqrt(n): solutions within the error that leaves
    scale = max(float(np.abs(np.asarray(x)).max()) for x in jx)
    for a, c in zip(tx, jx):
        assert np.abs(a.numpy() - np.asarray(c)).max() <= 1e-4 * scale


def test_env_keeps_its_data_across_resets(airfoil):
    """The env builds the space at reset and in ``load_initial_domain``,
    reuses it across resets, rebuilds when the viscosity moves."""
    from fluidgym_tpu_torch.types import EnvMode

    env = fluidgym_tpu_torch.make("Airfoil2D-medium-v0", device="cpu",
                                  **AIRFOIL)
    env.load_initial_domain(EnvMode.TRAIN, 0)
    first = env._cfg.pressure_agg
    assert first is not None and first.space.K == 1194
    env.reset(seed=0)
    assert env._cfg.pressure_agg is first
    env.reset(seed=1)
    assert env._cfg.pressure_agg is first
    env._state = replace(env._state, viscosity=env._state.viscosity * 1.5)
    env._ensure_agg_coarse()
    assert env._cfg.pressure_agg is not first
    assert env._cfg.pressure_agg.nu == pytest.approx(first.nu * 1.5)


# ---------------------------------------------------------------------------
# K3-agg's dispatch: the cluster rule over its own instance, its entries
# ---------------------------------------------------------------------------

CUDA = torch.device("cuda")
AIRFOIL_N = 73_456
#: the H100's answer for the airfoil's K3-agg-flip instance (measured:
#: 7 clusters of 16)
H100_AGG = {16: 7, 8: 15, 4: 30, 2: 60}


@pytest.fixture
def agg_occupancy(monkeypatch):
    """Stub the occupancy query; record its coarse instance's questions."""
    asked = []

    def occupancy(algo, ndims, C, n, device, coarse_k=0):
        if algo == "cg_coarse":
            asked.append((ndims, C, n, coarse_k))
        return H100_AGG[C]

    monkeypatch.setattr(cg_cuda_mb, "max_active_clusters", occupancy)
    return asked


@pytest.mark.parametrize("lanes,n,K,expected", [
    (1, AIRFOIL_N, 1194, (16, 0, False)),   # 223,296 B at C = 16: fits
    (1, AIRFOIL_N, 2048, (16, 0, False)),   # 223,232 B: the cap still fits
    (1, AIRFOIL_N, 2700, (1, 0, False)),    # over the shared memory at C = 16
    (8, AIRFOIL_N, 1194, (1, 0, False)),    # 8 clusters of 16: the card holds 7
    (64, 14_232, 228, (1, 0, False)),
    (1, 14_232, 228, (8, 0, False)),        # C = 16 would leave < 1024 cells
])
def test_agg_rule_on_the_main_path_shapes(agg_occupancy, lanes, n, K, expected):
    arm = cg_cuda_mb.merged_arm(lanes, n, 2, 1, CUDA, "cg_coarse", K)
    assert arm == expected
    if arm.cluster > 1:
        assert cg_cuda_mb.rows_fit(n, arm.cluster, 2, K)
        assert agg_occupancy and all(q[3] == K for q in agg_occupancy)
    # the rows, two coarse vectors of K rounded up to 4 floats, then the
    # chain terms with the ring's rows of Einv over them
    kp = cg_cuda_mb.agg_kp(K)
    rows = cg_cuda_mb.stage_bytes(n, 16, 2) // 4 - 2 * 64 * -(-n // 1024)
    ring = cg_cuda_mb.agg_ring_stages(n, 16, K) * kp
    assert ring >= kp
    assert (cg_cuda_mb.stage_bytes(n, 16, 2, K)
            == 4 * (rows + 2 * kp + max(2 * 64 * -(-n // 1024), ring)))


def test_agg_rule_off_the_card_chunks_and_3d(agg_occupancy):
    def arm(lanes, n, nd, chunk, dev):
        return cg_cuda_mb.merged_arm(lanes, n, nd, chunk, dev, "cg_coarse", 1194)

    assert arm(1, AIRFOIL_N, 2, 1, "cpu") == (1, 0, False)
    assert arm(1, AIRFOIL_N, 2, 2, CUDA) == (1, 0, False)
    assert arm(1, 341_568, 3, 1, CUDA) == (1, 0, False)
    assert not agg_occupancy
    with cg_cuda_mb.pinned_cluster(1):
        assert arm(1, AIRFOIL_N, 2, 1, CUDA) == (1, 0, False)


@pytest.mark.parametrize("K", [0, 1194])
def test_max_active_clusters_hands_k_to_the_coarse_entry(monkeypatch, K):
    """One occupancy entry serves both coarse instances: K3-coarse's strips
    ask with K = 0, K3-agg with its tile count, its rows' padded length and
    its ring's rows."""
    import contextlib
    import ctypes
    from types import SimpleNamespace

    from fluidgym_tpu_torch.ops import _build

    asked = []

    def occupancy(ndims, C, n, K_, kp, stages, out):
        asked.append((ndims, C, n, K_, kp, stages))
        ctypes.c_int.from_address(out).value = 7
        return 0

    lib = SimpleNamespace(fg_cg_mb_coarse_cluster_occupancy=occupancy)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    cg_cuda_mb.max_active_clusters.cache_clear()
    try:
        assert cg_cuda_mb.max_active_clusters("cg_coarse", 2, 16, AIRFOIL_N,
                                              CUDA, K) == 7
    finally:
        cg_cuda_mb.max_active_clusters.cache_clear()
    ring = (0, 0) if K == 0 else (1196, cg_cuda_mb.agg_ring_stages(
        AIRFOIL_N, 16, K))
    assert asked == [(2, 16, AIRFOIL_N, K, *ring)]


def _c_params(entry):
    """``(type, name)`` of each parameter of an ``extern "C"`` entry of
    ``csrc/cg.cu``."""
    import re
    from pathlib import Path

    src = (Path(cg_cuda_mb.__file__).resolve().parents[1] / "csrc" / "cg.cu")
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{",
                    src.read_text(), re.S).group(1)
    return [(" ".join(p.split()[:-1]), p.split()[-1])
            for p in sig.replace("\n", " ").split(",")]


@pytest.mark.parametrize("entry", ["fg_cg_mb_agg_solve",
                                   "fg_cg_mb_coarse_cluster_occupancy"])
def test_agg_entry_signature_matches_the_ctypes_argtypes(entry):
    """The loader's argtypes follow the C signature one for one; the solve
    takes the coarse solve's order with the tiles' runs and each cell's
    tile after Einv, the padded row length, the runs per tile and the
    ring's rows after K; the coarse forms' occupancy query K, the padded
    row length and the ring's rows after n (K = 0: the strips)."""
    from fluidgym_tpu_torch.ops import _build

    params = _c_params(entry)
    kinds = {"int": "c_int", "float": "c_float"}
    assert ([t.__name__ for t in _build._ARGTYPES[entry]]
            == [kinds.get(t, "c_void_p") for t, _ in params])
    names = [nm for _, nm in params]
    if "occupancy" in entry:
        assert names == ["ndims", "cluster", "n", "K", "kp", "stages", "out"]
    else:
        assert names == [nm for _, nm in _c_params("fg_cg_mb_coarse_solve")][:12] \
            + ["einv", "runs", "cidx"] + names[15:]
        i = names.index("cluster")
        assert names[i - 2:i + 9] == ["lanes", "chunk", "cluster", "n",
                                      "ndims", "op_per_lane", "K", "kp",
                                      "nruns", "stages", "tol2"]


def test_agg_cap_matches_the_kernel():
    """``AGG_MAX_K`` is ``FG_MAX_AGG_K`` of ``csrc/cg.cu``."""
    import re
    from pathlib import Path

    src = (Path(cg_cuda_mb.__file__).resolve().parents[1] / "csrc"
           / "cg.cu").read_text()
    assert int(re.search(r"#define FG_MAX_AGG_K (\d+)", src).group(1)) \
        == cg_cuda_mb.AGG_MAX_K == 2048


def test_one_coarse_space_per_solve(cyl):
    """The strips and the aggregation tiles are not taken together."""
    agg = cyl["agg"]
    plan = agg.plan
    t = cyl["t"]
    p_ops = piso.build_pressure_ops_like_substep(t._state, t._geoms, t._topo,
                                                 cyl["tcfg"])
    mops = block_merge.pack_ops(plan, p_ops)
    bs = block_merge.pack_fields(plan, tuple(torch.ones_like(o.diag)
                                             for o in p_ops))
    with pytest.raises(ValueError, match="one coarse space"):
        cg_cuda_mb.fused_cg_mb(plan, tuple(m[0] for m in mops),
                               tuple(m[1] for m in mops), bs, tol=1e-6,
                               coarse_strips=True, agg=agg.space)
