"""The spread arm of K1 and K2 over the trivial plan
(``fluidgym_tpu_torch.ops.cg_cuda``) on the host: the rule that picks G by
shape (the card's SM count and co-residency stubbed), ``pinned_spread``,
the shared memory a block takes (against ``csrc/krylov.cuh``), the blocks'
shares of a lane, a numpy emulation of the sum order that makes the arm
bit-equal to the chunk grid, the C entry points' signatures (against
``ops/_build.py``), the launchers' checks, and the wrappers' plain versions
on CPU tensors whatever the pin, against the JAX package's kernels in
interpret mode.  The kernels themselves run in
``tests/test_torch_kernels_cuda.py`` on the card.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidgym_tpu.ops import cg_pallas, cg_pallas_mb
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu.core.domain import DomainBuilder as JDomainBuilder
from fluidgym_tpu_torch.core import geometry
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.ops import _build, cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge
from torch_port_helpers import assert_rel, nonsym_stencil, spd_stencil

torch.set_num_threads(1)

CUDA = torch.device("cuda")  # a device name only: nothing runs on it here
H100_SMS = 132
T = cg_cuda.THREADS
RBC = (61, 96)                 # RBC2D-easy-v0's block: 5,856 cells
RBC_WIDE = (61, 192)           # RBC2D-wide-*: 11,712 cells
RBC3D = (64, 41, 64)           # RBC3D-easy-v0: 167,936 cells
RBC3D_WIDE = (128, 41, 128)    # RBC3D-wide-*: 671,744 cells
CSRC = Path(cg_cuda.__file__).resolve().parents[1] / "csrc"


@pytest.fixture
def h100(monkeypatch):
    """The card's SM count and co-residency (one 1024-thread block per SM)
    for the rules (no card here)."""
    monkeypatch.setattr(cg_cuda, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(cg_cuda, "spread_capacity",
                        lambda *a, **k: H100_SMS)


def _arm(lanes, shape, algo="cg", chunk=None, device=CUDA):
    n, nd = int(np.prod(shape)), len(shape)
    c = cg_cuda.default_chunk(lanes, device) if chunk is None else chunk
    return cg_cuda.roll_arm(lanes, n, nd, c, device, algo)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [RBC3D, RBC3D_WIDE])
@pytest.mark.parametrize("what,lanes,algo,G", [
    ("K1-3D pressure", 1, "cg", 128),
    ("K1-3D with a second right-hand side (phase 25)", 2, "cg", 64),
    ("K2-3D temperature", 1, "bicgstab", 128),
    ("K2-3D velocity (3 components)", 3, "bicgstab", 32),
])
def test_rbc3d_main_path_takes_the_spread_arm(h100, shape, what, lanes, algo, G):
    assert cg_cuda.default_chunk(lanes, CUDA) == 1, what
    assert _arm(lanes, shape, algo) == (False, G), what


def test_rbc2d_easy_stays_resident(h100):
    """The resident rule runs first: a lane it takes keeps it, pinned
    spread or not."""
    for lanes in (1, 2, 64):
        assert _arm(lanes, RBC) == (True, 0)
        with cg_cuda.pinned_spread(128):
            assert _arm(lanes, RBC) == (True, 0)


@pytest.mark.parametrize("shape", [RBC_WIDE])
@pytest.mark.parametrize("what,lanes,algo,G", [
    ("K1 pressure", 1, "cg", 32),
    ("K2 temperature", 1, "bicgstab", 32),
    ("K2 velocity (2 components)", 2, "bicgstab", 32),
])
def test_rbc2d_wide_takes_the_spread_arm(h100, shape, what, lanes, algo, G):
    """RBC2D-wide's (61, 192) lanes: 11,712 cells, 366 per block at G = 32,
    too few for G = 64 (183 < SPREAD_MIN_CELLS)."""
    assert _arm(lanes, shape, algo) == (False, G), what


@pytest.mark.parametrize("what,lanes,shape,chunk", [
    ("a small 3D lane: 4,096 cells < 256 x 32", 1, (16, 16, 16), None),
    ("RBC2D-wide batch of 64", 64, RBC_WIDE, None),
    ("forced chunk of 3", 3, RBC3D, 3),
    ("forced chunk of 2", 2, RBC3D_WIDE, 2),
    ("5 lanes x 32 blocks > 132", 5, RBC3D, None),
    ("batch 64 of velocity solves", 192, RBC3D, None),
])
def test_rule_keeps_the_chunk_grid(h100, what, lanes, shape, chunk):
    assert _arm(lanes, shape, chunk=chunk) == (False, 0), what


@pytest.mark.parametrize("shape", [RBC3D, RBC3D_WIDE, RBC_WIDE, (8, 8, 8)])
def test_rule_is_off_on_the_cpu(shape):
    n, nd = int(np.prod(shape)), len(shape)
    cpu = torch.device("cpu")
    assert cg_cuda.default_spread(1, n, nd, 1, cpu) == 0
    with cg_cuda.pinned_spread(128):
        assert cg_cuda.default_spread(1, n, nd, 1, cpu) == 0
        assert cg_cuda.roll_arm(1, n, nd, 1, "cpu") == (False, 0)


def test_rule_follows_co_residency(h100, monkeypatch):
    """G is the largest size whose grid the card holds: fewer co-resident
    blocks give smaller G, and under 32 per lane the chunk grid."""
    n = int(np.prod(RBC3D))
    for room, G in ((132, 128), (127, 64), (64, 64), (63, 32), (32, 32),
                    (31, 0)):
        monkeypatch.setattr(cg_cuda, "spread_capacity",
                            lambda *a, room=room, **k: room)
        assert cg_cuda.default_spread(1, n, 3, 1, CUDA) == G, room


def test_rule_keeps_a_quarter_cell_per_thread(h100):
    """At least SPREAD_MIN_CELLS cells per block: the largest such G."""
    m = cg_cuda.SPREAD_MIN_CELLS
    assert m == T // 4
    assert cg_cuda.default_spread(1, 128 * m, 3, 1, CUDA) == 128
    assert cg_cuda.default_spread(1, 128 * m - 1, 3, 1, CUDA) == 64
    assert cg_cuda.default_spread(1, 64 * m - 1, 3, 1, CUDA) == 32
    assert cg_cuda.default_spread(1, 32 * m - 1, 3, 1, CUDA) == 0


@pytest.mark.parametrize("n,G,ndims,chains", [
    (167_936, 128, 3, True),     # RBC3D-easy: 1.3 cells per thread
    (671_744, 128, 3, False),    # RBC3D-wide: 5.1 cells per thread
    (671_744, 64, 3, True), (671_744, 32, 3, True), (11_712, 32, 2, True),
    (4 * T * 128, 128, 3, False), (4 * T * 128 - 1, 128, 3, True),
    (4 * T * 128, 128, 2, True),  # the range layout is 3D only
])
def test_spread_layout_by_shape(n, G, ndims, chains):
    """The chains layout, but the range layout at G = 128 from 4 cells per
    thread of a 3D block (8-cell chain rows cost a big lane more than the
    range layout's second barrier); 2D lanes always the chains layout."""
    assert cg_cuda.SPREAD_RANGE_CELLS == 4
    assert cg_cuda.spread_chains(n, G, ndims) is chains


def test_pinned_spread_nests_and_restores(h100):
    n = int(np.prod(RBC3D))
    assert cg_cuda.default_spread(1, n, 3, 1, CUDA) == 128
    with cg_cuda.pinned_spread(0):
        assert cg_cuda.default_spread(1, n, 3, 1, CUDA) == 0
        with cg_cuda.pinned_spread(32):
            assert cg_cuda.default_spread(1, n, 3, 1, CUDA) == 32
            # a pin reaches a lane the rule leaves on the chunk grid
            assert cg_cuda.default_spread(1, 4_096, 3, 1, CUDA) == 32
            # chunk > 1 has no spread arm, pinned or not
            assert cg_cuda.default_spread(3, n, 3, 3, CUDA) == 0
            with cg_cuda.pinned_spread(None):
                assert cg_cuda.default_spread(1, n, 3, 1, CUDA) == 128
                assert cg_cuda.default_spread(1, 4_096, 3, 1, CUDA) == 0
            assert cg_cuda.default_spread(1, n, 3, 1, CUDA) == 32
        assert cg_cuda.default_spread(1, n, 3, 1, CUDA) == 0
    assert cg_cuda.default_spread(1, n, 3, 1, CUDA) == 128
    with pytest.raises(RuntimeError):
        with cg_cuda.pinned_spread(64):
            raise RuntimeError("inside")
    assert cg_cuda._PINNED_SPREAD is None
    for bad in (16, 1, 256, True):
        with pytest.raises(ValueError):
            with cg_cuda.pinned_spread(bad):
                pass


# ---------------------------------------------------------------------------
# shared memory and the blocks' shares of a lane
# ---------------------------------------------------------------------------

def _c_int_expr(src, name, args):
    """The return expression of ``name(args...)`` in ``krylov.cuh`` as a
    Python expression (integer division, casts dropped)."""
    body = re.search(name + r"\(" + args + r"\) \{\s*return (.*?);", src,
                     re.S).group(1)
    return (body.replace("(size_t)", "").replace("\n", " ")
            .replace("FG_THREADS", str(T)).replace("/", "//"))


def test_spread_bytes_is_the_krylov_formula():
    src = (CSRC / "krylov.cuh").read_text()
    assert int(re.search(r"#define FG_THREADS (\d+)", src).group(1)) == T
    chains = _c_int_expr(src, "fg_chain_floats", "int n, int C")
    spread = _c_int_expr(src, "fg_spread_bytes", "int n, int G")
    assert spread == "fg_chain_floats(n, G) * 4"
    for n in (167_936, 671_744, 11_712, 5_856, 1, 100_001):
        for G in cg_cuda.SPREAD_SIZES:
            floats = eval(chains, {}, {"n": n, "C": G})
            assert cg_cuda.spread_bytes(n, G) == 4 * floats, (n, G)
    assert "G == 32 || G == 64 || G == 128" in src
    assert cg_cuda.SPREAD_SIZES == (128, 64, 32)


def test_spread_bytes_of_the_main_path():
    # 2 floats x (1024 / G) chains x ceil(n / 1024) rows
    assert cg_cuda.spread_bytes(167_936, 128) == 2 * 8 * 164 * 4 == 10_496
    assert cg_cuda.spread_bytes(671_744, 128) == 2 * 8 * 656 * 4 == 41_984
    assert cg_cuda.spread_bytes(671_744, 32) == 2 * 32 * 656 * 4 == 167_936
    room = cg_cuda.SMEM_PER_BLOCK - cg_cuda.SMEM_STATIC
    for n in (167_936, 671_744):
        assert all(cg_cuda.spread_fits(n, G) for G in cg_cuda.SPREAD_SIZES)
    # a lane whose chain terms outgrow a block at G = 32 (~900k cells)
    assert not cg_cuda.spread_fits(room // 256 * T + T, 32)


@pytest.mark.parametrize("n", [167_936, 671_744, 11_712, 100_001,
                               341_568, 749_568])
@pytest.mark.parametrize("G", cg_cuda.SPREAD_SIZES)
def test_blocks_cover_the_lane_once(n, G):
    """Both layouts: the G blocks' cells are [0, n), each cell once (the
    RBC3D and RBC2D-wide lanes, and CylinderJet3D's merged lanes)."""
    seen = np.zeros(n, np.int64)
    for c0, c1 in cg_cuda.block_ranges(n, G):
        assert 0 <= c0 <= c1 <= n
        seen[c0:c1] += 1
    assert (seen == 1).all()
    seen[:] = 0
    for r in range(G):
        cells = cg_cuda.chain_cells(n, G, r)
        np.add.at(seen, cells, 1)
        # block r's cells are those of chains [r T/G, (r+1) T/G)
        assert ((cells % T) // (T // G) == r).all()
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# the sum order: the spread arm's chains rebuilt are the one-block form's
# ---------------------------------------------------------------------------

def _warp_sum(v):
    """``fg_warp_sum`` over the last axis (32 lanes): the xor butterfly."""
    idx = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., idx ^ o]).astype(np.float32)
    return v


def _block_tree(chains):
    """``fg_block_sum2`` of T per-thread values: warp sums, then lane 0 of
    each warp into shared memory, then one warp over those."""
    w = _warp_sum(chains.reshape(T // 32, 32))[:, 0]
    return _warp_sum(w.reshape(1, 32))[0, 0]


def _one_block(terms):
    """The one-block form: thread t adds the terms of cells t, t + T, ...
    in order (float32), then the tree."""
    n = terms.size
    acc = np.zeros(T, np.float32)
    for k in range(-(-n // T)):
        row = terms[k * T:(k + 1) * T]
        acc[:row.size] = (acc[:row.size] + row).astype(np.float32)
    return _block_tree(acc)


def _spread(terms, G, index):
    """The spread arm as ``fg_lane_sum2`` forms it: block r puts the terms
    of its chains at e (cell ``index(e, k, t0, per)``, zero past n) in its
    buffer, thread j < per adds e = j, j + per, ... while its cell is below
    n, the chains go to the lane's slot, and every block runs the tree."""
    n = terms.size
    per = T // G
    rows = -(-n // T)
    slot = np.zeros(T, np.float32)
    for r in range(G):
        t0 = r * per
        e = np.arange(per * rows)
        k = e // per
        c = index(e, k, t0, per)
        buf = np.where(c < n, terms[np.minimum(c, n - 1)], 0).astype(np.float32)
        for j in range(per):
            u = np.float32(0)
            for ee in range(j, per * rows, per):
                if t0 + j + (ee // per) * T >= n:
                    break
                u = np.float32(u + buf[ee])
            slot[t0 + j] = u
    return _block_tree(slot)


def _chain_index(e, k, t0, per):
    return k * T + t0 + (e - k * per)


@pytest.mark.parametrize("n", [167_936, 20_000, 3_000])
@pytest.mark.parametrize("G", cg_cuda.SPREAD_SIZES)
def test_spread_sum_is_the_one_block_sum(n, G):
    """Bit-equal in float32 for terms of mixed sign and scale, where the
    order of the additions decides the last bits; and ``chain_cells`` is
    the index arithmetic the emulation uses."""
    rng = np.random.default_rng(n + G)
    terms = (rng.normal(size=n) * 10.0 ** rng.uniform(-6, 3, size=n)
             ).astype(np.float32)
    want = _one_block(terms)
    assert _spread(terms, G, _chain_index).tobytes() == want.tobytes()
    for r in (0, G // 2, G - 1):
        e = np.arange((T // G) * -(-n // T))
        c = _chain_index(e, e // (T // G), r * (T // G), T // G)
        assert np.array_equal(cg_cuda.chain_cells(n, G, r), c[c < n])


def test_spread_sum_past_shared_memory_is_the_one_block_sum():
    """At Airfoil3D's 7,051,776 cells no G's chain terms fit a block's
    shared memory (440,768 B at G = 128), so the 3D merged forms keep them
    in global memory: the chains and their order are the same, so the sum
    is the one-block form's, bit for bit, at G = 128."""
    n, G = 7_051_776, 128
    assert not cg_cuda.spread_fits(n, G)
    rng = np.random.default_rng(n)
    terms = (rng.normal(size=n) * 10.0 ** rng.uniform(-6, 3, size=n)
             ).astype(np.float32)
    assert _spread(terms, G, _chain_index).tobytes() == _one_block(terms).tobytes()


def test_emulation_sees_a_wrong_sum_order():
    """The bars above have teeth: the same terms in another order (a row of
    a chain taken from the next chain) give other bits."""
    rng = np.random.default_rng(7)
    n = 167_936
    terms = (rng.normal(size=n) * 10.0 ** rng.uniform(-6, 3, size=n)
             ).astype(np.float32)
    wrong = lambda e, k, t0, per: k * T + t0 + ((e - k * per) + k) % per
    assert (_spread(terms, 128, wrong).tobytes()
            != _one_block(terms).tobytes())
    assert np.float32(terms.sum(dtype=np.float32)).tobytes() != \
        _one_block(terms).tobytes()


# ---------------------------------------------------------------------------
# the C entries and the launchers
# ---------------------------------------------------------------------------

def _c_params(source, entry):
    """``(type, name)`` of each parameter of an ``extern "C"`` entry."""
    src = (CSRC / source).read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                    re.S).group(1)
    return [(" ".join(p.split()[:-1]), p.split()[-1])
            for p in sig.replace("\n", " ").split(",")]


@pytest.mark.parametrize("source,entry", [
    ("cg.cu", "fg_cg_solve"), ("bicgstab_mb.cu", "fg_bicgstab_solve"),
    ("cg.cu", "fg_cg_spread_capacity"),
    ("bicgstab_mb.cu", "fg_bicgstab_spread_capacity")])
def test_entry_signature_matches_the_ctypes_argtypes(source, entry):
    """The loader's argtypes follow the C signature one for one (pointers
    and the stream as void*, int, float); the solves take the spread arm's
    buffers and its G and layout after ``resident``."""
    params = _c_params(source, entry)
    kinds = {"int": "c_int", "float": "c_float"}
    want = [kinds.get(t, "c_void_p") for t, _ in params]
    assert [t.__name__ for t in _build._ARGTYPES[entry]] == want
    names = [nm for _, nm in params]
    if "capacity" in entry:
        assert names == ["ndims", "spread", "chains", "n", "out"]
    else:
        i = names.index("resident")
        assert names[i - 2:i + 3] == ["lanes", "chunk", "resident", "spread",
                                      "chains"]
        assert names[i - 4:i - 2] == ["bar", "slot"]


def _system3d(L=1, seed=0, shape=(4, 6, 16)):
    diag, off = (torch.from_numpy(a) for a in spd_stencil(shape, 3, seed))
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.normal(size=(L,) + shape).astype(np.float32))
    return diag, off, b


@pytest.mark.parametrize("mod", [cg_cuda, cg_cuda_mb])
def test_launcher_checks_the_spread_arm(mod):
    """One lane per G blocks, G a spread size, not with the resident arm,
    the range layout in 3D only: refused before anything is built."""
    diag, off, b = _system3d(3)
    kw = dict(ndims=3, tol2_sum=1e-10, maxiter=10, stall_iters=5,
              precondition=True, return_best=True)
    with pytest.raises(ValueError, match="chunk 1"):
        mod.launcher(diag[None], off[None], b, None, chunk=3, spread=64, **kw)
    with pytest.raises(ValueError, match="spread must be"):
        mod.launcher(diag[None], off[None], b, None, chunk=1, spread=16, **kw)
    d2, o2, b2 = (torch.zeros((1,) + RBC), torch.zeros((1, 4) + RBC),
                  torch.zeros((1,) + RBC))
    with pytest.raises(ValueError, match="not both"):
        mod.launcher(d2, o2, b2, None, chunk=1, resident=True, spread=32,
                     **dict(kw, ndims=2))
    with pytest.raises(ValueError, match="3D only"):
        mod.launcher(d2, o2, b2, None, chunk=1, spread=32, chains=False,
                     **dict(kw, ndims=2))


def _jax_k1(diag, off, B, tol, kw):
    """The Pallas K1 over a lane batch (its vmap rule folds it onto lanes)."""
    one = lambda b: cg_pallas.fused_cg(jnp.asarray(diag), jnp.asarray(off), b,
                                       ndims=3, tol=tol, interpret=True, **kw)
    x, info = jax.vmap(one)(jnp.asarray(B))
    return np.asarray(x), np.asarray(info.iterations)


def _plans(shape):
    """The JAX and port trivial plans of one closed-y 3D block (Z, Y, X)."""
    out = []
    for Builder in (JDomainBuilder, DomainBuilder):
        dom = Builder(ndims=3, viscosity=0.01)
        blk = dom.create_block(geometry.make_uniform_grid(
            (shape[2], shape[1], shape[0]), (0, 0, 0), (1.0, 1.0, 1.0)))
        blk.close_boundary("-y")
        blk.close_boundary("+y")
        out.append(dom.build()[0])
    return jbm.trivial_plan(out[0]), block_merge.trivial_plan(out[1])


@pytest.mark.parametrize("G", [None, 0, 32, 128])
@pytest.mark.parametrize("shape", [(4, 6, 16), (4, 8, 128)])
def test_cpu_k1_runs_the_plain_version_whatever_the_pin(G, shape):
    """On CPU tensors the wrapper runs the plain version under any pin
    (no launch counted) and matches the Pallas K1 in interpret mode."""
    diag, off, B = _system3d(3, seed=len(shape) + shape[-1], shape=shape)
    B[1] *= 1e-3
    kw = dict(maxiter=400, stall_iters=250, precondition=True, return_best=True)
    f = cg_cuda.fused_cg
    before = (f.launches, f.spread_launches, cg_cuda.fused_cg_plain.calls)
    with cg_cuda.pinned_spread(G):
        x, info = f(diag, off, B, ndims=3, tol=1e-6, **kw)
    assert (f.launches, f.spread_launches) == before[:2]
    assert cg_cuda.fused_cg_plain.calls == before[2] + 1
    xj, ij = _jax_k1(diag.numpy(), off.numpy(), B.numpy(), 1e-6, kw)
    assert bool(info.converged.all())
    # the card's chunk here is 1 lane (default_chunk), the Pallas kernel's
    # one lockstep loop over the three: its shared count is the slowest's
    assert abs(int(info.iterations.max()) - int(ij.max())) <= 3
    for lane in range(3):
        assert_rel(x[lane].numpy(), xj[lane], 2e-4, f"lane {lane}")


@pytest.mark.parametrize("G", [None, 0, 32])
@pytest.mark.parametrize("C,warm", [(1, True), (3, False)])
def test_cpu_k2_runs_the_plain_version_whatever_the_pin(G, C, warm):
    """K2 over a 3D trivial plan (RBC3D's temperature, 1 lane, and velocity,
    3 lanes) on CPU tensors: the plain version under any pin, against the
    Pallas K2 in interpret mode."""
    shape = (6, 8, 16)
    jp, tp = _plans(shape)
    diag, off = nonsym_stencil(shape, 3, seed=40 + C)
    rng = np.random.default_rng(50 + C)
    b = rng.normal(size=(C,) + shape).astype(np.float32)
    x0 = (0.3 * b).astype(np.float32) if warm else None
    kw = dict(maxiter=400, stall_iters=250, precondition=True,
              return_best=False)
    f = cg_cuda_mb.fused_bicgstab_mb
    before = (f.launches, f.spread_launches,
              cg_cuda_mb.fused_bicgstab_plain.calls)
    with cg_cuda.pinned_spread(G):
        xt, it = f(tp, (torch.from_numpy(diag),), (torch.from_numpy(off),),
                   (torch.from_numpy(b),),
                   None if x0 is None else (torch.from_numpy(x0),), tol=1e-6,
                   **kw)
    assert (f.launches, f.spread_launches) == before[:2]
    assert cg_cuda_mb.fused_bicgstab_plain.calls == before[2] + 1
    xj, ij = cg_pallas_mb.fused_bicgstab_mb(
        jp, (jnp.asarray(diag),), (jnp.asarray(off),), (jnp.asarray(b),),
        None if x0 is None else (jnp.asarray(x0),), tol=1e-6, interpret=True,
        **kw)
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    assert_rel(xt[0].numpy(), np.asarray(xj[0]), 1e-4, f"C={C} warm={warm}")


# ---------------------------------------------------------------------------
# the channel's solves, and K2's roll form one lane per launch
# ---------------------------------------------------------------------------

TCF_SMALL = (64, 64, 64)       # TCFSmall3D-*: 262,144 cells
TCF_LARGE = (128, 64, 128)     # TCFLarge3D-*: 1,048,576 cells


def _roll_form(lanes, shape, chunk=None, device=CUDA):
    n, nd = int(np.prod(shape)), len(shape)
    c = cg_cuda.default_chunk(lanes, device) if chunk is None else chunk
    return cg_cuda_mb.roll_form_arm(lanes, n, nd, c, device)


@pytest.mark.parametrize("what,lanes,algo,G", [
    ("K1-3D pressure", 1, "cg", 128),
    ("K2-3D velocity (3 components)", 3, "bicgstab", 32),
])
def test_tcf_small_takes_the_spread_arm_at_once(h100, what, lanes, algo, G):
    """TCFSmall's (64, 64, 64) lanes fit as RBC3D's do: the pressure at G =
    128, the 3 velocity lanes together at G = 32, no launch per lane."""
    assert _arm(lanes, TCF_SMALL, algo) == (False, G), what
    if algo == "bicgstab":
        assert _roll_form(lanes, TCF_SMALL) == (False, G, False)


def test_tcf_large_velocity_goes_one_lane_per_launch(h100):
    """TCFLarge's 3 velocity lanes of 1,048,576 cells: a block's chain terms
    need 262,144 B at G = 32 (over its 224,256 B), and 3 lanes at G = 64 or
    128 need 192 or 384 co-resident blocks of the card's 132; so no G holds
    them at once, and the lanes go one per launch at G = 128, where a
    single lane has its 128 blocks.  The pressure lane takes G = 128 as
    before; ``pinned_spread(0)`` still pins the chunk grid and a pinned G is
    taken as given."""
    n = int(np.prod(TCF_LARGE))
    assert n == 1_048_576
    assert cg_cuda.spread_bytes(n, 32) == 262_144
    assert not cg_cuda.spread_fits(n, 32)
    assert cg_cuda.spread_fits(n, 64) and cg_cuda.spread_fits(n, 128)
    assert _arm(3, TCF_LARGE, "bicgstab") == (False, 0)
    assert cg_cuda.split_spread(3, n, 3, 1, CUDA, "bicgstab") == 128
    assert _roll_form(3, TCF_LARGE) == (False, 128, True)
    assert _arm(1, TCF_LARGE, "cg") == (False, 128)
    assert _roll_form(1, TCF_LARGE) == (False, 128, False)
    with cg_cuda.pinned_spread(0):
        assert _roll_form(3, TCF_LARGE) == (False, 0, False)
        assert cg_cuda.split_spread(3, n, 3, 1, CUDA, "bicgstab") == 0
    with cg_cuda.pinned_spread(128):
        assert _roll_form(3, TCF_LARGE) == (False, 128, False)
    # 17 lanes would leave each fewer than SPLIT_BLOCKS_PER_LANE blocks; a
    # chunk of several lanes, and the CPU, keep the chunk grid
    assert cg_cuda.SPLIT_BLOCKS_PER_LANE == 8
    assert _roll_form(16, TCF_LARGE) == (False, 128, True)
    assert _roll_form(17, TCF_LARGE) == (False, 0, False)
    assert _roll_form(3, TCF_LARGE, chunk=3) == (False, 0, False)
    assert _roll_form(3, TCF_LARGE, device="cpu") == (False, 0, False)


@pytest.mark.parametrize("shape,lanes,want", [
    (RBC3D, 1, (False, 128, False)), (RBC3D, 3, (False, 32, False)),
    (RBC3D_WIDE, 1, (False, 128, False)), (RBC3D_WIDE, 3, (False, 32, False)),
    (RBC_WIDE, 2, (False, 32, False)), (RBC, 2, (True, 0, False)),
    (RBC3D, 5, (False, 128, True)), (RBC3D, 192, (False, 0, False)),
])
def test_roll_form_keeps_the_rbc_answers(h100, shape, lanes, want):
    """RBC3D (K2 at G = 32 for its velocity), RBC3D-wide, RBC2D-wide and
    RBC2D-easy (resident) keep their answers.  5 lanes of RBC3D, which no G
    holds at once, go one per launch at G = 128 (5 x 8 <= 128 blocks); a
    batch of 64 velocity solves keeps the chunk grid."""
    assert _roll_form(lanes, shape) == want


@pytest.mark.parametrize("warm", [False, True])
def test_roll_form_per_lane_launches_are_the_chunk_grids_lanes(monkeypatch, warm):
    """The wrapper's one-lane-per-launch path of K2 over the trivial plan on
    the host, with the card's pieces stubbed: ``roll_form_arm`` answers
    ``(False, 128, True)``, the tensors count as the card's, and each
    launch runs the plain version of the lane it is given.  The wrapper
    must launch each lane alone at G = 128 (the operator shared), in order,
    count every launch as K2-3D on the spread arm, and return what the
    plain version returns for the lanes in chunks of one, bit for bit."""
    shape = (8, 6, 8)
    d, o = nonsym_stencil(shape, 3, seed=90)
    rng = np.random.default_rng(91)
    b = rng.normal(size=(3,) + shape).astype(np.float32)
    b[1] *= 1e-3
    x0 = (0.3 * b).astype(np.float32) if warm else None
    launched = []

    def launcher(diag, off, b_, x0_, *, ndims, tol2_sum, maxiter, stall_iters,
                 precondition, return_best, chunk, resident=False, spread=0,
                 chains=None):
        launched.append((tuple(b_.shape), diag.shape[0], off.shape[0], chunk,
                         resident, spread, x0_ is None))
        return lambda: cg_cuda_mb.fused_bicgstab_plain(
            diag, off, b_, x0_, ndims=ndims, tol2_sum=tol2_sum, maxiter=maxiter,
            stall_iters=stall_iters, precondition=precondition,
            return_best=return_best, chunk=1)

    monkeypatch.setattr(cg_cuda_mb, "roll_form_arm",
                        lambda *a, **k: (False, 128, True))
    monkeypatch.setattr(cg_cuda_mb, "device_kind", lambda b_, what: "cuda")
    monkeypatch.setattr(cg_cuda_mb, "launcher", launcher)
    f = cg_cuda_mb.fused_bicgstab_mb
    counters = ("launches", "launches_3d", "spread_launches", "resident_launches")
    before = [getattr(f, c) for c in counters]
    T = torch.from_numpy
    plan = block_merge.trivial_plan(_single_block_topo(shape))
    kw = dict(maxiter=400, stall_iters=250, precondition=True, return_best=False)
    xs, info = f(plan, (T(d),), (T(o),), (T(b),),
                 None if x0 is None else (T(x0),), tol=1e-6, **kw)
    assert [getattr(f, c) - v for c, v in zip(counters, before)] == [3, 3, 3, 0]
    assert launched == [((1,) + shape, 1, 1, 1, False, 128, not warm)] * 3
    xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(
        T(d)[None], T(o)[None], T(b), None if x0 is None else T(x0), ndims=3,
        tol2_sum=cg_cuda.tol2_sum_f32(1e-6, int(np.prod(shape))), chunk=1, **kw)
    assert torch.equal(xs[0], xp)
    assert int(info.iterations) == int(ip.max())
    assert bool(info.converged) == bool((rp <= cg_cuda.tol2_sum_f32(
        1e-6, int(np.prod(shape)))).all())


def _single_block_topo(shape):
    """The topology of one periodic 3D block of ``shape`` (z, y, x)."""
    nz, ny, nx = shape
    grid = geometry.extrude_grid_z(
        geometry.make_uniform_grid((nx, ny), (0.0, 0.0), (1.0, 1.0)), nz)
    dom = DomainBuilder(ndims=3, viscosity=0.01)
    dom.create_block(grid)
    return dom.build()[0]
