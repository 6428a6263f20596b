"""The resident arm of K1 and K2 over the trivial plan
(``fluidgym_tpu_torch.ops.cg_cuda``) on the host: the rule that picks it
by shape, the shared memory it stages (against ``csrc/krylov.cuh``), the
C entry points' signatures (against ``ops/_build.py``), the launchers'
checks, ``pinned_resident``, and the wrappers' plain versions on CPU
tensors whatever the pin.  The kernels themselves run in
``tests/test_torch_kernels_cuda.py`` on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidgym_tpu_torch.core import geometry
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.ops import _build, cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge
from torch_port_helpers import nonsym_stencil, spd_stencil

torch.set_num_threads(1)

CUDA = torch.device("cuda")  # a device name only: nothing runs on it here
H100_SMS = 132
RBC = (61, 96)             # RBC2D-easy-v0's block: 5,856 cells
RBC_WIDE = (61, 192)       # RBC2D-wide-*: 11,712 cells
RBC3D = (64, 41, 64)       # RBC3D-easy-v0's block (nz, ny, nx)
CSRC = Path(cg_cuda.__file__).resolve().parents[1] / "csrc"


@pytest.fixture
def h100(monkeypatch):
    """The card's SM count for ``default_chunk`` (no card here)."""
    monkeypatch.setattr(cg_cuda, "_sm_count", lambda device: H100_SMS)


def _rule(lanes, shape, chunk=None):
    n, nd = int(np.prod(shape)), len(shape)
    c = cg_cuda.default_chunk(lanes, CUDA) if chunk is None else chunk
    return cg_cuda.default_resident(lanes, n, nd, c, CUDA)


@pytest.mark.parametrize("what,lanes", [
    ("K1 pressure, K2 temperature", 1),
    ("K2 velocity (2 components)", 2),
    ("batch 64: K1", 64),
    ("batch 64: K2 velocity", 128),
    ("130 lanes", 130),
    ("one lane per SM", H100_SMS),
])
def test_rbc_main_path_takes_the_resident_arm(h100, what, lanes):
    assert cg_cuda.default_chunk(lanes, CUDA) == 1, what
    assert _rule(lanes, RBC), what


@pytest.mark.parametrize("what,lanes,shape,chunk", [
    ("RBC2D-wide lane", 1, RBC_WIDE, None),
    ("RBC2D-wide batch", 64, RBC_WIDE, None),
    ("RBC3D lane", 1, RBC3D, None),
    ("a small 3D lane", 1, (16, 16, 16), None),
    ("more lanes than SMs: chunk 2", H100_SMS + 1, RBC, None),
    ("batch 256: chunk 2", 256, RBC, None),
    ("forced chunk", 4, RBC, 4),
    ("forced chunk of 33", 130, RBC, 33),
])
def test_rule_keeps_the_chunk_grid(h100, what, lanes, shape, chunk):
    assert not _rule(lanes, shape, chunk), what


@pytest.mark.parametrize("shape", [RBC, RBC_WIDE, RBC3D, (8, 8)])
def test_rule_is_off_on_the_cpu(shape):
    n, nd = int(np.prod(shape)), len(shape)
    assert not cg_cuda.default_resident(1, n, nd, 1, "cpu")
    with cg_cuda.pinned_resident(True):
        assert not cg_cuda.default_resident(1, n, nd, 1, torch.device("cpu"))


def _krylov_formula():
    """``fg_resident_bytes`` of ``csrc/krylov.cuh`` as a Python function."""
    src = (CSRC / "krylov.cuh").read_text()
    vecs = int(re.search(r"#define FG_RESIDENT_VECS (\d+)", src).group(1))
    body = re.search(r"fg_resident_bytes\(int n, int nd\) \{\s*return (.*?);",
                     src, re.S).group(1)
    expr = (body.replace("(size_t)", "").replace("FG_RESIDENT_VECS", str(vecs))
            .replace("\n", " "))
    return vecs, lambda n, nd: eval(expr, {}, {"n": n, "nd": nd})


@pytest.mark.parametrize("n,nd", [(5_856, 2), (11_712, 2), (167_936, 3),
                                  (1, 2), (6_229, 2), (4_096, 3)])
def test_resident_bytes_is_the_krylov_formula(n, nd):
    vecs, formula = _krylov_formula()
    assert vecs == cg_cuda.RESIDENT_VECS
    assert cg_cuda.resident_bytes(n, nd) == formula(n, nd)


def test_resident_bytes_of_the_main_path():
    # diag + 4 off rows (117,120 B) and four vectors (4 x 23,424 B)
    assert cg_cuda.resident_bytes(5_856, 2) == 5 * 23_424 + 4 * 23_424 == 210_816
    assert cg_cuda.resident_bytes(11_712, 2) == 421_632


def test_everything_the_rule_admits_fits():
    """The largest admitted lane fits 227 KB less the static reserve, and
    one more cell does not."""
    room = cg_cuda.SMEM_PER_BLOCK - cg_cuda.SMEM_STATIC
    n_max = room // (4 * (1 + 4 + cg_cuda.RESIDENT_VECS))
    assert n_max == 6_229
    assert cg_cuda.default_resident(1, n_max, 2, 1, CUDA)
    assert cg_cuda.resident_bytes(n_max, 2) <= room
    assert not cg_cuda.default_resident(1, n_max + 1, 2, 1, CUDA)
    for n in range(1, n_max + 1, 97):
        assert cg_cuda.default_resident(1, n, 2, 1, CUDA)
        assert cg_cuda.resident_bytes(n, 2) <= room
        # 3D takes the chunk grid whatever its size
        assert not cg_cuda.default_resident(1, n, 3, 1, CUDA)
    assert cg_cuda.SMEM_PER_BLOCK == cg_cuda_mb.SMEM_PER_BLOCK == 232_448


def test_pinned_resident_nests_and_restores(h100):
    n = 5_856
    assert cg_cuda.default_resident(1, n, 2, 1, CUDA)
    with cg_cuda.pinned_resident(False):
        assert not cg_cuda.default_resident(1, n, 2, 1, CUDA)
        with cg_cuda.pinned_resident(True):
            assert cg_cuda.default_resident(1, 11_712, 2, 1, CUDA)
            # chunk > 1 has no resident arm, pinned or not
            assert not cg_cuda.default_resident(4, n, 2, 4, CUDA)
            with cg_cuda.pinned_resident(None):
                assert not cg_cuda.default_resident(1, 11_712, 2, 1, CUDA)
                assert cg_cuda.default_resident(1, n, 2, 1, CUDA)
            assert cg_cuda.default_resident(1, 11_712, 2, 1, CUDA)
        assert not cg_cuda.default_resident(1, n, 2, 1, CUDA)
    assert cg_cuda.default_resident(1, n, 2, 1, CUDA)
    with pytest.raises(RuntimeError):
        with cg_cuda.pinned_resident(True):
            raise RuntimeError("inside")
    assert cg_cuda._PINNED_RESIDENT is None
    with pytest.raises(ValueError):
        with cg_cuda.pinned_resident(1):
            pass


def _c_params(source, entry):
    """The parameter types of an ``extern "C"`` entry in ``csrc/``."""
    src = (CSRC / source).read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                    re.S).group(1)
    return [" ".join(p.split()[:-1]) for p in sig.replace("\n", " ").split(",")]


@pytest.mark.parametrize("source,entry", [("cg.cu", "fg_cg_solve"),
                                          ("bicgstab_mb.cu", "fg_bicgstab_solve")])
def test_entry_signature_matches_the_ctypes_argtypes(source, entry):
    """The loader's argtypes follow the C signature one for one (pointers
    and the stream as void*, int, float), and ``resident`` follows
    ``chunk``."""
    params = _c_params(source, entry)
    kinds = {"int": "c_int", "float": "c_float"}
    want = [kinds.get(p, "c_void_p") for p in params]
    got = [t.__name__ for t in _build._ARGTYPES[entry]]
    assert got == want
    src = (CSRC / source).read_text()
    names = [p.split()[-1] for p in re.search(
        r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
        re.S).group(1).replace("\n", " ").split(",")]
    assert names[names.index("chunk") + 1] == "resident"


def _rbc_system(L=1, seed=0):
    diag, off = (torch.from_numpy(a) for a in spd_stencil((10, 16), 2, seed))
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.normal(size=(L, 10, 16)).astype(np.float32))
    return diag, off, b


def test_launcher_checks_the_resident_arm():
    """The arm takes one lane per block whose bytes fit; both are refused
    before anything is built."""
    diag, off, b = _rbc_system(4)
    kw = dict(ndims=2, tol2_sum=1e-10, maxiter=10, stall_iters=5,
              precondition=True, return_best=True)
    with pytest.raises(ValueError, match="chunk 1"):
        cg_cuda.launcher(diag[None], off[None], b, None, chunk=4,
                         resident=True, **kw)
    with pytest.raises(ValueError, match="chunk 1"):
        cg_cuda_mb.launcher(diag[None], off[None], b, None, chunk=2,
                            resident=True, **kw)
    big = torch.zeros((1,) + RBC_WIDE)
    big_off = torch.zeros((1, 4) + RBC_WIDE)
    for mod in (cg_cuda, cg_cuda_mb):
        with pytest.raises(ValueError, match="2D lanes whose bytes fit"):
            mod.launcher(big, big_off, big, None, chunk=1, resident=True, **kw)


@pytest.mark.parametrize("arm", [None, True, False])
def test_cpu_wrappers_run_the_plain_versions_whatever_the_pin(arm):
    diag, off, b = _rbc_system(3, seed=1)
    n = b[0].numel()
    kw = dict(maxiter=500, stall_iters=250, precondition=True)
    counters = (cg_cuda.fused_cg.launches, cg_cuda.fused_cg.resident_launches,
                cg_cuda_mb.fused_bicgstab_mb.launches,
                cg_cuda_mb.fused_bicgstab_mb.resident_launches)
    k1_plain = cg_cuda.fused_cg_plain.calls
    k2_plain = cg_cuda_mb.fused_bicgstab_plain.calls
    with cg_cuda.pinned_resident(arm):
        x, info = cg_cuda.fused_cg(diag, off, b, ndims=2, tol=1e-6,
                                   return_best=True, **kw)
        topo = DomainBuilder(ndims=2, viscosity=0.01)
        topo.create_block(geometry.make_uniform_grid((16, 10), (0, 0), (1.0, 1.0)))
        plan = block_merge.trivial_plan(topo.build()[0])
        d2, o2 = (torch.from_numpy(a) for a in nonsym_stencil((10, 16), 2, 1))
        xs, info2 = cg_cuda_mb.fused_bicgstab_mb(plan, (d2,), (o2,), (b,),
                                                 tol=1e-6, return_best=False,
                                                 **kw)
    assert cg_cuda.fused_cg_plain.calls == k1_plain + 1
    assert cg_cuda_mb.fused_bicgstab_plain.calls == k2_plain + 1
    assert counters == (cg_cuda.fused_cg.launches,
                        cg_cuda.fused_cg.resident_launches,
                        cg_cuda_mb.fused_bicgstab_mb.launches,
                        cg_cuda_mb.fused_bicgstab_mb.resident_launches)
    xp, ip, _ = cg_cuda.fused_cg_plain(
        diag[None], off[None], b, None, ndims=2, chunk=1, return_best=True,
        tol2_sum=cg_cuda.tol2_sum_f32(1e-6, n), **kw)
    assert torch.equal(x, xp) and torch.equal(info.iterations, ip)
    xq, _, _ = cg_cuda_mb.fused_bicgstab_plain(
        d2[None], o2[None], b, None, ndims=2, chunk=1, return_best=False,
        tol2_sum=cg_cuda.tol2_sum_f32(1e-6, n), **kw)
    assert torch.equal(xs[0], xq)
    assert bool(info.converged.all()) and bool(info2.converged)


def _magic(d):
    """``fg_magic`` of ``csrc/krylov.cuh``."""
    l = 0
    while (1 << l) < d:
        l += 1
    s = 30 + l
    return (1 << s) // d + 1, s


def test_magic_division_source_is_the_mirrored_formula():
    src = (CSRC / "krylov.cuh").read_text()
    assert "*s = 30 + l;" in src
    assert "*m = (unsigned)((1ULL << *s) / (unsigned long long)d + 1);" in src
    assert "(((unsigned long long)(unsigned)a * m) >> s)" in src


@pytest.mark.parametrize("d", [1, 2, 3, 7, 61, 64, 96, 97, 192, 1023, 1024,
                               4097, 65_537, 1 << 20, (1 << 30) - 1])
def test_magic_division_is_exact(d):
    """``fg_div(a, fg_magic(d))`` = ``a // d`` for every ``0 <= a < 2^30``:
    checked on every a below 200,000 and around every multiple of d up to
    2^30 that a stride reaches, with the multiplier inside 32 bits."""
    m, s = _magic(d)
    assert m < 1 << 32 and s < 64
    a = np.arange(200_000, dtype=np.uint64)
    assert np.array_equal((a * np.uint64(m)) >> np.uint64(s), a // np.uint64(d))
    q = np.unique(np.linspace(1, ((1 << 30) - 1) // d, 20_000).astype(np.int64))
    for off in (-1, 0, 1, d - 1):
        b = (q * d + off).astype(object)
        b = np.array([v for v in b if 0 <= v < 1 << 30], dtype=object)
        assert all((v * m) >> s == v // d for v in b)


def test_matvec_index_arithmetic_covers_the_main_path_grids():
    """The matvec's (i, j, k) from two magic divisions equal ``%`` and
    ``//`` on every cell of the RBC2D, RBC2D-wide and RBC3D grids."""
    for nz, ny, nx in ((1,) + RBC, (1,) + RBC_WIDE, RBC3D):
        (mx, sx), (my, sy) = _magic(nx), _magic(ny)
        c = np.arange(nz * ny * nx, dtype=np.uint64)
        q = (c * np.uint64(mx)) >> np.uint64(sx)
        k = (q * np.uint64(my)) >> np.uint64(sy)
        assert np.array_equal(c - q * np.uint64(nx), c % np.uint64(nx))
        assert np.array_equal(q - k * np.uint64(ny), (c // np.uint64(nx)) % np.uint64(ny))
        assert np.array_equal(k, c // np.uint64(nx * ny))


def test_admitted_lanes_fit_the_unrolled_cells():
    """The resident arm's cell loop is unrolled to ``FG_RESIDENT_CELLS``
    cells per thread (``csrc/krylov.cuh``; its entry refuses more): every
    lane the byte rule admits has at most that many per 1024 threads."""
    src = (CSRC / "krylov.cuh").read_text()
    cells = int(re.search(r"#define FG_RESIDENT_CELLS (\d+)", src).group(1))
    threads = int(re.search(r"#define FG_THREADS (\d+)", src).group(1))
    room = cg_cuda.SMEM_PER_BLOCK - cg_cuda.SMEM_STATIC
    n_max = room // (4 * (1 + 4 + cg_cuda.RESIDENT_VECS))
    assert cg_cuda.resident_fits(n_max, 2)
    assert -(-n_max // threads) <= cells
    assert -(-5_856 // threads) == 6
    assert "nd == 2 && chunk == 1 && n <= FG_RESIDENT_CELLS * FG_THREADS" in src
