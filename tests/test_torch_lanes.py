"""Lane folding and chunking: the port's solvers under ``torch.func.vmap``
against the TPU kernels under ``jax.vmap`` (interpret mode), on the plain
versions (twins of ``tests/test_cg_pallas.py:102,119,138`` and
``tests/test_cg_pallas_mb.py:111,359``).

A vmapped batch reaches the solver through ``cg_cuda.LaneFold``'s vmap
rule: batch x lanes fold onto the lane axis, one solve for the batch, in
lockstep chunks (``chunk``; on the CPU one lane per chunk by default, the
card's layout up to its SM count).  The JAX package folds the same way
(``custom_vmap``) and runs batches larger than its VMEM budget in chunks.

Bar (ROADMAP, Krylov solves): both converge, iteration counts within 3,
solutions within the error the tolerance allows (``max|dx| <= 2e-4
max|x|``).  Where the port runs the JAX package's lockstep group
(``chunk`` equal to its chunk) the iteration counts are compared lane for
lane.  On the plain versions a forced chunk gives the same x per lane as
one chunk, exactly, while no frozen lane is reactivated by the refresh
(every system here converges before iteration 100).  Every vmapped call runs
inside ``piso.strict_vmap``: vmap's per-lane fallback would raise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.ops import cg_pallas, cg_pallas_mb
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.core.domain import domain_state_from_numpy
from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge as tbm
from fluidgym_tpu_torch.solver import piso
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import CYL_KW, assert_rel, nonsym_stencil, spd_stencil

torch.set_num_threads(1)
SHAPE, ND = (16, 128), 2
KW = dict(maxiter=500, stall_iters=250, precondition=True, return_best=True)


def _vmap(fn, *args):
    with piso.strict_vmap():
        return torch.func.vmap(fn)(*args)


def _jax_k1(diag, off, bs, **kw):
    solve = functools.partial(cg_pallas.fused_cg, ndims=ND, tol=1e-6,
                              interpret=True, **{**KW, **kw})
    x, info = jax.vmap(lambda b: solve(jnp.asarray(diag), jnp.asarray(off), b))(
        jnp.asarray(bs))
    return np.asarray(x), np.asarray(info.iterations), np.asarray(info.converged)


def _port_k1(diag, off, bs, chunk=None, **kw):
    d, o = torch.from_numpy(diag), torch.from_numpy(off)
    f = lambda b: cg_cuda.fused_cg(d, o, b[None], ndims=ND, tol=1e-6,
                                   chunk=chunk, **{**KW, **kw})
    x, info = _vmap(f, torch.from_numpy(bs))
    return x[:, 0].numpy(), info.iterations[:, 0].numpy(), info.converged[:, 0].numpy()


def test_fused_cg_vmap_matches_jax():
    """A vmapped batch folds onto lanes: each lane matches the JAX kernel's
    vmapped lane and the port's own standalone solve."""
    diag, off = spd_stencil(SHAPE, ND, seed=7)
    bs = np.random.default_rng(8).normal(size=(3,) + SHAPE).astype(np.float32)
    xj, ij, cj = _jax_k1(diag, off, bs)
    xt, it, ct = _port_k1(diag, off, bs, chunk=3)
    assert cj.all() and ct.all()
    assert np.abs(it.astype(int) - ij.astype(int)).max() <= 3
    for lane in range(3):
        assert_rel(xt[lane], xj[lane], 2e-4, f"lane {lane}")
    xd, id_, cd = _port_k1(diag, off, bs)  # default: one lane per chunk
    for lane in range(3):
        x1, i1 = cg_cuda.fused_cg(torch.from_numpy(diag), torch.from_numpy(off),
                                  torch.from_numpy(bs[lane:lane + 1]), ndims=ND,
                                  tol=1e-6, **KW)
        assert np.array_equal(xd[lane], x1[0].numpy())
        assert int(id_[lane]) == int(i1.iterations[0])


def test_fused_cg_vmap_chunked_matches_jax(monkeypatch):
    """Batches split into chunks: the JAX kernel's VMEM budget forced to 8
    lanes (20 lanes in 3 chunks, the last one padded, run by lax.map; below
    8 lanes per chunk it would take its XLA loop instead), the port's chunk
    = 8 (run one after another by the plain version, side by side on the
    card): the same chunks, the same per-lane iteration counts within 3."""
    diag, off = spd_stencil(SHAPE, ND, seed=9)
    bs = np.random.default_rng(10).normal(size=(20,) + SHAPE).astype(np.float32)
    bs[::3] *= 1e-3
    monkeypatch.setattr(cg_pallas, "_VMEM_BUDGET_BYTES",
                        8 * cg_pallas._lane_bytes(SHAPE, ND, jnp.float32))
    xj, ij, cj = _jax_k1(diag, off, bs)
    xt, it, ct = _port_k1(diag, off, bs, chunk=8)
    assert cj.all() and ct.all()
    for c0 in (0, 8, 16):
        assert len(set(it[c0:c0 + 8].tolist())) == 1
        assert len(set(ij[c0:c0 + 8].tolist())) == 1
    assert np.abs(it.astype(int) - ij.astype(int)).max() <= 3
    for lane in range(20):
        assert_rel(xt[lane], xj[lane], 2e-4, f"lane {lane}")


def test_kernel_path_at_every_lane_count(monkeypatch):
    """The JAX package falls back to its XLA loop when its VMEM holds fewer
    than 8 lanes (test_cg_pallas.py:138).  The port has no such fallback:
    every lane count takes the kernel's path, one folded solve per call
    (the plain version on the CPU), and the card's chunking accepts it."""
    diag, off = spd_stencil((8, 16), ND, seed=11)
    d, o = torch.from_numpy(diag), torch.from_numpy(off)
    from fluidgym_tpu_torch.solver import linsolve

    calls = []
    monkeypatch.setattr(linsolve, "cg", lambda *a, **k: calls.append(1))
    for L in (1, 2, 7, 8, 65, 130):
        bs = torch.from_numpy(np.random.default_rng(L).normal(
            size=(L, 8, 16)).astype(np.float32))
        before = cg_cuda.fused_cg_plain.calls
        x, info = _vmap(lambda b: cg_cuda.fused_cg(d, o, b[None], ndims=ND,
                                                   tol=1e-5, **KW), bs)
        assert cg_cuda.fused_cg_plain.calls == before + 1
        assert x.shape == (L, 1, 8, 16) and bool(info.converged.all())
    assert not calls

    monkeypatch.setattr(cg_cuda, "_sm_count", lambda dev: 132)  # an H100
    for L in (1, 2, 64, 65, 130, 132, 133, 1000, 9000):
        c = cg_cuda.default_chunk(L, "cuda")
        cg_cuda.check_chunk(L, c)
        blocks = -(-L // c)
        assert blocks <= max(132, -(-L // cg_cuda.MAX_LANES))
        assert c == (1 if L <= 132 else c)


def test_forced_chunk_equals_one_chunk_exactly():
    """On the plain versions a lane's x does not depend on its chunk mates
    (per-lane freeze): chunks of 2 give what one chunk of 5 gives, bit for
    bit, and what 1-lane chunks give; only the shared counts differ."""
    diag, off = (torch.from_numpy(a) for a in spd_stencil((12, 32), ND, seed=3))
    adiag, aoff = (torch.from_numpy(a) for a in nonsym_stencil((12, 32), ND, 4))
    rng = np.random.default_rng(12)
    bs = torch.from_numpy(rng.normal(size=(5, 12, 32)).astype(np.float32))
    bs[2] = 0.0
    bs[3] *= 1e-3
    n = 12 * 32
    k1 = dict(ndims=ND, tol2_sum=cg_cuda.tol2_sum_f32(1e-5, n), **KW)
    k2 = dict(k1, return_best=False)
    for plain, d, o, kw in ((cg_cuda.fused_cg_plain, diag, off, k1),
                            (cg_cuda_mb.fused_bicgstab_plain, adiag, aoff, k2)):
        x5, i5, _ = plain(d[None], o[None], bs, None, chunk=None, **kw)
        assert int(i5.max()) < 100
        for c in (1, 2, 3):
            xc, ic, _ = plain(d[None], o[None], bs, None, chunk=c, **kw)
            assert torch.equal(xc, x5), (plain.__name__, c)
            if c == 1:
                assert int(ic[2]) == 0 and int(ic.max()) == int(i5.max())


@pytest.mark.parametrize("algo", ["cg", "bicgstab"])
def test_lanes_early_zero_nan_and_tiny_dt(algo):
    """One lockstep chunk of four lanes: one that converges early, a
    zero-RHS lane, a lane with dt ~ 0 (its operator ~ I/dt, as a finished
    lane's advection system in a lockstep round) and a lane whose system is
    NaN (a diverged env).  The NaN lane counts as frozen: it holds the
    chunk no longer than the others, and every other lane comes back as it
    does alone."""
    stencil = spd_stencil if algo == "cg" else nonsym_stencil
    d0, o0 = (torch.from_numpy(a) for a in stencil((12, 32), ND, seed=5))
    dt_small = 1e-7
    diag = torch.stack([d0, d0, d0 + 1.0 / dt_small, d0])
    off = torch.stack([o0] * 4)
    rng = np.random.default_rng(13)
    bs = torch.from_numpy(rng.normal(size=(4, 12, 32)).astype(np.float32))
    bs[0] *= 1e-4
    bs[1] = 0.0
    bs[2] = bs[2] / dt_small
    bs[3] = float("nan")
    plain = (cg_cuda.fused_cg_plain if algo == "cg"
             else cg_cuda_mb.fused_bicgstab_plain)
    kw = dict(ndims=ND, tol2_sum=cg_cuda.tol2_sum_f32(1e-5, 12 * 32),
              maxiter=500, stall_iters=250, precondition=True,
              return_best=algo == "cg")
    x, it, _ = plain(diag, off, bs, None, chunk=4, **kw)
    alone = [plain(diag[l:l + 1], off[l:l + 1], bs[l:l + 1], None, chunk=1,
                   **kw) for l in range(3)]
    assert int(it[0]) == max(int(a[1][0]) for a in alone) < 100
    assert int(alone[2][1][0]) <= 3, "dt ~ 0 converges at once"
    assert bool((x[1] == 0).all())
    for l in range(3):
        assert torch.equal(x[l], alone[l][0][0]), (algo, l)


# ---------------------------------------------------------------------------
# the merged frame: a CylinderJet2D state at resolution 16
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cyl():
    """The pressure and velocity advection systems of one res-16 cylinder
    state, built by each package from the same numpy state."""
    jenv = fluidgym_tpu.make("CylinderJet2D-easy-v0", **CYL_KW)
    jenv.reset(seed=0)
    tenv = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu", **CYL_KW)
    tenv.reset(seed=0)
    js = jenv._state
    ts = domain_state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    jt, jg, tt, tg = jenv._topo, jenv._geoms, tenv._topo, tenv._geoms
    jadv = jst.build_advection_ops(js, jg, jt, js.viscosity,
                                   jnp.asarray(0.01, jnp.float32))
    tadv = tst.build_advection_ops(ts, tg, tt, ts.viscosity, torch.tensor(0.01))
    jp = jst.build_pressure_ops(tuple(o.diag for o in jadv), jg, jt)
    tp = tst.build_pressure_ops(tuple(o.diag for o in tadv), tg, tt)
    return dict(jt=jt, tt=tt, jplan=jbm.merge_plan(jt), tplan=tbm.merge_plan(tt),
                jadv=jadv, tadv=tadv, jp=jp, tp=tp)


def _packed(bm, plan, ops):
    m = bm.pack_ops(plan, ops)
    return tuple(a[0] for a in m), tuple(a[1] for a in m)


def test_fused_cg_mb_vmap_matches_jax(cyl):
    """K3's lane folding over a batch of 3 pressure RHS (in range, one
    scaled by 1e-3), in one lockstep chunk as the JAX kernel runs them."""
    jd, jo = _packed(jbm, cyl["jplan"], cyl["jp"])
    td, to = _packed(tbm, cyl["tplan"], cyl["tp"])
    rng = np.random.default_rng(20)
    fields = [tuple(rng.standard_normal(bt.shape).astype(np.float32)
                    for bt in cyl["tt"].blocks) for _ in range(3)]
    bl = [[np.asarray(a) for a in jst.domain_apply(
        cyl["jp"], tuple(jnp.asarray(f) for f in fs), cyl["jt"])] for fs in fields]
    bl[1] = [b * 1e-3 for b in bl[1]]
    jb = [jbm.pack_fields(cyl["jplan"], tuple(jnp.asarray(b) for b in bb))
          for bb in bl]
    jbs = tuple(jnp.stack([p[s] for p in jb]) for s in range(2))
    kw = dict(maxiter=3000, stall_iters=250, precondition=True, return_best=True)
    xj, ij = jax.vmap(lambda *bs: cg_pallas_mb.fused_cg_mb(
        cyl["jplan"], jd, jo, bs, tol=1e-5, interpret=True, **kw))(*jbs)
    tbs = tuple(torch.from_numpy(np.array(b)) for b in jbs)
    for chunk in (3, None):
        xt, it = _vmap(lambda *bs: cg_cuda_mb.fused_cg_mb(
            cyl["tplan"], td, to, bs, tol=1e-5, chunk=chunk, **kw), *tbs)
        assert bool(it.converged.all()) and bool(np.asarray(ij.converged).all())
        if chunk == 3:
            assert np.abs(it.iterations.numpy() - np.asarray(ij.iterations)).max() <= 3
        for s in range(2):
            for lane in range(3):
                assert_rel(xt[s][lane].numpy(), np.asarray(xj[s][lane]), 2e-4,
                           f"sb {s} lane {lane} chunk {chunk}")


def test_fused_bicgstab_vmap_folds_batch_and_components(cyl):
    """K2-mb: a batch of 3 envs of 2 velocity components folds onto 6
    lanes; each env matches the JAX kernel's vmapped env."""
    jd, jo = _packed(jbm, cyl["jplan"], cyl["jadv"])
    td, to = _packed(tbm, cyl["tplan"], cyl["tadv"])
    rng = np.random.default_rng(30)

    def comp_packed(bm, plan, fields, conv):
        per_c = [bm.pack_fields(plan, tuple(conv(f[c]) for f in fields))
                 for c in range(2)]
        return tuple(per_c[c][s] for c in range(2) for s in range(2))

    envs = [[rng.standard_normal((2,) + bt.shape).astype(np.float32)
             for bt in cyl["tt"].blocks] for _ in range(3)]
    jb = [comp_packed(jbm, cyl["jplan"], e, jnp.asarray) for e in envs]
    jbs = tuple(jnp.stack([jnp.stack([p[s], p[2 + s]]) for p in jb])
                for s in range(2))
    kw = dict(maxiter=2000, stall_iters=250, precondition=True, return_best=False)
    xj, ij = jax.vmap(lambda *bs: cg_pallas_mb.fused_bicgstab_mb(
        cyl["jplan"], jd, jo, bs, tol=1e-6, interpret=True, **kw))(*jbs)
    tbs = tuple(torch.from_numpy(np.array(b)) for b in jbs)
    xt, it = _vmap(lambda *bs: cg_cuda_mb.fused_bicgstab_mb(
        cyl["tplan"], td, to, bs, tol=1e-6, **kw), *tbs)
    assert bool(it.converged.all()) and bool(np.asarray(ij.converged).all())
    assert np.abs(it.iterations.numpy() - np.asarray(ij.iterations)).max() <= 3
    for s in range(2):
        assert_rel(xt[s].numpy(), np.asarray(xj[s]), 2e-4, f"sb {s}")
