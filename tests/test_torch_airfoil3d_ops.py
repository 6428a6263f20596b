"""Airfoil3D's grid, merge plan and solves: the port
(``fluidgym_tpu_torch.envs.airfoil.grid``, ``solver.block_merge``,
``ops.cg_cuda_mb``) against the JAX package on the C-grid extruded over a
small span (``res_z`` 2 and 4: 146,912 and 293,824 cells), and the rule
that sends the registered width's lanes (7,051,776 cells) to the spread arm
with its chain terms through the ring (the card's occupancy stubbed).

Bars: vertex coordinates exact (the same float64 numpy arithmetic); block
shapes, faces and connections equal; ``det`` and cell centres within 1e-12
relative; the merge plan identical, 3 super-blocks whose wake cut is a
reflected x seam; ``merged_apply`` equals the blockwise
``stencil.domain_apply`` in both packages and the two packages agree (<=
1e-12 relative in float64); the neighbour-table matvec the kernels compute
equals ``merged_apply`` (<= 1e-6 relative, float32); the plain K3 / K2-mb
through the 3D flip plan against the JAX package's ``linsolve.cg`` /
``linsolve.bicgstab`` over the blocks (its Pallas kernels decline a 3D flip
seam): both converge at tol 1e-8, iterations within 3, ``max|dx| <= 1e-6
max|x|`` (float64 solves from the same start: what differs is the iterate
at which each stops).
The kernels themselves run in ``tests/test_torch_kernels_cuda.py`` on the
card (``-k global_terms``, the ring).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidgym_tpu.envs.airfoil.grid import make_airfoil_domain as jgrid
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu.solver import linsolve as jlin
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.core.domain import BoundKind, domain_state_from_numpy
from fluidgym_tpu_torch.envs.airfoil.grid import make_airfoil_domain as tgrid
from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge as tbm
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import assert_rel

torch.set_num_threads(1)

GRID_KW = dict(ndims=3, H=1.4, L=4.5, vel_in=0.3, attack_angle_deg=10.0,
               viscosity=3e-4, tail_grow_mul=1.01)
XY_CELLS = 73_456
EASY_N = 96 * XY_CELLS                   # Airfoil3D-easy / -medium
HARD_N = 96 * 218_046                    # Airfoil3D-hard (tails (95, 1062))
CUDA = torch.device("cuda")  # a device name only: nothing runs on it here
H100_SMS = 132


def _faces(topo):
    return [[(f.kind.name, f.connected_block, f.connected_face,
              tuple(f.axes or ())) for f in bt.faces] for bt in topo.blocks]


@pytest.fixture(scope="module", params=[2, 4])
def doms(request):
    res_z = request.param
    with jax.enable_x64(True):
        jd, jinfo = jgrid(res_z=res_z, dtype=jnp.float64, **GRID_KW)
        jbuilt = jd.build()
    td, tinfo = tgrid(res_z=res_z, dtype=torch.float64, **GRID_KW)
    return dict(res_z=res_z, jd=jd, jinfo=jinfo, jbuilt=jbuilt, td=td,
                tinfo=tinfo, tbuilt=td.build())


def test_3d_grid_matches_jax(doms):
    jd, td = doms["jd"], doms["td"]
    (jt, jg, _), (tt, tg, _) = doms["jbuilt"], doms["tbuilt"]
    for jb, tb in zip(jd._blocks, td._blocks):
        np.testing.assert_array_equal(np.asarray(tb.coords), np.asarray(jb.coords))
    nz = doms["res_z"]
    assert [b.shape for b in tt.blocks] == [b.shape for b in jt.blocks] == [
        (nz, 11, 71), (nz, 11, 95), (nz, 95, 76), (nz, 95, 76), (nz, 95, 301),
        (nz, 95, 301)]
    assert sum(int(np.prod(b.shape)) for b in tt.blocks) == nz * XY_CELLS
    assert _faces(tt) == _faces(jt)
    assert all(bt.faces[4].kind == bt.faces[5].kind == BoundKind.PERIODIC
               for bt in tt.blocks)
    for k in ("x_min", "x_max", "y_min", "y_max", "out_faces", "normal_res"):
        assert doms["tinfo"][k] == doms["jinfo"][k]
    for a, b in zip(jg, tg):
        for name in ("det", "centers"):
            assert_rel(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                       1e-12, name)
        assert float(b.det.min()) > 0


def test_3d_faces_carry_the_profiles(doms):
    """The inflow profile over the span and the (3, res_z, 95, 1) outflow
    slabs, as the JAX package builds them."""
    (_, _, js), (_, _, ts) = doms["jbuilt"], doms["tbuilt"]
    for b, f in ((0, 0), (4, 1), (5, 1)):
        jv = np.asarray(js.blocks[b].faces[f].velocity)
        tv = ts.blocks[b].faces[f].velocity.numpy()
        assert tv.shape == jv.shape
        np.testing.assert_array_equal(tv, jv)
    assert ts.blocks[4].faces[1].velocity.shape == (3, doms["res_z"], 95, 1)


def _plan_tuple(plan):
    return dataclasses.asdict(plan)


def test_3d_merge_plan_matches_jax(doms):
    """Twin of ``tests/test_block_merge.py:151`` in 3D: the 6-block C-grid
    merges into strip + upper + lower halves; the wake cut survives as a
    same-parity reflected seam (flip on the canonical axis that carries the
    tails' x), and z passes every placement unchanged, so its periodic wrap
    joins matching planes."""
    tp = tbm.merge_plan(doms["tbuilt"][0])
    jp = jbm.merge_plan(doms["jbuilt"][0])
    assert tp is not None and jp is not None
    assert _plan_tuple(tp) == _plan_tuple(jp)
    assert tp.ndims == 3 and len(tp.superblocks) == 3
    assert not tp.identity_seams
    cut = [f for f in tp.fixups if any(f.flip)]
    assert len(cut) == 2
    for f in cut:
        assert f.sb != f.src_sb and f.face == f.src_face
        assert f.flip == (False, True, False)
    for sb in tp.superblocks:
        assert sb.shape[2] == doms["res_z"]
        for pl in sb.members:
            assert pl.perm[2] == 2 and pl.inv[2] == 0 and pl.offset[2] == 0
    rng = np.random.default_rng(11)
    xs = tuple(torch.from_numpy(rng.standard_normal(bt.shape))
               for bt in doms["tbuilt"][0].blocks)
    back = tbm.unpack_fields(tp, tbm.pack_fields(tp, xs))
    assert all(torch.equal(a, b) for a, b in zip(back, xs))


@pytest.fixture(scope="module")
def systems(doms):
    """Pressure and velocity advection systems of the 3D C-grid from one
    perturbed numpy state (free stream plus noise), in both packages, in
    float64."""
    (jt, jg, js), (tt, tg, _) = doms["jbuilt"], doms["tbuilt"]
    rng = np.random.default_rng(doms["res_z"])
    with jax.enable_x64(True):
        blocks = []
        for blk in js.blocks:
            u = 0.05 * rng.standard_normal(blk.velocity.shape)
            u[0] += 0.3
            blocks.append(dataclasses.replace(blk, velocity=jnp.asarray(u)))
        js = dataclasses.replace(js, blocks=tuple(blocks))
        ts = domain_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                     dtype=torch.float64)
        jadv = jst.build_advection_ops(js, jg, jt, js.viscosity,
                                       jnp.asarray(0.005, jnp.float64))
        jp = jst.build_pressure_ops(tuple(o.diag for o in jadv), jg, jt)
    tadv = tst.build_advection_ops(ts, tg, tt, ts.viscosity,
                                   torch.tensor(0.005, dtype=torch.float64))
    tp = tst.build_pressure_ops(tuple(o.diag for o in tadv), tg, tt)
    return dict(jt=jt, tt=tt, js=js, ts=ts, jadv=jadv, tadv=tadv, jp=jp, tp=tp,
                jplan=jbm.merge_plan(jt), tplan=tbm.merge_plan(tt))


def test_3d_merged_apply_matches_domain_apply(systems):
    """Twin of ``tests/test_block_merge.py:165`` in 3D, in both packages:
    the merged-frame matvec (rolls + slab fixups, the x-reflected slabs of
    the cut) is the blockwise halo apply, permuted; and the two packages'
    pressure and velocity operators and applies agree."""
    s = systems
    rng = np.random.default_rng(4)
    xs_np = [rng.standard_normal(bt.shape) for bt in s["tt"].blocks]
    for which in ("p", "adv"):
        tops, jops = s["t" + which], s["j" + which]
        for a, b in zip(jops, tops):
            assert_rel(b.diag.numpy(), np.asarray(a.diag), 1e-12, which + " diag")
            assert_rel(b.off.numpy(), np.asarray(a.off), 1e-12, which + " off")
        txs = tuple(torch.from_numpy(x) for x in xs_np)
        want = tst.domain_apply(tops, txs, s["tt"])
        got = tbm.unpack_fields(s["tplan"], tbm.merged_apply(
            s["tplan"], tbm.pack_ops(s["tplan"], tops),
            tbm.pack_fields(s["tplan"], txs)))
        with jax.enable_x64(True):
            jxs = tuple(jnp.asarray(x) for x in xs_np)
            jwant = jst.domain_apply(jops, jxs, s["jt"])
            jgot = jbm.unpack_fields(s["jplan"], jbm.merged_apply(
                s["jplan"], jbm.pack_ops(s["jplan"], jops),
                jbm.pack_fields(s["jplan"], jxs)))
        for w, g, jw, jg_ in zip(want, got, jwant, jgot):
            assert_rel(g.numpy(), w.numpy(), 1e-12, which + " port merged")
            assert_rel(np.asarray(jg_), np.asarray(jw), 1e-12, which + " jax merged")
            assert_rel(w.numpy(), np.asarray(jw), 1e-12, which + " port vs jax")


def test_3d_flip_neighbor_table_matches_merged_apply(systems):
    """What ``csrc/merged.cuh`` computes through the table built for the 3D
    flip plan (``cg_cuda_mb.neighbor_table``) equals ``merged_apply`` with
    3 lanes, in float32 as the kernels run."""
    plan = systems["tplan"]
    mops = tbm.pack_ops(plan, systems["tadv"])
    td = tuple(m[0].float() for m in mops)
    to = tuple(m[1].float() for m in mops)
    rng = np.random.default_rng(0)
    xs = tuple(torch.from_numpy(rng.standard_normal((3,) + tuple(d.shape))
                                .astype(np.float32)) for d in td)
    ref = tbm.merged_apply(plan, tuple(zip(td, to)), xs)
    diag, off = cg_cuda_mb.flatten_ops(plan, td, to)
    nbr = cg_cuda_mb.neighbor_table(plan, "cpu").long()
    assert nbr.shape == (6, sum(int(np.prod(bt.shape)) for bt in systems["tt"].blocks))
    v = cg_cuda_mb.flatten_fields(plan, xs)
    y = diag * v
    for f in range(6):
        y = y + off[:, f] * v[:, nbr[f]]
    assert_rel(y.numpy(), cg_cuda_mb.flatten_fields(plan, ref).numpy(), 1e-6,
               "3D flip table matvec")


def _packed(plan, ops):
    m = tbm.pack_ops(plan, ops)
    return tuple(a[0] for a in m), tuple(a[1] for a in m)


def test_3d_flip_plain_k3_matches_jax_linsolve(systems):
    """K3's plain version through the 3D flip plan (the wrapper on CPU
    tensors) against ``linsolve.cg`` over the blocks with the Jacobi
    preconditioner: the mean-free right-hand side of a random x, cold."""
    s = systems
    rng = np.random.default_rng(31)
    xs = [rng.standard_normal(bt.shape) for bt in s["tt"].blocks]
    b = tst.domain_apply(s["tp"], tuple(torch.from_numpy(x) for x in xs), s["tt"])
    tol = 1e-8
    diags, offs = _packed(s["tplan"], s["tp"])
    calls = cg_cuda_mb.fused_cg_mb_plain.calls
    xt, it = cg_cuda_mb.fused_cg_mb(
        s["tplan"], diags, offs, tbm.pack_fields(s["tplan"], b), tol=tol,
        maxiter=4000, stall_iters=250, precondition=True, return_best=True)
    assert cg_cuda_mb.fused_cg_mb_plain.calls == calls + 1
    xt = tbm.unpack_fields(s["tplan"], xt)
    with jax.enable_x64(True):
        jops, jt = s["jp"], s["jt"]
        jb = tuple(jnp.asarray(x.numpy()) for x in b)
        diag = tuple(o.diag for o in jops)
        xj, ij = jlin.cg(lambda v: jst.domain_apply(jops, v, jt), jb, tol=tol,
                         maxiter=4000, return_best=True, stall_iters=250,
                         precond=lambda r: tuple(a / d for a, d in zip(r, diag)))
    assert bool(it.converged) and bool(ij.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 3, (it, ij)
    scale = max(np.abs(np.asarray(x)).max() for x in xj)
    err = max(np.abs(a.numpy() - np.asarray(c)).max() for a, c in zip(xt, xj))
    assert err <= 1e-6 * scale, (err, scale)


def test_3d_flip_plain_k2_mb_matches_jax_linsolve(systems):
    """K2-mb's plain version through the 3D flip plan on the 3 velocity
    components (warm from the state's velocity) against
    ``linsolve.bicgstab`` over the blocks, per component, right-Jacobi
    preconditioned."""
    s = systems
    plan = s["tplan"]
    diags, offs = _packed(plan, s["tadv"])
    vel = [b.velocity for b in s["ts"].blocks]
    rhs = [tuple(200.0 * v[c] for v in vel) for c in range(3)]
    per_c = [tbm.pack_fields(plan, r) for r in rhs]
    x0c = [tbm.pack_fields(plan, tuple(v[c] for v in vel)) for c in range(3)]
    stack = lambda parts: tuple(torch.stack([parts[c][k] for c in range(3)])
                                for k in range(len(plan.superblocks)))
    tol = 1e-8
    calls = cg_cuda_mb.fused_bicgstab_plain.calls
    xt, it = cg_cuda_mb.fused_bicgstab_mb(
        plan, diags, offs, stack(per_c), stack(x0c), tol=tol, maxiter=2000,
        stall_iters=250, precondition=True, return_best=False)
    assert cg_cuda_mb.fused_bicgstab_plain.calls == calls + 1
    assert bool(it.converged)
    with jax.enable_x64(True):
        jops, jt = s["jadv"], s["jt"]
        diag = tuple(o.diag for o in jops)
        jits = []
        for c in range(3):
            jb = tuple(jnp.asarray(r.numpy()) for r in rhs[c])
            jx0 = tuple(jnp.asarray(v[c].numpy()) for v in vel)
            xj, ij = jlin.bicgstab(lambda v: jst.domain_apply(jops, v, jt), jb,
                                   jx0, tol=tol, maxiter=2000, return_best=False,
                                   precond=lambda r: tuple(
                                       a / d for a, d in zip(r, diag)))
            assert bool(ij.converged)
            jits.append(int(ij.iterations))
            got = tbm.unpack_fields(plan, tuple(x[c] for x in xt))
            scale = max(np.abs(np.asarray(x)).max() for x in xj)
            err = max(np.abs(a.numpy() - np.asarray(b)).max()
                      for a, b in zip(got, xj))
            assert err <= 1e-6 * scale, (c, err, scale)
    assert abs(int(it.iterations) - max(jits)) <= 3, (it, jits)


# ---------------------------------------------------------------------------
# the rule: the spread arm with its chain terms through the ring
# ---------------------------------------------------------------------------

@pytest.fixture
def h100(monkeypatch):
    """The card's SM count, co-residency (one 1024-thread block per SM)
    and cluster occupancy for the rules (no card here)."""
    monkeypatch.setattr(cg_cuda, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(cg_cuda, "spread_capacity", lambda *a, **k: H100_SMS)
    monkeypatch.setattr(cg_cuda_mb, "max_active_clusters",
                        lambda algo, ndims, C, n, device, coarse_k=0:
                        {16: 7, 8: 16, 4: 33, 2: 66}[C])


@pytest.mark.parametrize("n", [EASY_N, HARD_N])
def test_airfoil3d_lanes_take_the_global_terms(h100, n):
    """Past ~3.59 M cells no G's chain terms fit a block's shared memory
    (440,768 B at G = 128 for 7,051,776 cells): the pressure lane goes to
    G = 128 with its terms through the ring (64 KB of shared memory per
    block), the 3 velocity lanes one per launch at G = 128, each of those
    one-lane launches on the ring too."""
    assert not any(cg_cuda.spread_fits(n, G) for G in cg_cuda.SPREAD_SIZES)
    assert cg_cuda.spread_bytes(EASY_N, 128) == 2 * 8 * 6887 * 4 == 440_768
    assert cg_cuda_mb.merged_arm(1, n, 3, 1, CUDA, "cg") == (1, 128, False)
    assert cg_cuda_mb.merged_arm(3, n, 3, 1, CUDA, "bicgstab") == (1, 128, True)
    assert cg_cuda.spread_ring(1, n, 3)
    assert not cg_cuda.spread_ring(3, n, 3)
    assert cg_cuda.spread_smem(n, 128, cg_cuda.CHAINS_RING) == 65_536
    # the roll forms have no such layout: such a lane keeps the chunk grid
    assert not cg_cuda.spread_ring(1, n, 3, merged=False)
    assert cg_cuda.default_spread(1, n, 3, 1, CUDA, "cg") == 0


@pytest.mark.parametrize("n,lanes,algo,want", [
    (341_568, 1, "cg", (1, 128, False)),      # CylinderJet3D-easy
    (341_568, 3, "bicgstab", (1, 32, False)),
    (749_568, 1, "cg", (1, 128, False)),      # -medium
    (749_568, 3, "bicgstab", (1, 32, False)),
    (2_481_408, 1, "cg", (1, 128, False)),    # -hard
    (2_481_408, 3, "bicgstab", (1, 128, True)),
    (4 * XY_CELLS, 1, "cg", (1, 128, False)),  # the CPU tests' 3D airfoil
])
def test_registered_widths_keep_shared_memory(h100, n, lanes, algo, want):
    """Every registered 3D merged lane's arm is what it was, with its chain
    terms in shared memory."""
    assert cg_cuda_mb.merged_arm(lanes, n, 3, 1, CUDA, algo) == want
    one = 1 if want[2] else lanes
    assert not cg_cuda.spread_ring(one, n, 3)


@pytest.mark.parametrize("shape", [(64, 64, 64), (128, 64, 128), (64, 41, 64),
                                   (128, 41, 128)])
@pytest.mark.parametrize("lanes,algo", [(1, "cg"), (1, "bicgstab"),
                                        (3, "bicgstab")])
def test_roll_forms_keep_their_arms(h100, shape, lanes, algo):
    """RBC3D's and the channel's roll-form lanes (K1-3D, K2-3D) never take
    the ring."""
    n = int(np.prod(shape))
    assert not cg_cuda.spread_ring(lanes, n, 3, merged=False)
    with cg_cuda.pinned_ring(True):
        assert not cg_cuda.spread_ring(lanes, n, 3, merged=False)


def test_pinned_global_terms_nests_and_restores(h100):
    """The ring's pin answers for the 3D merged forms at any width (an A/B
    of the ring against the shared-memory arm on CylinderJet3D-easy's lane,
    and, pinned off, of the chunk grid at Airfoil3D's width) and restores
    what was there; a bad value raises."""
    assert not cg_cuda.spread_ring(1, 341_568, 3)
    with cg_cuda.pinned_ring(True):
        assert cg_cuda.spread_ring(1, 341_568, 3)
        assert cg_cuda.spread_ring(3, 341_568, 3)
        with cg_cuda.pinned_ring(False):
            assert not cg_cuda.spread_ring(1, EASY_N, 3)
            assert cg_cuda_mb.merged_arm(1, EASY_N, 3, 1, CUDA, "cg") == (
                1, 0, False)
        assert cg_cuda.spread_ring(1, 341_568, 3)
    assert cg_cuda.spread_ring(1, EASY_N, 3)
    assert not cg_cuda.spread_ring(1, 341_568, 3)
    with pytest.raises(ValueError):
        with cg_cuda.pinned_ring(1):
            pass
    # the CPU takes no spread arm at all
    assert cg_cuda_mb.merged_arm(1, EASY_N, 3, 1, torch.device("cpu"), "cg") == (
        1, 0, False)


def test_merged_launcher_refuses_global_terms_in_a_range(systems):
    """The ring takes the chains layout: a range with it is refused before
    anything is built or loaded."""
    plan = systems["tplan"]
    n = sum(int(np.prod(bt.shape)) for bt in systems["tt"].blocks)
    diag, off, b = torch.ones(1, n), torch.zeros(1, 6, n), torch.ones(1, n)
    with pytest.raises(ValueError, match="chains layout"):
        cg_cuda_mb.merged_launcher(
            "cg", plan, diag, off, b, None, tol2_sum=1e-6, maxiter=10,
            stall_iters=5, precondition=True, return_best=True, chunk=1,
            spread=128, chains=False, ring=True)


@pytest.mark.parametrize("L,G", [(1, 128), (3, 32)])
def test_spread_buffers_hold_the_slots_alone(L, G):
    """No chain term goes to global memory: the spread arm's buffers are the
    barrier counters and the lanes' 2 x 1024 chain slots (float2), whatever
    the lane's width (the 56.4 MB scratch of a 7,051,776-cell lane is
    gone)."""
    bar, slot = cg_cuda.spread_buffers(L, G, "cpu")
    assert bar.numel() == L and bar.dtype == torch.int32
    assert slot.numel() == L * 2 * 1024 * 2 and slot.dtype == torch.float32
    assert cg_cuda.spread_buffers(L, 0, "cpu") == (None, None)
