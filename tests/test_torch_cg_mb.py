"""K3 (merged-frame CG) and K2 in merged multi-super-block form, plain
PyTorch versions (``fluidgym_tpu_torch.ops.cg_cuda_mb``) against the TPU
kernels ``fluidgym_tpu.ops.cg_pallas_mb.fused_cg_mb`` /
``fused_bicgstab_mb`` in interpret mode, on the pressure and velocity
advection systems of a CylinderJet2D state at resolution 16 (2
super-blocks, 2 seam fixups) and of the Airfoil2D C-grid at its registered
width (3 super-blocks, 6 fixups, 2 of them the reflected wake cut).

Bars (Krylov solves, as for K1/K2): both converge, iteration counts within
3 (K3) / 2 (K2), ``max|dx| <= 2e-4 max|x|`` (K3) / ``1e-4 max|x|`` (K2).
The solvers run the same arithmetic in float32; the tolerances hold the
solutions that closely on these systems.  Also: the kernels' neighbour
table reproduces ``merged_apply``, and the deflation warm start matches
``piso._make_deflation_x0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.ops import cg_pallas_mb
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu.solver import piso as jpiso
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.core.domain import domain_state_from_numpy
from fluidgym_tpu_torch.ops import cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge as tbm
from fluidgym_tpu_torch.solver import piso as tpiso
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import CYL_KW, assert_rel

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(scope="module")
def systems():
    """Pressure and velocity advection systems of one cylinder state, built
    by each package from the same numpy state."""
    jenv = fluidgym_tpu.make("CylinderJet2D-easy-v0", **CYL_KW)
    jenv.reset(seed=0)
    tenv = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu", **CYL_KW)
    tenv.reset(seed=0)
    js = jenv._state
    ts = domain_state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    jt, jg, tt, tg = jenv._topo, jenv._geoms, tenv._topo, tenv._geoms
    dj, dt_ = jnp.asarray(0.01, jnp.float32), torch.tensor(0.01)
    jadv = jst.build_advection_ops(js, jg, jt, js.viscosity, dj)
    tadv = tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_)
    jp = jst.build_pressure_ops(tuple(o.diag for o in jadv), jg, jt)
    tp = tst.build_pressure_ops(tuple(o.diag for o in tadv), tg, tt)
    return dict(jt=jt, tt=tt, jplan=jbm.merge_plan(jt), tplan=tbm.merge_plan(tt),
                jadv=jadv, tadv=tadv, jp=jp, tp=tp, js=js, ts=ts)


def _pack_j(plan, ops):
    m = jbm.pack_ops(plan, ops)
    return tuple(a[0] for a in m), tuple(a[1] for a in m)


def _pack_t(plan, ops):
    m = tbm.pack_ops(plan, ops)
    return tuple(a[0] for a in m), tuple(a[1] for a in m)


def _rhs(topo, seed, mv=None):
    """An in-range RHS of the singular pressure system (``A`` applied to a
    random field), as numpy per block."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(bt.shape).astype(np.float32) for bt in topo.blocks]


def _in_range(sy, fields):
    """``A x`` for the given per-block numpy fields, by the JAX package."""
    out = jst.domain_apply(sy["jp"], tuple(jnp.asarray(f) for f in fields), sy["jt"])
    return [np.array(o) for o in out]


def _k3_pair(sy, b_blocks, x0_blocks=None, **kw):
    kw = {**dict(maxiter=3000, stall_iters=250, precondition=True,
                 return_best=True), **kw}
    jplan, tplan = sy["jplan"], sy["tplan"]
    jd, jo = _pack_j(jplan, sy["jp"])
    td, to = _pack_t(tplan, sy["tp"])
    jb = jbm.pack_fields(jplan, tuple(jnp.asarray(b) for b in b_blocks))
    tb = tbm.pack_fields(tplan, tuple(torch.from_numpy(b) for b in b_blocks))
    jx0 = tx0 = None
    if x0_blocks is not None:
        jx0 = jbm.pack_fields(jplan, tuple(jnp.asarray(x) for x in x0_blocks))
        tx0 = tbm.pack_fields(tplan, tuple(torch.from_numpy(x) for x in x0_blocks))
    xj, ij = cg_pallas_mb.fused_cg_mb(jplan, jd, jo, jb, jx0, tol=TOL,
                                      interpret=True, **kw)
    calls = cg_cuda_mb.fused_cg_mb_plain.calls
    xt, it = cg_cuda_mb.fused_cg_mb(tplan, td, to, tb, tx0, tol=TOL, **kw)
    assert cg_cuda_mb.fused_cg_mb_plain.calls == calls + 1
    return ([np.asarray(x) for x in xj], ij), ([x.numpy() for x in xt], it)


def _assert_k3(j, t, what):
    (xj, ij), (xt, it) = j, t
    assert bool(ij.converged) and bool(it.converged), (what, ij, it)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 3, (what, ij, it)
    scale = max(np.abs(x).max() for x in xj)
    err = max(np.abs(a - b).max() for a, b in zip(xt, xj))
    assert err <= 2e-4 * scale, f"{what}: max|dx| {err:.3e} > 2e-4 * {scale:.3e}"


def test_plans_and_neighbor_table(systems):
    """The kernels' neighbour-table matvec (what csrc/merged.cuh computes)
    equals merged_apply, which equals the JAX package's."""
    sy = systems
    plan = sy["tplan"]
    assert len(plan.superblocks) == 2 and len(plan.fixups) == 2
    assert plan.identity_seams
    td, to = _pack_t(plan, sy["tadv"])
    rng = np.random.default_rng(0)
    xs = tuple(torch.from_numpy(rng.standard_normal((2,) + tuple(d.shape))
                                .astype(np.float32)) for d in td)
    ref = tbm.merged_apply(plan, tuple(zip(td, to)), xs)
    diag, off = cg_cuda_mb.flatten_ops(plan, td, to)
    nbr = cg_cuda_mb.neighbor_table(plan, "cpu").long()
    v = cg_cuda_mb.flatten_fields(plan, xs)
    y = diag * v
    for f in range(4):
        y = y + off[:, f] * v[:, nbr[f]]
    assert_rel(y.numpy(), cg_cuda_mb.flatten_fields(plan, ref).numpy(), 1e-6,
               "table matvec")
    jd, jo = _pack_j(sy["jplan"], sy["jadv"])
    jref = jbm.merged_apply(sy["jplan"], tuple(zip(jd, jo)),
                            tuple(jnp.asarray(x[0].numpy()) for x in xs))
    for a, b in zip(ref, jref):
        assert_rel(a[0].numpy(), np.asarray(b), 1e-6, "merged_apply")


def test_k3_plain_cold(systems):
    b = _in_range(systems, _rhs(systems["tt"], 7))
    j, t = _k3_pair(systems, b)
    _assert_k3(j, t, "cold")


def _deflation_guess(sy, b, base, dtype):
    """The deflation warm start of both packages for the same pressure
    system, in ``dtype`` ("float32"/"float64"; JAX float64 under a scoped
    ``jax.enable_x64``)."""
    with jax.enable_x64(dtype == "float64"):
        jdt = getattr(jnp, dtype)
        jp = tuple(jst.StencilOp(o.diag.astype(jdt), o.off.astype(jdt))
                   for o in sy["jp"])
        jg = jpiso._make_deflation_x0(jp, sy["jt"], jdt)(
            tuple(jnp.asarray(x, jdt) for x in b),
            base=tuple(jnp.asarray(x, jdt) for x in base))
        jg = [np.array(g) for g in jg]
    tdt = getattr(torch, dtype)
    # the JAX package's operator for both: the two builds differ by float32
    # rounding, which the coarse solve would amplify
    tp = tuple(tst.StencilOp(torch.from_numpy(np.array(o.diag)).to(tdt),
                             torch.from_numpy(np.array(o.off)).to(tdt))
               for o in sy["jp"])
    tg = tpiso._make_deflation_x0(tp, sy["tt"], tdt)(
        tuple(torch.from_numpy(x).to(tdt) for x in b),
        base=tuple(torch.from_numpy(x).to(tdt) for x in base))
    return jg, [g.numpy() for g in tg]


def test_deflation_x0_matches_jax(systems):
    """``_make_deflation_x0`` (coarse solve W E^+ W^T over 15 per-block
    modes, self-gated base).  In float64 both packages agree to 1e-9 (same
    arithmetic; summation order and the SVD inside the pseudo-inverse
    differ).  In float32 the guess carries the rounding of E = W^T A W (A
    annihilates the constant modes, so E's entries come from cancelling
    sums) amplified by the pseudo-inverse (E_n has condition ~450 after the
    rtol cut): the port's float32 guess is held to 5e-3 of its float64 one
    (measured 1.8e-3; the JAX package's own float32 guess is 0.9e-3 off its
    float64 guess on this system)."""
    sy = systems
    b = _in_range(sy, _rhs(sy["tt"], 8))
    base = _rhs(sy["tt"], 9)
    j64, t64 = _deflation_guess(sy, b, base, "float64")
    for i, (a, c) in enumerate(zip(t64, j64)):
        assert_rel(a, c, 1e-9, f"float64 guess block {i}")
    _, t32 = _deflation_guess(sy, b, base, "float32")
    scale = max(np.abs(g).max() for g in t64)
    err = max(np.abs(a - c).max() for a, c in zip(t32, t64))
    assert err <= 5e-3 * scale, (err, scale)
    # the pure coarse start (no base) too
    with jax.enable_x64(True):
        jp = tuple(jst.StencilOp(o.diag.astype(jnp.float64),
                                 o.off.astype(jnp.float64)) for o in sy["jp"])
        jc = jpiso._make_deflation_x0(jp, sy["jt"], jnp.float64)(
            tuple(jnp.asarray(x, jnp.float64) for x in b))
        jc = [np.asarray(g) for g in jc]
    tp = tuple(tst.StencilOp(torch.from_numpy(np.array(o.diag)).double(),
                             torch.from_numpy(np.array(o.off)).double())
               for o in sy["jp"])
    tc = tpiso._make_deflation_x0(tp, sy["tt"], torch.float64)(
        tuple(torch.from_numpy(x).double() for x in b))
    for i, (a, c) in enumerate(zip(tc, jc)):
        assert_rel(a.numpy(), c, 1e-9, f"coarse start block {i}")


def test_k3_plain_warm_from_deflation(systems):
    """Warm start from the deflation guess (the JAX package's, given to
    both) around a base near the solution, as the corrector loop runs it:
    fewer iterations than cold."""
    sy = systems
    x_true = _rhs(sy["tt"], 8)
    b = _in_range(sy, x_true)
    rng = np.random.default_rng(9)
    base = [x + 1e-2 * rng.standard_normal(x.shape).astype(np.float32)
            for x in x_true]
    x0, _ = _deflation_guess(sy, b, base, "float32")
    j, t = _k3_pair(sy, b, x0)
    _assert_k3(j, t, "warm")
    assert int(t[1].iterations) < int(_k3_pair(sy, b)[1][1].iterations)


def test_k3_plain_zero_rhs(systems):
    b = [np.zeros(bt.shape, np.float32) for bt in systems["tt"].blocks]
    (xj, ij), (xt, it) = _k3_pair(systems, b)
    assert bool(ij.converged) and bool(it.converged)
    assert all((x == 0).all() for x in xt)
    assert all((x == 0).all() for x in xj)


def test_k3_plain_lanes_past_refresh(systems):
    """A vmapped batch in the JAX kernel against the port's lanes: lanes
    converge at different speeds (one scaled by 1e-3), the lockstep loop
    passes the 100-iteration true-residual refresh."""
    sy = systems
    jplan, tplan = sy["jplan"], sy["tplan"]
    jd, jo = _pack_j(jplan, sy["jp"])
    td, to = _pack_t(tplan, sy["tp"])
    lanes = [_in_range(sy, _rhs(sy["tt"], 20 + i)) for i in range(3)]
    lanes[1] = [x * 1e-3 for x in lanes[1]]
    packed = [tbm.pack_fields(tplan, tuple(torch.from_numpy(x) for x in l))
              for l in lanes]
    tb = tuple(torch.stack([p[s] for p in packed]) for s in range(2))
    kw = dict(maxiter=3000, stall_iters=250, precondition=True, return_best=True)
    # chunk=3: the three lanes in one lockstep loop, as the Pallas kernel
    xt, it = cg_cuda_mb.fused_cg_mb(tplan, td, to, tb, tol=1e-6, chunk=3, **kw)

    def one(*bs):
        return cg_pallas_mb.fused_cg_mb(jplan, jd, jo, bs, tol=1e-6,
                                        interpret=True, **kw)

    xj, ij = jax.vmap(one)(*(jnp.asarray(b.numpy()) for b in tb))
    assert int(it.iterations[0]) > 100
    assert torch.equal(it.iterations, it.iterations[:1].expand(3))
    assert abs(int(it.iterations[0]) - int(np.asarray(ij.iterations)[0])) <= 3
    np.testing.assert_array_equal(it.converged.numpy(), np.asarray(ij.converged))
    for s in range(2):
        for l in range(3):
            scale = np.abs(np.asarray(xj[s][l])).max()
            err = np.abs(xt[s][l].numpy() - np.asarray(xj[s][l])).max()
            assert err <= 2e-4 * scale, (s, l, err, scale)


def _k2_pair(sy, warm, zero=False):
    jplan, tplan = sy["jplan"], sy["tplan"]
    jd, jo = _pack_j(jplan, sy["jadv"])
    td, to = _pack_t(tplan, sy["tadv"])
    rng = np.random.default_rng(5)
    comps = [[rng.standard_normal(bt.shape).astype(np.float32)
              for bt in sy["tt"].blocks] for _ in range(2)]
    if zero:
        comps = [[np.zeros_like(x) for x in c] for c in comps]
    vel = [np.asarray(b.velocity) for b in sy["js"].blocks]
    x0c = [[v[c] for v in vel] for c in range(2)]

    def pack(pkg, plan, per_comp, conv, stack):
        per = [pkg.pack_fields(plan, tuple(conv(x) for x in c)) for c in per_comp]
        return tuple(stack([per[c][s] for c in range(2)])
                     for s in range(len(plan.superblocks)))

    jb = pack(jbm, jplan, comps, jnp.asarray, jnp.stack)
    tb = pack(tbm, tplan, comps, torch.from_numpy, torch.stack)
    jx0 = pack(jbm, jplan, x0c, jnp.asarray, jnp.stack) if warm else None
    tx0 = (pack(tbm, tplan, x0c, lambda a: torch.from_numpy(np.array(a)),
                torch.stack) if warm else None)
    kw = dict(tol=1e-6, maxiter=2000, stall_iters=250, precondition=True,
              return_best=False)
    xj, ij = cg_pallas_mb.fused_bicgstab_mb(jplan, jd, jo, jb, jx0,
                                            interpret=True, **kw)
    calls = cg_cuda_mb.fused_bicgstab_plain.calls
    xt, it = cg_cuda_mb.fused_bicgstab_mb(tplan, td, to, tb, tx0, **kw)
    assert cg_cuda_mb.fused_bicgstab_plain.calls == calls + 1
    return ([np.asarray(x) for x in xj], ij), ([x.numpy() for x in xt], it)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_k2_merged_plain(systems, warm):
    (xj, ij), (xt, it) = _k2_pair(systems, warm)
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2, (ij, it)
    scale = max(np.abs(x).max() for x in xj)
    err = max(np.abs(a - b).max() for a, b in zip(xt, xj))
    assert err <= 1e-4 * scale, (err, scale)


def test_k2_merged_plain_zero_rhs(systems):
    (xj, ij), (xt, it) = _k2_pair(systems, False, zero=True)
    assert bool(it.converged) and bool(ij.converged)
    assert all((x == 0).all() for x in xt)


# ---------------------------------------------------------------------------
# the flip-seam (C-grid) plan of Airfoil2D: 3 super-blocks, 6 fixups, 2 of
# them the reflected wake cut
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def airfoil():
    """Pressure and velocity advection systems of the Airfoil2D-easy-v0
    domain as built (uniform inflow state), by each package from the same
    numpy state."""
    from fluidgym_tpu.envs.airfoil.grid import make_airfoil_domain as jgrid
    from fluidgym_tpu_torch.envs.airfoil.grid import make_airfoil_domain as tgrid

    kw = dict(ndims=2, H=1.4, L=4.5, vel_in=0.3, attack_angle_deg=10.0,
              viscosity=3e-4, tail_grow_mul=1.01)
    jt, jg, js = jgrid(res_z=0, **kw)[0].build()
    tt, tg, _ = tgrid(**kw)[0].build()
    ts = domain_state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    dj, dt_ = jnp.asarray(0.05, jnp.float32), torch.tensor(0.05)
    jadv = jst.build_advection_ops(js, jg, jt, js.viscosity, dj)
    tadv = tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_)
    jp = jst.build_pressure_ops(tuple(o.diag for o in jadv), jg, jt)
    tp = tst.build_pressure_ops(tuple(o.diag for o in tadv), tg, tt)
    sy = dict(jt=jt, tt=tt, jplan=jbm.merge_plan(jt), tplan=tbm.merge_plan(tt),
              jadv=jadv, tadv=tadv, jp=jp, tp=tp, js=js, ts=ts)
    assert len(sy["tplan"].superblocks) == 3 and not sy["tplan"].identity_seams
    return sy


def test_k3_flip_plain_matches_kernel(airfoil):
    """Twin of ``tests/test_cg_pallas_mb.py:184``: K3's plain version on the
    C-grid plan against ``fused_cg_mb(..., interpret=True)``: both converge,
    iterations within 3, max|dx| <= 2e-4 max|x|."""
    b = _in_range(airfoil, _rhs(airfoil["tt"], 31))
    j, t = _k3_pair(airfoil, b, maxiter=4000)
    _assert_k3(j, t, "airfoil cold")


def test_k2_flip_plain_matches_kernel(airfoil):
    """K2 in merged form on the C-grid plan (2 velocity lanes, warm from the
    state's velocity) against ``fused_bicgstab_mb(..., interpret=True)``:
    both converge, iterations within 2, max|dx| <= 1e-4 max|x|."""
    (xj, ij), (xt, it) = _k2_pair(airfoil, True)
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2, (ij, it)
    scale = max(np.abs(x).max() for x in xj)
    err = max(np.abs(a - b).max() for a, b in zip(xt, xj))
    assert err <= 1e-4 * scale, (err, scale)
