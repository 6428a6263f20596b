"""The pieces of the CylinderJet3D path in the PyTorch port against
``fluidgym_tpu`` (CPU), on one perturbed state at resolution 8 (4 jets;
5 extruded blocks of 15,872 cells, periodic z, 2 super-blocks):

* the extruded grid, its curvilinear geometry and the topology, the
  bundled ``test_00`` snapshot read by both loaders;
* ``merge_plan`` (the twin of ``tests/test_block_merge.py::
  test_cylinder_3d_merges``), ``merged_apply`` and the kernels' neighbour
  table against ``domain_apply`` on the 3D pressure operator, the periodic
  z wrap inside the table, and the invariant the table's circular roll
  rests on: a FIXED face carries zero off-coefficients;
* the non-orthogonal corrections with three axes, the flux balancing over
  the jet and outflow faces, the convective outflow hook, the 15-column
  deflation basis (5 blocks x (1 constant + 2 ramps): no ramp along the
  periodic z) and its warm start;
* K3 and K2 in merged form, plain versions (``ops.cg_cuda_mb``) against the
  TPU kernels ``cg_pallas_mb.fused_cg_mb`` / ``fused_bicgstab_mb`` in
  interpret mode on the 3D identity-seam plan, at the env's pressure tol
  5e-7;
* the per-z-slice wall forces, the 3D sensor point plans and the fields
  on the uniform render grid.

Bars: operators and hooks <= 1e-6 relative to each field's scale (float32,
the same arithmetic; only summation order differs), the grid and the
loaded snapshot exactly, forces 1e-12 (float64).  Krylov solves: both
converge, iterations within 3, ``max|dx| <= 2e-4 max|x|`` (K3) /
``1e-4 max|x|`` (K2), the bars of ``tests/test_torch_cg_mb.py``.
"""

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.core.domain_io import load_domain as jload
from fluidgym_tpu.envs.cylinder.grid import \
    make_vortex_street_domain as jmake_domain
from fluidgym_tpu.envs.util import forces as jforces
from fluidgym_tpu.envs.util.multiblock_resample import \
    make_multiblock_point_plan as jpoint_plan
from fluidgym_tpu.ops import cg_pallas_mb
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu.solver import boundaries as jbd
from fluidgym_tpu.solver import nonortho as jno
from fluidgym_tpu.solver import piso as jpiso
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.core.domain import BoundKind, domain_state_from_numpy
from fluidgym_tpu_torch.core.domain_io import load_domain as tload
from fluidgym_tpu_torch.envs.cylinder.grid import \
    make_vortex_street_domain as tmake_domain
from fluidgym_tpu_torch.envs.util import forces as tforces
from fluidgym_tpu_torch.envs.util.multiblock_resample import \
    make_multiblock_point_plan as tpoint_plan
from fluidgym_tpu_torch.ops import cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge as tbm
from fluidgym_tpu_torch.solver import boundaries as tbd
from fluidgym_tpu_torch.solver import nonortho as tno
from fluidgym_tpu_torch.solver import piso as tpiso
from fluidgym_tpu_torch.solver import stencil as tst
from fluidgym_tpu_torch.utils import data_utils
from torch_port_helpers import assert_rel

torch.set_num_threads(1)
RTOL = 1e-6
ID = "CylinderJet3D-easy-v0"
KW = dict(resolution=8, n_jets=4, load_initial_domain=False,
          load_domain_statistics=False, randomize_initial_state=False,
          step_length=0.02, dt=0.01)
JETS = np.array([[0.7], [-0.4], [0.2], [0.9]], np.float32)
TOL = 5e-7


def _cmp(j, t, what, rtol=RTOL):
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t), what
        for i, (a, b) in enumerate(zip(j, t)):
            _cmp(a, b, f"{what}[{i}]", rtol)
        return
    if hasattr(j, "diag"):
        _cmp(j.diag, t.diag, what + ".diag", rtol)
        _cmp(j.off, t.off, what + ".off", rtol)
        return
    assert_rel(t.detach().numpy(), np.asarray(j), rtol, what)


def _fields(topo, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(lead + bt.shape).astype(np.float32)
          for bt in topo.blocks]
    return tuple(jnp.asarray(x) for x in xs), tuple(torch.from_numpy(x) for x in xs)


@pytest.fixture(scope="module")
def cyl():
    """One perturbed 3D cylinder state in both packages: the jets set per
    segment, noise on the velocity, a random pressure, a non-trivial
    outflow face."""
    jenv = fluidgym_tpu.make(ID, **KW)
    tenv = fluidgym_tpu_torch.make(ID, device="cpu", **KW)
    jenv.reset(seed=0)
    tenv.reset(seed=0)
    js = jenv._pure_apply_action(jenv._state, jnp.asarray(JETS))
    rng = np.random.default_rng(3)
    blocks = []
    for b, blk in enumerate(js.blocks):
        u = np.asarray(blk.velocity) + 0.1 * rng.standard_normal(blk.velocity.shape)
        p = rng.standard_normal(blk.pressure.shape)
        faces = list(blk.faces)
        if b == 4:  # the wake's outflow face
            v = np.asarray(faces[1].velocity)
            faces[1] = replace(faces[1], velocity=jnp.asarray(
                v * (1 + 0.2 * rng.standard_normal(v.shape)), jnp.float32))
        blocks.append(replace(blk, velocity=jnp.asarray(u, jnp.float32),
                              pressure=jnp.asarray(p, jnp.float32),
                              faces=tuple(faces)))
    js = replace(js, blocks=tuple(blocks))
    ts = domain_state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    jt, jg, tt, tg = jenv._topo, jenv._geoms, tenv._topo, tenv._geoms
    dj, dt_ = jnp.asarray(0.01, jnp.float32), torch.tensor(0.01)
    jadv = jst.build_advection_ops(js, jg, jt, js.viscosity, dj)
    tadv = tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_)
    jp = jst.build_pressure_ops(tuple(o.diag for o in jadv), jg, jt)
    tp = tst.build_pressure_ops(tuple(o.diag for o in tadv), tg, tt)
    return dict(jenv=jenv, tenv=tenv, jt=jt, jg=jg, js=js, tt=tt, tg=tg, ts=ts,
                jadv=jadv, tadv=tadv, jp=jp, tp=tp,
                jplan=jbm.merge_plan(jt), tplan=tbm.merge_plan(tt))


# ---------------------------------------------------------------------------
# grid, geometry, topology, snapshot
# ---------------------------------------------------------------------------

def _grid_kw(env):
    return dict(ndims=3, viscosity=env._viscosity, domain_height=env.H,
                domain_length=env.L, cylinder_radius=0.5, cylinder_offset_y=0.05,
                circle_thickness=0.5, quad_thickness_x=1.0,
                circle_resolution_angular=8, vortex_street_refinement_base=0.95,
                vortex_street_refinement_axes=("+y", "-y"))


def _faces(topo):
    return [[(f.kind.name, f.vel_type.name, f.connected_block, f.connected_face,
              tuple(f.axes)) for f in bt.faces] for bt in topo.blocks]


def test_grid_3d_matches_jax(cyl):
    jdom, jinfo = jmake_domain(**_grid_kw(cyl["jenv"]))
    tdom, tinfo = tmake_domain(**_grid_kw(cyl["tenv"]))
    assert tinfo == jinfo
    for jb, tb in zip(jdom._blocks, tdom._blocks):
        np.testing.assert_array_equal(np.asarray(tb.coords), np.asarray(jb.coords))
    jt, tt = cyl["jt"], cyl["tt"]
    assert tt.ndims == jt.ndims == 3
    assert [b.shape for b in tt.blocks] == [b.shape for b in jt.blocks] == [
        (8, 8, 15), (8, 15, 8), (8, 8, 15), (8, 15, 8), (8, 8, 188)]
    assert _faces(tt) == _faces(jt)
    assert [b.orthogonal for b in tt.blocks] == [b.orthogonal for b in jt.blocks]
    # z is periodic on every block
    assert all(bt.faces[4].kind == bt.faces[5].kind == BoundKind.PERIODIC
               for bt in tt.blocks)


def test_geometry_3d_matches_jax(cyl):
    for a, b in zip(cyl["jg"], cyl["tg"]):
        for name in ("det", "alpha", "centers", "minv", "minv_diag"):
            ja, ta = getattr(a, name), getattr(b, name)
            assert (ja is None) == (ta is None), name
            if ja is not None:
                assert_rel(ta.numpy(), np.asarray(ja), RTOL, name)
    # the extruded O-grid blocks are non-orthogonal: their minv has cross terms
    assert not cyl["tt"].blocks[0].orthogonal
    assert float(torch.abs(cyl["tg"][0].minv[..., 0, 1]).max()) > 1e-3


def _state_leaves(state, arrays=False):
    """(name, shape or array) of every leaf of a DomainState, JAX or port."""
    out = []
    for i, b in enumerate(state.blocks):
        leaves = [(k, getattr(b, k)) for k in ("velocity", "pressure", "scalar")]
        leaves += [(f"f{f}", fd.velocity) for f, fd in enumerate(b.faces)]
        for k, v in leaves:
            v = v if v is None or not torch.is_tensor(v) else v.numpy()
            out.append((f"b{i}.{k}", v if arrays or v is None
                        else tuple(np.shape(v))))
    return out


def test_bundled_3d_snapshot_loads_identically():
    path = data_utils.initial_domain_dir("cylinder_3D_Re100_Res24") / "test_00"
    jt, jg, js = jload(path)
    tt, tg, ts = tload(path)
    assert _faces(tt) == _faces(jt)
    assert [b.shape for b in tt.blocks] == [b.shape for b in jt.blocks]
    assert sum(int(np.prod(b.shape)) for b in tt.blocks) == 341568
    assert tt.blocks[0].faces[2].axes == jt.blocks[0].faces[2].axes
    for a, b in zip(jg, tg):
        for k in ("det", "minv_diag", "minv", "alpha", "centers"):
            ja, tb = getattr(a, k), getattr(b, k)
            assert (ja is None) == (tb is None), k
            if ja is not None:
                np.testing.assert_array_equal(tb.numpy(), np.asarray(ja), err_msg=k)
    assert _state_leaves(ts) == _state_leaves(js)
    for (_, a), (_, b) in zip(_state_leaves(js, True), _state_leaves(ts, True)):
        if a is not None:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    # the jet faces carry (3, nz, 1, nx) slabs
    assert tuple(ts.blocks[1].faces[2].velocity.shape) == (3, 24, 1, 24)


# ---------------------------------------------------------------------------
# the merged frame
# ---------------------------------------------------------------------------

def test_merge_plan_3d_matches_jax(cyl):
    jp, tp = cyl["jplan"], cyl["tplan"]
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert len(tp.superblocks) == 2 and tp.identity_seams
    assert tp.ndims == 3 and len(tp.fixups) == 2
    # z goes through every placement unchanged (axis 2 -> 2, not reversed),
    # so the periodic wrap joins matching planes
    for sb in tp.superblocks:
        assert sb.shape[2] == 8
        for pl in sb.members:
            assert pl.perm[2] == 2 and pl.inv[2] == 0 and pl.offset[2] == 0
    # pack / unpack round trip
    _, tx = _fields(cyl["tt"], seed=11)
    back = tbm.unpack_fields(tp, tbm.pack_fields(tp, tx))
    for a, b in zip(back, tx):
        assert torch.equal(a, b)


def _table_mv(plan, td, to, v):
    """What ``csrc/merged.cuh`` computes: diag * v + sum_f off_f * v[nbr_f]."""
    diag, off = cg_cuda_mb.flatten_ops(plan, td, to)
    nbr = cg_cuda_mb.neighbor_table(plan, "cpu").long()
    y = diag * v
    for f in range(6):
        y = y + off[:, f] * v[:, nbr[f]]
    return y


@pytest.mark.parametrize("which", ["tp", "tadv"], ids=["pressure", "advection"])
def test_merged_apply_and_table_match_domain_apply(cyl, which):
    """On the 3D operators: the table matvec == merged_apply == the port's
    domain_apply == the JAX package's domain_apply and merged_apply."""
    plan, tt = cyl["tplan"], cyl["tt"]
    ops = cyl[which]
    jops = cyl["jp" if which == "tp" else "jadv"]
    jx, tx = _fields(tt, seed=5)
    want = tst.domain_apply(ops, tx, tt)
    _cmp(jst.domain_apply(jops, jx, cyl["jt"]), want, "domain_apply")
    mops = tbm.pack_ops(plan, ops)
    got = tbm.unpack_fields(plan, tbm.merged_apply(plan, mops,
                                                   tbm.pack_fields(plan, tx)))
    _cmp(tuple(w.numpy() for w in want), got, "merged_apply")
    jm = jbm.pack_ops(cyl["jplan"], jops)
    jgot = jbm.merged_apply(cyl["jplan"], jm, jbm.pack_fields(cyl["jplan"], jx))
    _cmp(jgot, tbm.merged_apply(plan, mops, tbm.pack_fields(plan, tx)),
         "merged_apply vs JAX")
    td, to = tuple(m[0] for m in mops), tuple(m[1] for m in mops)
    v = cg_cuda_mb.flatten_fields(plan, tuple(x.unsqueeze(0) for x in
                                              tbm.pack_fields(plan, tx)))
    y = _table_mv(plan, td, to, v)
    got = tbm.unpack_fields(plan, tuple(
        u[0] for u in cg_cuda_mb.unflatten_fields(plan, y)))
    _cmp(tuple(w.numpy() for w in want), got, "table matvec")


def test_table_wraps_z_periodically(cyl):
    """Across -z / +z the table holds the circular roll inside each
    super-block: plane 0's -z neighbour is plane nz-1 of the same column."""
    plan = cyl["tplan"]
    nbr = cg_cuda_mb.neighbor_table(plan, "cpu").numpy()
    shapes = [tbm._sb_array_shape(plan, sb) for sb in plan.superblocks]
    base = 0
    for sh in shapes:
        n = int(np.prod(sh))
        idx = base + np.arange(n).reshape(sh)
        lo = nbr[4, base:base + n].reshape(sh)  # face 4: -z
        hi = nbr[5, base:base + n].reshape(sh)
        np.testing.assert_array_equal(lo, np.roll(idx, 1, axis=0))
        np.testing.assert_array_equal(hi, np.roll(idx, -1, axis=0))
        base += n


@pytest.mark.parametrize("which", ["tp", "tadv"], ids=["pressure", "advection"])
def test_fixed_faces_carry_zero_off(cyl, which):
    """The circular roll of the table (and of merged_apply) is harmless on
    the x / y faces only because a FIXED face's off-coefficient is zero;
    every other face is CONNECTED (a seam or the ring closure) or PERIODIC
    (z)."""
    tt = cyl["tt"]
    for b, (bt, op) in enumerate(zip(tt.blocks, cyl[which])):
        for f, spec in enumerate(bt.faces):
            ax = 2 - f // 2  # array axis of face f in (z, y, x)
            sl = [slice(None)] * 3
            sl[ax] = 0 if f % 2 == 0 else -1
            if spec.kind == BoundKind.FIXED:
                assert float(torch.abs(op.off[f][tuple(sl)]).max()) == 0.0, (b, f)
            else:
                assert spec.kind in (BoundKind.CONNECTED, BoundKind.PERIODIC)


# ---------------------------------------------------------------------------
# solver pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,det_divide", [("velocity", True),
                                              ("pressure", False)])
def test_nonortho_matrix_terms_3d(cyl, field, det_divide):
    jr, tr = _fields(cyl["tt"], seed=6)
    jr = tuple(jnp.abs(r) + 0.5 for r in jr)
    tr = tuple(torch.abs(r) + 0.5 for r in tr)
    _cmp(jno.apply_matrix_terms(cyl["jadv"], cyl["jg"], cyl["jt"], jr,
                                det_divide, field),
         tno.apply_matrix_terms(cyl["tadv"], cyl["tg"], cyl["tt"], tr,
                                det_divide, field), f"{field} matrix terms")


def test_nonortho_deferred_rhs_3d(cyl):
    jt, jg, js, tt, tg, ts = (cyl[k] for k in ("jt", "jg", "js", "tt", "tg", "ts"))
    nu_j = tuple(jnp.full_like(g.det, 0.01) for g in jg)
    nu_t = tuple(torch.full_like(g.det, 0.01) for g in tg)
    for d in range(3):
        _cmp(jno.deferred_rhs(
            tuple(b.velocity[d] for b in js.blocks), jg, jt, nu_j, "velocity",
            bval_fn=lambda b, f: js.blocks[b].faces[f].velocity[d],
            boundary_visc=js.viscosity),
            tno.deferred_rhs(
            tuple(b.velocity[d] for b in ts.blocks), tg, tt, nu_t, "velocity",
            bval_fn=lambda b, f: ts.blocks[b].faces[f].velocity[d],
            boundary_visc=ts.viscosity), f"deferred rhs u{d}", 1e-5)
    jp = tuple(b.pressure for b in js.blocks)
    tp = tuple(b.pressure for b in ts.blocks)
    ja, ta = _fields(tt, seed=8)
    ja = tuple(jnp.abs(a) + 0.5 for a in ja)
    ta = tuple(torch.abs(a) + 0.5 for a in ta)
    _cmp(jno.deferred_rhs_flux(jp, jg, jt, ja), tno.deferred_rhs_flux(tp, tg, tt, ta),
         "deferred rhs flux", 1e-5)


def _face_velocities(state):
    return [[fd.velocity for fd in blk.faces] for blk in state.blocks]


def _cmp_faces(jstate, tstate, what):
    for b, (jf, tf) in enumerate(zip(_face_velocities(jstate),
                                     _face_velocities(tstate))):
        for f, (a, c) in enumerate(zip(jf, tf)):
            assert (a is None) == (c is None), (what, b, f)
            if a is not None:
                _cmp(a, c, f"{what} b{b} f{f}")


def test_balance_fluxes_over_jets_and_outflow_3d(cyl):
    """The jet env's rebalancing (tol 1e-7) on a state whose jets and
    outflow leave a net flux."""
    free = ((1, 2), (3, 3), (4, 1))
    jo = jbd.balance_boundary_fluxes(cyl["js"], cyl["jg"], cyl["jt"], free, tol=1e-7)
    to = tbd.balance_boundary_fluxes(cyl["ts"], cyl["tg"], cyl["tt"], free, tol=1e-7)
    _cmp_faces(jo, to, "balanced")
    # the outflow face was rescaled
    assert not torch.equal(to.blocks[4].faces[1].velocity,
                           cyl["ts"].blocks[4].faces[1].velocity)


def test_convective_outflow_hook_3d(cyl):
    kw = dict(out_faces=((4, 1),), char_vel=(1.0, 0.0, 0.0), tol=5e-6)
    jo = jbd.make_convective_outflow_hook(cyl["jg"], cyl["jt"], **kw)(
        cyl["js"], time_step=jnp.asarray(0.013, jnp.float32))
    to = tbd.make_convective_outflow_hook(cyl["tg"], cyl["tt"], **kw)(
        cyl["ts"], time_step=torch.tensor(0.013))
    _cmp_faces(jo, to, "outflow")


def test_deflation_basis_and_guess_3d(cyl):
    """The basis, and the guess ``W E^+ W^T b`` (cold and from a base) in
    float64, held to 1e-7 (measured 3.0e-8: the pseudo-inverse of the
    15 x 15 E, whose SVDs differ between the packages, amplifies the
    rounding of E's cancelling sums; 1e-9 in 2D,
    ``tests/test_torch_cg_mb.py``, and ~1e-3 in float32)."""
    tt = cyl["tt"]
    tw = tpiso._deflation_basis(tt, torch.float32, torch.device("cpu"))
    jw = jpiso._deflation_basis(cyl["jt"], jnp.float32)
    assert tw[0].shape[0] == 15  # 5 blocks x (1 + 2): no ramp along periodic z
    _cmp(jw, tw, "basis")
    rng = np.random.default_rng(9)
    b = [np.asarray(o, np.float64) for o in jst.domain_apply(
        cyl["jp"], tuple(jnp.asarray(rng.standard_normal(bt.shape), jnp.float32)
                         for bt in tt.blocks), cyl["jt"])]
    base = [np.asarray(blk.pressure, np.float64) for blk in cyl["js"].blocks]
    with jax.enable_x64(True):
        jp = tuple(jst.StencilOp(o.diag.astype(jnp.float64),
                                 o.off.astype(jnp.float64)) for o in cyl["jp"])
        jx0 = jpiso._make_deflation_x0(jp, cyl["jt"], jnp.float64)
        jb = tuple(jnp.asarray(x) for x in b)
        want = [[np.asarray(g) for g in jx0(jb)],
                [np.asarray(g) for g in jx0(jb, base=tuple(
                    jnp.asarray(x) for x in base))]]
    tp = tuple(tst.StencilOp(o.diag.double(), o.off.double()) for o in cyl["tp"])
    tx0 = tpiso._make_deflation_x0(tp, tt, torch.float64)
    tb = tuple(torch.from_numpy(x) for x in b)
    got = [tx0(tb), tx0(tb, base=tuple(torch.from_numpy(x) for x in base))]
    _cmp(want, got, "deflation guess", 1e-7)


# ---------------------------------------------------------------------------
# K3 and K2 in merged form on the 3D plan
# ---------------------------------------------------------------------------

def _pack_j(plan, ops):
    m = jbm.pack_ops(plan, ops)
    return tuple(a[0] for a in m), tuple(a[1] for a in m)


def _pack_t(plan, ops):
    m = tbm.pack_ops(plan, ops)
    return tuple(a[0] for a in m), tuple(a[1] for a in m)


def _assert_solve(j, t, what, it_slack, rtol):
    (xj, ij), (xt, it) = j, t
    assert bool(ij.converged) and bool(it.converged), (what, ij, it)
    assert abs(int(it.iterations) - int(ij.iterations)) <= it_slack, (what, ij, it)
    scale = max(np.abs(x).max() for x in xj)
    err = max(np.abs(a - b).max() for a, b in zip(xt, xj))
    assert err <= rtol * scale, f"{what}: max|dx| {err:.3e} > {rtol} * {scale:.3e}"


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "deflated"])
def test_k3_plain_matches_pallas_3d(cyl, warm):
    jplan, tplan, tt = cyl["jplan"], cyl["tplan"], cyl["tt"]
    rng = np.random.default_rng(7)
    fields = [rng.standard_normal(bt.shape).astype(np.float32) for bt in tt.blocks]
    b = [np.array(o) for o in jst.domain_apply(
        cyl["jp"], tuple(jnp.asarray(f) for f in fields), cyl["jt"])]
    x0 = None
    if warm:  # the env's start: the deflated guess from the last pressure
        x0 = [np.array(o) for o in jpiso._make_deflation_x0(
            cyl["jp"], cyl["jt"], jnp.float32)(
            tuple(jnp.asarray(v) for v in b),
            base=tuple(blk.pressure for blk in cyl["js"].blocks))]
    kw = dict(tol=TOL, maxiter=3000, stall_iters=250, precondition=True,
              return_best=True)
    jd, jo = _pack_j(jplan, cyl["jp"])
    td, to = _pack_t(tplan, cyl["tp"])
    pj = lambda fs: None if fs is None else jbm.pack_fields(
        jplan, tuple(jnp.asarray(f) for f in fs))
    pt = lambda fs: None if fs is None else tbm.pack_fields(
        tplan, tuple(torch.from_numpy(f) for f in fs))
    xj, ij = cg_pallas_mb.fused_cg_mb(jplan, jd, jo, pj(b), pj(x0),
                                      interpret=True, **kw)
    calls = cg_cuda_mb.fused_cg_mb_plain.calls
    xt, it = cg_cuda_mb.fused_cg_mb(tplan, td, to, pt(b), pt(x0), **kw)
    assert cg_cuda_mb.fused_cg_mb_plain.calls == calls + 1
    assert int(it.iterations) > 20
    _assert_solve(([np.asarray(x) for x in xj], ij), ([x.numpy() for x in xt], it),
                  "K3-3D", 3, 2e-4)


def test_k2mb_plain_matches_pallas_3d(cyl):
    """The velocity advection solve: 3 component lanes."""
    jplan, tplan, tt = cyl["jplan"], cyl["tplan"], cyl["tt"]
    rng = np.random.default_rng(12)
    b = [rng.standard_normal((3,) + bt.shape).astype(np.float32) for bt in tt.blocks]

    def pack(pack_fields, plan, conv):
        per_c = [pack_fields(plan, tuple(conv(f[c]) for f in b)) for c in range(3)]
        return per_c

    jc = pack(jbm.pack_fields, jplan, jnp.asarray)
    tc = pack(tbm.pack_fields, tplan, torch.from_numpy)
    jb = tuple(jnp.stack([jc[c][s] for c in range(3)]) for s in range(2))
    tb = tuple(torch.stack([tc[c][s] for c in range(3)]) for s in range(2))
    kw = dict(tol=1e-6, maxiter=400, stall_iters=250, precondition=True,
              return_best=True)
    jd, jo = _pack_j(jplan, cyl["jadv"])
    td, to = _pack_t(tplan, cyl["tadv"])
    xj, ij = cg_pallas_mb.fused_bicgstab_mb(jplan, jd, jo, jb, None,
                                            interpret=True, **kw)
    calls = cg_cuda_mb.fused_bicgstab_plain.calls
    xt, it = cg_cuda_mb.fused_bicgstab_mb(tplan, td, to, tb, None, **kw)
    assert cg_cuda_mb.fused_bicgstab_plain.calls == calls + 1
    assert int(it.iterations) >= 2
    _assert_solve(([np.asarray(x) for x in xj], ij), ([x.numpy() for x in xt], it),
                  "K2-mb-3D", 2, 1e-4)


# ---------------------------------------------------------------------------
# forces and sensors
# ---------------------------------------------------------------------------

def test_compute_forces_3d_matches_jax():
    rng = np.random.default_rng(21)
    Z, N = 5, 32
    args = [rng.standard_normal((3, Z, N)), rng.standard_normal((3, Z, N)),
            rng.standard_normal((Z, N)), rng.standard_normal((2, N)),
            rng.uniform(0.1, 1.0, N), rng.uniform(0.01, 0.1, N),
            rng.uniform(0.1, 0.5, N)]
    with jax.enable_x64(True):
        want = np.asarray(jforces.compute_forces_3d(
            *[jnp.asarray(a) for a in args], jnp.asarray(0.004)))
    got = tforces.compute_forces_3d(*[torch.from_numpy(a) for a in args], 0.004)
    assert got.shape == (2, Z)
    assert_rel(got.numpy(), want, 1e-12, "forces")


def test_wall_forces_per_z_slice_match_jax(cyl):
    """The env's wall geometry (one z-slice of the loop) and drag / lift per
    z-slice on the perturbed state."""
    jenv, tenv = cyl["jenv"], cyl["tenv"]
    for name in ("_tangent_lengths", "_wall_distances", "_wall_normals",
                 "_wall_face_lengths"):
        _cmp(getattr(jenv, name), getattr(tenv, name), name)
    jcd, jcl = jenv._pure_drag_lift(cyl["js"])
    tcd, tcl = tenv._pure_drag_lift(cyl["ts"])
    assert tcd.shape == (8,)
    _cmp(jcd, tcd, "cd per slice", 1e-5)
    _cmp(jcl, tcl, "cl per slice", 1e-5)


def test_sensor_point_plans_3d_match_jax(cyl):
    """The mid-z plan of the 151 sensors and the z-stacked cloud (151 x 8
    points at 4 jets): the same fields sampled by both packages."""
    jenv, tenv = cyl["jenv"], cyl["tenv"]
    centers = [g.centers.numpy() for g in cyl["tg"]]
    pts = tenv._sensor_sample3  # noqa: F841  (built at reset)
    s2d = tenv._get_sensor_locations_2d()
    n_z = tenv._n_sensors_z
    zs = tenv._sensor_z()
    cloud = np.stack([np.tile(s2d[0], (n_z, 1)), np.tile(s2d[1], (n_z, 1)),
                      np.repeat(zs[:, None], s2d.shape[1], axis=1)],
                     axis=-1).reshape(-1, 3)
    assert cloud.shape == (151 * 8, 3)
    mid = np.concatenate([s2d.T, np.zeros((151, 1))], axis=1)
    jx, tx = _fields(cyl["tt"], lead=(3,), seed=13)
    for p in (mid, cloud):
        want = jpoint_plan(centers, p)(jx)
        _cmp(want, tpoint_plan(centers, p)(tx), "point plan")
    _cmp(jenv._sensor_sample(jx), tenv._sensor_sample(tx), "env mid-z plan")
    _cmp(jenv._sensor_sample3(jx), tenv._sensor_sample3(tx), "env cloud plan")
    np.testing.assert_array_equal(tenv._sensor_locations, jenv._sensor_locations)
    np.testing.assert_array_equal(tenv._cylinder_mask, jenv._cylinder_mask)
    assert tenv._cylinder_mask.shape == (32, 32, 171)


def test_render_fields_3d_match_jax(cyl):
    """``get_velocity`` (zero inside the cylinder) and ``get_pressure`` on
    the uniform render grid, (32, 32, 171) at resolution 8, from one
    state; the port builds the resample plan on first use."""
    jenv, tenv = cyl["jenv"], cyl["tenv"]
    before = (jenv._state, tenv._state)
    jenv._state, tenv._state = cyl["js"], cyl["ts"]
    try:
        assert tenv._resample is None
        u = tenv.get_velocity()
        assert u.shape == (3, 32, 32, 171)
        assert bool((u[:, torch.from_numpy(tenv._cylinder_mask)] == 0).all())
        _cmp(jenv.get_velocity(), u, "velocity on the render grid")
        _cmp(jenv.get_pressure(), tenv.get_pressure(), "pressure on the render grid")
    finally:
        jenv._state, tenv._state = before


@pytest.mark.parametrize("cells", [341568, 749568], ids=["easy", "medium"])
def test_3d_lanes_take_the_chunk_grid(cyl, cells):
    """At the registered 3D widths no cluster size holds a block's rows in
    shared memory (~1.1 MB per block at C = 16 for easy): the cluster rule
    can only give 1 (on the card ``merged_arm`` then takes the spread arm,
    ``tests/test_torch_merged_spread_rule.py``), and a forced C > 1 is
    refused before the plan is read or anything is built or launched."""
    assert cg_cuda_mb.stage_bytes(cells, 16, 3) > 1_000_000
    b = torch.zeros((1, cells))
    diag, off = torch.ones((1, cells)), torch.zeros((1, 6, cells))
    for C in cg_cuda_mb.CLUSTER_SIZES:
        assert not cg_cuda_mb.rows_fit(cells, C, 3)
        with pytest.raises(ValueError, match="do not fit"):
            cg_cuda_mb.merged_launcher(
                "cg", cyl["tplan"], diag, off, b, None, tol2_sum=1e-6,
                maxiter=1, stall_iters=1, precondition=True, return_best=True,
                chunk=1, cluster=C)
