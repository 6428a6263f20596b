"""Multi-block, curvilinear operators of the PyTorch port against the JAX
package on the same CylinderJet2D state at resolution 16 (5 blocks, 4
CONNECTED seams): every CONNECTED halo, ``domain_apply``, the curvilinear
advection/pressure operators, the non-orthogonal corrections and the
convective outflow hook.  Bar: <= 1e-6 relative to each field's scale (the
arithmetic is the same, in float32; only summation order may differ)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.solver import boundaries as jbd
from fluidgym_tpu.solver import nonortho as jno
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.core.domain import (BoundKind, domain_state_from_numpy,
                                            domain_state_to_numpy)
from fluidgym_tpu_torch.solver import boundaries as tbd
from fluidgym_tpu_torch.solver import nonortho as tno
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import CYL_KW, assert_rel

torch.set_num_threads(1)
RTOL = 1e-6


@pytest.fixture(scope="module")
def cyl():
    """The same perturbed cylinder state in both packages (noise on the
    velocity, a random pressure, jets at 0.7, a non-trivial outflow)."""
    jenv = fluidgym_tpu.make("CylinderJet2D-easy-v0", **CYL_KW)
    tenv = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu", **CYL_KW)
    jenv.reset(seed=0)
    tenv.reset(seed=0)
    js = jenv._pure_apply_action(jenv._state, jnp.asarray([0.7], jnp.float32))
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
    return ((jenv._topo, jenv._geoms, js), (tenv._topo, tenv._geoms, ts),
            jenv, tenv)


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


def _connected(topo):
    return [(b, f) for b, bt in enumerate(topo.blocks)
            for f, s in enumerate(bt.faces) if s.kind == BoundKind.CONNECTED]


def test_geometry_and_topology_match(cyl):
    (jt, jg, _), (tt, tg, _), _, _ = cyl
    assert [b.shape for b in tt.blocks] == [b.shape for b in jt.blocks]
    for jb, tb in zip(jt.blocks, tt.blocks):
        assert [(f.kind.name, f.connected_block, f.connected_face, f.axes)
                for f in tb.faces] == [(f.kind.name, f.connected_block,
                                        f.connected_face, f.axes) for f in jb.faces]
        assert tb.orthogonal == jb.orthogonal
    assert len(_connected(tt)) == 10  # 5 seams, both sides
    for a, b in zip(jg, tg):
        for name in ("det", "alpha", "centers", "minv", "minv_diag"):
            ja, ta = getattr(a, name), getattr(b, name)
            assert (ja is None) == (ta is None), name
            if ja is not None:
                assert_rel(ta.numpy(), np.asarray(ja), RTOL, name)


def test_state_carries_across_and_back(cyl):
    """The 5-block state, face data included (jets, outflow; CONNECTED faces
    carry none), goes numpy -> port -> numpy unchanged."""
    (_, _, js), (_, _, ts), _, _ = cyl
    back = domain_state_to_numpy(ts)
    assert len(back.blocks) == 5
    for jb, tb in zip(js.blocks, back.blocks):
        for name in ("velocity", "pressure"):
            np.testing.assert_array_equal(getattr(tb, name),
                                          np.asarray(getattr(jb, name)))
        for jf, tf in zip(jb.faces, tb.faces):
            assert (jf.velocity is None) == (tf.velocity is None)
            if jf.velocity is not None:
                np.testing.assert_array_equal(tf.velocity, np.asarray(jf.velocity))
    np.testing.assert_array_equal(back.viscosity, np.asarray(js.viscosity))


@pytest.mark.parametrize("lead", [(), (2,)], ids=["scalar", "channels"])
def test_every_connected_halo(cyl, lead):
    """Each CONNECTED face pair on its own, for scalar and channel fields:
    the remapped slab and the neighbour field with its halo."""
    (jt, _, _), (tt, _, _), _, _ = cyl
    jx, tx = _fields(tt, lead, seed=1)
    for b, f in _connected(tt):
        spec_t, spec_j = tt.blocks[b].faces[f], jt.blocks[b].faces[f]
        nb = spec_t.connected_block
        _cmp(jst._halo(jx[nb], spec_j, f, 2), tst._halo(tx[nb], spec_t, f, 2),
             f"halo b{b} f{f}")
        _cmp(jst._neighbor_field(jx, b, f, jt), tst._neighbor_field(tx, b, f, tt),
             f"neighbor b{b} f{f}")


@pytest.mark.parametrize("lead", [(), (2,)], ids=["scalar", "channels"])
def test_domain_apply_multiblock(cyl, lead):
    (jt, _, _), (tt, _, _), _, _ = cyl
    rng = np.random.default_rng(2)
    jops, tops = [], []
    for bt in tt.blocks:
        d = rng.standard_normal(bt.shape).astype(np.float32)
        o = rng.standard_normal((4,) + bt.shape).astype(np.float32)
        jops.append(jst.StencilOp(jnp.asarray(d), jnp.asarray(o)))
        tops.append(tst.StencilOp(torch.from_numpy(d), torch.from_numpy(o)))
    jx, tx = _fields(tt, lead, seed=4)
    _cmp(jst.domain_apply(tuple(jops), jx, jt),
         tst.domain_apply(tuple(tops), tx, tt), "domain_apply")
    _cmp(jst.domain_off_apply(tuple(jops), jx, jt),
         tst.domain_off_apply(tuple(tops), tx, tt), "domain_off_apply")


def test_curvilinear_operators(cyl):
    (jt, jg, js), (tt, tg, ts), _, _ = cyl
    dj, dt_ = jnp.asarray(0.013, jnp.float32), torch.tensor(0.013)
    jops = jst.build_advection_ops(js, jg, jt, js.viscosity, dj)
    tops = tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_)
    _cmp(jops, tops, "advection ops")
    _cmp(jst.advection_rhs_velocity(js, jg, jt, js.viscosity, dj),
         tst.advection_rhs_velocity(ts, tg, tt, ts.viscosity, dt_), "vel rhs")
    jad = tuple(o.diag for o in jops)
    tad = tuple(o.diag for o in tops)
    _cmp(jst.build_pressure_ops(jad, jg, jt), tst.build_pressure_ops(tad, tg, tt),
         "pressure ops")
    ju = tuple(b.velocity * 0.9 for b in js.blocks)
    tu = tuple(b.velocity * 0.9 for b in ts.blocks)
    jh = jst.pressure_rhs_vec(js, jg, jt, jops, ju, js.viscosity, dj)
    th = tst.pressure_rhs_vec(ts, tg, tt, tops, tu, ts.viscosity, dt_)
    _cmp(jh, th, "hbyA")
    _cmp(jst.divergence_of(jh, js, jg, jt), tst.divergence_of(th, ts, tg, tt),
         "divergence", 1e-5)
    jp = tuple(b.pressure for b in js.blocks)
    tp = tuple(b.pressure for b in ts.blocks)
    _cmp(jst.pressure_gradient(jp, jg, jt), tst.pressure_gradient(tp, tg, tt),
         "pressure gradient")
    _cmp(jst.correct_velocity_fd(jh, jp, jad, jg, jt, dj),
         tst.correct_velocity_fd(th, tp, tad, tg, tt, dt_), "corrected velocity")
    _cmp(jst.max_computational_velocity(js, jg, jt),
         tst.max_computational_velocity(ts, tg, tt), "max computational velocity")


@pytest.mark.parametrize("field,det_divide", [("velocity", True),
                                              ("pressure", False)])
def test_nonortho_matrix_terms(cyl, field, det_divide):
    (jt, jg, js), (tt, tg, ts), _, _ = cyl
    dj, dt_ = jnp.asarray(0.013, jnp.float32), torch.tensor(0.013)
    jops = jst.build_advection_ops(js, jg, jt, js.viscosity, dj)
    tops = tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_)
    jr, tr = _fields(tt, seed=6)
    jr = tuple(jnp.abs(r) + 0.5 for r in jr)
    tr = tuple(torch.abs(r) + 0.5 for r in tr)
    _cmp(jno.apply_matrix_terms(jops, jg, jt, jr, det_divide, field),
         tno.apply_matrix_terms(tops, tg, tt, tr, det_divide, field),
         f"{field} matrix terms")


def test_nonortho_deferred_rhs(cyl):
    (jt, jg, js), (tt, tg, ts), _, _ = cyl
    nu_j = tuple(jnp.full_like(g.det, 0.01) for g in jg)
    nu_t = tuple(torch.full_like(g.det, 0.01) for g in tg)
    for d in range(2):
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
    _cmp(jno.deferred_rhs(jp, jg, jt, ja, "pressure", include_direct=True),
         tno.deferred_rhs(tp, tg, tt, ta, "pressure", include_direct=True),
         "deferred rhs pressure", 1e-5)
    _cmp(jno.deferred_rhs_flux(jp, jg, jt, ja), tno.deferred_rhs_flux(tp, tg, tt, ta),
         "deferred rhs flux", 1e-5)


def test_convective_outflow_hook(cyl):
    (jt, jg, js), (tt, tg, ts), _, _ = cyl
    kw = dict(out_faces=((4, 1),), char_vel=(1.0, 0.0), tol=5e-6)
    jo = jbd.make_convective_outflow_hook(jg, jt, **kw)(
        js, time_step=jnp.asarray(0.013, jnp.float32))
    to = tbd.make_convective_outflow_hook(tg, tt, **kw)(
        ts, time_step=torch.tensor(0.013))
    for b in range(5):
        for f, (jf, tf) in enumerate(zip(jo.blocks[b].faces, to.blocks[b].faces)):
            assert (jf.velocity is None) == (tf.velocity is None)
            if jf.velocity is not None:
                _cmp(jf.velocity, tf.velocity, f"face velocity b{b} f{f}")
