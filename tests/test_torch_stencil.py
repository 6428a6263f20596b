"""Single-block stencil operators of the PyTorch port against
``fluidgym_tpu.solver.stencil`` on the same RBC state (pointwise parity
bar: <= 1e-6 relative to each field's scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.solver import block_merge as tbm
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import SMALL_RBC_KW, assert_rel

torch.set_num_threads(1)
RTOL = 1e-6


@pytest.fixture(scope="module")
def states():
    """The same random RBC domain in both packages, with a non-uniform
    bottom-plate temperature and a non-zero velocity source."""
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", **SMALL_RBC_KW)
    tenv = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **SMALL_RBC_KW)
    jenv.seed(11)
    tenv.seed(11)
    jt, jg, js = jenv._get_domain()
    tt, tg, ts = tenv._get_domain()
    rng = np.random.default_rng(5)
    act = rng.uniform(-1, 1, (4, 1)).astype(np.float32)
    js = jenv._pure_apply_action(js, jnp.asarray(act))
    ts = tenv._pure_apply_action(ts, torch.from_numpy(act))
    js = jenv._get_prep_fn()["PRE_VELOCITY_SETUP"][0](js)
    ts = tenv._get_prep_fn()["PRE_VELOCITY_SETUP"][0](ts)
    return (jt, jg, js), (tt, tg, ts)


def _cmp(j, t, what):
    if isinstance(j, (tuple, list)):
        for i, (a, b) in enumerate(zip(j, t)):
            _cmp(a, b, f"{what}[{i}]")
        return
    if hasattr(j, "diag"):
        _cmp(j.diag, t.diag, what + ".diag")
        _cmp(j.off, t.off, what + ".off")
        return
    assert_rel(t.numpy(), np.asarray(j), RTOL, what)


def test_advection_ops_and_rhs(states):
    (jt, jg, js), (tt, tg, ts) = states
    dt_j, dt_t = jnp.asarray(0.03, jnp.float32), torch.tensor(0.03)
    _cmp(jst.build_advection_ops(js, jg, jt, js.viscosity, dt_j),
         tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_t), "vel ops")
    k_j, k_t = js.scalar_diffusivity[0], ts.scalar_diffusivity[0]
    _cmp(jst.build_advection_ops(js, jg, jt, k_j, dt_j, for_scalar=True),
         tst.build_advection_ops(ts, tg, tt, k_t, dt_t, for_scalar=True),
         "scalar ops")
    _cmp(jst.advection_rhs_velocity(js, jg, jt, js.viscosity, dt_j),
         tst.advection_rhs_velocity(ts, tg, tt, ts.viscosity, dt_t), "vel rhs")
    _cmp(jst.advection_rhs_scalar(js, jg, jt, k_j, dt_j, 0),
         tst.advection_rhs_scalar(ts, tg, tt, k_t, dt_t, 0), "scalar rhs")


def test_pressure_system_and_correction(states):
    (jt, jg, js), (tt, tg, ts) = states
    dt_j, dt_t = jnp.asarray(0.03, jnp.float32), torch.tensor(0.03)
    jops = jst.build_advection_ops(js, jg, jt, js.viscosity, dt_j)
    tops = tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_t)
    ju = tuple(b.velocity * 1.1 for b in js.blocks)
    tu = tuple(b.velocity * 1.1 for b in ts.blocks)
    jp = jst.build_pressure_ops(tuple(o.diag for o in jops), jg, jt)
    tp = tst.build_pressure_ops(tuple(o.diag for o in tops), tg, tt)
    _cmp(jp, tp, "pressure ops")
    jh = jst.pressure_rhs_vec(js, jg, jt, jops, ju, js.viscosity, dt_j)
    th = tst.pressure_rhs_vec(ts, tg, tt, tops, tu, ts.viscosity, dt_t)
    _cmp(jh, th, "hbyA")
    _cmp(jst.divergence_of(jh, js, jg, jt), tst.divergence_of(th, ts, tg, tt),
         "divergence")
    rng = np.random.default_rng(2)
    p = rng.normal(size=tt.blocks[0].shape).astype(np.float32)
    _cmp(jst.domain_apply(jp, (jnp.asarray(p),), jt),
         tst.domain_apply(tp, (torch.from_numpy(p),), tt), "pressure apply")
    _cmp(jst.correct_velocity_fd(jh, (jnp.asarray(p),), tuple(o.diag for o in jops),
                                 jg, jt, dt_j),
         tst.correct_velocity_fd(th, (torch.from_numpy(p),),
                                 tuple(o.diag for o in tops), tg, tt, dt_t),
         "FD correction")
    mj = float(jst.max_computational_velocity(js, jg, jt))
    mt = float(tst.max_computational_velocity(ts, tg, tt))
    assert abs(mj - mt) <= RTOL * abs(mj)


def test_trivial_plan_pack_unpack(states):
    (jt, jg, js), (tt, tg, ts) = states
    dt_j, dt_t = jnp.asarray(0.03, jnp.float32), torch.tensor(0.03)
    jops = jst.build_advection_ops(js, jg, jt, js.viscosity, dt_j)
    tops = tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_t)
    jplan, tplan = jbm.trivial_plan(jt), tbm.trivial_plan(tt)
    jm, tm = jbm.pack_ops(jplan, jops), tbm.pack_ops(tplan, tops)
    _cmp(jm[0][0], tm[0][0], "packed diag")
    _cmp(jm[0][1], tm[0][1], "packed off")
    field = tuple(b.scalar[0] for b in ts.blocks)
    packed = tbm.pack_fields(tplan, field)
    back = tbm.unpack_fields(tplan, packed)
    assert torch.equal(back[0], field[0])
    _cmp(jbm.pack_fields(jplan, tuple(b.scalar[0] for b in js.blocks)), packed,
         "packed field")
