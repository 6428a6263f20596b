"""PISO main path of the PyTorch port against ``fluidgym_tpu.solver.piso``.

On the CPU the JAX package takes its XLA ``linsolve`` path (its fused gates
ask for Pallas, which the CPU backend only interprets), while the port takes
the plain versions of K1/K2.  Two differences follow, both within the
solver tolerances (1e-5): K2 stops per velocity component, ``linsolve``
jointly; and the sums of the dot products run in another order.  Bar: the
rollout bar, <= 1e-4 relative to each field's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.solver import piso as jpiso
from fluidgym_tpu_torch.core.domain import domain_state_from_numpy
from fluidgym_tpu_torch.solver import piso as tpiso
from torch_port_helpers import SMALL_RBC_KW, assert_rel

torch.set_num_threads(1)
RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", **SMALL_RBC_KW)
    tenv = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **SMALL_RBC_KW)
    jenv.reset(seed=2)
    tenv.reset(seed=2)
    js = jenv._state
    ts = domain_state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    return jenv, tenv, js, ts


def _cmp_states(js, ts, what):
    for k in ("velocity", "pressure", "scalar"):
        assert_rel(getattr(ts.blocks[0], k).numpy(),
                   np.asarray(getattr(js.blocks[0], k)), RTOL, f"{what} {k}")


def test_one_substep(setup):
    jenv, tenv, js, ts = setup
    dt = 0.02
    js1, ji = jax.jit(lambda s: jpiso.piso_substep_info(
        s, jenv._geoms, jenv._topo, jenv._cfg, jnp.asarray(dt, jnp.float32),
        jenv._hooks))(js)
    ts1, ti = tpiso.piso_substep_info(ts, tenv._geoms, tenv._topo, tenv._cfg,
                                      torch.tensor(dt), tenv._hooks)
    assert bool(ji.pressure_converged) and bool(ti.pressure_converged)
    assert bool(ji.advection_converged) and bool(ti.advection_converged)
    # two cold pressure solves: counts within 3 each
    assert abs(int(ji.pressure_iterations) - int(ti.pressure_iterations)) <= 6
    _cmp_states(js1, ts1, "substep")


def test_adaptive_step_substeps_and_state(setup):
    """One env-level dt: the port's host loop takes the JAX while-loop's
    substeps (first dt from the JAX CFL rule, count, sum = dt)."""
    jenv, tenv, js, ts = setup
    cfg = tenv._cfg
    ts_j, n_j = jpiso.get_max_time_step(js, jenv._geoms, jenv._topo, cfg.dt,
                                        cfl=cfg.adaptive_cfl)
    log = []
    ts1, ti = tpiso.single_step_info(ts, tenv._geoms, tenv._topo, cfg,
                                     tenv._hooks, dt_log=log)
    js1, ji = jax.jit(lambda s: jpiso.single_step_info(
        s, jenv._geoms, jenv._topo, jenv._cfg, jenv._hooks))(js)
    assert abs(float(log[0]) - float(ts_j)) <= 1e-7 * float(ts_j)
    assert len(log) >= int(n_j)
    assert abs(sum(float(d) for d in log) - cfg.dt) <= 1e-6
    assert abs(int(ji.pressure_iterations) - int(ti.pressure_iterations)) \
        <= 3 * 2 * len(log)
    _cmp_states(js1, ts1, "adaptive step")


def test_make_divergence_free(setup):
    """Projection of a strongly divergent velocity (noise added)."""
    from dataclasses import replace

    jenv, tenv, js, ts = setup
    noise = np.random.default_rng(9).normal(
        size=tuple(ts.blocks[0].velocity.shape)).astype(np.float32) * 0.2
    js = js.replace_block(0, replace(js.blocks[0],
                                     velocity=js.blocks[0].velocity + noise))
    ts = ts.replace_block(0, replace(ts.blocks[0], velocity=ts.blocks[0].velocity
                                     + torch.from_numpy(noise)))
    js1 = jpiso.make_divergence_free(js, jenv._geoms, jenv._topo, jenv._cfg)
    ts1 = tpiso.make_divergence_free(ts, tenv._geoms, tenv._topo, tenv._cfg)
    _cmp_states(js1, ts1, "projection")


def test_unported_options_raise():
    # SimConfig() builds with the JAX package's defaults, the differentiable
    # path among them; an option the port lacks still raises
    import dataclasses

    tcfg, jcfg = tpiso.SimConfig(), jpiso.SimConfig()
    assert tcfg.differentiable and jcfg.differentiable
    for f in dataclasses.fields(tcfg):
        if f.compare and hasattr(jcfg, f.name):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    with pytest.raises(NotImplementedError, match="pressure_coarse_tile"):
        tpiso.SimConfig(pressure_coarse_precondition=True)
    # non_orthogonal is ported (curvilinear slice), and so is the upwind
    # blend that the cylinder's hard tier needs
    assert tpiso.SimConfig(differentiable=False, non_orthogonal=True).non_orthogonal
    env = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu",
                                  reynolds_number=500,
                                  load_initial_domain=False,
                                  load_domain_statistics=False)
    assert env._get_simulation().advection_upwind_blend == 0.3
