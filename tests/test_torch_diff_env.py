"""The differentiable env path of the PyTorch port against the JAX package,
in float64 on the CPU.

* ``scripts/validate_gradients.py``'s env cases: RBC2D-easy
  (``n_heaters=4, resolution=6``) here, CylinderJet2D-easy
  (``resolution=8, step_length=dt=0.05``) in
  ``tests/test_torch_diff_cylinder.py``; solver tolerances 1e-10, the
  port's steps with fixed actions (3 / 1), then d(reward)/d(action)
  through ``_pure_step`` against ``jax.grad`` of the JAX env's
  ``_pure_step`` at the same carry within 1e-5 of max|g|;
* the twin of ``tests/test_solver_health.py:77`` (diff mode reports
  converged, 0 iterations), the env contract in diff mode (obs and reward
  carry the graph, ``info`` detached, ``detach()``), and the families
  whose differentiable path is not ported raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu_torch.envs.fluid_env import env_state_to_numpy
from fluidgym_tpu_torch.parallel import BatchedFluidEnv
from fluidgym_tpu_torch.solver import piso as tpiso
from torch_port_helpers import (CYL_KW, SMALL_RBC_KW, assert_rel,
                                jax_domain_state)

torch.set_num_threads(1)
F64 = torch.float64
TIGHT = dict(pressure_tol=1e-10, advection_tol=1e-10, pressure_maxiter=20000,
             advection_maxiter=20000)


def _np(t):
    return t.detach().cpu().numpy()


def _tighten(env):
    orig = env._get_simulation
    env._get_simulation = lambda: dataclasses.replace(orig(), **TIGHT)
    return env


CASES = {
    "rbc2d": ("RBC2D-easy-v0",
              dict(n_heaters=4, resolution=6, step_length=0.1, dt=0.05),
              [np.full((4, 1), 0.3 * (i - 1)) for i in range(3)]),
    "cylinder2d": ("CylinderJet2D-easy-v0",
                   dict(resolution=8, step_length=0.05, dt=0.05),
                   [np.array([0.5])]),
}


def check_action_gradient(case):
    """d(reward)/d(action) through ``_pure_step`` of the port against the
    JAX package's (``CASES[case]``): the port steps from ``reset(seed=0)``,
    the JAX package takes the gradient at the port's carry (the state, and
    the cylinder's smoothed control)."""
    env_id, kw, actions = CASES[case]
    kw = dict(episode_length=4, differentiable=True, load_initial_domain=False,
              load_domain_statistics=False, randomize_initial_state=False, **kw)
    tenv = _tighten(fluidgym_tpu_torch.make(env_id, device="cpu", dtype=F64, **kw))
    tenv.reset(seed=0)
    for a in actions:
        tenv.step(torch.as_tensor(a, dtype=F64))
    carry = tenv._pure_carry()
    a0 = torch.zeros(tenv.action_space.shape, dtype=F64, requires_grad=True)
    _, _, reward, info = tenv._pure_step(carry, a0)
    torch.sum(reward).backward()
    g = _np(a0.grad)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    assert int(info["pressure_iterations"]) == 0

    host = env_state_to_numpy(tenv.get_state())
    with jax.enable_x64(True):
        jenv = _tighten(fluidgym_tpu.make(env_id, dtype=jnp.float64, **kw))
        jenv.reset(seed=0)
        jstate = jax_domain_state(host.domain, np.float64)
        jcarry = jstate if len(carry) == 1 else (jstate, jnp.asarray(
            host.additional_info["last_control"], jnp.float64))

        def loss(action):
            _, _, r, _ = jenv._pure_step(jcarry, action)
            return jnp.sum(r)

        jg = np.asarray(jax.grad(loss)(jnp.zeros(a0.shape, jnp.float64)))
    assert_rel(g, jg, 1e-5, f"{env_id} d(reward)/d(action)")


def test_action_gradient_matches_jax():
    """RBC2D-easy; CylinderJet2D-easy's case runs in
    ``tests/test_torch_diff_cylinder.py`` (its JAX trace alone takes ~45 s
    on the CPU)."""
    check_action_gradient("rbc2d")


# ---------------------------------------------------------------------------
# the env contract in diff mode
# ---------------------------------------------------------------------------

HEALTH_KW = dict(n_heaters=4, resolution=4, episode_length=8, step_length=0.1,
                 dt=0.05, load_initial_domain=False,
                 load_domain_statistics=False, randomize_initial_state=False)


def test_differentiable_path_reports_info():
    """The implicit-function solves report no iteration counts; the
    post-hoc residual check still reports convergence (as the JAX
    package's ``tests/test_solver_health.py:77``)."""
    env = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu",
                                  differentiable=True, **HEALTH_KW)
    env.seed(0)
    env.reset(seed=0)
    _, _, _, _, info = env.step(env.sample_action())
    assert bool(info["pressure_converged"])
    assert bool(info["advection_converged"])
    assert int(info["pressure_iterations"]) == 0
    assert 0.0 < float(info["pressure_residual"]) <= 1e-5


def test_env_step_carries_the_graph():
    env = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", dtype=F64,
                                  differentiable=True, **HEALTH_KW)
    assert env.differentiable and env._cfg is None
    env.reset(seed=0)
    assert env._cfg.differentiable
    grads = []
    for _ in range(2):
        a = torch.full(env.action_space.shape, 0.2, dtype=F64, requires_grad=True)
        obs, reward, _, _, info = env.step(a)
        assert reward.requires_grad
        assert all(v.requires_grad for v in obs.values())
        assert not any(torch.is_tensor(v) and v.requires_grad
                       for v in info.values())
        (torch.sum(reward) + torch.sum(obs["temperature"])).backward()
        grads.append(a.grad)
        # the second step's backward would reach the freed graph of the
        # first without this
        env.detach()
        assert not env._state.blocks[0].velocity.requires_grad
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grads)


@pytest.mark.parametrize("env_id", ["Airfoil2D-easy-v0", "CylinderRot2D-easy-v0",
                                    "RBC3D-easy-v0", "CylinderJet3D-easy-v0",
                                    "TCFSmall3D-bottom-easy-v0"])
def test_unported_families_raise(env_id):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        fluidgym_tpu_torch.make(env_id, device="cpu", differentiable=True,
                                load_initial_domain=False,
                                load_domain_statistics=False)


@pytest.mark.parametrize("env_id,kw", [
    ("RBC2D-medium-v0", {}), ("RBC2D-wide-easy-v0", {}),
    ("RBC2D-easy-v0", dict(resolution=16)),
    ("CylinderJet2D-medium-v0", {}), ("CylinderJet2D-hard-v0", {}),
    ("CylinderJet2D-easy-v0", dict(resolution=32))])
def test_unported_configurations_raise(env_id, kw):
    """The ported families take ``differentiable=True`` only where it was
    run: RBC2D-easy and CylinderJet2D-easy at their registered size or
    smaller (not the spread arm of wider grids, C = 16, the upwind blend)."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        fluidgym_tpu_torch.make(env_id, device="cpu", differentiable=True,
                                load_initial_domain=False,
                                load_domain_statistics=False, **kw)


def test_differentiable_cylinder_with_strips_raises():
    env = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu",
                                  differentiable=True,
                                  **dict(CYL_KW, resolution=8))
    env.reset(seed=0)
    env._cfg = dataclasses.replace(env._cfg, pressure_coarse_strips=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        env.step(np.zeros(env.action_space.shape, np.float32))


def test_batched_differentiable_raises():
    benv = BatchedFluidEnv("RBC2D-easy-v0", 2, device="cpu", differentiable=True,
                           **SMALL_RBC_KW)
    benv.reset(seed=0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        benv.step(np.zeros((2,) + benv.action_space.shape, np.float32))
    env = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **SMALL_RBC_KW)
    env.reset(seed=0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tpiso.batched_step_info(env._state, env._geoms, env._topo,
                                dataclasses.replace(env._cfg, differentiable=True))
