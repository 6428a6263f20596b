"""Airfoil2D-easy-v0 contract in the port (twins of
``tests/test_airfoil_env.py:19,38,52,103``), from the bundled ``train_00``
snapshot at the registered width: registry entry, 2D observation/action
shapes and a finite step, attack-angle validation, the zero-mean jet
multiplier, the options that raise, and the ``get_state``/``set_state``
round trip through numpy with the smoothed control.
"""

import numpy as np
import pytest
import torch

import fluidgym_tpu_torch
from fluidgym_tpu_torch.envs.fluid_env import (env_state_from_numpy,
                                               env_state_to_numpy)

torch.set_num_threads(1)
ID = "Airfoil2D-easy-v0"
KW = dict(device="cpu", randomize_initial_state=False, episode_length=2,
          step_length=0.05, dt=0.05)


@pytest.fixture(scope="module")
def env():
    e = fluidgym_tpu_torch.make(ID, **KW)
    e.reset(seed=0)
    return e


def test_airfoil_registry():
    assert ID in fluidgym_tpu_torch.registry.ids()
    cfg = fluidgym_tpu_torch.registry._entries[ID][1]
    assert cfg["reynolds_number"] == 1e3 and cfg["attack_angle_deg"] == 10.0


def test_airfoil_2d_contract(env):
    obs = env._get_global_obs()
    n = env._sensor_locations.shape[-1]
    assert n == 209
    assert tuple(obs["velocity"].shape) == (n, 2)
    assert tuple(obs["pressure"].shape) == (n,)
    assert env.action_space.shape == (3,)
    assert env.observation_space["velocity"].shape == (n, 2)
    assert len(env._topo.blocks) == 6
    assert sum(int(np.prod(b.shape)) for b in env._topo.blocks) == 73456
    before = env.get_state()
    obs, r, te, tr, info = env.step(np.array([1.0, -0.5, -0.5], np.float32))
    assert np.isfinite(float(r))
    assert np.isfinite(float(info["drag"])) and float(info["drag"]) > 0
    assert np.isfinite(float(info["lift"]))
    assert bool(info["pressure_converged"])
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert not torch.equal(env._last_control, before.additional_info["last_control"])
    env.set_state(before)


def test_airfoil_attack_angle_validation():
    with pytest.raises(ValueError):
        fluidgym_tpu_torch.make(ID, attack_angle_deg=25.0, **KW)


def test_airfoil_unported_options_raise():
    # Re >= 3000 builds (the blend and the aggregation coarse space)
    cfg = fluidgym_tpu_torch.make(ID, reynolds_number=3e3, **KW)._get_simulation()
    assert cfg.advection_upwind_blend == 0.3
    assert cfg.pressure_coarse_tile == 8 and cfg.pressure_coarse_precondition
    # the JAX package's 2D airfoil has no multi-agent mode either
    with pytest.raises(ValueError, match="multi-agent"):
        fluidgym_tpu_torch.make(ID, use_marl=True, **KW)


def test_airfoil_action_zero_mean(env):
    """The jet multiplier removes the action mean and max-normalizes."""
    m = env._pure_action_multiplier(torch.tensor([2.0, 2.0, 2.0]))
    assert torch.allclose(m, torch.zeros_like(m))
    m = env._pure_action_multiplier(torch.tensor([1.0, 0.0, -1.0]))
    masks = env._jet_masks.numpy()
    assert np.allclose(m.numpy()[masks[0] > 0], 1.0)
    assert np.allclose(m.numpy()[masks[2] > 0], -1.0)


def test_state_round_trip_through_numpy(env):
    """``get_state`` -> numpy -> ``set_state`` restores the domain and the
    smoothed control (what a test uses to hand one state to both
    packages)."""
    st = env.get_state()
    st.additional_info["last_control"] = torch.tensor([0.1, -0.2, 0.3])
    host = env_state_to_numpy(st)
    assert isinstance(host.additional_info["last_control"], np.ndarray)
    assert isinstance(host.domain.blocks[2].velocity, np.ndarray)
    env.set_state(env_state_from_numpy(host))
    assert torch.equal(env._last_control, torch.tensor([0.1, -0.2, 0.3]))
    for a, b in zip(env._state.blocks, st.domain.blocks):
        assert torch.equal(a.velocity, b.velocity)
        assert torch.equal(a.pressure, b.pressure)
    # the jets' wall face of the top block
    assert torch.equal(env._state.blocks[2].faces[2].velocity,
                       st.domain.blocks[2].faces[2].velocity)


def test_seeded_randomized_reset_matches_jax(env):
    """``_randomize_domain`` from one state and one seed draws the same
    noise as the JAX package's (numpy draws per block, velocity then
    pressure) and takes the same number of uncontrolled sim steps (8..15 at
    ``episode_length`` 300; counted, the steps themselves are the solver's,
    compared in ``test_torch_airfoil_rollout.py``)."""
    from fluidgym_tpu.envs.airfoil import AirfoilEnv2D as JEnv
    from torch_port_helpers import jax_domain_state

    start = env.get_state()
    host = env_state_to_numpy(start)
    jenv = object.__new__(JEnv)  # only what _randomize_domain reads
    jenv._topo = env._topo
    jenv._state = jax_domain_state(host.domain)
    counts = {"jax": 0, "port": 0}

    def counter(name):
        def step():
            counts[name] += 1
        return step

    jenv._run_single_step = counter("jax")
    env._run_single_step = counter("port")
    for e in (jenv, env):
        e._episode_length = 300
        e._np_rng = np.random.default_rng(7)
    try:
        jenv._randomize_domain()
        env._randomize_domain()
        noisy = env_state_to_numpy(env.get_state()).domain
    finally:
        del env._run_single_step
        env._episode_length = KW["episode_length"]
        env.set_state(start)
    assert 8 <= counts["port"] == counts["jax"] <= 15
    for jb, tb in zip(jenv._state.blocks, noisy.blocks):
        np.testing.assert_allclose(tb.velocity, np.asarray(jb.velocity),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tb.pressure, np.asarray(jb.pressure),
                                   rtol=0, atol=1e-6)
    assert not np.array_equal(noisy.blocks[0].pressure,
                              host.domain.blocks[0].pressure)
