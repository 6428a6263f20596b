"""The port's wrappers (``fluidgym_tpu_torch.wrappers``) against the JAX
package's, on the small RBC2D config of ``tests/test_wrappers.py``.

Each twin builds the same wrapper stack over both packages' envs, carries
the JAX env's state into the port's (``env_state_from_numpy``) and holds
spaces, observations, rewards and infos against the JAX side: rollouts of
at most 3 steps within 1e-4 of each quantity's scale (the repo's rollout
bar).  The noise wrappers draw from a ``torch.Generator`` where the JAX
package uses ``jax.random``, so those twins replay the port's draws into
the JAX env: a port step with noise equals a JAX step on action + the
same noise.  With sigma 0 a noise wrapper equals the bare env bit for bit.
"""

import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu import wrappers as jw
from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch import wrappers as tw
from fluidgym_tpu_torch.envs.fluid_env import env_state_from_numpy
from torch_port_helpers import assert_rel

torch.set_num_threads(1)
RTOL = 1e-4

DEV_KW = dict(
    load_initial_domain=False,
    load_domain_statistics=False,
    randomize_initial_state=False,
    episode_length=3,
    step_length=0.1,
    dt=0.05,
    n_heaters=4,
    resolution=4,
)


@pytest.fixture(scope="module")
def envs():
    """``(jax_env, port_env)`` of the small RBC2D config."""
    return (fluidgym_tpu.make("RBC2D-easy-v0", **DEV_KW),
            fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **DEV_KW))


def _carry(jenv, tenv):
    """The JAX env's state into the port env (below any wrapper)."""
    tenv.unwrapped.set_state(env_state_from_numpy(jenv.unwrapped.get_state()))


def _actions(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(n)]


def _same_space(t, j):
    assert t.shape == tuple(j.shape)
    assert np.dtype(t.dtype) == np.dtype(j.dtype)
    np.testing.assert_array_equal(t.low, j.low)
    np.testing.assert_array_equal(t.high, j.high)


def test_flatten_observation(envs):
    jenv, tenv = envs
    jwr, twr = jw.FlattenObservation(jenv), tw.FlattenObservation(tenv)
    n_expected = sum(int(np.prod(tenv.observation_space[k].shape))
                     for k in ("temperature", "velocity"))
    assert isinstance(twr.observation_space, spaces.Box)
    assert twr.observation_space.shape == (n_expected,)
    _same_space(twr.observation_space, jwr.observation_space)
    obs, info = twr.reset(seed=0)
    jwr.reset(seed=0)
    assert obs.shape == (n_expected,) and "original_temperature" in info
    _carry(jenv, tenv)
    for i, a in enumerate(_actions(2, (4, 1))):
        jo, jr, _, _, ji = jwr.step(a)
        to, tr, _, _, ti = twr.step(a)
        assert to.shape == (n_expected,) and to.device == tenv.device
        assert sorted(ti) == sorted(ji)
        assert_rel(to.numpy(), np.asarray(jo), RTOL, f"step {i} flat obs")
        assert_rel(tr.numpy(), np.asarray(jr), RTOL, f"step {i} reward")
    # the JAX package's key order: temperature, then velocity
    np.testing.assert_array_equal(
        to[: ti["original_temperature"].numel()].numpy(),
        ti["original_temperature"].reshape(-1).numpy())


def test_flatten_observation_keys_and_marl():
    """Explicit keys keep their order; in MARL the agent axis stays leading
    (both as in the JAX package)."""
    kw = dict(DEV_KW, use_marl=True, local_obs_window=3)
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", **kw)
    tenv = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **kw)
    keys = ["pressure", "temperature"]
    jwr, twr = jw.FlattenObservation(jenv, keys=keys), tw.FlattenObservation(tenv, keys=keys)
    _same_space(twr.observation_space, jwr.observation_space)
    jwr.reset(seed=1)
    obs, _ = twr.reset(seed=1)
    assert obs.shape == (4,) + twr.observation_space.shape
    _carry(jenv, tenv)
    a = _actions(1, (4, 1), seed=1)[0]
    jo, jr, *_ = jwr.step(a)
    to, tr, *_ = twr.step(a)
    assert_rel(to.numpy(), np.asarray(jo), RTOL, "marl flat obs")
    assert_rel(tr.numpy(), np.asarray(jr), RTOL, "marl rewards")
    with pytest.raises(ValueError):
        tw.FlattenObservation(tenv, keys=["nope"])
    with pytest.raises(ValueError):
        tw.FlattenObservation(twr)  # a Box space cannot be flattened again


def test_obs_extraction(envs):
    jenv, tenv = envs
    jwr = jw.ObsExtraction(jenv, keys=["temperature"])
    twr = tw.ObsExtraction(tenv, keys=["temperature"])
    assert set(twr.observation_space.spaces) == {"temperature"}
    _same_space(twr.observation_space["temperature"],
                jwr.observation_space["temperature"])
    obs, _ = twr.reset(seed=0)
    jwr.reset(seed=0)
    assert set(obs) == {"temperature"}
    _carry(jenv, tenv)
    a = _actions(1, (4, 1), seed=2)[0]
    jo, *_ = jwr.step(a)
    to, *_ = twr.step(a)
    assert set(to) == {"temperature"}
    assert_rel(to["temperature"].numpy(), np.asarray(jo["temperature"]), RTOL,
               "temperature")
    with pytest.raises(ValueError):
        tw.ObsExtraction(tenv, keys=["nope"])
    with pytest.raises(ValueError):
        tw.ObsExtraction(tenv, keys=[])


def test_noise_wrappers_preserve_shapes(envs):
    _, env = envs
    w = tw.SensorNoise(tw.ActionNoise(env, sigma=0.1, seed=1), sigma=0.05, seed=2)
    obs, _ = w.reset(seed=0)
    for k, v in obs.items():
        assert tuple(v.shape) == tuple(env.observation_space[k].shape)
        assert v.device == env.device and v.dtype == torch.float32
    obs, r, te, tr, info = w.step(w.sample_action())
    for k, v in obs.items():
        assert tuple(v.shape) == tuple(env.observation_space[k].shape)


def test_unwrapped(envs):
    _, env = envs
    w = tw.SensorNoise(tw.FlattenObservation(env), sigma=0.1, seed=0)
    assert w.unwrapped is env
    assert isinstance(w, tw.FluidWrapper)
    assert w.n_agents == env.n_agents
    assert w.differentiable is False and w.episode_length == env.episode_length
    assert w.device == env.device  # attributes fall through to the env


def test_wrapper_delegates_state_and_detach(envs):
    """``get_state`` / ``set_state`` / ``detach`` / ``load_initial_domain``
    pass through every layer to the env."""
    _, env = envs
    w = tw.ObsExtraction(tw.FluidWrapper(env), keys=["pressure"])
    w.reset(seed=3)
    w.step(np.full((4, 1), 0.2, np.float32))
    snap = w.get_state()
    assert snap.n_steps == 1
    o1, r1, *_ = w.step(np.full((4, 1), -0.3, np.float32))
    w.set_state(snap)
    w.detach()
    o2, r2, *_ = w.step(np.full((4, 1), -0.3, np.float32))
    assert torch.equal(o1["pressure"], o2["pressure"]) and torch.equal(r1, r2)
    full = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu",
                                   randomize_initial_state=False,
                                   load_domain_statistics=False)
    tw.FluidWrapper(full).load_initial_domain("train", 0)
    assert full._topo.blocks[0].shape == (61, 96) and full._n_steps == 0


def test_gymnasium_adapter(envs):
    from fluidgym_tpu.integration import GymFluidEnv as JGym
    from fluidgym_tpu_torch.integration import GymFluidEnv

    jenv, tenv = envs
    g, jg = GymFluidEnv(tenv, render_mode="rgb_array"), JGym(jenv, render_mode="rgb_array")
    obs, info = g.reset(seed=0)
    jg.reset(seed=0)
    assert isinstance(obs, dict)
    assert all(isinstance(v, np.ndarray) for v in obs.values())
    _same_space(g.action_space, jg.action_space)
    _carry(jenv, tenv)
    a = np.asarray(g.action_space.sample())
    obs, reward, te, tr, info = g.step(a)
    jobs, jreward, *_ = jg.step(a)
    assert isinstance(reward, float)
    assert isinstance(te, bool) and isinstance(tr, bool)
    assert all(isinstance(v, np.ndarray) for v in info.values())
    assert reward == pytest.approx(jreward, rel=RTOL)
    for k in obs:
        assert_rel(obs[k], np.asarray(jobs[k]), RTOL, k)
    frame = g.render()
    assert frame is not None and frame.ndim == 3
    np.testing.assert_array_equal(frame.shape, jg.render().shape)


@pytest.mark.parametrize("wrapper", ["action", "sensor"])
def test_noise_sigma_zero_is_the_bare_env(wrapper):
    """sigma 0: the wrapped env's obs and rewards equal the bare env's bit
    for bit over a reset and 3 steps."""
    bare = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **DEV_KW)
    inner = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **DEV_KW)
    w = (tw.ActionNoise(inner, sigma=0.0, seed=5) if wrapper == "action"
         else tw.SensorNoise(inner, sigma=0.0, seed=5))
    ob, _ = bare.reset(seed=2)
    ow, _ = w.reset(seed=2)
    assert all(torch.equal(ob[k], ow[k]) for k in ob)
    for a in _actions(3, (4, 1), seed=3):
        ob, rb, *_ = bare.step(a)
        ow, rw, *_ = w.step(a)
        assert all(torch.equal(ob[k], ow[k]) for k in ob)
        assert torch.equal(rb, rw)


def test_noise_wrappers_against_jax_on_the_same_noise():
    """``SensorNoise(ActionNoise(env))`` with the port's generators against
    the JAX env stepped on action + the same action noise, its obs plus the
    same sensor noise: 3 steps within 1e-4 of each quantity's scale."""
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", **DEV_KW)
    tenv = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **DEV_KW)
    sa, ss, seed_a, seed_s = 0.3, 0.05, 11, 12
    w = tw.SensorNoise(tw.ActionNoise(tenv, sigma=sa, seed=seed_a), sigma=ss,
                       seed=seed_s)
    ga = torch.Generator().manual_seed(seed_a)
    gs = torch.Generator().manual_seed(seed_s)

    def sensor_noise(obs):
        # in the port's key order (a jitted JAX step returns sorted keys)
        return {k: torch.randn(tuple(np.shape(obs[k])), generator=gs).numpy() * ss
                for k in tenv.observation_space.spaces}

    to, _ = w.reset(seed=0)
    jo, _ = jenv.reset(seed=0)
    noise = sensor_noise(jo)
    for k in to:
        assert_rel(to[k].numpy(), np.asarray(jo[k]) + noise[k], RTOL,
                   f"reset obs {k}")
    _carry(jenv, tenv)
    for i, a in enumerate(_actions(3, (4, 1), seed=4)):
        na = torch.randn(a.shape, generator=ga).numpy() * sa
        jo, jr, *_ = jenv.step(a + na)
        to, tr, *_ = w.step(a)
        noise = sensor_noise(jo)
        for k in to:
            assert_rel(to[k].numpy(), np.asarray(jo[k]) + noise[k], RTOL,
                       f"step {i} obs {k}")
        assert_rel(tr.numpy(), np.asarray(jr), RTOL, f"step {i} reward")


def test_action_noise_keeps_the_action_dtype_and_device():
    env = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu",
                                  **dict(DEV_KW, dtype=torch.float64))
    w = tw.ActionNoise(env, sigma=0.5, seed=0)
    w.reset(seed=0)
    seen = {}
    step = env.step

    def spy(action):
        seen["a"] = action
        return step(action)

    env.step = spy
    w.step(np.zeros((4, 1), np.float32))
    assert seen["a"].dtype == torch.float32 and seen["a"].device == env.device
    w.step(np.zeros((4, 1), np.int64))  # an integer action takes the env's dtype
    assert seen["a"].dtype == torch.float64
    assert float(seen["a"].abs().max()) > 0
