"""The turbulent channel flow envs of the PyTorch port against
``fluidgym_tpu`` on the CPU.

* The registry: the 12 TCF ids with the JAX package's merged defaults, key
  for key, and ``make(id, device="cpu")`` of each with the JAX package's
  spaces, agents, dataset id and wall units.
* Twins of every test in ``tests/test_tcf_env.py`` (a tiny channel).
* Float64 rollouts of 3 env steps from the generated state (Reichardt
  profile plus curl noise) with fixed non-zero actions: SARL bottom, MARL
  bottom, MARL both walls, and the Smagorinsky model with Van Driest
  damping; obs and wall stresses within 1e-4 relative, pressure iterations
  within 3.  Both packages run the pressure solves to 1e-8 (from the
  reset's projection on): at the registered 1e-6 the two packages' float64
  solves stop at the same iteration with iterates ~1e-6 apart (their CG
  loops round differently), which the channel's small pressure turns into
  ~3e-3 of the pressure obs.  The reward ``1 - tau / tau_ref`` is a
  difference of near-equal numbers, so it is held on the scale of tau.
* A randomized reset (noise and two uncontrolled sim steps) gives the same
  state in both packages; the bundled ``train_01`` snapshot at full width
  resets to the same obs.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu_torch.types import EnvMode
from torch_port_helpers import assert_rel

torch.set_num_threads(1)
RTOL = 1e-4
TCF_IDS = sorted(i for i in fluidgym_tpu.registry.ids() if i.startswith("TCF"))

DEV_KW = dict(
    resolution_y=17,
    resolution_x_z=16,
    actor_size=4,
    load_initial_domain=False,
    load_domain_statistics=False,
    randomize_initial_state=False,
    episode_length=3,
    step_length=0.6,
)


def _make(env_id, **kw):
    return fluidgym_tpu_torch.make(env_id, device="cpu", **{**DEV_KW, **kw})


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_tcf_registry():
    ids = fluidgym_tpu_torch.registry.ids()
    assert len([i for i in ids if i.startswith("TCF")]) == 12
    assert "TCFSmall3D-bottom-easy-v0" in ids
    assert "TCFLarge3D-both-hard-v0" in ids
    assert len(ids) == 37  # 12 RBC + 9 cylinder + 12 TCF + 3 Airfoil2D + 1 Airfoil3D
    assert len(TCF_IDS) == 12
    for want in TCF_IDS:
        tcfg = fluidgym_tpu_torch.registry._entries[want][1]
        jcfg = fluidgym_tpu.registry._entries[want][1]
        assert tcfg.keys() == jcfg.keys(), want
        for k in jcfg:
            assert tcfg[k] == jcfg[k] and type(tcfg[k]) is type(jcfg[k]), (want, k)


@pytest.mark.parametrize("env_id", TCF_IDS)
def test_make_on_cpu_matches_jax_spaces(env_id):
    """``make(id, device="cpu")`` at the registered defaults: the JAX
    package's spaces, agents, dataset id, wall units and step."""
    tenv = fluidgym_tpu_torch.make(env_id, device="cpu")
    jenv = fluidgym_tpu.make(env_id)
    assert tenv.device.type == "cpu"
    assert (tenv.use_marl, tenv.n_agents) == (jenv.use_marl, jenv.n_agents)
    assert tenv.initial_domain_id == jenv.initial_domain_id
    assert tenv.id == jenv.id
    assert tenv.tau_ref == pytest.approx(jenv.tau_ref)
    for a in ("_viscosity", "_u_wall", "_dt", "_step_length", "_n_sim_steps",
              "_grid_refinement_strength", "_y_obs_wall"):
        assert getattr(tenv, a) == getattr(jenv, a), a
    assert tuple(tenv.action_space.shape) == tuple(jenv.action_space.shape)
    for k in jenv.observation_space.spaces:
        assert (tuple(tenv.observation_space[k].shape)
                == tuple(jenv.observation_space[k].shape)), k


def test_make_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make(id) runs on it")
    with pytest.raises(Exception, match="(?i)cuda"):
        fluidgym_tpu_torch.make("TCFSmall3D-bottom-easy-v0")


# ---------------------------------------------------------------------------
# twins of tests/test_tcf_env.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tcf_env():
    return _make("TCFSmall3D-bottom-easy-v0", use_marl=False)


def test_tcf_sarl_contract(tcf_env):
    env = tcf_env
    obs, info = env.reset(seed=0)
    assert obs["velocity"].shape == (2, 16, 16)
    assert obs["pressure"].shape == (16, 16)
    obs, reward, te, tr, info = env.step(env.sample_action())
    assert np.isfinite(float(reward))
    for k in env.metrics:
        assert k in info and np.isfinite(float(info[k]))
    # bottom wall stress should be positive for streamwise channel flow
    assert float(info["wall_stress_bottom"]) > 0


def test_tcf_marl_contract():
    env = _make("TCFSmall3D-bottom-easy-v0", use_marl=True, local_obs_window=3)
    obs, _ = env.reset(seed=0)
    assert env.n_agents == (16 // 4) ** 2
    assert obs["velocity"].shape == (env.n_agents, 3, 3, 2)
    assert obs["pressure"].shape == (env.n_agents, 3, 3)
    obs, rewards, te, tr, info = env.step(env.sample_action())
    assert rewards.shape == (env.n_agents,)
    assert "global_reward" in info


def test_tcf_both_env():
    env = _make("TCFSmall3D-both-easy-v0", use_marl=True, local_obs_window=1)
    obs, _ = env.reset(seed=1)
    assert env.n_agents == 2 * (16 // 4) ** 2
    assert obs["pressure"].shape[0] == env.n_agents
    obs, rewards, te, tr, info = env.step(env.sample_action())
    assert rewards.shape == (env.n_agents,)


def test_tcf_smagorinsky_runs():
    env = _make("TCFSmall3D-bottom-easy-v0", use_marl=False, C_smag=0.1,
                use_van_driest=True)
    obs, _ = env.reset(seed=0)
    assert env._state.blocks[0].viscosity.shape == (16, 16, 16)
    obs, reward, *_ = env.step(env.sample_action())
    assert np.isfinite(float(reward))
    assert float(env._state.blocks[0].viscosity.min()) >= env._viscosity


def test_prep_fn_before_additional_initialization():
    """The base reset calls _get_prep_fn BEFORE _additional_initialization;
    on the disk-load path the channel info is not built yet and must be
    built there rather than crash."""
    env = _make("TCFSmall3D-bottom-easy-v0", use_marl=False)
    assert env._channel_info is None
    hooks = env._get_prep_fn()  # must not raise
    assert hooks and env._channel_info is not None


def test_both_env_local_obs_honors_requested_slice():
    env = _make("TCFSmall3D-both-easy-v0", use_marl=True)
    env.reset(seed=0)
    both = env._pure_local_obs(env._state)
    bottom_only = env._pure_local_obs(env._state, y_idx=env._y_obs_bottom_idx)
    for k in both:
        assert both[k].shape[0] == 2 * bottom_only[k].shape[0]


def test_opposition_control_episode_archival(tmp_path, monkeypatch):
    """Opposition-control episode CSVs round-trip beside the initial-domain
    dataset (under the user data path), keyed by the actuation kind."""
    import pandas as pd

    monkeypatch.setattr(fluidgym_tpu_torch.config, "_data_path", tmp_path)
    env = fluidgym_tpu_torch.make(
        "TCFSmall3D-bottom-easy-v0", device="cpu", load_initial_domain=False,
        load_domain_statistics=False, use_marl=False)
    rows = [{"t": 0, "wall_stress": 1.0}, {"t": 1, "wall_stress": 0.9}]
    env.save_opposition_control_episode(0, EnvMode.TRAIN, rows)
    df = env.load_opposition_control_episode(0, EnvMode.TRAIN)
    assert list(df.columns) == ["t", "wall_stress"]
    assert len(df) == 2
    path = env._opposition_episode_path(EnvMode.TRAIN, 0)
    assert path.name == "train_00_opposition_control_bottom_episode.csv"
    assert tmp_path in path.parents

    env.save_opposition_control_episode(1, EnvMode.VAL, pd.DataFrame(rows))
    assert env.load_opposition_control_episode(1, EnvMode.VAL).shape == (2, 2)
    with pytest.raises(FileNotFoundError):
        env.load_opposition_control_episode(7, EnvMode.TEST)


def test_physics_screen_and_turbulence_ratio():
    env = _make("TCFSmall3D-bottom-easy-v0", use_marl=False)
    env.reset(seed=0)
    nominal = env._u_wall ** 2
    assert env._episode_physics_violations(
        [{"wall_stress_bottom": 0.8 * nominal}]) == []
    assert "relaminarized" in env._episode_physics_violations(
        [{"wall_stress_bottom": 0.4 * nominal}])[0]
    v = env._state.blocks[0].velocity[1]
    assert env.snapshot_turbulence_ratio() == pytest.approx(
        float(v.std(correction=0)) / env._u_wall)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _tight(env, tol=1e-8):
    """Both packages' pressure solves to ``tol`` from the next reset on."""
    base = env._get_simulation
    env._get_simulation = lambda: replace(base(), pressure_tol=tol)


def _pair(env_id, **kw):
    jenv = fluidgym_tpu.make(env_id, dtype=jnp.float64, **{**DEV_KW, **kw})
    tenv = _make(env_id, dtype=torch.float64, **kw)
    _tight(jenv)
    _tight(tenv)
    return jenv, tenv


def _obs_close(to, jo, what):
    assert set(to) == set(jo)
    for k in jo:
        assert tuple(to[k].shape) == tuple(np.shape(jo[k])), (what, k)
        assert_rel(to[k].numpy(), np.asarray(jo[k]), RTOL, f"{what} obs {k}")


ROLLOUTS = {
    "SARL bottom": ("TCFSmall3D-bottom-easy-v0", dict(use_marl=False)),
    "MARL bottom": ("TCFSmall3D-bottom-easy-v0", dict(local_obs_window=3)),
    "MARL both": ("TCFSmall3D-both-medium-v0", dict(local_obs_window=3)),
    "Smagorinsky + Van Driest": ("TCFSmall3D-bottom-easy-v0",
                                 dict(use_marl=False, C_smag=0.1,
                                      use_van_driest=True)),
}


@pytest.mark.parametrize("case", list(ROLLOUTS))
def test_rollout_matches_jax_float64(case):
    env_id, kw = ROLLOUTS[case]
    with jax.enable_x64(True):
        jenv, tenv = _pair(env_id, **kw)
        jo, _ = jenv.reset(seed=3)
        to, _ = tenv.reset(seed=3)
        _obs_close(to, jo, f"{case} reset")
        rng = np.random.default_rng(11)
        for i in range(3):
            a = rng.uniform(-1, 1, tuple(tenv._zero_action.shape)).astype(np.float32)
            jo, jr, *_, ji = jenv.step(a)
            to, tr, *_, ti = tenv.step(a)
            _obs_close(to, jo, f"{case} step {i}")
            for k in tenv.metrics:
                assert_rel(float(ti[k]), float(ji[k]), RTOL, f"{case} {k}")
            assert abs(int(ti["pressure_iterations"])
                       - int(ji["pressure_iterations"])) <= 3
            assert bool(ti["pressure_converged"]) and bool(ji["pressure_converged"])
            tau = float(ji["wall_stress"])
            jr, tr = np.asarray(jr, np.float64), tr.numpy()
            assert tr.shape == jr.shape
            assert np.abs(tr - jr).max() <= RTOL * tau, (case, i, tr, jr, tau)
            if tenv.use_marl:
                assert abs(float(ti["global_reward"])
                           - float(ji["global_reward"])) <= RTOL * tau


def test_randomized_reset_matches_jax_float64():
    """``_randomize_domain``: the same numpy draws (noise on velocity and
    pressure, then the number of uncontrolled sim steps) in the same order
    give the same state."""
    with jax.enable_x64(True):
        jenv, tenv = _pair("TCFSmall3D-bottom-hard-v0", use_marl=False,
                           randomize_initial_state=True, episode_length=300)
        jo, _ = jenv.reset(seed=21)
        to, _ = tenv.reset(seed=21)
        _obs_close(to, jo, "randomized reset")
        for name in ("velocity", "pressure"):
            assert_rel(getattr(tenv._state.blocks[0], name).numpy(),
                       np.asarray(getattr(jenv._state.blocks[0], name)), RTOL,
                       f"state {name}")
        # the generator is left in the same place
        assert tenv._np_rng.integers(1 << 30) == jenv._np_rng.integers(1 << 30)


def test_bundled_snapshot_reset_matches_jax():
    """TCFSmall3D-bottom-easy-v0 at full width from the bundled ``train_01``
    (the (64, 64, 64) block, no randomization, MARL at the registered
    defaults): the same obs after the reset's projection, in float32."""
    kw = dict(randomize_initial_state=False)
    jenv = fluidgym_tpu.make("TCFSmall3D-bottom-easy-v0", **kw)
    tenv = fluidgym_tpu_torch.make("TCFSmall3D-bottom-easy-v0", device="cpu", **kw)
    jenv.load_initial_domain(EnvMode.TRAIN, 1)
    tenv.load_initial_domain(EnvMode.TRAIN, 1)
    assert tenv._topo.blocks[0].shape == (64, 64, 64)
    assert tenv.tau_ref == pytest.approx(jenv.tau_ref)
    assert tenv._y_obs_bottom_idx == jenv._y_obs_bottom_idx
    _obs_close(tenv._get_local_obs(), jenv._get_local_obs(), "train_01")
    _obs_close(tenv._get_global_obs(), jenv._get_global_obs(), "train_01 global")
