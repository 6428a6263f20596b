"""RBC3D in the PyTorch port against ``fluidgym_tpu`` (CPU).

Both packages start from the same seed: the port draws the same numpy
numbers for the conduction state, the randomized reset's flips, rolls and
noise, and its burn-in length.  On the CPU the JAX env solves with its XLA
``linsolve`` loops (its fused gates need Pallas, which the CPU backend only
interprets) and the port with the plain versions of K1 and K2.  Bars: obs
and reward <= 1e-4 relative to each quantity's scale (the rollout bar),
pressure iterations within 3 per env step.

A randomized reset runs a burn-in of 20-40 sim steps from a conduction
state whose velocity is noise; float32 rounding grows over it (the two
packages' velocity obs 2.9e-4 apart after it, 1.7e-9 in float64), so the
randomized cases run in float64.  At full width the JAX package's own
float32 step lies 1.5e-4 off its float64 step in the velocity obs and
2.5e-4 in Nu (1.1e-2 in the reward, a difference of near-equal numbers),
where the port's float32 step lies within 1.5e-6 of it in the obs and
1.4e-7 in Nu (``scripts/port_float32_gap.py --env RBC3D-easy-v0``), so the
full-width float32 step is held against the JAX package in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from torch_port_helpers import SMALL_RBC_KW, assert_rel

torch.set_num_threads(1)
RTOL = 1e-4
ID = "RBC3D-easy-v0"


def _dtypes(x64):
    return ((jnp.float64, torch.float64) if x64 else (jnp.float32, torch.float32))


def _obs_match(to, jo, what):
    assert set(to) == set(jo)
    for k in jo:
        assert tuple(to[k].shape) == tuple(np.shape(jo[k])), (what, k)
        if np.abs(np.asarray(jo[k])).max() > 0:
            assert_rel(to[k].numpy(), np.asarray(jo[k]), RTOL, f"{what} obs {k}")
        else:
            assert float(to[k].abs().max()) == 0.0, (what, k)


def _rollout(kw, seed, x64, n_steps=3):
    jdt, tdt = _dtypes(x64)
    with jax.enable_x64(x64):
        jenv = fluidgym_tpu.make(ID, dtype=jdt, **kw)
        tenv = fluidgym_tpu_torch.make(ID, device="cpu", dtype=tdt, **kw)
        jo, _ = jenv.reset(seed=seed)
        to, _ = tenv.reset(seed=seed)
        _obs_match(to, jo, "reset")
        shape = ((tenv.n_agents, 1) if tenv.use_marl
                 else tenv.action_space.shape)
        rng = np.random.default_rng(seed)
        for i in range(n_steps):
            a = rng.uniform(-1, 1, shape).astype(np.float32)
            jo, jr, jte, jtr, ji = jenv.step(a)
            to, tr, tte, ttr, ti = tenv.step(a)
            assert (jte, jtr) == (tte, ttr)
            _obs_match(to, jo, f"step {i}")
            assert tuple(tr.shape) == tuple(np.shape(jr))
            assert_rel(tr.numpy(), np.asarray(jr), RTOL, f"step {i} reward")
            assert_rel(float(ti["nusselt"]), float(ji["nusselt"]), RTOL,
                       f"step {i} nusselt")
            assert abs(int(ti["pressure_iterations"])
                       - int(ji["pressure_iterations"])) <= 3
            assert bool(ti["pressure_converged"]) and bool(ji["pressure_converged"])
            if tenv.use_marl:
                assert_rel(ti["global_reward"].numpy(),
                           np.asarray(ji["global_reward"]), RTOL,
                           f"step {i} global reward")
    return tenv


@pytest.mark.parametrize("marl", [False, True], ids=["sarl", "marl"])
@pytest.mark.parametrize("randomize", [False, True], ids=["fixed", "randomized"])
def test_three_small_steps_match_jax(marl, randomize):
    """n_heaters 4, resolution 4: a (16, 10, 16) block; MARL has 16 agents
    with 3x3-heater windows that wrap."""
    kw = dict(SMALL_RBC_KW, use_marl=marl, randomize_initial_state=randomize)
    tenv = _rollout(kw, seed=3, x64=randomize)
    assert tenv._topo.blocks[0].shape == (16, 10, 16)
    assert tenv.n_agents == (16 if marl else 1)


FULL_KW = dict(randomize_initial_state=False, step_length=0.05, episode_length=2)
FULL_ACTION = np.linspace(-1, 1, 64, dtype=np.float32).reshape(64, 1)


@pytest.fixture(scope="module")
def jax_full_step():
    """The JAX package's float64 full-width step, computed once."""
    with jax.enable_x64(True):
        jenv = fluidgym_tpu.make(ID, dtype=jnp.float64, **FULL_KW)
        jenv.reset(seed=0)
        jo, jr, *_, ji = jenv.step(FULL_ACTION)
        return (jenv.nu_ref, {k: np.asarray(v) for k, v in jo.items()},
                np.asarray(jr), {k: np.asarray(v) for k, v in ji.items()})


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_full_width_sim_step_matches_jax(x64, jax_full_step):
    """The registered defaults (MARL, 64 agents, one (64, 41, 64) block),
    the bundled ``train_00`` snapshot, one sim step (``step_length`` =
    ``dt``) against the JAX package in float64."""
    nu_ref, jo, jr, ji = jax_full_step
    kw, a = FULL_KW, FULL_ACTION
    tenv = fluidgym_tpu_torch.make(ID, device="cpu", dtype=_dtypes(x64)[1], **kw)
    tenv.reset(seed=0)
    assert tenv._topo.blocks[0].shape == (64, 41, 64)
    assert tenv.nu_ref == pytest.approx(nu_ref)
    to, tr, *_, ti = tenv.step(a)
    _obs_match(to, jo, "full width")
    assert_rel(tr.numpy(), np.asarray(jr), RTOL, "reward")
    assert_rel(float(ti["nusselt"]), float(ji["nusselt"]), RTOL, "nusselt")
    assert abs(int(ti["pressure_iterations"]) - int(ji["pressure_iterations"])) <= 3
    assert bool(ti["pressure_converged"])


@pytest.mark.parametrize("env_id,kw", [
    ("RBC2D-easy-v0", dict(SMALL_RBC_KW)),
    (ID, dict(SMALL_RBC_KW, episode_length=3)),
], ids=["2d", "3d"])
def test_marl_contract(env_id, kw):
    """Twin of ``tests/test_rbc_env.py::test_marl_contract``, also for an
    RBC3D env (n_heaters**2 agents)."""
    env = fluidgym_tpu_torch.make(env_id, device="cpu", **dict(kw, use_marl=True))
    obs, info = env.reset(seed=7)
    assert env.n_agents == (4 if env_id.startswith("RBC2D") else 16)
    space = env.observation_space
    for k, v in obs.items():
        assert v.shape[0] == env.n_agents
        assert tuple(v.shape[1:]) == space[k].shape
    actions = env.sample_action()
    assert tuple(actions.shape) == (env.n_agents, 1)
    obs, rewards, term, trunc, info = env.step(actions)
    assert tuple(rewards.shape) == (env.n_agents,)
    assert "global_reward" in info
    assert bool(torch.isfinite(rewards).all())


def test_sarl_contract_3d():
    """Twin of ``tests/test_rbc_env.py::test_rbc3d_smoke`` with the port's
    contract checks: shapes from the spaces, finite values, truncation."""
    env = fluidgym_tpu_torch.make(ID, device="cpu",
                                  **dict(SMALL_RBC_KW, use_marl=False,
                                         episode_length=2))
    obs, _ = env.reset(seed=0)
    for k, v in obs.items():
        assert tuple(v.shape) == env.observation_space[k].shape
    assert env.action_space.shape == (4, 4, 1)
    with pytest.raises(ValueError, match="shape"):
        env.step(np.zeros((16, 1), np.float32))
    *_, trunc, info = env.step(env.sample_action())
    assert not trunc and np.isfinite(float(info["nusselt"]))
    obs, reward, term, trunc, info = env.step(env.sample_action())
    assert trunc and bool(torch.isfinite(reward).all())
    for k, v in obs.items():
        assert bool(torch.isfinite(v).all())
