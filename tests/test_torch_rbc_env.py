"""The slice as a whole: ``RBC2D-easy-v0`` in the PyTorch port against
``fluidgym_tpu`` from the same state.

The JAX state is carried across with ``domain_state_from_numpy``; both envs
then take 3 steps with the same fixed (numpy) actions.  On the CPU the JAX
env solves with its XLA ``linsolve`` loops (its fused gates need Pallas,
which the CPU backend only interprets) and the port with the plain versions
of K1/K2.  The port's K2 stops per velocity component where
``linsolve.bicgstab`` stops on the joint residual, and both solve to
``pressure_tol`` = advection tol = 1e-5; the resulting differences stay
far inside the rollout bar used here: obs, reward and Nusselt <= 1e-4
relative to each quantity's scale.
"""

import jax
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu_torch.core.domain import domain_state_from_numpy
from fluidgym_tpu_torch.envs import EnvState
from torch_port_helpers import SMALL_RBC_KW, assert_rel

torch.set_num_threads(1)
RTOL = 1e-4


def _carry(jenv, tenv):
    """Put the JAX env's current state into the port env."""
    js = jenv.get_state()
    tenv.set_state(EnvState(
        class_name=tenv.__class__.__name__,
        domain=domain_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, js.domain)),
        n_steps=js.n_steps, mode=tenv.mode, additional_info={}))


def _compare_rollout(jenv, tenv, actions):
    for i, a in enumerate(actions):
        jo, jr, jte, jtr, ji = jenv.step(a)
        to, tr, tte, ttr, ti = tenv.step(a)
        assert (jte, jtr) == (tte, ttr)
        for k in jo:
            assert tuple(to[k].shape) == tuple(np.shape(jo[k]))
            assert_rel(to[k].numpy(), np.asarray(jo[k]), RTOL, f"step {i} obs {k}")
        assert_rel(tr.numpy(), np.asarray(jr), RTOL, f"step {i} reward")
        assert_rel(float(ti["nusselt"]), float(ji["nusselt"]), RTOL,
                   f"step {i} nusselt")
        assert bool(ti["pressure_converged"]) and bool(ji["pressure_converged"])


def test_three_steps_match_jax_small():
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", **SMALL_RBC_KW)
    tenv = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **SMALL_RBC_KW)
    jenv.reset(seed=4)
    tenv.reset(seed=4)
    _carry(jenv, tenv)
    rng = np.random.default_rng(0)
    acts = [rng.uniform(-1, 1, (4, 1)).astype(np.float32) for _ in range(3)]
    _compare_rollout(jenv, tenv, acts)


def test_full_width_step_from_bundled_snapshot_matches_jax():
    """Registered defaults (12 heaters, resolution 8: the 61 x 96 block),
    the bundled initial domain (no randomization), one 1.0-time-unit step."""
    kw = dict(randomize_initial_state=False, episode_length=2)
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", **kw)
    tenv = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **kw)
    jo, _ = jenv.reset(seed=0)
    to, _ = tenv.reset(seed=0)
    assert tenv._topo.blocks[0].shape == (61, 96)
    for k in jo:
        assert_rel(to[k].numpy(), np.asarray(jo[k]), 1e-6, f"reset obs {k}")
    assert tenv.nu_ref == pytest.approx(jenv.nu_ref)
    a = np.linspace(-1, 1, 12, dtype=np.float32).reshape(12, 1)
    _compare_rollout(jenv, tenv, [a])


def test_marl_step_matches_jax():
    kw = {**SMALL_RBC_KW, "use_marl": True}
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", **kw)
    tenv = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **kw)
    jenv.reset(seed=1)
    tenv.reset(seed=1)
    _carry(jenv, tenv)
    a = np.array([[0.5], [-0.2], [0.1], [0.9]], np.float32)
    jo, jr, *_, ji = jenv.step(a)
    to, tr, *_, ti = tenv.step(a)
    for k in jo:
        assert_rel(to[k].numpy(), np.asarray(jo[k]), RTOL, f"marl obs {k}")
    assert_rel(tr.numpy(), np.asarray(jr), RTOL, "marl rewards")
    assert_rel(ti["global_reward"].numpy(), np.asarray(ji["global_reward"]),
               RTOL, "global reward")


def test_env_contract():
    env = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **SMALL_RBC_KW)
    with pytest.raises(RuntimeError):
        env.step(np.zeros((4, 1), np.float32))
    with pytest.raises(RuntimeError):
        env.sample_action()
    obs, info = env.reset(seed=42)
    assert info == {}
    space = env.observation_space
    for k, v in obs.items():
        assert tuple(v.shape) == space[k].shape
        assert v.device.type == "cpu" and bool(torch.isfinite(v).all())
    a = env.sample_action()
    assert env.action_space.contains(a)
    with pytest.raises(ValueError, match="shape"):
        env.step(np.zeros((3, 1), np.float32))
    snap = env.get_state()
    _, r1, *_, i1 = env.step(a)
    env.set_state(snap)
    _, r2, *_, i2 = env.step(a)
    assert float(i1["nusselt"]) == float(i2["nusselt"])
    for _ in range(4):  # episode_length 5: steps 2..5
        *_, truncated, _ = env.step(a)
    assert truncated
    with pytest.raises(RuntimeError, match="terminated"):
        env.step(a)
    assert "RBC2D-easy-v0" in fluidgym_tpu_torch.registry


def test_verify_recipe_nusselt_grows_from_conduction():
    """The verify recipe at full width (61 x 96): a fresh conduction state
    (no dataset) starts at Nu ~ 1 and convection makes Nu grow."""
    env = fluidgym_tpu_torch.make(
        "RBC2D-easy-v0", device="cpu", load_initial_domain=False,
        load_domain_statistics=False, randomize_initial_state=False)
    env.reset(seed=42)
    nus = [float(env.compute_global_nusselt()[0])]
    for _ in range(3):
        *_, info = env.step(env.sample_action())
        nus.append(float(info["nusselt"]))
    assert abs(nus[0] - 1.0) < 0.05, nus
    assert all(b > a for a, b in zip(nus, nus[1:])), nus
