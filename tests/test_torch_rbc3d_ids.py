"""The RBC ids the PyTorch port registers with RBC3D: the six RBC3D ids and
the five RBC2D ids beside ``RBC2D-easy-v0`` (medium, hard and the three
wide ids), against ``fluidgym_tpu`` on the CPU.

* The registry: every RBC id of the JAX package, with the same merged
  defaults (twin of ``tests/test_rbc_env.py::test_registry_ids``), and
  ``make(id, device="cpu")`` of each with the JAX package's spaces.
* 3 small steps of each new RBC2D id (its registered Ra, CFL and aspect
  ratio at 4 heaters of resolution 4): obs, reward and Nusselt <= 1e-4
  relative (the rollout bar), pressure iterations within 3.
* One full-width ``RBC2D-wide-easy-v0`` step from the bundled snapshot (one
  (61, 192) block, ~4,760 pressure iterations).  In float32 the reward
  ``nu_ref - Nu`` is a difference of near-equal numbers (0.196 out of a Nu
  of 4.67), so float32 rounding of Nu (6.1e-6 relative) is 1.5e-4 of the
  reward: the float32 step holds the reward on Nu's scale (|d reward| <=
  1e-4 |Nu|) and the float64 step holds it at the rollout bar.
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
NEW_2D = ["RBC2D-medium-v0", "RBC2D-hard-v0", "RBC2D-wide-easy-v0",
          "RBC2D-wide-medium-v0", "RBC2D-wide-hard-v0"]


def test_registry_ids_and_defaults():
    ids = fluidgym_tpu_torch.registry.ids()
    jax_rbc = [i for i in fluidgym_tpu.registry.ids() if i.startswith("RBC")]
    assert len(jax_rbc) == 12
    for want in jax_rbc:
        assert want in ids
        tcfg = fluidgym_tpu_torch.registry._entries[want][1]
        jcfg = fluidgym_tpu.registry._entries[want][1]
        assert tcfg == jcfg, want
    for want in ["RBC2D-easy-v0", "RBC2D-medium-v0", "RBC2D-hard-v0",
                 "RBC2D-wide-easy-v0", "RBC3D-easy-v0", "RBC3D-wide-hard-v0"]:
        assert want in fluidgym_tpu_torch.registry


@pytest.mark.parametrize("env_id", sorted(
    i for i in fluidgym_tpu.registry.ids() if i.startswith("RBC")))
def test_make_on_cpu_matches_jax_spaces(env_id):
    """``make(id, device="cpu")`` at the registered defaults: the JAX
    package's spaces, agents and dataset id."""
    tenv = fluidgym_tpu_torch.make(env_id, device="cpu")
    jenv = fluidgym_tpu.make(env_id)
    assert tenv.device.type == "cpu"
    assert (tenv.use_marl, tenv.n_agents) == (jenv.use_marl, jenv.n_agents)
    assert tenv.initial_domain_id == jenv.initial_domain_id
    assert tenv.nu_ref == pytest.approx(jenv.nu_ref)
    assert tuple(tenv.action_space.shape) == tuple(jenv.action_space.shape)
    for k in jenv.observation_space.spaces:
        assert (tuple(tenv.observation_space[k].shape)
                == tuple(jenv.observation_space[k].shape)), k


def test_make_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make(id) runs on it")
    for env_id in ("RBC3D-easy-v0", "RBC2D-wide-hard-v0"):
        with pytest.raises(Exception, match="(?i)cuda"):
            fluidgym_tpu_torch.make(env_id)


def _step_both(jenv, tenv, a):
    jo, jr, *_, ji = jenv.step(a)
    to, tr, *_, ti = tenv.step(a)
    assert abs(int(ti["pressure_iterations"]) - int(ji["pressure_iterations"])) <= 3
    assert bool(ti["pressure_converged"]) and bool(ji["pressure_converged"])
    for k in jo:
        assert tuple(to[k].shape) == tuple(np.shape(jo[k]))
        assert_rel(to[k].numpy(), np.asarray(jo[k]), RTOL, f"obs {k}")
    assert_rel(float(ti["nusselt"]), float(ji["nusselt"]), RTOL, "nusselt")
    return (float(tr.reshape(-1)[0]), float(np.asarray(jr).reshape(-1)[0]),
            float(ji["nusselt"]))


@pytest.mark.parametrize("env_id", NEW_2D)
def test_three_small_steps_match_jax(env_id):
    jenv = fluidgym_tpu.make(env_id, **SMALL_RBC_KW)
    tenv = fluidgym_tpu_torch.make(env_id, device="cpu", **SMALL_RBC_KW)
    jenv.reset(seed=4)
    tenv.reset(seed=4)
    assert tenv._topo.blocks[0].shape == jenv._topo.blocks[0].shape
    rng = np.random.default_rng(0)
    for i in range(3):
        a = rng.uniform(-1, 1, (4, 1)).astype(np.float32)
        tr, jr, _ = _step_both(jenv, tenv, a)
        assert_rel(tr, jr, RTOL, f"{env_id} step {i} reward")


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_full_width_wide_step_matches_jax(x64):
    """``RBC2D-wide-easy-v0`` at its registered defaults (24 heaters), the
    bundled ``train_00`` snapshot, one 1.0-time-unit step."""
    kw = dict(randomize_initial_state=False, episode_length=2)
    jdt, tdt = (jnp.float64, torch.float64) if x64 else (jnp.float32, torch.float32)
    a = np.linspace(-1, 1, 24, dtype=np.float32).reshape(24, 1)
    with jax.enable_x64(x64):
        jenv = fluidgym_tpu.make("RBC2D-wide-easy-v0", dtype=jdt, **kw)
        tenv = fluidgym_tpu_torch.make("RBC2D-wide-easy-v0", device="cpu",
                                       dtype=tdt, **kw)
        jenv.reset(seed=0)
        tenv.reset(seed=0)
        assert tenv._topo.blocks[0].shape == (61, 192)
        assert tenv.nu_ref == pytest.approx(jenv.nu_ref)
        tr, jr, jnu = _step_both(jenv, tenv, a)
    if x64:
        assert_rel(tr, jr, RTOL, "reward")
    else:
        assert abs(tr - jr) <= RTOL * abs(jnu), (tr, jr, jnu)
