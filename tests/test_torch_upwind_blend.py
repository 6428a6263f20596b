"""The upwind blend of the advection matrix and the cylinder ids it unlocks,
on the host: ``build_advection_ops(upwind=)`` against the JAX package's on
the cylinder's resolution-8 grid (2D and 3D) to 1e-6 relative, ``upwind=0``
bit-equal to the central matrix, the hard tier's ``SimConfig``, the six
cylinder ids' merged defaults against the JAX package's key for key, and
the twins of the JAX package's cylinder contract tests
(``tests/test_cylinder_env.py``) and of its all-ids sweep
(``tests/test_all_envs.py``) over the port's registered ids.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.core.domain import domain_state_from_numpy
from fluidgym_tpu_torch.solver import piso
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import CYL_KW

torch.set_num_threads(1)
BAR = 1e-6
NEW_IDS = ("CylinderJet2D-medium-v0", "CylinderJet2D-hard-v0",
           "CylinderRot2D-easy-v0", "CylinderRot2D-medium-v0",
           "CylinderRot2D-hard-v0", "CylinderJet3D-hard-v0")
DEV_KW = dict(CYL_KW, episode_length=3)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def systems(request):
    """The JAX package's cylinder env at resolution 8 after ``reset`` (the
    projected impulsive start, plus noise so every face flux has both
    signs), and the port's topology and geometry of the same grid with that
    state."""
    env_id = "CylinderJet2D-easy-v0" if request.param == 2 else "CylinderJet3D-easy-v0"
    kw = dict(CYL_KW, resolution=8)
    if request.param == 3:
        kw["n_jets"] = 4
    jenv = fluidgym_tpu.make(env_id, **kw)
    jenv.reset(seed=0)
    rng = np.random.default_rng(5)
    js = jenv._state
    for b, blk in enumerate(js.blocks):
        noise = rng.normal(size=blk.velocity.shape).astype(np.float32) * 0.3
        js = js.replace_block(b, dataclasses.replace(
            blk, velocity=blk.velocity + jnp.asarray(noise)))
    tenv = fluidgym_tpu_torch.make(env_id, device="cpu", **kw)
    tenv.reset(seed=0)
    ts = domain_state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    return (jenv._topo, jenv._geoms, js), (tenv._topo, tenv._geoms, ts)


@pytest.mark.parametrize("upwind", [0.3, 1.0])
def test_blended_advection_ops_match_jax(systems, upwind):
    """The blended velocity matrix (diag and every face coefficient of every
    block) against the JAX package's, and away from the central one."""
    (jt, jg, js), (tt, tg, ts) = systems
    dt_j, dt_t = jnp.asarray(0.01, jnp.float32), torch.tensor(0.01)
    jops = jst.build_advection_ops(js, jg, jt, js.viscosity, dt_j, upwind=upwind)
    tops = tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_t, upwind=upwind)
    central = tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt_t)
    for b, (j, t, c) in enumerate(zip(jops, tops, central)):
        for name in ("diag", "off"):
            tv, jv = _np(getattr(t, name)), np.asarray(getattr(j, name))
            assert tv.shape == jv.shape, (b, name)
            assert _rel(tv, jv) <= BAR, (b, name, _rel(tv, jv))
            assert _rel(tv, _np(getattr(c, name))) > 1e-3, (b, name)
        # the blend adds to the diagonal what it takes from the faces
        assert bool((t.diag >= c.diag).all())
        assert bool((t.off <= c.off).all())


def test_zero_blend_is_the_central_matrix_bit_for_bit(systems):
    """``upwind=0.0`` gives today's tensors, velocity and scalar systems."""
    _, (tt, tg, ts) = systems
    dt = torch.tensor(0.01)
    for a, c in zip(tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt,
                                            upwind=0.0),
                    tst.build_advection_ops(ts, tg, tt, ts.viscosity, dt)):
        assert torch.equal(a.diag, c.diag) and torch.equal(a.off, c.off)


def test_simconfig_blend_default_and_hard_tier():
    """The blend defaults to 0 and reaches the velocity matrix only; the
    cylinder's Re >= 500 tiers take 0.3, the others 0, as in the JAX
    package."""
    assert piso.SimConfig(differentiable=False).advection_upwind_blend == 0.0
    for re, blend in ((100, 0.0), (250, 0.0), (500, 0.3)):
        for env_id in ("CylinderJet2D-easy-v0", "CylinderRot2D-easy-v0"):
            t = fluidgym_tpu_torch.make(env_id, device="cpu",
                                        reynolds_number=re, **DEV_KW)
            j = fluidgym_tpu.make(env_id, reynolds_number=re, **DEV_KW)
            assert t._get_simulation().advection_upwind_blend == blend
            assert j._get_simulation().advection_upwind_blend == blend


@pytest.mark.parametrize("env_id", NEW_IDS)
def test_new_ids_merged_defaults_match_jax(env_id):
    """Registered, with the JAX package's merged defaults key for key."""
    assert env_id in fluidgym_tpu_torch.registry.ids()
    t = fluidgym_tpu_torch.registry._entries[env_id][1]
    j = fluidgym_tpu.registry._entries[env_id][1]
    assert sorted(t) == sorted(j) and t == j, env_id


# ---------------------------------------------------------------------------
# twins of tests/test_cylinder_env.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jet_env():
    return fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu",
                                   **DEV_KW)


def test_cylinder_registry():
    ids = fluidgym_tpu_torch.registry.ids()
    for want in ("CylinderJet2D-easy-v0", "CylinderJet2D-hard-v0",
                 "CylinderRot2D-easy-v0", "CylinderRot2D-medium-v0"):
        assert want in ids


def test_jet_contract(jet_env):
    env = jet_env
    obs, info = env.reset(seed=0)
    assert set(obs) == {"velocity", "pressure"}
    assert tuple(obs["velocity"].shape) == (151, 2)
    assert tuple(obs["pressure"].shape) == (151,)
    obs, reward, te, tr, info = env.step(env.sample_action())
    assert np.isfinite(float(reward))
    for k in ("drag", "lift"):
        assert k in info
        assert np.isfinite(float(info[k]))
    # impulsively-started flow: drag must be positive
    assert float(info["drag"]) > 0


def test_jet_action_changes_flow(jet_env):
    env = jet_env
    env.reset(seed=1)
    snap = env.get_state()
    _, r0, *_ = env.step(np.zeros((1,), np.float32))
    env.set_state(snap)
    _, r1, *_ = env.step(np.ones((1,), np.float32))
    assert not np.isclose(float(r0), float(r1))


def test_rot_env_steps():
    env = fluidgym_tpu_torch.make("CylinderRot2D-easy-v0", device="cpu",
                                  **DEV_KW)
    obs, _ = env.reset(seed=0)
    obs, reward, te, tr, info = env.step(env.sample_action())
    assert np.isfinite(float(reward))
    assert env.id == "RotatingCylinder2D_Re100.0"
    # the jet env's datasets
    assert env.initial_domain_id == "cylinder_2D_Re100_Res16"


def test_rot_action_sets_the_tangential_wall_velocity():
    """The action scales a unit tangential velocity on the four wall faces
    (the JAX package's wall velocities, face for face)."""
    kw = dict(DEV_KW, resolution=8)
    t = fluidgym_tpu_torch.make("CylinderRot2D-easy-v0", device="cpu", **kw)
    j = fluidgym_tpu.make("CylinderRot2D-easy-v0", **kw)
    t.reset(seed=0)
    j.reset(seed=0)
    assert sorted(t._wall_velocities) == sorted(j._wall_velocities)
    state = t._pure_apply_action(t._state, torch.tensor([0.7]))
    for (b, f), base in t._wall_velocities.items():
        jb = np.asarray(j._wall_velocities[(b, f)])
        assert _rel(_np(base), jb) <= BAR, (b, f)
        assert np.allclose(np.linalg.norm(_np(base), axis=0), 1.0)
        assert _rel(_np(state.blocks[b].faces[f].velocity), 0.7 * jb) <= BAR


def test_divergence_free_after_init(jet_env):
    """Post-reset velocity is (approximately) solenoidal."""
    env = jet_env
    env.reset(seed=2)
    for d in tst.velocity_divergence(env._state, env._geoms, env._topo):
        d = _np(d)
        assert np.isfinite(d).all()
        assert np.sqrt((d ** 2).mean()) < 2e-2
        assert np.abs(d).max() < 0.2


def test_hard_tier_upwind_blend_gating():
    """The Re >= 500 tier ships with the blend and steps finite."""
    easy = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu",
                                   **DEV_KW)
    hard = fluidgym_tpu_torch.make("CylinderJet2D-hard-v0", device="cpu",
                                   **DEV_KW)
    assert easy._get_simulation().advection_upwind_blend == 0.0
    assert hard._get_simulation().advection_upwind_blend == 0.3
    hard.reset(seed=0)
    assert hard._cfg.advection_upwind_blend == 0.3
    for _ in range(3):
        _, _, _, _, info = hard.step(np.zeros(hard.action_space.shape,
                                              np.float32))
    assert np.isfinite(float(info["drag"]))


# ---------------------------------------------------------------------------
# twins of tests/test_all_envs.py over the port's registered ids
# ---------------------------------------------------------------------------

COMMON = dict(load_initial_domain=False, load_domain_statistics=False,
              randomize_initial_state=False, episode_length=2)
PORT_IDS = fluidgym_tpu_torch.registry.ids()


def _dev_kwargs(env_id: str) -> dict:
    """The JAX sweep's tiny sizes.  The airfoil (no resolution knob)
    starts from its bundled snapshot: from a uniform flow its first step
    takes ~22,000 pressure iterations on the host."""
    if env_id.startswith("RBC"):
        return dict(COMMON, n_heaters=4, resolution=4, local_obs_window=3,
                    step_length=0.1, dt=0.05)
    if env_id.startswith("Cylinder"):
        kw = dict(COMMON, resolution=16, step_length=0.02, dt=0.01)
        if "3D" in env_id:
            kw["n_jets"] = 4
        return kw
    if env_id.startswith("TCF"):
        return dict(COMMON, resolution_y=9, resolution_x_z=8, actor_size=2,
                    step_length=0.6)
    if env_id.startswith("Airfoil"):
        return dict(COMMON, load_initial_domain=True, step_length=0.05,
                    dt=0.05)
    raise AssertionError(f"unknown family for {env_id}")


def test_port_registers_22_ids():
    # 22 ids when this test was written; the airfoil's medium and hard
    # tiers (the aggregation coarse space) made 24, the 12 TCF ids 36,
    # Airfoil3D-easy 37
    assert len(PORT_IDS) == 37
    assert set(PORT_IDS) <= set(fluidgym_tpu.registry.ids())


@pytest.mark.parametrize("env_id", PORT_IDS)
def test_make_and_spaces(env_id):
    env = fluidgym_tpu_torch.make(env_id, device="cpu", **_dev_kwargs(env_id))
    obs_space = env.observation_space
    assert hasattr(obs_space, "spaces") and len(obs_space.spaces) > 0
    for key, sub in obs_space.spaces.items():
        assert isinstance(key, str)
        assert all(int(s) > 0 for s in sub.shape), (env_id, key, sub.shape)
    act_space = env.action_space
    assert all(int(s) > 0 for s in act_space.shape), (env_id, act_space.shape)
    joint_shape = tuple(act_space.shape)
    if env.use_marl:
        assert env.n_agents > 1
        joint_shape = (env.n_agents,) + joint_shape
    assert len(env.metrics) > 0
    assert all(isinstance(m, str) and m for m in env.metrics)
    env.seed(0)
    a = np.asarray(env.sample_action())
    assert a.shape == joint_shape, (env_id, a.shape, joint_shape)
    assert np.isfinite(a).all()


@pytest.mark.parametrize("env_id", [i for i in PORT_IDS if "2D" in i])
def test_2d_ids_reset_step(env_id):
    env = fluidgym_tpu_torch.make(env_id, device="cpu", **_dev_kwargs(env_id))
    obs, info = env.reset(seed=1)
    space = env.observation_space
    assert set(obs.keys()) == set(space.spaces.keys())
    for k, v in obs.items():
        assert tuple(v.shape) == tuple(space[k].shape), (env_id, k)
        assert bool(torch.isfinite(v).all()), (env_id, k)
    obs, reward, terminated, truncated, info = env.step(env.sample_action())
    assert bool(torch.isfinite(torch.as_tensor(reward)).all()), env_id
    assert isinstance(terminated, bool) and isinstance(truncated, bool)
    for metric in env.metrics:
        assert metric in info, (env_id, metric)
