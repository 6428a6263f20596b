"""The cylinder ids of the upwind blend end to end: the port against the JAX
package in float64 (both packages; JAX under a scoped ``jax.enable_x64``),
3 env steps of 2 sim steps with fixed non-zero actions after
``reset(seed=0)`` from the uniform flow:

* ``CylinderRot2D`` at Re 100 (central advection) and Re 500 (the blend),
  and ``CylinderJet2D`` at Re 500, at resolution 16 (5 blocks, 2
  super-blocks);
* ``CylinderJet3D`` at Re 500 (the blend) at resolution 8 with 4 jets
  (15,872 cells, periodic z), SARL, with the steps' pressure tol set to
  1e-8 in both packages after ``reset`` (at the registered 5e-7 the two
  packages' float64 solves stop a few iterations apart on the impulsive
  start; see ``tests/test_torch_cylinder3d_env.py``).

Bar: obs, reward, drag and lift (per z-slice too in 3D) <= 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from torch_port_helpers import CYL_KW

torch.set_num_threads(1)
BAR = 1e-4


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rollout(env, actions, keys, pressure_tol=None):
    obs, _ = env.reset(seed=0)
    if pressure_tol is not None:
        env._cfg = dataclasses.replace(env._cfg, pressure_tol=pressure_tol)
    out = [dict(velocity=_np(obs["velocity"]), pressure=_np(obs["pressure"]))]
    for a in actions:
        obs, reward, _, _, info = env.step(a)
        rec = dict(velocity=_np(obs["velocity"]), pressure=_np(obs["pressure"]),
                   reward=_np(reward),
                   converged=bool(np.asarray(info["pressure_converged"])))
        rec.update({k: _np(info[k]) for k in keys})
        out.append(rec)
    return out


def _pair(env_id, kw, actions, keys, pressure_tol=None):
    with jax.enable_x64(True):
        jenv = fluidgym_tpu.make(env_id, dtype=jnp.float64, **kw)
        j = _rollout(jenv, actions, keys, pressure_tol)
    tenv = fluidgym_tpu_torch.make(env_id, device="cpu", dtype=torch.float64,
                                   **kw)
    t = _rollout(tenv, actions, keys, pressure_tol)
    assert tenv._state.blocks[0].velocity.dtype == torch.float64
    assert tenv._cfg.advection_upwind_blend == jenv._cfg.advection_upwind_blend
    for i, (a, b) in enumerate(zip(j, t)):
        for k in ("velocity", "pressure") + (("reward",) + keys if i else ()):
            assert b[k].shape == a[k].shape, (i, k, b[k].shape, a[k].shape)
            assert _rel(b[k], a[k]) <= BAR, (i, k, _rel(b[k], a[k]))
        if i:
            assert a["converged"] == b["converged"], i
    return tenv


@pytest.mark.parametrize("env_id,re", [("CylinderRot2D-easy-v0", 100),
                                       ("CylinderRot2D-hard-v0", 500),
                                       ("CylinderJet2D-hard-v0", 500)])
def test_2d_steps_match_jax_float64(env_id, re):
    actions = [np.array([a], np.float32) for a in (0.6, -0.4, 0.9)]
    kw = dict(CYL_KW, reynolds_number=re)
    env = _pair(env_id, kw, actions, ("drag", "lift"))
    assert env._cfg.advection_upwind_blend == (0.3 if re >= 500 else 0.0)


def test_3d_re500_steps_match_jax_float64():
    base = np.linspace(-0.8, 0.9, 4).astype(np.float32)[:, None]
    actions = [base, -0.5 * base[::-1], 0.3 * np.ones_like(base)]
    kw = dict(resolution=8, n_jets=4, reynolds_number=500,
              load_initial_domain=False, load_domain_statistics=False,
              randomize_initial_state=False, episode_length=4,
              step_length=0.02, dt=0.01)
    env = _pair("CylinderJet3D-easy-v0", kw, actions,
                ("drag", "lift", "all_cds", "all_cls"), pressure_tol=1e-8)
    assert env._cfg.advection_upwind_blend == 0.3
