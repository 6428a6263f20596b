"""Airfoil2D-medium-v0 (Re 3000) and -hard-v0 (Re 5000): the velocity
advection matrix's upwind blend 0.3 and the aggregation coarse space of the
pressure solve (8 x 8 tiles, k = 1,194 on the 73,456-cell C-grid).

* The registry entries and the Re >= 3000 gating against the JAX package.
* One env step of ``step_length = dt = 0.05`` (one sim step) of each id at
  full width from the bundled ``train_00``, both packages in float64, obs,
  reward, drag and lift <= 1e-4 relative.  The port solves every pressure
  corrector with K3-agg's plain version in the merged frame, the JAX
  package with ``linsolve.cg`` over the blocks and its aggregation
  ``coarse_fn``.  The JAX package's Galerkin cache is process-global: a
  JAX env of an earlier test with the same operator key would hand this
  one its E, so the JAX side rebuilds it from its own reset state
  (``force=True``) and drops its traced steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.solver import piso as jpiso
from fluidgym_tpu_torch.ops import cg_cuda_mb

torch.set_num_threads(1)
BAR = 1e-4
IDS = ("Airfoil2D-medium-v0", "Airfoil2D-hard-v0")
KW = dict(randomize_initial_state=False, load_domain_statistics=False,
          episode_length=5, step_length=0.05, dt=0.05)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _step(env):
    obs, reward, _, _, info = env.step(np.array([0.6, -0.2, -0.4], np.float32))
    return dict(velocity=_np(obs["velocity"]), pressure=_np(obs["pressure"]),
                reward=_np(reward), drag=_np(info["drag"]),
                lift=_np(info["lift"]),
                iterations=int(_np(info["pressure_iterations"])),
                converged=bool(_np(info["pressure_converged"])))


@pytest.mark.parametrize("env_id", IDS)
def test_registry_entry_matches_jax(env_id):
    tcls, tcfg = fluidgym_tpu_torch.registry._entries[env_id]
    jcls, jcfg = fluidgym_tpu.registry._entries[env_id]
    assert tcls.__name__ == jcls.__name__
    assert dict(tcfg) == dict(jcfg), env_id


@pytest.mark.parametrize("re_number", [1e3, 2999.0, 3e3, 5e3])
def test_re_gating_matches_jax(re_number):
    """Blend 0.3, tile 8 and the coarse preconditioner at Re >= 3000 only,
    as in the JAX package."""
    kw = dict(load_initial_domain=False, load_domain_statistics=False,
              randomize_initial_state=False, reynolds_number=re_number)
    t = fluidgym_tpu_torch.make("Airfoil2D-easy-v0", device="cpu", **kw)
    j = fluidgym_tpu.make("Airfoil2D-easy-v0", **kw)
    tc, jc = t._get_simulation(), j._get_simulation()
    hard = re_number >= 3000
    for name, want in (("advection_upwind_blend", 0.3 if hard else 0.0),
                       ("pressure_coarse_tile", 8 if hard else 0),
                       ("pressure_coarse_precondition", hard)):
        assert getattr(tc, name) == getattr(jc, name) == want, name


@pytest.mark.parametrize("env_id", IDS)
def test_one_step_matches_jax_float64(env_id):
    with jax.enable_x64(True):
        jenv = fluidgym_tpu.make(env_id, dtype=jnp.float64, **KW)
        jo, _ = jenv.reset(seed=0)
        jpiso.ensure_agg_coarse_cache(jenv._state, jenv._geoms, jenv._topo,
                                      jenv._cfg, force=True)
        jenv._jit_cache.clear()
        tenv = fluidgym_tpu_torch.make(env_id, device="cpu",
                                       dtype=torch.float64, **KW)
        to, _ = tenv.reset(seed=0)
        for k in ("velocity", "pressure"):
            assert _rel(_np(to[k]), np.asarray(jo[k])) <= BAR, ("reset", k)
        agg = tenv._cfg.pressure_agg
        assert agg is not None and agg.space.K == 1194
        calls = cg_cuda_mb.fused_cg_mb_plain.calls
        j, t = _step(jenv), _step(tenv)
    # every pressure corrector went through K3-agg's plain version
    solves = cg_cuda_mb.fused_cg_mb_plain.calls - calls
    assert solves > 0
    diffs = {k: _rel(t[k], j[k])
             for k in ("velocity", "pressure", "reward", "drag", "lift")}
    print(env_id, diffs, t["iterations"], j["iterations"], solves)
    assert all(v <= BAR for v in diffs.values()), diffs
    assert t["converged"] and j["converged"]
    # the Krylov bar: iterations within a few per solve
    assert abs(t["iterations"] - j["iterations"]) <= 3 * solves, (
        t["iterations"], j["iterations"], solves)
