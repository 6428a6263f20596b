"""Airfoil3D-easy end to end: the port's ``AirfoilEnv3D`` against the JAX
package's on the C-grid extruded over ``_res_z = 2`` (146,912 cells; both
packages' class attribute set for the module, as ``tests/test_airfoil_env.py``
does), in float64.

* the registered defaults key for key, the spaces (SARL, MARL, MARL with
  ``local_2d_obs``), the medium and hard ids unregistered and a 3D config at
  Re >= 3000 refused, naming the 3D aggregation space;
* ``load_initial_domain=True`` raises at reset in both packages (no
  ``airfoil_3D_*`` set is bundled; the JAX package's download is stubbed);
* the 2D warm start: the same snapshot index drawn from the seed (seed 23
  draws ``train_00``, seed 21 ``train_03``), the same 3D state, and its
  shape-mismatch and missing-file paths keeping the uniform state;
* one SARL env step of one sim step (``step_length = dt = 0.002``) with
  the registered pressure tol 1e-8 in both packages: the port resets
  (seed 23) and steps 3 times, the JAX env takes the port's state and
  smoothed control from there and both take the fourth step; obs and
  reward <= 1e-4 relative.  The JAX step runs eagerly (``jax.disable_jit``:
  ~0.09 s per pressure iteration on one core, ~800 iterations in that
  step; its jitted 3D step compiles for ~5 min).  Eagerly from the reset
  (2,759 iterations) the two packages' rewards agreed to 6e-10;
* MARL on a carried state at ``_res_z`` 4 (4 agents): the local
  observations (windows of 3, and ``local_2d_obs``), the per-segment
  action on the jet face, the per-slice drag and lift and the agents'
  rewards through the JAX env's own ``_pure_local_obs`` /
  ``_pure_apply_action`` / ``_pure_drag_lift`` / ``_pure_step_marl`` (its
  sim steps stubbed by the per-slice forces), to 1e-10 relative: twins of
  ``tests/test_airfoil_env.py:79,119`` (both ``slow`` there), with no
  jitted JAX 3D step.

Every JAX env here is built with ``load_domain_statistics=False`` and, but
for the raising case (whose download is stubbed), ``load_initial_domain=
False``: there is no 3D set to fetch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.envs.airfoil import airfoil_env_base as jbase
from fluidgym_tpu.envs.airfoil.airfoil_env_3d import AirfoilEnv3D as JEnv3D
from fluidgym_tpu.utils import data_utils as jdata
from fluidgym_tpu_torch.core.domain import (domain_state_from_numpy,
                                            domain_state_to_numpy)
from fluidgym_tpu_torch.envs.airfoil import airfoil_env_3d as tmod
from fluidgym_tpu_torch.envs.airfoil.airfoil_env_3d import AirfoilEnv3D as TEnv3D
from torch_port_helpers import jax_domain_state

torch.set_num_threads(1)
ID = "Airfoil3D-easy-v0"
RES_Z = 2
BAR = 1e-4
DT = 0.002
KW = dict(load_initial_domain=False, load_domain_statistics=False,
          randomize_initial_state=False, episode_length=4, step_length=DT,
          dt=DT)
SARL = dict(KW, n_agents=1)
MARL = dict(KW, n_agents=2, use_marl=True, local_obs_window=3,
            local_reward_weight=0.5)
ACTION = np.array([[1.0, -0.5, -0.5]], np.float32)
#: SARL steps the port takes from the reset before the compared step
WARM_STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def span():
    """Both packages' span at ``RES_Z`` cells, and the JAX env's uniform
    render plan (13.5 M points, only ``get_velocity`` reads it) left out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEnv3D, "_res_z", RES_Z)
        mp.setattr(TEnv3D, "_res_z", RES_Z)
        mp.setattr(jbase, "make_multiblock_plan", lambda *a, **k: None)
        yield


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pair(kw):
    t = fluidgym_tpu_torch.make(ID, device="cpu", dtype=torch.float64, **kw)
    with jax.enable_x64(True):
        j = fluidgym_tpu.make(ID, dtype=jnp.float64, **kw)
    return t, j


# ---------------------------------------------------------------------------
# registry, spaces, refusals
# ---------------------------------------------------------------------------

def test_registered_defaults_match_jax():
    tcfg = fluidgym_tpu_torch.registry._entries[ID][1]
    jcfg = fluidgym_tpu.registry._entries[ID][1]
    assert tcfg.keys() == jcfg.keys()
    for k in jcfg:
        assert tcfg[k] == jcfg[k] and type(tcfg[k]) is type(jcfg[k]), k
    assert tcfg["reynolds_number"] == 1e3 and tcfg["init_from_2d"] is True
    ids = fluidgym_tpu_torch.registry.ids()
    assert "Airfoil3D-medium-v0" not in ids and "Airfoil3D-hard-v0" not in ids


@pytest.mark.parametrize("kw", [SARL, MARL, dict(MARL, local_2d_obs=True)],
                         ids=["sarl", "marl", "local_2d_obs"])
def test_spaces_match_jax(kw):
    t, j = _pair(kw)
    assert t.n_agents == j.n_agents
    assert t.action_space.shape == j.action_space.shape
    for k in ("velocity", "pressure"):
        assert t.observation_space[k].shape == j.observation_space[k].shape, k
    np.testing.assert_array_equal(t._sensor_locations, j._sensor_locations)
    np.testing.assert_array_equal(t._airfoil_mask, j._airfoil_mask)
    assert t._airfoil_mask.shape == (150, 150, 600)


def test_3d_re3000_raises_naming_the_aggregation_space():
    with pytest.raises(NotImplementedError, match="3D aggregation"):
        fluidgym_tpu_torch.make(ID, device="cpu", reynolds_number=3e3, **SARL)
    with pytest.raises(ValueError, match="divides"):
        fluidgym_tpu_torch.make(ID, device="cpu", **dict(SARL, n_agents=3))


def test_load_initial_domain_raises_as_in_jax(monkeypatch):
    """No ``airfoil_3D_*`` set is bundled: the registered
    ``load_initial_domain=True`` raises at reset in both packages."""
    monkeypatch.setattr(jdata, "prepare_initial_domains", lambda i: None)
    kw = dict(SARL, load_initial_domain=True)
    t, j = _pair(kw)
    with pytest.raises(RuntimeError, match="Initial domain not found"):
        t.reset(seed=23)
    with jax.enable_x64(True), pytest.raises(RuntimeError,
                                             match="Initial domain not found"):
        j.reset(seed=23)


# ---------------------------------------------------------------------------
# the 2D warm start
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,idx", [(23, 0), (21, 3)])
def test_2d_warm_start_matches_jax(seed, idx):
    """The snapshot index comes from the env's numpy generator; the 2D
    velocity is broadcast over the span with no z component, in both
    packages."""
    assert int(np.random.default_rng(seed).integers(0, 10)) == idx
    t, j = _pair(SARL)
    t.seed(seed)
    with jax.enable_x64(True):
        j.seed(seed)
        _, _, js = j._get_domain()
    _, _, ts = t._get_domain()
    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.utils import data_utils

    _, _, s2d = load_domain(data_utils.initial_domain_dir("airfoil_2D_Re1000")
                            / f"train_{idx:02d}", dtype=torch.float64)
    for jb, tb, b2 in zip(js.blocks, ts.blocks, s2d.blocks):
        np.testing.assert_array_equal(_np(tb.velocity), np.asarray(jb.velocity))
        assert bool((tb.velocity[2] == 0).all())
        for z in range(RES_Z):
            assert torch.equal(tb.velocity[:2, z], b2.velocity)


def test_warm_start_skips_on_mismatch_and_missing_data(monkeypatch, caplog):
    """A 2D snapshot whose block 4 is a cell short stops the warm start
    there (blocks 0-3 carry the 2D field, 4-5 the uniform state), and a
    missing snapshot keeps the uniform state, with a warning each, as in
    the JAX package (its loader patched the same way)."""
    from fluidgym_tpu.core import domain_io as jio

    t, j = _pair(SARL)
    t.seed(23)
    base = super(TEnv3D, t)._get_domain()[2]  # the uniform state
    real_t, real_j = tmod.load_domain, jio.load_domain

    def cut(real):
        def load(path, **kw):
            topo, geoms, st = real(path, **kw)
            blk = st.blocks[4]
            return topo, geoms, st.replace_block(
                4, dataclasses.replace(blk, velocity=blk.velocity[:, :, :-1]))
        return load

    def missing(path, **kw):
        raise FileNotFoundError(path)

    for t_load, j_load, msg, warm in (
            (cut(real_t), cut(real_j), "shape mismatch for block 4", 4),
            (missing, missing, "2D initial domain not found", 0)):
        monkeypatch.setattr(tmod, "load_domain", t_load)
        monkeypatch.setattr(jio, "load_domain", j_load)
        t.seed(23)
        caplog.clear()
        with caplog.at_level("WARNING"):
            _, _, st = t._get_domain()
        assert msg in caplog.text
        with jax.enable_x64(True):
            j.seed(23)
            _, _, js = j._get_domain()
        for b, (a, u, jb) in enumerate(zip(st.blocks, base.blocks, js.blocks)):
            np.testing.assert_array_equal(_np(a.velocity), np.asarray(jb.velocity))
            assert torch.equal(a.velocity, u.velocity) == (b >= warm), (msg, b)


# ---------------------------------------------------------------------------
# SARL rollout and MARL on the carried state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rollout():
    """The port: ``reset(seed=23)``, then ``WARM_STEPS`` SARL steps, then
    the compared step.  The JAX env: reset from the same seed (the same 2D
    warm start, its sensor plans), handed the port's state and smoothed
    control from before the compared step, and stepped eagerly.  (The first
    steps from the reset take ~2,800-4,000 pressure iterations at tol 1e-8,
    ~800 from the fourth on; eagerly the JAX package spends ~0.09 s per
    iteration here.)"""
    t, j = _pair(SARL)
    out = {}
    t.reset(seed=23)
    assert t._cfg.pressure_tol == 1e-8
    for _ in range(WARM_STEPS):
        tobs, *_ = t.step(ACTION)
    out["t0"] = {k: _np(v) for k, v in tobs.items()}
    start = domain_state_to_numpy(t._state)
    control = _np(t._last_control)
    tobs, trew, _, _, tinfo = t.step(ACTION)
    out["t1"] = dict({k: _np(v) for k, v in tobs.items()}, reward=_np(trew),
                     drag=_np(tinfo["drag"]), lift=_np(tinfo["lift"]),
                     all_cds=_np(tinfo["all_cds"]),
                     iterations=int(tinfo["pressure_iterations"]),
                     conv=_np(tinfo["pressure_converged"]))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jbase, "jit_make_divergence_free", lambda s, g, topo, cfg: s)
        j.reset(seed=23)
        assert j._cfg.pressure_tol == 1e-8
        j._state = jax_domain_state(start, np.float64)
        j._last_control = jnp.asarray(control)
        out["j0"] = {k: np.asarray(v) for k, v in j._get_global_obs().items()}
        with jax.disable_jit():
            jobs, jrew, _, _, jinfo = j.step(ACTION)
        out["j1"] = dict({k: np.asarray(v) for k, v in jobs.items()},
                         reward=np.asarray(jrew), drag=np.asarray(jinfo["drag"]),
                         lift=np.asarray(jinfo["lift"]),
                         all_cds=np.asarray(jinfo["all_cds"]),
                         iterations=int(np.asarray(jinfo["pressure_iterations"])),
                         conv=np.asarray(jinfo["pressure_converged"]))
    return out


def test_sarl_step_matches_jax(rollout):
    """The carried state's obs (the same state through both packages'
    sensor plans), then the step's obs, reward and drag / lift (also per
    z-slice) to 1e-4 relative; every solve converged, the step's pressure
    iterations within 3."""
    r = rollout
    for k in ("velocity", "pressure"):
        assert _rel(r["t0"][k], r["j0"][k]) <= BAR, ("carried", k)
        assert _rel(r["t1"][k], r["j1"][k]) <= BAR, ("step", k)
    for k in ("reward", "drag", "lift", "all_cds"):
        assert _rel(r["t1"][k], r["j1"][k]) <= BAR, k
    assert r["t1"]["all_cds"].shape == (RES_Z,)
    assert bool(r["t1"]["conv"].all()) and bool(r["j1"]["conv"].all())
    assert abs(r["t1"]["iterations"] - r["j1"]["iterations"]) <= 3


@pytest.mark.parametrize("local_2d", [False, True], ids=["windows", "local_2d_obs"])
def test_marl_pure_functions_match_jax(monkeypatch, local_2d):
    """Twins of ``tests/test_airfoil_env.py:79,119`` on a span of 4 cells
    with 4 agents (windows of 3, local reward weight 0.5; and
    ``local_2d_obs``), without a jitted JAX step: a carried state (the
    warm-started flow of seed 23 with seeded noise on velocity and
    pressure, made once in numpy and handed to both packages), then the
    agents' observations, the per-segment action on the jet face
    (zero-mean per segment, fluxes rebalanced), the per-slice forces and
    the blended rewards through the JAX env's own pure functions (eager;
    its sim steps stubbed by the per-slice forces), to 1e-10 relative.
    Both packages' projection at reset is skipped: the state is
    replaced."""
    from fluidgym_tpu_torch.envs.airfoil import airfoil_env_base as tbase

    monkeypatch.setattr(JEnv3D, "_res_z", 4)
    monkeypatch.setattr(TEnv3D, "_res_z", 4)
    monkeypatch.setattr(jbase, "jit_make_divergence_free",
                        lambda s, g, topo, cfg: s)
    monkeypatch.setattr(tbase.piso, "make_divergence_free",
                        lambda s, g, topo, cfg: s)
    kw = dict(MARL, n_agents=4)
    if local_2d:
        kw = dict(kw, local_2d_obs=True)
    t, j = _pair(kw)
    t.reset(seed=23)
    with jax.enable_x64(True):
        j.reset(seed=23)
    host = domain_state_to_numpy(t._state)
    rng = np.random.default_rng(5)
    for b in host.blocks:
        b.velocity[...] += 0.05 * rng.standard_normal(b.velocity.shape)
        b.pressure[...] = rng.standard_normal(b.pressure.shape)
    tstate = domain_state_from_numpy(host, dtype=torch.float64)
    acts = np.array([[1.0, -0.5, 0.2], [-0.3, 0.9, 0.4], [0.0, 0.0, 0.0],
                     [2.0, -2.0, 0.5]])
    with jax.enable_x64(True):
        jstate = jax_domain_state(host, np.float64)
        tl = t._pure_local_obs(tstate)
        jl = j._pure_local_obs(jstate)
        for k in ("velocity", "pressure"):
            assert tuple(tl[k].shape) == (4,) + t.observation_space[k].shape, k
            assert _rel(_np(tl[k]), jl[k]) <= 1e-10, k
        ta = t._pure_apply_action(tstate, torch.as_tensor(acts))
        ja = j._pure_apply_action(jstate, jnp.asarray(acts))
        for b in range(6):
            for f in range(6):
                jv = ja.blocks[b].faces[f].velocity
                if jv is not None:
                    assert _rel(_np(ta.blocks[b].faces[f].velocity), jv) <= 1e-10, (b, f)
        tcd, tcl = t._pure_drag_lift(ta)
        jcd, jcl = j._pure_drag_lift(ja)
        assert tuple(tcd.shape) == (4,)
        assert _rel(_np(tcd), jcd) <= 1e-10 and _rel(_np(tcl), jcl) <= 1e-10
        tobs, trew, tinfo = t._pure_end_marl((ta, t._last_control),
                                             [(tcd, tcl)])
        monkeypatch.setattr(
            jbase.AirfoilEnvBase, "_pure_step",
            lambda self, carry, action: (carry, None, None,
                                         {"drag": jcd, "lift": jcl}))
        _, jobs, jrew, jinfo = j._pure_step_marl((ja, j._last_control),
                                                 jnp.asarray(acts))
    assert tuple(trew.shape) == (4,)
    assert _rel(_np(trew), jrew) <= 1e-10
    assert _rel(_np(tinfo["global_reward"]), jinfo["global_reward"]) <= 1e-10
    for k in ("velocity", "pressure"):
        assert _rel(_np(tobs[k]), jobs[k]) <= 1e-10, k
