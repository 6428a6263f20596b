"""``fluidgym_tpu_torch.parallel.BatchedFluidEnv`` against the JAX package's
``BatchedFluidEnv`` (twins of ``tests/test_batched_env.py``), on the CPU.

Both packages step from the same numpy batched state (the JAX package's
after ``reset(seed=0)``) with the same seeded numpy actions.

Bars:

* against the JAX package: obs and reward <= 1e-4 relative after 2 steps
  (the parity bar of short rollouts); RBC in float32, the cylinder in
  float64 (in float32 its impulsive start is decided by rounding at ~1e-4
  in either package, see ``tests/test_torch_cylinder_env.py``);
* each lane against the port's single env stepped from the same state with
  the same actions: <= 1e-6 relative (RBC lanes are bit-equal: on the CPU
  every lane solves in its own lockstep chunk, as on the card);
* ``lockstep_chunk`` groups against one group: equal.

The JAX side runs in two module-scoped fixtures (RBC, the cylinder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu_torch
from fluidgym_tpu_torch.core.domain import domain_state_from_numpy
from fluidgym_tpu_torch.parallel import BatchedFluidEnv
from fluidgym_tpu_torch.parallel.batched_env import _pack, _tree_map
from torch_port_helpers import CYL_KW

torch.set_num_threads(1)
BAR, LANE_BAR = 1e-4, 1e-6
ID = "RBC2D-easy-v0"
CYL = "CylinderJet2D-easy-v0"
#: tests/test_batched_env.py's DEV_KW
DEV_KW = dict(load_initial_domain=False, load_domain_statistics=False,
              randomize_initial_state=False, episode_length=3, step_length=0.1,
              dt=0.05, n_heaters=4, resolution=4, local_obs_window=3)
CYL_BKW = dict(CYL_KW, episode_length=2)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _actions(n, shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n,) + tuple(shape)).astype(np.float32)
            for _ in range(2)]


def _jax_run(jb, actions, poison=None):
    """Reset (seed 0), optionally NaN one lane, step; numpy results."""
    jb.reset(seed=0)
    if poison is not None:
        jb._bstate = jax.tree.map(
            lambda x: x.at[poison].set(jnp.nan)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, jb._bstate)
    start = jax.tree.map(np.asarray, jb._bstate)
    steps = []
    for a in actions:
        obs, rew, term, trunc, info = jb.step(a)
        steps.append(dict(obs=_np(obs), rew=_np(rew), term=_np(term),
                          trunc=_np(trunc),
                          final=_np(info.get("final_observation", {}))))
    return start, steps


def _port(n, jstart, dtype=torch.float32, **kw):
    """A port batched env reset like the JAX one, then put on its numpy
    start state (DomainState, or the cylinder's (state, last_control))."""
    tb = BatchedFluidEnv(kw.pop("env_id", ID), n, device="cpu", dtype=dtype, **kw)
    tb.reset(seed=0)
    _put(tb, jstart, dtype)
    return tb


def _put(tb, jstart, dtype=torch.float32):
    carry = jstart if isinstance(jstart, tuple) else (jstart,)
    state = domain_state_from_numpy(carry[0], dtype=dtype)
    extra = tuple(torch.as_tensor(np.array(c)).to(dtype) for c in carry[1:])
    tb._bcarry = _pack((state,) + extra)


def _port_steps(tb, actions):
    out = []
    for a in actions:
        obs, rew, term, trunc, info = tb.step(a)
        out.append(dict(obs=_np(obs), rew=_np(rew), term=_np(term),
                        trunc=_np(trunc),
                        final=_np(info.get("final_observation", {}))))
    return out


def _assert_steps(port, ref, what):
    for i, (p, j) in enumerate(zip(port, ref)):
        assert np.array_equal(p["term"], j["term"]), (what, i)
        assert np.array_equal(p["trunc"], j["trunc"]), (what, i)
        assert _rel(p["rew"], j["rew"]) <= BAR, (what, i, p["rew"], j["rew"])
        for k in j["obs"]:
            assert p["obs"][k].shape == j["obs"][k].shape, (what, k)
            assert _rel(p["obs"][k], j["obs"][k]) <= BAR, (what, i, k)
        assert set(p["final"]) == set(j["final"]), (what, i)
        for k in j["final"]:
            assert _rel(p["final"][k], j["final"][k]) <= BAR, (what, i, k)


@pytest.fixture(scope="module")
def jax_rbc():
    """The JAX package's batched RBC runs: SARL, MARL, auto-reset and a
    diverged lane."""
    from fluidgym_tpu.parallel import BatchedFluidEnv as JaxBatched

    out = {}
    jb = JaxBatched(ID, n_envs=3, **DEV_KW)
    acts = _actions(3, jb.action_space.shape, 1)
    out["sarl"] = (acts,) + _jax_run(jb, acts)
    jb = JaxBatched(ID, n_envs=2, use_marl=True, **DEV_KW)
    acts = _actions(2 * jb.n_agents, jb.action_space.shape, 2)
    out["marl"] = (acts,) + _jax_run(jb, acts)
    jb = JaxBatched(ID, n_envs=3, **dict(DEV_KW, episode_length=2))
    acts = [np.zeros((3,) + tuple(jb.action_space.shape), np.float32)] * 3
    out["auto"] = (acts,) + _jax_run(jb, acts)
    jb = JaxBatched(ID, n_envs=3, **DEV_KW)
    acts = acts[:2]
    out["nan"] = (acts,) + _jax_run(jb, acts, poison=1)
    return out


@pytest.fixture(scope="module")
def jax_cyl():
    """The JAX package's batched cylinder (tuple carry) in float64, 3 envs
    with distinct actions."""
    from fluidgym_tpu.parallel import BatchedFluidEnv as JaxBatched

    with jax.enable_x64(True):
        jb = JaxBatched(CYL, n_envs=3, dtype=jnp.float64, **CYL_BKW)
        acts = [np.array([[0.8], [-0.4], [0.1]], np.float32),
                np.array([[-0.6], [0.9], [0.0]], np.float32)]
        start, steps = _jax_run(jb, acts)
    return acts, start, steps


def test_batched_sarl_step(jax_rbc):
    acts, start, ref = jax_rbc["sarl"]
    tb = BatchedFluidEnv(ID, 3, device="cpu", **DEV_KW)
    obs, _ = tb.reset(seed=0)
    for k, v in obs.items():
        assert v.shape == (3,) + tuple(tb.observation_space[k].shape)
    _put(tb, start)
    out = _port_steps(tb, acts)
    _assert_steps(out, ref, "sarl")
    assert out[-1]["rew"].shape == (3,)
    assert len(np.unique(out[-1]["rew"].round(8))) > 1


def test_batched_mesh_raises():
    """Mesh sharding (the JAX test at test_batched_env.py:38) is not
    ported: the port says so instead of ignoring the mesh."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        BatchedFluidEnv(ID, 8, mesh=object(), device="cpu", **DEV_KW)


def test_diverged_lane_rewards_and_obs_sanitized(jax_rbc):
    acts, start, ref = jax_rbc["nan"]
    tb = _port(3, start, **DEV_KW)
    out = _port_steps(tb, acts)
    first = out[0]
    assert list(first["term"]) == [False, True, False]
    assert np.isfinite(first["rew"]).all()
    assert first["rew"][1] == tb.divergence_reward < -10.0
    for v in list(first["obs"].values()) + list(first["final"].values()):
        assert np.isfinite(v).all()
    # the lane was auto-reset in place: the next step is healthy
    assert not out[1]["term"].any() and np.isfinite(out[1]["rew"]).all()
    _assert_steps(out, ref, "diverged lane")


def test_late_divergence_guard_terminates_on_bad_obs(monkeypatch):
    benv = BatchedFluidEnv(ID, 3, device="cpu", **DEV_KW)
    benv.reset(seed=0)
    benv._bcarry = _poison(benv._bcarry, 1)
    monkeypatch.setattr(benv, "_per_env_terminated",
                        lambda info: np.zeros(benv.n_envs, bool))
    actions = np.zeros((3,) + tuple(benv.action_space.shape), np.float32)
    obs, rew, term, trunc, info = benv.step(actions)
    assert term.tolist() == [False, True, False]
    assert float(rew[1]) == benv.divergence_reward
    for v in obs.values():
        assert bool(torch.isfinite(v).all())


def _poison(packed, lane):
    """A packed carry with every floating tensor of ``lane`` set to NaN."""
    def nan(t):
        if not t.is_floating_point():
            return t
        t = t.clone()
        t[lane] = float("nan")
        return t
    return _tree_map(nan, packed)


def test_batched_marl_step(jax_rbc):
    acts, start, ref = jax_rbc["marl"]
    tb = _port(2, start, use_marl=True, **DEV_KW)
    out = _port_steps(tb, acts)
    n_total = 2 * tb.n_agents
    assert out[0]["rew"].shape == (n_total,)
    for v in out[0]["obs"].values():
        assert v.shape[0] == n_total
    _assert_steps(out, ref, "marl")


def test_batched_cylinder_tuple_carry(jax_cyl):
    """The cylinder's (state, last_control) carry, in float64: against the
    JAX package, and every lane against the port's single env from the same
    state with the same actions."""
    acts, start, ref = jax_cyl
    tb = _port(3, start, dtype=torch.float64, env_id=CYL, **CYL_BKW)
    out = _port_steps(tb, acts)
    assert out[0]["obs"]["velocity"].shape == (3, 151, 2)
    _assert_steps(out, ref, "cylinder")
    state = domain_state_from_numpy(start[0], dtype=torch.float64)
    for lane in range(3):
        env = fluidgym_tpu_torch.make(CYL, device="cpu", dtype=torch.float64,
                                      **CYL_BKW)
        env.reset(seed=0)
        env._state = _lane_state(state, lane)
        env._last_control = torch.as_tensor(np.array(start[1][lane]))
        for i, a in enumerate(acts):
            obs, rew, *_ = env.step(a[lane])
            assert _rel(_np(rew), out[i]["rew"][lane]) <= LANE_BAR
            # the batch truncates at the last step: its obs are the next
            # episode's, the stepped ones are the final_observation
            got = out[i]["final"] if out[i]["trunc"][lane] else out[i]["obs"]
            for k, v in obs.items():
                assert _rel(_np(v), got[k][lane]) <= LANE_BAR, (lane, i, k)


def _lane_state(bstate, lane):
    from fluidgym_tpu_torch.core.domain import map_state
    return map_state(bstate, lambda t: t[lane].clone())


def test_lanes_match_single_env_rbc(jax_rbc):
    """Each RBC lane against the port's single env from the same state
    with the same actions: bit-equal (every lane solves alone)."""
    acts, start, _ = jax_rbc["sarl"]
    tb = _port(3, start, **DEV_KW)
    out = _port_steps(tb, acts)
    state = domain_state_from_numpy(start)
    for lane in range(3):
        env = fluidgym_tpu_torch.make(ID, device="cpu", **DEV_KW)
        env.reset(seed=0)
        env._state = _lane_state(state, lane)
        for i, a in enumerate(acts):
            obs, rew, *_ = env.step(a[lane])
            assert _rel(_np(rew), out[i]["rew"][lane]) <= LANE_BAR
            for k, v in obs.items():
                assert np.array_equal(_np(v), out[i]["obs"][k][lane]), (lane, i, k)


def test_seed_method_affects_unseeded_reset():
    def make_benv():
        return BatchedFluidEnv(
            ID, 2, device="cpu", n_heaters=4, resolution=4, local_obs_window=3,
            load_initial_domain=False, load_domain_statistics=False,
            episode_length=3, step_length=0.1, dt=0.05)

    b1 = make_benv()
    b1.seed(42)
    o1, _ = b1.reset()
    b2 = make_benv()
    b2.seed(7)
    o2, _ = b2.reset()
    diff = max(float((o1[k] - o2[k]).abs().max()) for k in o1)
    assert diff > 0.0, "different seed() must change unseeded reset"


def test_batched_auto_reset(jax_rbc):
    """Finished slots are reset in place and report the old episodes' last
    obs as final_observation; matches the JAX package step for step."""
    acts, start, ref = jax_rbc["auto"]
    tb = _port(3, start, **dict(DEV_KW, episode_length=2))
    out = _port_steps(tb, acts)
    assert not out[0]["trunc"].any() and not out[0]["final"]
    assert out[1]["trunc"].all() and out[1]["final"]
    assert not out[2]["trunc"].any()
    _assert_steps(out, ref, "auto-reset")
    # final_observation is what the un-reset trajectory would have given
    ref_env = _port(3, start, auto_reset=False, **dict(DEV_KW, episode_length=2))
    last = _port_steps(ref_env, acts[:2])[-1]["obs"]
    for k in last:
        assert np.array_equal(out[1]["final"][k], last[k])


def test_batched_auto_reset_off():
    kw = dict(DEV_KW, episode_length=1)
    benv = BatchedFluidEnv(ID, 2, auto_reset=False, device="cpu", **kw)
    benv.reset(seed=0)
    nact = benv.action_space.shape
    obs, rew, term, trunc, info = benv.step(np.zeros((2,) + tuple(nact), np.float32))
    assert bool(trunc.all())
    assert "final_observation" not in info


def test_lockstep_chunk_matches_unchunked():
    """Groups stepping one after another are a scheduling change only."""
    kw = dict(DEV_KW, episode_length=10**9)
    full = BatchedFluidEnv(ID, 4, device="cpu", **kw)
    chunked = BatchedFluidEnv(ID, 4, lockstep_chunk=2, device="cpu", **kw)
    full.reset(seed=0)
    chunked.reset(seed=0)
    for a in _actions(4, full.action_space.shape, 3):
        _, r_f, *_ = full.step(a)
        _, r_c, *_ = chunked.step(a)
    assert torch.equal(r_f, r_c)
    _tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
              full._bcarry, chunked._bcarry)


def test_lockstep_chunk_validation():
    with pytest.raises(ValueError, match="divisor"):
        BatchedFluidEnv(ID, 4, lockstep_chunk=3, device="cpu", **DEV_KW)
    assert BatchedFluidEnv(ID, 256, device="cpu", **DEV_KW).lockstep_chunk == 128
    assert BatchedFluidEnv(ID, 4, device="cpu", **DEV_KW).lockstep_chunk is None


def test_load_initial_domain_fills_every_slot():
    """``load_initial_domain`` puts one bundled snapshot (RBC2D-easy at full
    width) into every slot: equal actions then give equal lanes, each the
    single env's step from the same snapshot."""
    from fluidgym_tpu_torch.types import EnvMode

    kw = dict(device="cpu", randomize_initial_state=False, step_length=0.1,
              dt=0.05)
    benv = BatchedFluidEnv(ID, 2, **kw)
    benv.seed(0)
    benv.load_initial_domain(EnvMode.TRAIN, 0)
    act = np.zeros((2,) + tuple(benv.action_space.shape), np.float32)
    obs, rew, *_ = benv.step(act)
    env = fluidgym_tpu_torch.make(ID, **kw)
    env.seed(0)
    env.load_initial_domain(EnvMode.TRAIN, 0)
    o1, r1, *_ = env.step(act[0])
    for k, v in o1.items():
        assert torch.equal(obs[k][0], obs[k][1])
        assert torch.equal(obs[k][0], v)
    assert torch.equal(rew[0], r1.reshape(()))
