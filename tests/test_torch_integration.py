"""The port's RL-framework adapters (``fluidgym_tpu_torch.integration``:
Gymnasium, PettingZoo, SB3, TorchRL), its logging and seeding helpers, and
the repository's examples replayed through the port.

Twins of ``tests/test_pettingzoo.py``, ``tests/test_sb3_eval.py`` (but its
``diff_tools`` test, which has its own twin) and ``tests/test_logging.py``,
held against the JAX package where they step an env (rollouts of at most 3
steps within 1e-4 of each quantity's scale).  The examples
(``examples/wrappers/*.py``, ``examples/interfaces/{gymnasium,pettingzoo,
sb3_vec_env,torchrl}_env.py``, ``examples/rendering.py``) run as written
with ``fluidgym_tpu`` read as ``fluidgym_tpu_torch`` and ``make`` given
``device="cpu"`` and a small size.  torchrl, tensordict and
stable-baselines3 are not installed here: their gates must raise
``ImportError``.
"""

import csv
import io
import logging
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.integration.pettingzoo import PettingZooFluidEnv as JPettingZoo
from fluidgym_tpu.wrappers import FlattenObservation as JFlatten
from fluidgym_tpu_torch.envs.fluid_env import env_state_from_numpy
from fluidgym_tpu_torch.integration.gymnasium import GymFluidEnv
from fluidgym_tpu_torch.integration.pettingzoo import PettingZooFluidEnv
from fluidgym_tpu_torch.integration.sb3 import (VecFluidEnv, evaluate_model,
                                                plot_eval_sequence)
from fluidgym_tpu_torch.wrappers import FlattenObservation
from torch_port_helpers import assert_rel

torch.set_num_threads(1)
RTOL = 1e-4
REPO = Path(__file__).resolve().parents[1]

DEV_KW = dict(
    n_heaters=4, resolution=4, use_marl=True, local_obs_window=3,
    load_initial_domain=False, load_domain_statistics=False,
    randomize_initial_state=False, episode_length=3,
    step_length=0.1, dt=0.05,
)
ENV_KW = dict(
    load_initial_domain=False,
    load_domain_statistics=False,
    randomize_initial_state=False,
    episode_length=2,
)


def _make(env_id="RBC2D-easy-v0", **kw):
    return fluidgym_tpu_torch.make(env_id, device="cpu", **kw)


class _ZeroModel:
    def __init__(self, space):
        self._space = space

    def predict(self, obs, deterministic=True):
        return np.zeros(self._space.shape, np.float32), None


@pytest.fixture(scope="module")
def penv():
    return PettingZooFluidEnv(FlattenObservation(_make(**DEV_KW)))


# ---------------------------------------------------------------------------
# PettingZoo (twins of tests/test_pettingzoo.py)
# ---------------------------------------------------------------------------
def test_requires_marl_and_flat_obs():
    sarl = _make(**{**DEV_KW, "use_marl": False})
    with pytest.raises(ValueError):
        PettingZooFluidEnv(FlattenObservation(sarl))
    marl_dict = _make(**DEV_KW)
    with pytest.raises(ValueError):
        PettingZooFluidEnv(marl_dict)  # un-flattened Dict obs


def test_parallel_api_contract(penv):
    import gymnasium

    n = len(penv.possible_agents)
    assert n > 1
    obs, infos = penv.reset(seed=0)
    assert set(obs) == set(penv.possible_agents)
    for a in penv.possible_agents:
        o = obs[a]
        assert isinstance(o, np.ndarray)
        assert tuple(o.shape) == tuple(penv.observation_space(a).shape)
        assert np.isfinite(o).all()
    assert isinstance(penv.action_space("agent_0"), gymnasium.spaces.Box)

    actions = {a: penv.action_space(a).sample() for a in penv.possible_agents}
    obs, rewards, terms, truncs, infos = penv.step(actions)
    assert set(rewards) == set(penv.possible_agents)
    for a in penv.possible_agents:
        assert np.isfinite(rewards[a])
        assert isinstance(terms[a], bool) and isinstance(truncs[a], bool)


def test_parallel_step_matches_jax():
    """The same actions from the same state through both packages'
    PettingZoo adapters."""
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", **DEV_KW)
    tenv = _make(**DEV_KW)
    jp, tp = JPettingZoo(JFlatten(jenv)), PettingZooFluidEnv(FlattenObservation(tenv))
    jp.reset(seed=2)
    tp.reset(seed=2)
    tenv.set_state(env_state_from_numpy(jenv.get_state()))
    rng = np.random.default_rng(0)
    for i in range(2):
        actions = {a: rng.uniform(-1, 1, (1,)).astype(np.float32)
                   for a in tp.possible_agents}
        jo, jr, *_ = jp.step(actions)
        to, tr, *_ = tp.step(actions)
        for a in tp.possible_agents:
            assert_rel(to[a], np.asarray(jo[a]), RTOL, f"step {i} obs {a}")
        assert_rel([tr[a] for a in tr], [jr[a] for a in jr], RTOL, f"step {i} rewards")


def test_truncation_clears_agents(penv):
    penv.reset(seed=1)
    for _ in range(3):  # episode_length = 3
        actions = {a: penv.action_space(a).sample()
                   for a in penv.possible_agents}
        obs, rewards, terms, truncs, infos = penv.step(actions)
    assert all(truncs.values())
    assert penv.agents == []


# ---------------------------------------------------------------------------
# SB3 (twins of tests/test_sb3_eval.py)
# ---------------------------------------------------------------------------
def test_evaluate_model_sarl(tmp_path):
    """Full-width RBC2D-easy, a 2-step episode; the metrics against the
    JAX package's ``evaluate_model`` from the same seed."""
    from fluidgym_tpu.integration.gymnasium import GymFluidEnv as JGym
    from fluidgym_tpu.integration.sb3 import evaluate_model as jevaluate

    env = GymFluidEnv(_make(**ENV_KW))
    env.unwrapped.seed(0)
    model = _ZeroModel(env.action_space)
    df, metrics = evaluate_model(env, model, randomize=False)
    assert len(df) == 2
    assert "mean_reward" in metrics
    assert np.isfinite(metrics["mean_reward"])
    for m in env.unwrapped.metrics:
        assert f"mean_{m}" in metrics
    plot_eval_sequence(env, None, df, tmp_path / "seq.pdf")
    assert (tmp_path / "seq.pdf").exists()

    jenv = JGym(fluidgym_tpu.make("RBC2D-easy-v0", **ENV_KW))
    jenv.unwrapped.seed(0)
    jdf, jmetrics = jevaluate(jenv, model, randomize=False)
    assert list(df.columns) == list(jdf.columns)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        assert metrics[k] == pytest.approx(jmetrics[k], rel=RTOL), k
    assert_rel(df.to_numpy(), jdf.to_numpy(), RTOL, "sequence")


def test_rolling_meter_and_csv_sink(tmp_path):
    from fluidgym_tpu_torch.integration.sb3.eval_callback import _CsvSink, _RollingMeter

    meter = _RollingMeter(["reward", "nusselt"])
    meter.push(np.array([1.0, 3.0]), [{"nusselt": 4.0}, {"nusselt": 6.0}])
    meter.push(np.array([2.0]), [{}])  # metric absent -> skipped, not zeroed
    out = meter.drain()
    assert out["mean_reward"] == 2.0  # (mean(1,3) + 2) / 2
    assert out["mean_nusselt"] == 2.5  # (5 + 0) / 2 steps
    assert meter.drain()["mean_reward"] == 0.0  # drained state resets

    sink = _CsvSink(tmp_path / "log.csv")
    sink.append({"step": 1, "training/mean_reward": 0.5})
    sink.append({"step": 2, "evaluation/mean_reward": 0.7})
    with (tmp_path / "log.csv").open() as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 2
    assert rows[0]["training/mean_reward"] == "0.5"
    assert rows[0]["evaluation/mean_reward"] == ""  # widened header backfills
    assert rows[1]["evaluation/mean_reward"] == "0.7"


def test_csv_sink_preserves_prior_run(tmp_path):
    """A resumed run in the same directory keeps the previous log's rows
    and leaves a backup."""
    from fluidgym_tpu_torch.integration.sb3.eval_callback import _CsvSink

    path = tmp_path / "training_log.csv"
    first = _CsvSink(path)
    first.append({"step": 1, "training/mean_reward": 0.1})
    first.append({"step": 2, "training/mean_reward": 0.2})

    second = _CsvSink(path)  # a new training run
    second.append({"step": 1, "training/mean_reward": 0.9})

    with path.open() as fh:
        rows = list(csv.DictReader(fh))
    assert [r["step"] for r in rows] == ["1", "2", "1"]
    assert rows[0]["training/mean_reward"] == "0.1"  # old rows retained
    backup = tmp_path / "training_log_backup.csv"
    assert backup.exists()
    with backup.open() as fh:
        assert len(list(csv.DictReader(fh))) == 2


def test_eval_callback_step_cadence(tmp_path, monkeypatch):
    """Drive _on_step through log and eval boundaries without sb3."""
    import fluidgym_tpu_torch.integration.sb3.eval_callback as ec

    monkeypatch.setattr(ec, "_HAS_SB3", True)
    monkeypatch.chdir(tmp_path)

    env = GymFluidEnv(_make(**ENV_KW))
    env.unwrapped.seed(0)

    cb = ec.EvalCallback(env, env, eval_freq=4, n_eval_episodes=1,
                         verbose=0, save_eval_sequence=False,
                         log_path=tmp_path / "log.csv")
    cb.model = _ZeroModel(env.action_space)
    evals = []
    monkeypatch.setattr(cb, "_run_evaluation", lambda steps: evals.append(steps))
    monkeypatch.setattr(cb, "_save_model", lambda: None)

    cb._on_training_start()
    for t in range(1, 9):
        cb.num_timesteps = t
        cb.locals = {"rewards": np.array([float(t)]),
                     "infos": [{"nusselt": 1.0}]}
        assert cb._on_step()
    assert evals == [4, 8]
    with (tmp_path / "log.csv").open() as fh:
        rows = list(csv.DictReader(fh))
    # log_freq = max(4 // 10, 1) = 1 -> one training row per step
    assert len(rows) == 8
    assert float(rows[3]["training/mean_reward"]) == 4.0
    cb._on_training_end()


def test_eval_callback_and_torchrl_need_their_packages():
    from fluidgym_tpu_torch.integration.sb3 import EvalCallback
    from fluidgym_tpu_torch.integration.torchrl import TorchRLFluidEnv

    env = _make(**ENV_KW)
    with pytest.raises(ImportError, match="stable-baselines3"):
        EvalCallback(env, env, eval_freq=1, n_eval_episodes=1)
    with pytest.raises(ImportError, match="torchrl"):
        TorchRLFluidEnv(env)


def test_vec_env_auto_reset_matches_the_bare_env():
    """``VecFluidEnv(FlattenObservation(env))`` over ``episode_length`` + 1
    steps (one auto-reset) against the bare env on the same actions: obs and
    rewards bit for bit, ``terminated_observation`` the last step's obs."""
    kw = dict(DEV_KW, randomize_initial_state=True, episode_length=2)
    venv = VecFluidEnv(FlattenObservation(_make(**kw)))
    bare = _make(**kw)
    keys = ["temperature", "velocity"]

    def flat(o):
        return torch.cat([o[k].reshape(4, -1) for k in keys], dim=1).numpy()

    o = venv.reset(seed=3)
    ob, _ = bare.reset(seed=3)
    np.testing.assert_array_equal(o, flat(ob))
    rng = np.random.default_rng(1)
    resets = []
    for i in range(3):
        a = rng.uniform(-1, 1, (venv.num_envs, 1)).astype(np.float32)
        o, r, dones, infos = venv.step(a)
        ob, rb, te, tr, _ = bare.step(a)
        np.testing.assert_array_equal(r, rb.numpy())
        assert dones.tolist() == [bool(te or tr)] * 4
        if dones.all():
            resets.append(i)
            np.testing.assert_array_equal(
                np.stack([inf["terminated_observation"] for inf in infos]), flat(ob))
            ob, _ = bare.reset()
        np.testing.assert_array_equal(o, flat(ob))
    assert resets == [1]


def test_gymnasium_passive_checks():
    """gymnasium's passive checkers accept the adapter's spaces and its
    reset / step / render, and the numpy obs lie in the gymnasium spaces."""
    import gymnasium
    from gymnasium.utils import passive_env_checker as pc

    env = GymFluidEnv(_make(**{**DEV_KW, "use_marl": False}),
                      render_mode="rgb_array")
    assert isinstance(env, gymnasium.Env)
    pc.check_action_space(env.action_space)
    pc.check_observation_space(env.observation_space)
    obs, info = pc.env_reset_passive_checker(env, seed=0)
    assert env.observation_space.contains(obs)
    obs, reward, te, tr, info = pc.env_step_passive_checker(
        env, env.action_space.sample())
    assert env.observation_space.contains(obs) and isinstance(reward, float)
    assert pc.env_render_passive_checker(env).shape[-1] == 3


def test_uncontrolled_episode_metrics():
    """The bundled uncontrolled episode of the loaded snapshot, as numbers
    (the JAX package's DataFrame holds the CSV's strings)."""
    env = _make(randomize_initial_state=False, load_domain_statistics=False)
    env.reset(seed=0)
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", randomize_initial_state=False,
                             load_domain_statistics=False)
    jenv._np_rng = np.random.default_rng(0)
    jenv._set_initial_state(randomize=False)
    df, jdf = env.get_uncontrolled_episode_metrics(), jenv.get_uncontrolled_episode_metrics()
    assert list(df.columns) == list(jdf.columns) == ["nusselt"]
    assert len(df) == len(jdf) > 0
    np.testing.assert_array_equal(df.to_numpy(), jdf.to_numpy(dtype=np.float64))
    assert _make(**ENV_KW).get_uncontrolled_episode_metrics() is None


# ---------------------------------------------------------------------------
# logging and seeding (twins of tests/test_logging.py)
# ---------------------------------------------------------------------------
def test_stream_capture_tees(tmp_path):
    from fluidgym_tpu_torch.utils.logging import StreamCapture

    path = tmp_path / "cap.log"
    inner = io.StringIO()
    cap = StreamCapture(inner, path)
    cap.write("hello\n")
    cap.flush()
    assert inner.getvalue() == "hello\n"
    assert path.read_text() == "hello\n"
    assert cap.isatty() is False
    cap.close()


def test_setup_logging_capture_streams(tmp_path):
    from fluidgym_tpu_torch.utils.logging import (StreamCapture, get_logger,
                                                  setup_logging)

    orig_out, orig_err = sys.stdout, sys.stderr
    try:
        setup_logging(tmp_path, capture_streams=True)
        print("through capture")
        sys.stdout.flush()
        captured = (tmp_path / "fluidgym_tpu.log.captured").read_text()
        assert "through capture" in captured
        get_logger("x").info("to file")
        assert "to file" in (tmp_path / "fluidgym_tpu.log").read_text()
        # idempotent: a second call must not re-wrap the capture
        setup_logging(tmp_path, capture_streams=True)
        assert isinstance(sys.stdout, StreamCapture)
        assert not isinstance(sys.stdout.stream, StreamCapture)
    finally:
        if isinstance(sys.stdout, StreamCapture):
            sys.stdout.close()
            sys.stdout = sys.stdout.stream
        if isinstance(sys.stderr, StreamCapture):
            sys.stderr.close()
            sys.stderr = sys.stderr.stream
        sys.stdout, sys.stderr = orig_out, orig_err
        logging.basicConfig(force=True, handlers=[logging.StreamHandler(sys.stdout)])


def test_seed_all():
    import random

    from fluidgym_tpu_torch.utils.helpers import seed_all

    g = seed_all(7)
    first = (random.random(), np.random.rand(), torch.rand(1).item(),
             torch.rand(1, generator=g).item())
    g = seed_all(7)
    assert first == (random.random(), np.random.rand(), torch.rand(1).item(),
                     torch.rand(1, generator=g).item())


# ---------------------------------------------------------------------------
# the examples, through the port
# ---------------------------------------------------------------------------
#: per id, what makes an example's env small (randomized resets of the
#: cylinder burn in hundreds of sim steps at this step length)
EXAMPLE_SMALL = {
    "RBC2D-easy-v0": dict(n_heaters=4, resolution=4, step_length=0.1, dt=0.05,
                          local_obs_window=3),
    "CylinderJet2D-easy-v0": dict(resolution=16, step_length=0.02, dt=0.01,
                                  randomize_initial_state=False),
}
EXAMPLES = ["wrappers/action_noise.py", "wrappers/flatten_observation.py",
            "wrappers/obs_extraction.py", "wrappers/sensor_noise.py",
            "interfaces/gymnasium_env.py", "interfaces/pettingzoo_env.py",
            "interfaces/sb3_vec_env.py", "rendering.py"]


def _replay(name, monkeypatch, tmp_path):
    real = fluidgym_tpu_torch.make
    made = []

    def small_make(env_id, **kw):
        made.append(real(env_id, **{**kw, **EXAMPLE_SMALL[env_id], "device": "cpu"}))
        return made[-1]

    monkeypatch.setattr(fluidgym_tpu_torch, "make", small_make)
    path = REPO / "examples" / name
    src = re.sub(r"\bfluidgym_tpu\b", "fluidgym_tpu_torch", path.read_text())
    src = src.replace('output_path="/tmp"', f"output_path={str(tmp_path)!r}")
    exec(compile(src, str(path), "exec"), {"__name__": "__main__"})
    return made


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_through_the_port(name, monkeypatch, tmp_path):
    made = _replay(name, monkeypatch, tmp_path)
    assert len(made) == 1 and made[0]._n_episodes == 1
    if name == "rendering.py":
        assert (tmp_path / "rbc_episode_temperature.gif").exists()
    else:
        assert made[0]._n_steps == (5 if "gymnasium" in name
                                    else int("flatten" not in name
                                             and "extraction" not in name))


def test_torchrl_example_needs_torchrl(monkeypatch, tmp_path):
    with pytest.raises(ImportError, match="torchrl"):
        _replay("interfaces/torchrl_env.py", monkeypatch, tmp_path)
