"""Evaluation and plotting utilities for Stable-Baselines3 training
(counterpart of ``fluidgym_tpu/integration/sb3/util.py``).

``evaluate_model`` rolls a trained policy for one episode, collecting
per-step metrics and actions into a DataFrame; ``plot_eval_sequence`` draws
the controlled-vs-uncontrolled comparison; ``test_model`` runs a
multi-episode test sweep.  Works with both the Gymnasium adapter (SARL) and
``VecFluidEnv`` (MARL, agents as envs), whose outputs are numpy already.
pandas and matplotlib are imported inside the functions that need them.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from pathlib import Path

import numpy as np

from fluidgym_tpu_torch.integration.sb3.vec_env import VecFluidEnv

logger = logging.getLogger("fluidgym_tpu_torch.integration.sb3")

PLOT_MAX_ACTIONS = 64

__all__ = ["evaluate_model", "plot_eval_sequence", "test_model",
           "PLOT_MAX_ACTIONS"]


def _get_sequence_df(env, metric_sequence, action_sequence):
    """The episode's per-step metrics, actions and rewards as a DataFrame."""
    import pandas as pd

    seq = {m: np.array(metric_sequence[m]).reshape(len(metric_sequence[m]), -1)
             .mean(axis=1)
           for m in env.unwrapped.metrics}
    actions = np.array(action_sequence)
    if actions.ndim == 1:
        seq["action"] = actions
    else:
        for i in range(min(actions.shape[1], PLOT_MAX_ACTIONS)):
            seq[f"action_{i}"] = actions[:, i]
    if isinstance(env, VecFluidEnv):
        seq["local_reward"] = np.array(metric_sequence["local_reward"])
    seq["reward"] = np.array(metric_sequence["reward"]).reshape(
        len(metric_sequence["reward"]), -1).mean(axis=1)
    return pd.DataFrame(seq)


def _env_step(env, action):
    """One step of either adapter as ``(obs, rewards, done, info)``."""
    if isinstance(env, VecFluidEnv):
        if action.ndim == 1:
            action = action[:, None]
        obs, reward, dones, infos = env.step(action)
        return obs, np.asarray(reward), bool(np.any(dones)), infos[0]
    obs, reward, term, trunc, info = env.step(action)
    return obs, np.array([float(np.asarray(reward))]), bool(term or trunc), info


def plot_eval_sequence(env, uncontrolled_sequence_df, sequence_df,
                       output_file: Path) -> None:
    """Actions and every metric over time, the uncontrolled episode's
    beside the controlled one where given, saved to ``output_file``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics = ["reward"] + list(env.unwrapped.metrics)
    if (uncontrolled_sequence_df is not None
            and len(uncontrolled_sequence_df) > len(sequence_df)):
        uncontrolled_sequence_df = uncontrolled_sequence_df.iloc[
            : len(sequence_df)].reset_index(drop=True)

    n = len(metrics)
    fig, axes = plt.subplots(n + 1, 1, figsize=(10, 4 * (n + 1)))
    t = np.arange(len(sequence_df)) * env.unwrapped.dt

    ax = axes[0]
    action_cols = [c for c in sequence_df.columns if c.startswith("action")]
    for c in action_cols[:PLOT_MAX_ACTIONS]:
        ax.plot(t, sequence_df[c], label=c)
    ax.set_title("Actions over Time")
    ax.set_xlabel("Time")
    ax.set_ylabel("Action Value")

    for i, m in enumerate(metrics):
        ax = axes[i + 1]
        if (uncontrolled_sequence_df is not None
                and m in uncontrolled_sequence_df.columns):
            tu = np.arange(len(uncontrolled_sequence_df)) * env.unwrapped.dt
            ax.plot(tu, uncontrolled_sequence_df[m], "--", label="Uncontrolled")
        if m in sequence_df.columns:
            ax.plot(t, sequence_df[m], label="RL Control")
        ax.set_title(f"{m} over Time")
        ax.set_xlabel("Time")
        ax.set_ylabel(m)
        ax.legend()

    plt.tight_layout()
    plt.savefig(output_file)
    plt.close(fig)


def evaluate_model(
    env,
    model,
    randomize: bool,
    save_name: str | None = None,
    save_frames: bool = False,
    render_3d: bool = False,
    deterministic: bool = True,
    output_path: Path | None = None,
):
    """Roll one episode with the policy; returns ``(sequence_df,
    mean_metrics)``.  With ``save_name`` the episode's frames, GIF and CSV
    are written under ``output_path``."""
    if output_path is None:
        output_path = Path(".")
    is_marl = isinstance(env, VecFluidEnv)

    episode_rewards: list[np.ndarray] = []
    episode_metrics: dict[str, float] = defaultdict(float)
    action_sequence: list[np.ndarray] = []
    metric_sequence: dict[str, list] = defaultdict(list)

    obs = env.reset(randomize=randomize)
    if isinstance(obs, tuple):
        obs = obs[0]

    if save_name is not None:
        env.unwrapped.render(save=save_frames, render_3d=render_3d,
                             output_path=output_path,
                             filename=save_name + "_initial")

    done, step = False, 0
    while not done:
        action, _ = model.predict(obs, deterministic=deterministic)
        obs, reward, done, info = _env_step(env, np.asarray(action))

        if is_marl:
            metric_sequence["local_reward"].append(float(np.mean(reward)))
            g = np.asarray(info["global_reward"]).reshape(-1)
            metric_sequence["reward"].append(g)
            episode_metrics["global_reward"] += float(g.mean())
        else:
            metric_sequence["reward"].append(reward)
        action_sequence.append(np.asarray(action).reshape(-1))

        if save_name is not None:
            env.unwrapped.render(save=False, render_3d=render_3d,
                                 output_path=output_path,
                                 filename=save_name + f"_step_{step:04d}")

        episode_rewards.append(reward)
        for m in env.unwrapped.metrics:
            v = np.asarray(info[m])
            metric_sequence[m].append(v)
            episode_metrics[m] += float(v.mean())
        step += 1

    if save_name is not None:
        env.unwrapped.render(save=save_frames, render_3d=render_3d,
                             output_path=output_path,
                             filename=save_name + "_final")

    rewards_arr = np.array(episode_rewards)
    mean_eval_reward = float(np.mean(rewards_arr))
    mean_eval_metrics = {
        f"mean_{m}": episode_metrics[m] / rewards_arr.shape[0]
        for m in env.unwrapped.metrics
    }
    mean_eval_metrics["mean_reward"] = mean_eval_reward

    sequence_df = _get_sequence_df(env, metric_sequence, action_sequence)

    if save_name is not None:
        env.save_gif(save_name + ".gif", output_path=output_path)
        sequence_df.to_csv(output_path / (save_name + ".csv"), index=False)

    return sequence_df, mean_eval_metrics


def test_model(
    model,
    test_env,
    n_episodes: int,
    save_frames: bool = False,
    render_3d: bool = False,
    deterministic: bool = True,
    output_path: Path | None = None,
) -> None:
    """Multi-episode test sweep with plots and CSVs."""
    import pandas as pd

    if output_path is None:
        output_path = Path(".")

    dfs = []
    df, _ = evaluate_model(test_env, model, randomize=False,
                           save_name="test_eval_episode_0",
                           save_frames=save_frames, render_3d=render_3d,
                           deterministic=deterministic, output_path=output_path)
    df["episode"] = 0
    df["step"] = np.arange(len(df))
    dfs.append(df)

    uncontrolled = test_env.unwrapped.get_uncontrolled_episode_metrics()
    plot_eval_sequence(test_env, uncontrolled, df,
                       output_path / "test_eval_sequence.pdf")

    for i in range(1, n_episodes):
        df, _ = evaluate_model(test_env, model, randomize=True,
                               save_frames=save_frames, render_3d=render_3d,
                               deterministic=deterministic,
                               output_path=output_path)
        df["episode"] = i
        df["step"] = np.arange(len(df))
        dfs.append(df)

    pd.concat(dfs, ignore_index=True).to_csv(
        output_path / "test_eval_sequences.csv", index=False)
