"""Evaluation callback for Stable-Baselines3 training (counterpart of
``fluidgym_tpu/integration/sb3/eval_callback.py``).

Periodic val-mode evaluation, training / evaluation metric logging to CSV
(and optionally wandb), latest-model checkpointing and
controlled-vs-uncontrolled sequence plots: a drainable rolling meter for
the training statistics, incremental CSV appends (stdlib ``csv``) and a
context manager for the train / val switch.  ``EvalCallback`` raises
``ImportError`` without stable-baselines3.
"""

from __future__ import annotations

import contextlib
import csv
from pathlib import Path

import numpy as np

from fluidgym_tpu_torch.integration.sb3.util import evaluate_model, plot_eval_sequence
from fluidgym_tpu_torch.integration.sb3.vec_env import VecFluidEnv

try:
    from stable_baselines3.common.callbacks import BaseCallback as _BaseCallback

    _HAS_SB3 = True
except ImportError:  # sb3 not installed
    _HAS_SB3 = False
    _BaseCallback = object

__all__ = ["EvalCallback"]


class _RollingMeter:
    """Accumulates per-step scalars and drains to means.

    One instance covers reward plus every declared env metric; ``drain``
    returns the means since the last drain and resets."""

    def __init__(self, keys):
        self._keys = list(keys)
        self.reset()

    def reset(self) -> None:
        self._sums = {k: 0.0 for k in self._keys}
        self._count = 0

    def push(self, reward, infos) -> None:
        self._sums["reward"] += float(np.mean(reward))
        for k in self._keys:
            if k == "reward":
                continue
            vals = [np.mean(np.asarray(info[k], dtype=np.float64))
                    for info in infos if k in info]
            if vals:
                self._sums[k] += float(np.mean(vals))
        self._count += 1

    def drain(self) -> dict[str, float]:
        n = max(self._count, 1)
        out = {f"mean_{k}" if k != "reward" else "mean_reward": s / n
               for k, s in self._sums.items()}
        self.reset()
        return out


class _CsvSink:
    """CSV metric log.  Rows append incrementally; the file is rewritten
    in full only when the column set grows (training rows and eval rows
    carry different tags).  A pre-existing log (a resumed or second run in
    the same directory) is backed up to ``*_backup.csv`` and its rows
    retained, so no prior history is lost."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._columns: list[str] = []
        self._rows: list[dict] = []
        if self.path.exists():
            with self.path.open(newline="") as fh:
                reader = csv.DictReader(fh)
                self._columns = list(reader.fieldnames or [])
                self._rows = [dict(r) for r in reader]
            backup = self.path.with_name(self.path.stem + "_backup.csv")
            backup.write_bytes(self.path.read_bytes())

    def append(self, row: dict) -> None:
        row = dict(row)
        self._rows.append(row)
        new_cols = [c for c in row if c not in self._columns]
        if new_cols:
            self._columns.extend(new_cols)
            self.flush()
            return
        write_header = not self.path.exists()
        with self.path.open("a", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=self._columns, restval="")
            if write_header:
                writer.writeheader()
            writer.writerow(row)

    def flush(self) -> None:
        with self.path.open("w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=self._columns,
                                    restval="")
            writer.writeheader()
            writer.writerows(self._rows)


class EvalCallback(_BaseCallback):
    """Periodic evaluation + logging callback.

    During training, per-step rewards and declared metrics are averaged
    into a rolling meter and emitted every ``log_freq`` env steps under the
    ``training/`` tag.  Every ``eval_freq`` env steps the eval env is
    switched to its validation split and the current policy is rolled for
    ``n_eval_episodes`` episodes; the first episode is deterministic
    (un-randomized start) and produces the sequence plot against the
    bundled uncontrolled episode."""

    def __init__(
        self,
        env,
        eval_env,
        eval_freq: int,
        n_eval_episodes: int,
        use_wandb: bool = False,
        checkpoint_latest: bool = True,
        verbose: int = 1,
        save_eval_sequence: bool = True,
        log_freq: int | None = None,
        log_path: str | Path = "training_log.csv",
    ):
        if not _HAS_SB3:
            raise ImportError(
                "stable-baselines3 is required for EvalCallback.")
        if _BaseCallback is object:  # test path without sb3 installed
            self.verbose = verbose
            self.num_timesteps = 0
            self.locals: dict = {}
        else:
            super().__init__(verbose)
        self.env = env
        self.eval_env = eval_env
        self.eval_freq = int(eval_freq)
        self.log_freq = int(log_freq) if log_freq else max(eval_freq // 10, 1)
        # episode 0 always runs (it produces the sequence plot), so clamp
        self.n_eval_episodes = max(int(n_eval_episodes), 1)
        self.use_wandb = use_wandb
        self.checkpoint_latest = checkpoint_latest
        self.save_evaluation = save_eval_sequence

        self._marl_vec = (isinstance(env, VecFluidEnv)
                          and env.unwrapped.use_marl)
        metric_keys = list(env.unwrapped.metrics)
        if self._marl_vec:
            metric_keys = ["global_reward"] + metric_keys
        self.metrics = metric_keys
        self.num_actions = (env.num_envs if self._marl_vec
                            else int(env.action_space.shape[0]))

        self._meter = _RollingMeter(["reward"] + metric_keys)
        self._next_log_at = self.log_freq
        self._next_eval_at = self.eval_freq
        self._sink = _CsvSink(Path(log_path))
        self.uncontrolled_sequence_df = None

    # -- step accounting ---------------------------------------------------

    @property
    def _num_env_steps(self) -> int:
        """SB3 counts one timestep per vec-env slot; under the
        agents-as-envs trick all slots belong to one physical env."""
        n = self.num_timesteps
        return n // self.env.num_envs if self._marl_vec else n

    # -- logging -----------------------------------------------------------

    def _log(self, data: dict, step: int, tag: str) -> None:
        tagged = {f"{tag}/{k}": float(v) for k, v in data.items()}
        self._sink.append({"step": step, **tagged})
        if self.verbose:
            rendered = ", ".join(f"{k}={v:.4f}" for k, v in tagged.items())
            print(f"Step {step}: {rendered}")
        if self.use_wandb:
            import wandb

            wandb.log(tagged, step=step)

    # -- sb3 hooks ----------------------------------------------------------

    def _on_training_start(self) -> None:
        df = self.env.unwrapped.get_uncontrolled_episode_metrics()
        if df is not None:
            df = df.iloc[:self.eval_env.unwrapped.episode_length]
        self.uncontrolled_sequence_df = df

    def _on_step(self) -> bool:
        self._meter.push(self.locals["rewards"], self.locals["infos"])
        steps = self._num_env_steps
        if steps >= self._next_log_at:
            self._next_log_at = steps + self.log_freq
            self._log(self._meter.drain(), step=steps, tag="training")
        if steps >= self._next_eval_at:
            self._next_eval_at = steps + self.eval_freq
            self._run_evaluation(steps)
        return True

    def _on_training_end(self) -> None:
        self._sink.flush()
        if self.checkpoint_latest:
            self._save_model()

    # -- evaluation ---------------------------------------------------------

    @contextlib.contextmanager
    def _val_split(self):
        env = self.eval_env
        switchable = hasattr(env, "val") and hasattr(env, "train")
        if switchable:
            env.val()
        try:
            yield env
        finally:
            if switchable:
                env.train()

    def _run_evaluation(self, steps: int) -> None:
        with self._val_split() as env:
            episode_rewards = []
            for ep in range(self.n_eval_episodes):
                first = ep == 0
                save_name = (f"eval_sequence_{steps}"
                             if first and self.save_evaluation else None)
                sequence_df, metrics = evaluate_model(
                    env=env, model=self.model, randomize=not first,
                    save_name=save_name)
                if first:
                    if self.save_evaluation:
                        plot_eval_sequence(
                            env=env,
                            uncontrolled_sequence_df=self.uncontrolled_sequence_df,
                            sequence_df=sequence_df,
                            output_file=Path(f"eval_sequence_{steps}.pdf"))
                    eval_metrics = dict(metrics)
                episode_rewards.append(metrics["mean_reward"])
        eval_metrics["mean_reward"] = float(np.mean(episode_rewards))
        self._log(eval_metrics, step=steps, tag="evaluation")
        if self.checkpoint_latest:
            self._save_model()

    def _save_model(self) -> None:
        self.model.save("ckpt_latest")
