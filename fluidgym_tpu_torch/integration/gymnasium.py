"""Gymnasium adapter (counterpart of ``fluidgym_tpu/integration/gymnasium.py``).

A single-agent ``gymnasium.Env`` facade over a port env or wrapper.  The
env's tensors cross to numpy at this boundary only.  Where gymnasium
imports, the adapter inherits ``gymnasium.Env`` and exposes gymnasium
``Box`` / ``Dict`` spaces converted from the port's (so gymnasium's and
SB3's checks accept them); elsewhere (the card's machine) it inherits
``object`` and keeps the port's own spaces.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, cast

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.envs.fluid_env import FluidEnv
from fluidgym_tpu_torch.types import FluidEnvLike

try:
    import gymnasium as _gym

    _GymEnv = _gym.Env
except ImportError:
    _gym = None
    _GymEnv = object

__all__ = ["GymFluidEnv", "gym_space", "to_numpy"]


def gym_space(space):
    """The gymnasium counterpart of a port space (``Box`` / ``Dict``, bounds
    and dtype kept) where gymnasium imports; the space itself elsewhere or
    when it is not a port space."""
    if _gym is None:
        return space
    if isinstance(space, spaces.Box):
        return _gym.spaces.Box(low=space.low, high=space.high, shape=space.shape,
                               dtype=space.dtype)
    if isinstance(space, spaces.Dict):
        return _gym.spaces.Dict({k: gym_space(s) for k, s in space.spaces.items()})
    return space


def to_numpy(data):
    """Host numpy copies of a tensor, or of each entry of a dict."""
    if isinstance(data, dict):
        return {k: to_numpy(v) for k, v in data.items()}
    if torch.is_tensor(data):
        return data.detach().cpu().numpy()
    return np.asarray(data)


class GymFluidEnv(_GymEnv):
    """Gymnasium-compatible wrapper around a port environment."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 24}

    def __init__(self, env: FluidEnvLike, render_mode: str | None = None):
        super().__init__()
        if env.use_marl:
            raise ValueError(
                "GymFluidEnv does not support multi-agent environments. "
                "Please use a single-agent environment."
            )
        if render_mode is not None and render_mode != "rgb_array":
            raise ValueError(
                f"Unsupported render mode: {render_mode}. Only 'rgb_array' is "
                "supported."
            )
        self.render_mode = render_mode
        self.__env = env
        self.action_space = gym_space(env.action_space)
        self.observation_space = gym_space(env.observation_space)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.__env.step(action)
        return (
            to_numpy(obs),
            # rewards can be shape-(1,) arrays; float() on ndim > 0 arrays is
            # an error on NumPy >= 2.3
            float(to_numpy(reward).reshape(-1)[0]),
            bool(terminated),
            bool(truncated),
            to_numpy(info),
        )

    def reset(self, *, seed: int | None = None,
              options: dict[str, Any] | None = None,
              randomize: bool | None = None):
        obs, info = self.__env.reset(seed=seed, randomize=randomize)
        return to_numpy(obs), to_numpy(info)

    def render(self, save: bool = False, render_3d: bool = False,
               filename: str | None = None, output_path: Path | None = None):
        frame = self.__env.render(save=save, render_3d=render_3d,
                                  filename=filename, output_path=output_path)
        return frame if self.render_mode == "rgb_array" else None

    def save_gif(self, filename: str = "fluidgym.gif",
                 output_path: Path | None = None) -> None:
        self.__env.save_gif(filename=filename, output_path=output_path)

    def close(self):
        pass

    @property
    def unwrapped(self) -> FluidEnv:  # type: ignore[override]
        if hasattr(self.__env, "unwrapped"):
            return self.__env.unwrapped  # type: ignore[return-value]
        return cast(FluidEnv, self.__env)

    def train(self) -> None:
        self.__env.train()

    def val(self) -> None:
        self.__env.val()

    def test(self) -> None:
        self.__env.test()

    def seed(self, seed: int) -> None:
        self.__env.seed(seed)

    @property
    def num_actions(self) -> int:
        return int(np.prod(self.action_space.shape))
