"""Base wrapper delegating the full FluidEnv surface (counterpart of
``fluidgym_tpu/wrappers/fluid_wrapper.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Generic, cast

import numpy as np

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.envs.fluid_env import EnvState, FluidEnv
from fluidgym_tpu_torch.types import EnvMode, EnvT, FluidEnvLike

__all__ = ["FluidWrapper"]


class FluidWrapper(FluidEnvLike, Generic[EnvT]):
    """Delegating base class for environment wrappers.  A wrapper runs where
    its env runs: it hands tensors through on the env's device."""

    def __init__(self, env: FluidEnvLike) -> None:
        self._env = env

    def __getattr__(self, name: str) -> Any:
        # only reached when normal lookup fails on self
        if name == "_env":
            raise AttributeError(name)
        return getattr(self._env, name)

    @property
    def unwrapped(self) -> FluidEnv:
        e = self._env
        while isinstance(e, FluidWrapper):
            e = e._env
        return cast(FluidEnv, e)

    # -- passthrough properties -----------------------------------------
    @property
    def use_marl(self) -> bool:
        return self._env.use_marl

    @property
    def n_agents(self) -> int:
        return self._env.n_agents

    @property
    def episode_length(self) -> int:
        return self._env.episode_length

    @property
    def metrics(self) -> list[str]:
        return self._env.metrics

    @property
    def differentiable(self) -> bool:
        return self._env.differentiable

    @property
    def action_space(self) -> spaces.Box:
        return self._env.action_space

    @property
    def observation_space(self):
        return self._env.observation_space

    # -- passthrough methods ----------------------------------------------
    def train(self) -> None:
        self._env.train()

    def val(self) -> None:
        self._env.val()

    def test(self) -> None:
        self._env.test()

    def sample_action(self):
        return self._env.sample_action()

    def step(self, action):
        return self._env.step(action)

    def seed(self, seed: int) -> None:
        self._env.seed(seed)

    def reset(self, seed: int | None = None, randomize: bool | None = None):
        return self._env.reset(seed=seed, randomize=randomize)

    def render(self, save: bool = False, render_3d: bool = False,
               filename: str | None = None,
               output_path: Path | None = None) -> np.ndarray:
        return self._env.render(save=save, render_3d=render_3d,
                                filename=filename, output_path=output_path)

    def save_gif(self, filename: str, output_path: Path | None = None) -> None:
        self._env.save_gif(filename=filename, output_path=output_path)

    def load_initial_domain(self, mode: EnvMode, idx: int) -> None:
        self._env.load_initial_domain(mode, idx)

    def detach(self) -> None:
        self._env.detach()

    def get_state(self) -> EnvState:
        return self._env.get_state()

    def set_state(self, state: EnvState) -> None:
        self._env.set_state(state)
