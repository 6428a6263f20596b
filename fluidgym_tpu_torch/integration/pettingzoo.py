"""PettingZoo ParallelEnv adapter (counterpart of
``fluidgym_tpu/integration/pettingzoo.py``).

Agent-indexed dicts over a MARL port env, which must have flattened Box
observations (wrap it in ``wrappers.FlattenObservation``).  Inherits
``pettingzoo.ParallelEnv`` where pettingzoo imports, else ``object`` (the
ParallelEnv duck type); tensors cross to numpy here.
"""

from __future__ import annotations

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.integration.gymnasium import gym_space, to_numpy
from fluidgym_tpu_torch.types import FluidEnvLike

try:
    from pettingzoo import ParallelEnv as _ParallelEnv
except ImportError:
    _ParallelEnv = object

__all__ = ["PettingZooFluidEnv"]


class PettingZooFluidEnv(_ParallelEnv):
    """PettingZoo parallel API over a MARL port environment."""

    metadata = {"render_modes": ["rgb_array"], "name": "fluidgym_tpu_torch"}

    def __init__(self, env: FluidEnvLike, render_mode: str | None = None):
        if not env.use_marl or env.n_agents <= 1:
            raise ValueError(
                "PettingZooFluidEnv requires a MARL environment with "
                "multiple agents."
            )
        if not isinstance(env.observation_space, spaces.Box):
            raise ValueError(
                "PettingZooFluidEnv requires flattened Box observations; "
                "wrap the env in wrappers.FlattenObservation."
            )
        self.__env = env
        self.__observation_space = gym_space(env.observation_space)
        self.__action_space = gym_space(env.action_space)
        self.render_mode = render_mode
        self.possible_agents = [f"agent_{i}" for i in range(env.n_agents)]
        self.agents = list(self.possible_agents)

    def observation_space(self, agent: str):
        return self.__observation_space

    def action_space(self, agent: str):
        return self.__action_space

    def __split(self, stacked) -> dict[str, np.ndarray]:
        arr = to_numpy(stacked)
        return {a: arr[i] for i, a in enumerate(self.possible_agents)}

    def reset(self, seed: int | None = None, options: dict | None = None):
        obs, info = self.__env.reset(seed=seed)
        self.agents = list(self.possible_agents)
        infos = {a: {} for a in self.possible_agents}
        return self.__split(obs), infos

    def step(self, actions: dict[str, np.ndarray]):
        stacked = torch.stack(
            [torch.as_tensor(actions[a]) for a in self.possible_agents])
        obs, rewards, term, trunc, info = self.__env.step(stacked)
        obs_d = self.__split(obs)
        rew = to_numpy(rewards)
        rewards_d = {a: float(rew[i]) for i, a in enumerate(self.possible_agents)}
        terms = {a: bool(term) for a in self.possible_agents}
        truncs = {a: bool(trunc) for a in self.possible_agents}
        info_np = to_numpy(info)
        infos = {a: dict(info_np) for a in self.possible_agents}
        if term or trunc:
            self.agents = []
        return obs_d, rewards_d, terms, truncs, infos

    def render(self):
        frame = self.__env.render()
        return frame if self.render_mode == "rgb_array" else None

    def close(self) -> None:
        pass

    @property
    def unwrapped(self):
        return self.__env.unwrapped if hasattr(self.__env, "unwrapped") else self.__env
