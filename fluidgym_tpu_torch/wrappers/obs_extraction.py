"""Observation-key filtering wrapper (counterpart of
``fluidgym_tpu/wrappers/obs_extraction.py``)."""

from __future__ import annotations

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.types import FluidEnvLike
from fluidgym_tpu_torch.wrappers.fluid_wrapper import FluidWrapper

__all__ = ["ObsExtraction"]


class ObsExtraction(FluidWrapper):
    """Keep only the listed keys of a Dict observation, in that order."""

    def __init__(self, env: FluidEnvLike, keys: list[str]) -> None:
        super().__init__(env)
        if len(keys) == 0:
            raise ValueError("Keys list must be non-empty.")
        if not isinstance(self._env.observation_space, spaces.Dict):
            raise ValueError(
                "ObsExtraction wrapper only supports Dict observation spaces."
            )
        for k in keys:
            if k not in self._env.observation_space.spaces:
                raise ValueError(f"Key {k!r} not found in observation space.")
        self.__keys = list(keys)
        self.__observation_space = spaces.Dict(
            {k: self._env.observation_space.spaces[k] for k in keys}
        )

    @property
    def observation_space(self) -> spaces.Dict:
        return self.__observation_space

    def __filter(self, obs):
        return {k: obs[k] for k in self.__keys}

    def reset(self, seed: int | None = None, randomize: bool | None = None):
        obs, info = self._env.reset(seed=seed, randomize=randomize)
        return self.__filter(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self._env.step(action)
        return self.__filter(obs), reward, terminated, truncated, info
