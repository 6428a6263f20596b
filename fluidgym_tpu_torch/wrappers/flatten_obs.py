"""Dict -> Box observation flattening wrapper (counterpart of
``fluidgym_tpu/wrappers/flatten_obs.py``)."""

from __future__ import annotations

import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.types import FluidEnvLike
from fluidgym_tpu_torch.wrappers.fluid_wrapper import FluidWrapper
from fluidgym_tpu_torch.wrappers.util import flatten_dict_space

DEFAULT_KEYS = ["temperature", "velocity"]

__all__ = ["FlattenObservation"]


class FlattenObservation(FluidWrapper):
    """Concatenate observation keys into one flat Box observation with
    ``torch.cat`` on the env's device; the original dict entries are kept in
    info as ``original_<key>``.

    ``keys=None`` takes temperature and velocity, or every key of the space
    (sorted) where neither is present, so that a cylinder or airfoil env
    (velocity and pressure) keeps its pressure sensors.  Pass ``keys`` to
    choose the selection and order.  In MARL the agent axis stays leading.
    """

    def __init__(self, env: FluidEnvLike,
                 keys: list[str] | None = None) -> None:
        super().__init__(env)
        if not isinstance(self._env.observation_space, spaces.Dict):
            raise ValueError(
                "FlattenObservation wrapper only supports Dict observation spaces."
            )
        space_keys = self._env.observation_space.spaces
        if keys is not None:
            missing = [k for k in keys if k not in space_keys]
            if missing:
                raise ValueError(
                    f"keys {missing} not in the observation space "
                    f"({sorted(space_keys)})"
                )
            self.__keys = list(keys)
        else:
            self.__keys = [k for k in DEFAULT_KEYS if k in space_keys]
            if not self.__keys:
                self.__keys = sorted(space_keys)
        self.__observation_space = flatten_dict_space(
            self._env.observation_space, keys=self.__keys
        )
        self.__start_axis = 1 if env.use_marl else 0

    @property
    def observation_space(self) -> spaces.Box:
        return self.__observation_space

    def __flatten(self, obs):
        a = self.__start_axis
        return torch.cat(
            [obs[k].reshape(tuple(obs[k].shape[:a]) + (-1,)) for k in self.__keys],
            dim=a)

    def reset(self, seed: int | None = None, randomize: bool | None = None):
        obs, info = self._env.reset(seed=seed, randomize=randomize)
        for k, v in obs.items():
            info["original_" + k] = v
        return self.__flatten(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self._env.step(action)
        for k, v in obs.items():
            info["original_" + k] = v
        return self.__flatten(obs), reward, terminated, truncated, info
