"""Gaussian sensor-noise wrapper (counterpart of
``fluidgym_tpu/wrappers/sensor_noise.py``)."""

from __future__ import annotations

import torch

from fluidgym_tpu_torch.types import FluidEnvLike
from fluidgym_tpu_torch.wrappers.action_noise import noise_generator
from fluidgym_tpu_torch.wrappers.fluid_wrapper import FluidWrapper

__all__ = ["SensorNoise"]


class SensorNoise(FluidWrapper):
    """Add seeded Gaussian noise (stddev sigma) to every observation entry:
    one draw per key, in the observation's key order, on the env's
    device."""

    def __init__(self, env: FluidEnvLike, sigma: float, seed: int) -> None:
        super().__init__(env)
        self.__sigma = float(sigma)
        self.__gen = noise_generator(env, seed)

    def __add_noise(self, obs):
        return {k: v + torch.randn(v.shape, generator=self.__gen,
                                   device=v.device, dtype=v.dtype) * self.__sigma
                for k, v in obs.items()}

    def reset(self, seed: int | None = None, randomize: bool | None = None):
        obs, info = self._env.reset(seed=seed, randomize=randomize)
        return self.__add_noise(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self._env.step(action)
        return self.__add_noise(obs), reward, terminated, truncated, info
