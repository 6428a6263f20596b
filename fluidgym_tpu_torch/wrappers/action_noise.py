"""Gaussian action-noise wrapper (counterpart of
``fluidgym_tpu/wrappers/action_noise.py``)."""

from __future__ import annotations

import torch

from fluidgym_tpu_torch.types import FluidEnvLike
from fluidgym_tpu_torch.wrappers.fluid_wrapper import FluidWrapper

__all__ = ["ActionNoise", "noise_generator"]


def noise_generator(env: FluidEnvLike, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on the env's device, seeded from ``seed``: the
    noise wrappers draw their noise there, in the place of the JAX
    package's ``jax.random`` key."""
    return torch.Generator(device=env.unwrapped.device).manual_seed(int(seed))


class ActionNoise(FluidWrapper):
    """Add seeded Gaussian noise (stddev sigma) to every action: one draw
    of the action's shape per step, on the env's device, in the action's
    floating dtype (the env's where the action is not floating)."""

    def __init__(self, env: FluidEnvLike, sigma: float, seed: int) -> None:
        super().__init__(env)
        self.__sigma = float(sigma)
        self.__gen = noise_generator(env, seed)

    def step(self, action):
        env = self.unwrapped
        action = torch.as_tensor(action, device=env.device)
        if not action.is_floating_point():
            action = action.to(env._dtype)
        noise = torch.randn(action.shape, generator=self.__gen,
                            device=action.device, dtype=action.dtype)
        return self._env.step(action + noise * self.__sigma)
