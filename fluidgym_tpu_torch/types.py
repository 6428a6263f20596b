"""Shared types: env mode enum and the structural env protocol
(counterpart of ``fluidgym_tpu/types.py``; arrays are ``torch.Tensor``)."""

from __future__ import annotations

import enum
from typing import Any, Protocol, TypeVar, runtime_checkable

import torch


class EnvMode(enum.Enum):
    """Dataset split / evaluation mode of an environment."""

    TRAIN = "train"
    VAL = "val"
    TEST = "test"


@runtime_checkable
class FluidEnvLike(Protocol):
    """Structural protocol satisfied by the port's environments."""

    @property
    def action_space(self) -> Any: ...

    @property
    def observation_space(self) -> Any: ...

    def reset(
        self, seed: int | None = None, randomize: bool | None = None
    ) -> tuple[Any, dict]: ...

    def step(self, action: Any) -> tuple[Any, Any, bool, bool, dict]: ...

    def seed(self, seed: int) -> None: ...

    def sample_action(self) -> torch.Tensor: ...

    def train(self) -> None: ...

    def val(self) -> None: ...

    def test(self) -> None: ...

    @property
    def use_marl(self) -> bool: ...

    @property
    def n_agents(self) -> int: ...

    @property
    def unwrapped(self) -> "FluidEnvLike": ...


EnvT = TypeVar("EnvT", bound=FluidEnvLike)
