"""TorchRL EnvBase adapter (counterpart of
``fluidgym_tpu/integration/torchrl.py``).

Specs built from the env's spaces, tensordict-based ``_step`` / ``_reset``,
optional ``from_pixels`` frames.  The env's tensors stay torch tensors and
move with ``.to(device)`` to the adapter's device.  ``TorchRLFluidEnv``
raises ``ImportError`` without torchrl / tensordict.
"""

from __future__ import annotations

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.types import FluidEnvLike

__all__ = ["TorchRLFluidEnv"]

try:
    from tensordict import TensorDict
    from torchrl.data import Bounded, Composite, Unbounded
    from torchrl.envs import EnvBase as _EnvBase

    _HAS_TORCHRL = True
except ImportError:
    _HAS_TORCHRL = False
    _EnvBase = object


class TorchRLFluidEnv(_EnvBase):
    """TorchRL-compatible wrapper around a port environment."""

    def __init__(self, env: FluidEnvLike, from_pixels: bool = False,
                 device: str = "cpu"):
        if not _HAS_TORCHRL:
            raise ImportError(
                "torchrl and tensordict are required for TorchRLFluidEnv; "
                "install them or use the Gymnasium / SB3 adapters.")
        super().__init__(device=device)
        self.__env = env
        self.__from_pixels = from_pixels
        self._make_specs()

    def __to_device(self, x):
        return torch.as_tensor(x).to(self.device)

    def _probe_frame_shape(self) -> tuple[int, ...]:
        """Shape of the frames ``render()`` produces (resetting the env
        first where it has no state yet)."""
        env = self.__env
        if env.unwrapped._state is None:
            env.reset(seed=0)
        return tuple(np.asarray(env.render()).shape)

    def _make_specs(self) -> None:
        env = self.__env
        obs_space = env.observation_space
        specs = {}
        if isinstance(obs_space, spaces.Dict):
            for k, s in obs_space.spaces.items():
                specs[k] = Unbounded(shape=s.shape, device=self.device)
        else:
            specs["observation"] = Unbounded(shape=obs_space.shape,
                                             device=self.device)
        if self.__from_pixels:
            # from a frame render() really produces: the frame shape varies
            # with the family and its resolution
            specs["pixels"] = Unbounded(shape=self._probe_frame_shape(),
                                        device=self.device)
        self.observation_spec = Composite(**specs)
        a = env.action_space
        self.action_spec = Bounded(low=float(a.low.min()), high=float(a.high.max()),
                                   shape=a.shape, device=self.device)
        self.reward_spec = Unbounded(shape=(1,), device=self.device)

    def _obs_to_td(self, obs) -> dict:
        if isinstance(obs, dict):
            out = {k: self.__to_device(v) for k, v in obs.items()}
        else:
            out = {"observation": self.__to_device(obs)}
        if self.__from_pixels:
            out["pixels"] = self.__to_device(self.__env.render())
        return out

    def _reset(self, tensordict=None, **kwargs) -> "TensorDict":
        obs, _ = self.__env.reset(seed=kwargs.get("seed"))
        return TensorDict(self._obs_to_td(obs), batch_size=[])

    def _step(self, tensordict) -> "TensorDict":
        obs, reward, term, trunc, info = self.__env.step(
            tensordict["action"].detach())
        out = self._obs_to_td(obs)
        out["reward"] = self.__to_device(reward).reshape(1)
        out["done"] = torch.tensor([bool(term or trunc)], device=self.device)
        out["terminated"] = torch.tensor([bool(term)], device=self.device)
        out["truncated"] = torch.tensor([bool(trunc)], device=self.device)
        return TensorDict(out, batch_size=[])

    def _set_seed(self, seed: int | None) -> None:
        if seed is not None:
            self.__env.seed(int(seed))
