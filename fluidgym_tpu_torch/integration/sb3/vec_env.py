"""Stable-Baselines3 VecEnv adapter: the agents of one MARL env as vector
envs (counterpart of ``fluidgym_tpu/integration/sb3/vec_env.py``).

The ``n_agents`` of one MARL port environment are exposed to SB3 as
``num_envs`` parallel envs sharing one simulation; at the end of an episode
the env is reset and the last observation is kept under
``terminated_observation`` in each agent's info.  Inherits SB3's ``VecEnv``
where stable_baselines3 imports, else ``object`` (the VecEnv duck type);
tensors cross to numpy here, and the spaces are gymnasium's where gymnasium
imports.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from fluidgym_tpu_torch.envs.fluid_env import FluidEnv
from fluidgym_tpu_torch.integration.gymnasium import gym_space, to_numpy
from fluidgym_tpu_torch.types import FluidEnvLike

try:
    from stable_baselines3.common.vec_env import VecEnv as _SB3VecEnv

    _HAS_SB3 = True
except ImportError:
    _SB3VecEnv = object
    _HAS_SB3 = False

__all__ = ["VecFluidEnv"]


class VecFluidEnv(_SB3VecEnv):
    """SB3 VecEnv over the agents of one MARL port environment."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, env: FluidEnvLike, auto_reset: bool = True):
        self.__env = env
        self.__agents = list(range(env.n_agents))
        self.__auto_reset = auto_reset
        if not env.use_marl or env.n_agents <= 1:
            raise ValueError(
                "VecFluidEnv can only be used with MARL fluid environments "
                "with multiple agents."
            )
        self.observations = None
        observation_space = gym_space(env.observation_space)
        action_space = gym_space(env.action_space)
        if _HAS_SB3:
            super().__init__(num_envs=len(self.__agents),
                             observation_space=observation_space,
                             action_space=action_space)
        else:
            self.num_envs = len(self.__agents)
            self.observation_space = observation_space
            self.action_space = action_space

    def reset(self, seed: int | None = None, randomize: bool | None = None):
        local_obs, _ = self.__env.reset(seed=seed, randomize=randomize)
        return to_numpy(local_obs)

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def step_async(self, actions) -> None:
        a = torch.as_tensor(actions)
        if a.ndim > 2:
            # multi-dimensional per-agent actions get a trailing axis, as in
            # the JAX package's adapter
            a = a[..., None]
        self._actions = a

    def step_wait(self):
        local_obs, agent_rewards, term, trunc, info = self.__env.step(self._actions)
        obs_np = to_numpy(local_obs)
        rewards = to_numpy(agent_rewards)
        done = bool(term or trunc)
        dones = np.full(len(self.__agents), done, dtype=bool)
        info_np = to_numpy(info)
        infos: list[dict[str, Any]] = [dict(info_np) for _ in self.__agents]
        if done and self.__auto_reset:
            for i in range(len(self.__agents)):
                if isinstance(obs_np, dict):
                    infos[i]["terminated_observation"] = {
                        k: obs_np[k][i] for k in obs_np}
                else:
                    infos[i]["terminated_observation"] = obs_np[i]
            obs_np = self.reset()
        return obs_np, rewards, dones, infos

    # -- SB3 VecEnv API surface -----------------------------------------
    def get_attr(self, attr_name: str, indices=None) -> list[Any]:
        return [getattr(self.__env, attr_name) for _ in self.__agents]

    def set_attr(self, attr_name: str, value: Any, indices=None) -> None:
        setattr(self.__env, attr_name, value)

    def env_is_wrapped(self, wrapper_class, indices=None) -> list[bool]:
        return [False for _ in self.__agents]

    def env_method(self, method_name: str, *args, indices=None, **kwargs):
        result = getattr(self.__env, method_name)(*args, **kwargs)
        return [result for _ in self.__agents]

    def render(self, mode: str | None = None):
        return self.__env.render()

    def close(self) -> None:
        pass

    @property
    def unwrapped(self) -> FluidEnv:  # type: ignore[override]
        return self.__env.unwrapped if hasattr(self.__env, "unwrapped") else self.__env

    def train(self) -> None:
        self.__env.train()

    def val(self) -> None:
        self.__env.val()

    def test(self) -> None:
        self.__env.test()

    def save_gif(self, filename: str, output_path: Path | None = None) -> None:
        self.__env.save_gif(filename=filename, output_path=output_path)

    def seed(self, seed: int | None = None):  # type: ignore[override]
        if seed is not None:
            self.__env.seed(seed)
        return [seed for _ in self.__agents]

    @property
    def num_actions(self) -> int:
        return int(np.prod(self.action_space.shape))
