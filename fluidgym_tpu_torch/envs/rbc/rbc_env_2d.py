"""2D Rayleigh-Benard Convection environment (counterpart of
``fluidgym_tpu/envs/rbc/rbc_env_2d.py``): segmented bottom-plate heaters,
zero-mean amplitude-clamped control, cubic edge smoothing, sensor-grid Dict
observations, circular per-agent obs windows, local Nusselt rewards."""

from __future__ import annotations

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.envs.rbc.rbc_env_base import RBCEnvBase
from fluidgym_tpu_torch.envs.util.obs_extraction import extract_moving_window_2d

Tensor = torch.Tensor

RBC_2D_DEFAULT_CONFIG = {
    "rayleigh_number": 8e4,
    "prandtl_number": 0.7,
    "n_heaters": 12,
    "resolution": 8,
    "dt": 0.05,
    "adaptive_cfl": 0.8,
    "step_length": 1.0,
    "episode_length": 200,
    "local_obs_window": 11,
    "local_reward_weight": 0.2,
    "uniform_grid": False,
    "aspect_ratio": 1.0,
    "use_marl": False,
    "load_initial_domain": True,
    "load_domain_statistics": True,
    "randomize_initial_state": True,
    "enable_actions": True,
    "differentiable": False,
}


class RBCEnv2D(RBCEnvBase):
    """2D RBC with segmented bottom-plate temperature actuators."""

    _ndims = 2

    def _get_action_space(self) -> spaces.Box:
        shape = (1,) if self.use_marl else (self._n_heaters, 1)
        return spaces.Box(low=-1.0, high=1.0, shape=shape, dtype=np.float32)

    def _get_observation_space(self) -> spaces.Dict:
        if self._use_marl:
            shape = (self._n_sensors_y,
                     self._n_sensors_per_heater * self._local_obs_window)
        else:
            shape = (self._n_sensors_y, self._n_heaters * self._n_sensors_per_heater)
        return spaces.Dict({
            "temperature": spaces.Box(
                low=self._T_cold, high=self._T_hot + self._heater_limit,
                shape=shape, dtype=np.float32),
            "velocity": spaces.Box(low=-np.inf, high=np.inf,
                                   shape=(self._ndims,) + shape, dtype=np.float32),
            "pressure": spaces.Box(low=-np.inf, high=np.inf, shape=shape,
                                   dtype=np.float32),
        })

    def _get_sensor_locations(self) -> np.ndarray:
        return self._get_sensor_locations_2d()

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------
    def _pure_global_obs(self, state) -> dict[str, Tensor]:
        blk = state.blocks[0]
        T = self._resample_plan(blk.scalar[0])
        u = self._resample_plan(blk.velocity)
        p = self._resample_plan(blk.pressure)
        sx, sy = self._sensor_locations[0], self._sensor_locations[1]
        nsx, nsy = self._n_sensors_x, self._n_sensors_y
        T = T[sy, sx].reshape(nsx, nsy).T
        u = u[:, sy, sx].reshape(2, nsx, nsy).permute(0, 2, 1)
        p = p[sy, sx].reshape(nsx, nsy).T
        return {"temperature": T, "velocity": u, "pressure": p}

    def _pure_local_obs(self, state) -> dict[str, Tensor]:
        g = self._pure_global_obs(state)

        def window(f):
            return extract_moving_window_2d(
                f, self.n_agents, self._n_sensors_per_heater,
                self._local_obs_window)

        u = g["velocity"]
        return {
            "temperature": window(g["temperature"]),
            "velocity": torch.stack([window(u[0]), window(u[1])], dim=1),
            "pressure": window(g["pressure"]),
        }

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------
    def _action_to_control(self, action: Tensor) -> Tensor:
        T_shifted = action - torch.mean(action)
        # clamp the amplitude to heater_limit
        T_action = T_shifted / (torch.clamp(torch.abs(T_shifted), min=1.0)
                                / self._heater_limit)
        T_action = T_action + self._T_hot
        return self._smooth_action_profile_1d(T_action)

    def _pure_apply_action(self, state, action: Tensor):
        flat = torch.reshape(action, (self._n_heaters,))
        return self._with_bottom_plate_scalar(state, self._action_to_control(flat))

    # ------------------------------------------------------------------
    # local rewards
    # ------------------------------------------------------------------
    def _pure_local_rewards(self, state) -> Tensor:
        blk = state.blocks[0]
        T = blk.scalar[0]
        u_y = blk.velocity[1]
        cell_size = self._geoms[0].det
        w = self._local_obs_window * self._heater_width
        reps = -(-w // cell_size.shape[1])  # wrap when the window exceeds X
        local_cell = cell_size.repeat(1, reps)[:, :w]
        local_T = extract_moving_window_2d(
            T, self.n_agents, self._heater_width, self._local_obs_window)
        local_uy = extract_moving_window_2d(
            u_y, self.n_agents, self._heater_width, self._local_obs_window)
        local_nu = self._compute_nusselt(local_T, local_uy, local_cell)
        return self.nu_ref - local_nu
