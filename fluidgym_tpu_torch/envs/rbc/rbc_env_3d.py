"""3D Rayleigh-Benard Convection environment (counterpart of
``fluidgym_tpu/envs/rbc/rbc_env_3d.py``): an n_heaters x n_heaters grid of
bottom-plate actuators over the (z, x) plane, the 2D action smoothing
applied per axis, MARL with 3D circular obs windows and local Nusselt
rewards."""

from __future__ import annotations

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.envs.rbc.rbc_env_base import RBCEnvBase
from fluidgym_tpu_torch.envs.util.obs_extraction import extract_moving_window_3d

Tensor = torch.Tensor

RBC_3D_DEFAULT_CONFIG = {
    "rayleigh_number": 2e3,
    "prandtl_number": 0.7,
    "n_heaters": 8,
    "resolution": 8,
    "dt": 0.05,
    "adaptive_cfl": 0.8,
    "step_length": 1.0,
    "episode_length": 200,
    "local_obs_window": 3,
    "local_reward_weight": 0.0015,
    "uniform_grid": False,
    "aspect_ratio": 1.0,
    "use_marl": True,
    "load_initial_domain": True,
    "load_domain_statistics": True,
    "randomize_initial_state": True,
    "enable_actions": True,
    "differentiable": False,
}


class RBCEnv3D(RBCEnvBase):
    """3D RBC with a (z, x) grid of bottom-plate heaters."""

    _ndims = 3

    def _get_action_space(self) -> spaces.Box:
        shape = (1,) if self.use_marl else (self._n_heaters, self._n_heaters, 1)
        return spaces.Box(low=-1.0, high=1.0, shape=shape, dtype=np.float32)

    def _get_observation_space(self) -> spaces.Dict:
        if self._use_marl:
            w = self._n_sensors_per_heater * self._local_obs_window
            shape = (w, self._n_sensors_y, w)
        else:
            n = self._n_sensors_per_heater * self._n_heaters
            shape = (n, self._n_sensors_y, n)
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
        """``(3, n)`` integer sensor pixels as (x, y, z), z the minor index."""
        s2d = self._get_sensor_locations_2d()  # (2, n_x * n_y) as (x, y)
        nz = self.render_shape[-1]
        n_sz = self._n_sensors_per_heater * self._n_heaters
        sz = np.linspace(0, nz, n_sz + 1)[:-1] + nz / (2 * n_sz)
        sz = sz.round().astype(np.int32)
        x = np.repeat(s2d[0], n_sz)
        y = np.repeat(s2d[1], n_sz)
        z = np.tile(sz, s2d.shape[1])
        return np.stack([x, y, z], axis=0)

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------
    def _pure_global_obs(self, state) -> dict[str, Tensor]:
        blk = state.blocks[0]
        T = self._resample_plan(blk.scalar[0])  # (Z, Y, X)
        u = self._resample_plan(blk.velocity)   # (3, Z, Y, X)
        p = self._resample_plan(blk.pressure)
        sx, sy, sz = (self._sensor_locations[0], self._sensor_locations[1],
                      self._sensor_locations[2])
        n, nsy = self._n_sensors_x, self._n_sensors_y
        T = T[sz, sy, sx].reshape(n, nsy, n).permute(2, 1, 0)
        u = u[:, sz, sy, sx].reshape(3, n, nsy, n).permute(0, 3, 2, 1)
        p = p[sz, sy, sx].reshape(n, nsy, n).permute(2, 1, 0)
        return {"temperature": T, "velocity": u, "pressure": p}

    def _pure_local_obs(self, state) -> dict[str, Tensor]:
        g = self._pure_global_obs(state)

        def window(f):
            return extract_moving_window_3d(
                f, self._n_heaters, self._n_sensors_per_heater,
                self._local_obs_window)

        u = g["velocity"]
        return {
            "temperature": window(g["temperature"]),
            "velocity": torch.stack([window(u[0]), window(u[1]), window(u[2])],
                                    dim=1),
            "pressure": window(g["pressure"]),
        }

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------
    def _smooth_action_profile_2d(self, T_action: Tensor) -> Tensor:
        smooth_x = self._smooth_action_profile_1d(T_action.T)
        return self._smooth_action_profile_1d(smooth_x.T)

    def _action_to_control(self, action: Tensor) -> Tensor:
        a = torch.reshape(action, (self._n_heaters, self._n_heaters))
        T_shifted = a - torch.mean(a)
        # clamp the amplitude to heater_limit
        T_action = T_shifted / (torch.clamp(torch.abs(T_shifted), min=1.0)
                                / self._heater_limit)
        T_action = T_action + self._T_hot
        return self._smooth_action_profile_2d(T_action)

    def _pure_apply_action(self, state, action: Tensor):
        control = self._action_to_control(action)  # (z, x) over the plate
        return self._with_bottom_plate_scalar(state, control[:, None, :])

    # ------------------------------------------------------------------
    # local rewards
    # ------------------------------------------------------------------
    def _pure_local_rewards(self, state) -> Tensor:
        blk = state.blocks[0]
        T = blk.scalar[0]  # (Z, Y, X)
        u_y = blk.velocity[1]
        cell_size = self._geoms[0].det
        w = self._local_obs_window * self._heater_width
        reps = -(-w // cell_size.shape[0])  # wrap when the window exceeds Z / X
        local_cell = cell_size.repeat(reps, 1, reps)[:w, :, :w]
        local_T = extract_moving_window_3d(
            T, self._n_heaters, self._heater_width, self._local_obs_window)
        local_uy = extract_moving_window_3d(
            u_y, self._n_heaters, self._heater_width, self._local_obs_window)
        local_nu = self._compute_nusselt(local_T, local_uy, local_cell)
        return self.nu_ref - local_nu
