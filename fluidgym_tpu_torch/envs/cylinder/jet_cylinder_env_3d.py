"""3D cylinder flow with segmented jet actuation (counterpart of
``fluidgym_tpu/envs/cylinder/jet_cylinder_env_3d.py``): the top and bottom
wall jets cut into ``n_jets`` independent z-segments (one agent per jet in
MARL), z-stacked planes of the 151 wake sensors, an optional
``local_2d_obs`` mode whose agents see the 2D env's observation, drag and
lift per z-slice (summed over the span for the global reward, per jet
segment for the local ones), and flux balancing over the jet and outflow
faces after every action.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.core.domain import DomainState
from fluidgym_tpu_torch.envs.cylinder.cylinder_env_base import CylinderEnvBase
from fluidgym_tpu_torch.envs.util.multiblock_resample import (
    make_multiblock_point_plan,
)
from fluidgym_tpu_torch.envs.util.profiles import get_jet_profile
from fluidgym_tpu_torch.solver.boundaries import balance_boundary_fluxes

Tensor = torch.Tensor

CYLINDER_JET_3D_DEFAULT_CONFIG = {
    "n_jets": 8,
    "reynolds_number": 1e2,
    "resolution": 24,
    "dt": 1e-2,
    "adaptive_cfl": 0.8,
    "step_length": 0.25,
    "lift_penalty": 1.0,
    "episode_length": 80,
    "local_obs_window": 3,
    "local_reward_weight": 0.8,
    "local_2d_obs": False,
    "use_marl": False,
    "load_initial_domain": True,
    "load_domain_statistics": True,
    "randomize_initial_state": True,
    "enable_actions": True,
    "differentiable": False,
}


class CylinderJetEnv3D(CylinderEnvBase):
    """3D cylinder with ``n_jets`` independently controlled jet segments."""

    _default_render_key: str = "x-y-vorticity"
    _jet_angle: float = 10.0  # degrees
    _n_sensors_per_agent: int = 2
    _supports_marl = True

    def __init__(self, n_jets: int, local_obs_window: int,
                 local_reward_weight: float | None, local_2d_obs: bool = False,
                 **kwargs):
        resolution = kwargs.get("resolution")
        if n_jets < 1 or resolution % n_jets != 0:
            raise ValueError("n_jets must be a positive integer that evenly "
                             "divides the angular resolution.")
        if local_2d_obs and not kwargs.get("use_marl"):
            raise ValueError(
                "Local 2D observations are only supported in multi-agent mode.")
        self._local_2d_obs = bool(local_2d_obs)
        self._n_jets = int(n_jets)
        self._local_obs_window = int(local_obs_window)
        self._local_reward_weight = local_reward_weight
        if local_2d_obs:
            self._n_sensors_per_agent = 1
            self._local_obs_window = 1
        super().__init__(ndims=3, **kwargs)

    # ------------------------------------------------------------------
    # spaces
    # ------------------------------------------------------------------
    @property
    def n_agents(self) -> int:
        return self._n_jets if self._use_marl else 1

    @property
    def _n_sensors_z(self) -> int:
        return self._n_jets * self._n_sensors_per_agent

    @property
    def _control_shape(self) -> tuple[int, ...]:
        return (self._n_jets, 1)

    def _get_action_space(self) -> spaces.Box:
        shape = (1,) if self._use_marl else (self._n_jets, 1)
        return spaces.Box(low=-1.0, high=1.0, shape=shape, dtype=np.float32)

    def _get_observation_space(self) -> spaces.Dict:
        nspa, n_xy = self._n_sensors_per_agent, self._n_sensors_x_y
        if self._use_marl and self._local_2d_obs:
            vel_shape, p_shape = (n_xy, 2), (n_xy,)
        elif self._use_marl:
            w = self._local_obs_window
            vel_shape, p_shape = (w, nspa, self._ndims, n_xy), (w, nspa, n_xy)
        else:
            vel_shape = (self._n_jets, nspa, self._ndims, n_xy)
            p_shape = (self._n_jets, nspa, n_xy)
        return spaces.Dict({
            "velocity": spaces.Box(-np.inf, np.inf, vel_shape, np.float32),
            "pressure": spaces.Box(-np.inf, np.inf, p_shape, np.float32),
        })

    # ------------------------------------------------------------------
    # sensors
    # ------------------------------------------------------------------
    def _sensor_z(self) -> np.ndarray:
        """z of the ``_n_sensors_z`` sensor planes, centred in equal slabs."""
        n_z = self._n_sensors_z
        return (np.linspace(-self.H / 2, self.H / 2, n_z + 1)[:-1]
                + self.H / (2 * n_z))

    def _get_sensor_locations(self) -> np.ndarray:
        """Render-grid indices of the z-stacked sensors, ``(3, n_z, n_xy)``."""
        s2d = self._get_sensor_locations_2d()
        x = np.repeat(s2d[0][:, None], self._n_sensors_z, axis=1)
        y = np.repeat(s2d[1][:, None], self._n_sensors_z, axis=1)
        z = np.repeat(self._sensor_z()[None, :], s2d.shape[1], axis=0)
        phys = np.stack([x, y, z], axis=0)  # (3, n_xy, n_z)
        grid = self._sensor_locations_to_grid_coords(
            phys.reshape(3, -1)).reshape(3, -1, self._n_sensors_z)
        return np.stack([grid[0].T, grid[1].T, grid[2].T])

    def _pure_global_obs(self, state: DomainState) -> dict[str, Tensor]:
        """Velocity and pressure at the z-stacked sensors, per jet: ``(n_jets,
        nspa, vd, n_xy)`` and ``(n_jets, nspa, n_xy)`` (``(n_jets, 1, n_xy,
        2)`` velocity with ``local_2d_obs``).  The velocity reshape is the
        JAX package's, a reinterpretation of the ``(n, vd)`` sample and not a
        transpose."""
        u = self._sensor_sample3(tuple(b.velocity for b in state.blocks))
        p = self._sensor_sample3(tuple(b.pressure for b in state.blocks))
        nspa = self._n_sensors_per_agent
        vd = 2 if self._local_2d_obs else 3
        uv = u[:vd].movedim(0, 1).reshape(self._n_sensors_z, vd, -1)
        uv = uv.reshape(self._n_jets, nspa, vd, -1)
        if self._local_2d_obs:
            uv = uv.permute(0, 1, 3, 2)
        pv = p.reshape(self._n_jets, nspa, -1)
        return {"velocity": uv, "pressure": pv}

    def _pure_local_obs(self, state: DomainState) -> dict[str, Tensor]:
        """Per-agent windows of ``local_obs_window`` jets, circular over the
        span, centred on the agent's jet."""
        g = self._pure_global_obs(state)
        offset = self._local_obs_window // 2
        out = {}
        for k, v in g.items():
            shifted = torch.roll(v, offset, dims=0)
            windows = []
            for i in range(self._n_jets):
                w = torch.roll(shifted, -i, dims=0)[: self._local_obs_window]
                if self._local_2d_obs:
                    w = w.squeeze(1).squeeze(0)
                windows.append(w)
            out[k] = torch.stack(windows, dim=0)
        return out

    def _get_local_obs(self) -> dict[str, Tensor]:
        return self._pure_local_obs(self._state)

    # ------------------------------------------------------------------
    # jets
    # ------------------------------------------------------------------
    def _additional_initialization(self) -> None:
        super()._additional_initialization()
        self._top_velocity, self._bottom_velocity, self._nz_per_agent = (
            self._get_boundary_velocities())
        # the sensor cloud, n_z-major (plane by plane), as the obs reshapes
        # expect
        s2d = self._get_sensor_locations_2d()
        n_z = self._n_sensors_z
        xs = np.tile(s2d[0], (n_z, 1))
        ys = np.tile(s2d[1], (n_z, 1))
        zs = np.repeat(self._sensor_z()[:, None], s2d.shape[1], axis=1)
        pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3)
        self._sensor_sample3 = make_multiblock_point_plan(
            self._centers_np, pts, device=self._device)

    def _get_boundary_velocities(self):
        """Base jet profiles on the top / bottom cylinder-wall faces in face
        slab layout ``(3, nz, 1, nx)`` (the 2D profile of one z-slice,
        repeated along z), and the z cells per jet."""

        def coords_to_velocities(line: np.ndarray, direction: str):
            centers = 0.5 * (line[:, :-1] + line[:, 1:])
            if direction == "top":
                angles = np.pi / 2 - np.arctan2(centers[1], centers[0])
            else:
                angles = -np.pi / 2 - np.arctan2(centers[1], centers[0])
            deg = np.rad2deg(angles)
            deg_abs = np.abs(deg).copy()
            deg_abs[deg_abs > self._jet_angle] = 0.0
            nz = np.where(deg_abs > 0.0)[0]
            min_idx, max_idx = nz[0] - 1, nz[-1] + 1
            profile = get_jet_profile(int(max_idx - min_idx + 1))
            velocities = np.zeros((3, centers.shape[1]))
            for i, mag in zip(range(min_idx, max_idx + 1), profile):
                a = np.deg2rad(deg[i])
                velocities[0, i] = mag * np.sin(a)
                velocities[1, i] = mag * np.cos(a)
            return velocities

        vcs = self._blocks_vertex_coords
        # coords (3, nz+1, ny+1, nx+1): the z = 0 slice of the wall line
        top_v = coords_to_velocities(
            np.asarray(vcs[self._top_block_idx])[:2, 0, 0, :], "top")
        bottom_v = coords_to_velocities(
            np.asarray(vcs[self._bottom_block_idx])[:2, 0, -1, :], "bottom")
        n_z = np.asarray(vcs[self._top_block_idx]).shape[1] - 1
        conv = lambda v: torch.as_tensor(
            np.repeat(v[:, None, None, :], n_z, axis=1),
            device=self._device).to(self._dtype)
        return conv(top_v), conv(bottom_v), n_z // self._n_jets

    def _pure_apply_action(self, state: DomainState, control: Tensor) -> DomainState:
        """Scale each jet's z-segment of the profiles, then rebalance the
        fluxes over the jet and outflow faces."""
        a = torch.repeat_interleave(control.reshape(-1), self._nz_per_agent)
        a = a[None, :, None, None]  # over (3, nz, 1, nx)
        # top block "-y" face (2) and bottom block "+y" face (3)
        for b, f, base in ((self._top_block_idx, 2, self._top_velocity),
                           (self._bottom_block_idx, 3, self._bottom_velocity)):
            blk = state.blocks[b]
            faces = list(blk.faces)
            faces[f] = replace(faces[f], velocity=(base * a).to(
                faces[f].velocity.dtype))
            state = state.replace_block(b, replace(blk, faces=tuple(faces)))
        free = ((self._top_block_idx, 2), (self._bottom_block_idx, 3),
                (self._vortex_street_block_idx, 1))
        return balance_boundary_fluxes(state, self._geoms, self._topo, free,
                                       tol=1e-7)

    # ------------------------------------------------------------------
    # rewards
    # ------------------------------------------------------------------
    def _pure_end(self, carry: tuple, records: list):
        """Drag and lift per z-slice averaged over the sim steps
        (``all_cds``, ``all_cls``), summed over the span per unit length
        for the global reward."""
        all_cds = torch.mean(torch.stack([r[0] for r in records]), dim=0)
        all_cls = torch.mean(torch.stack([r[1] for r in records]), dim=0)
        cd = torch.sum(all_cds) / self.D
        cl = torch.sum(all_cls) / self.D
        return (self._pure_global_obs(carry[0]), self._reward(cd, cl),
                {"drag": cd, "lift": cl, "all_cds": all_cds,
                 "all_cls": all_cls})

    def _pure_end_marl(self, carry: tuple, records: list):
        """Per-jet rewards: the drag and lift of the jet's z-segment, mixed
        with the global reward by ``local_reward_weight``."""
        _, global_reward, info = self._pure_end(carry, records)
        all_cds = info.pop("all_cds")
        all_cls = info.pop("all_cls")
        seg = self.D / self._n_jets
        local_cd = all_cds.reshape(self._n_jets, -1).sum(dim=1) / seg
        local_cl = all_cls.reshape(self._n_jets, -1).sum(dim=1) / seg
        local_rewards = self._reward(local_cd, local_cl)
        agent_rewards = (self._local_reward_weight * local_rewards
                         + (1 - self._local_reward_weight) * global_reward)
        info["global_reward"] = global_reward
        return self._pure_local_obs(carry[0]), agent_rewards, info

    def _step_marl_impl(self, actions: Tensor):
        if self._local_reward_weight is None:
            raise ValueError("local_reward_weight must be set for multi-agent step.")
        return super()._step_marl_impl(actions)

    def _get_render_data(self, render_3d: bool, output_path=None):
        """The mid-plane slice always; with ``render_3d`` also an
        iso-surface of |vorticity| = 2 coloured by |u|."""
        data = super()._get_render_data(render_3d, output_path)
        if render_3d:
            from fluidgym_tpu_torch.envs.util.visualization import render_3d_iso

            u = self.get_velocity().detach().cpu().numpy()
            vort = self.get_vorticity().detach().cpu().numpy()
            curl = np.abs(vort).transpose(2, 1, 0)  # (X, Y, Z)
            umag = np.linalg.norm(u, axis=0).transpose(2, 1, 0)
            out = None
            if output_path is not None:
                out = output_path / f"vorticity_{self._n_episodes}_{self._n_steps}.png"
            data["3d_vorticity"] = render_3d_iso(
                iso_field=curl, iso=[2.0], color_field=umag,
                color_range=(0.0, float(umag.max()) or 1.0), output_path=out,
                extent=((-2.0, self.L - 2.0), (-self.H / 2, self.H / 2),
                        (-self.D / 2, self.D / 2)),
                view_kwargs={"elev": 10, "azim": 60})
        return data

    @property
    def id(self) -> str:
        return f"JetCylinder3D_Re{self._reynolds_number}"
