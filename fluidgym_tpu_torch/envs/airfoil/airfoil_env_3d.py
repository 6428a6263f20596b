"""3D airfoil flow-separation control (counterpart of
``fluidgym_tpu/envs/airfoil/airfoil_env_3d.py``): the three upper-surface
jets cut into ``n_agents`` spanwise segments (an agent per segment in MARL),
z-stacked planes of the 2D sensor cloud, an optional ``local_2d_obs`` mode
whose agents see the 2D env's observation, a zero-mean action per segment,
lift-to-drag rewards per z-slice (summed over the span for the global
reward, per segment for the local ones), and a warm start of the 3D flow
from a saved 2D initial domain.

Its pressure solve is K3 over the C-grid's 3D merge plan, whose wake cut is
a reflected x seam ("K3-3D-flip"), and its velocity solve K2-mb over the
same plan ("K2-mb-3D-flip"); at the registered 7,051,776 cells both take
the spread arm with their chain terms passed through a ring of tiles in
shared memory (``ops.cg_cuda.spread_ring``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.core.domain import DomainState
from fluidgym_tpu_torch.core.domain_io import load_domain
from fluidgym_tpu_torch.envs.airfoil.airfoil_env_base import AirfoilEnvBase
from fluidgym_tpu_torch.envs.util.multiblock_resample import (
    make_multiblock_point_plan,
)
from fluidgym_tpu_torch.solver.boundaries import balance_boundary_fluxes
from fluidgym_tpu_torch.types import EnvMode
from fluidgym_tpu_torch.utils import data_utils

Tensor = torch.Tensor

AIRFOIL_3D_DEFAULT_CONFIG = {
    "n_agents": 4,
    "reynolds_number": 3e3,
    "dt": 0.05,
    "adaptive_cfl": 0.8,
    "step_length": 0.25,
    "episode_length": 200,
    "attack_angle_deg": 10.0,
    "local_obs_window": 1,
    "use_marl": False,
    "local_reward_weight": 0.5,
    "local_2d_obs": False,
    "init_from_2d": True,
    "load_initial_domain": True,
    "load_domain_statistics": True,
    "randomize_initial_state": True,
    "enable_actions": True,
    "differentiable": False,
}


class AirfoilEnv3D(AirfoilEnvBase):
    """3D NACA 0012 with spanwise-segmented upper-surface jets."""

    _n_sensors_per_agent: int = 1
    _supports_marl = True

    def __init__(self, n_agents: int, local_obs_window: int,
                 local_reward_weight: float | None, local_2d_obs: bool = False,
                 init_from_2d: bool = True, **kwargs):
        if n_agents < 1 or self._res_z % n_agents != 0:
            raise ValueError(
                "n_agents must be a positive integer that evenly divides the "
                "spanwise resolution.")
        if local_2d_obs and not kwargs.get("use_marl"):
            raise ValueError(
                "Local 2D observations are only supported in multi-agent mode.")
        self._local_2d_obs = bool(local_2d_obs)
        self._n_agents = int(n_agents)
        self._local_obs_window = int(local_obs_window)
        self._local_reward_weight = local_reward_weight
        self._init_from_2d = bool(init_from_2d)
        if local_2d_obs:
            self._n_sensors_per_agent = 1
            self._local_obs_window = 1
        super().__init__(ndims=3, **kwargs)

    # ------------------------------------------------------------------
    # spaces
    # ------------------------------------------------------------------
    @property
    def n_agents(self) -> int:
        return self._n_agents

    @property
    def _n_sensors_z(self) -> int:
        return self._n_agents * self._n_sensors_per_agent

    @property
    def _nz_per_agent(self) -> int:
        return self._res_z // self._n_agents

    @property
    def _control_shape(self) -> tuple[int, ...]:
        return (self._n_agents, self._n_jets)

    def _get_action_space(self) -> spaces.Box:
        shape = ((self._n_jets,) if self._use_marl
                 else (self._n_agents, self._n_jets))
        return spaces.Box(low=-1.0, high=1.0, shape=shape, dtype=np.float32)

    def _get_observation_space(self) -> spaces.Dict:
        n = self._sensor_locations.shape[-1]
        nspa = self._n_sensors_per_agent
        if self._use_marl and self._local_2d_obs:
            vel_shape, p_shape = (n, 2), (n,)
        elif self._use_marl:
            w = self._local_obs_window
            vel_shape, p_shape = (w, nspa, self._ndims, n), (w, nspa, n)
        else:
            vel_shape = (self._n_agents, nspa, self._ndims, n)
            p_shape = (self._n_agents, nspa, n)
        return spaces.Dict({
            "velocity": spaces.Box(-np.inf, np.inf, vel_shape, np.float32),
            "pressure": spaces.Box(-np.inf, np.inf, p_shape, np.float32),
        })

    # ------------------------------------------------------------------
    # sensors
    # ------------------------------------------------------------------
    def _sensor_cloud_2d(self) -> np.ndarray:
        """The 2D sensor cloud outside the airfoil mask, physical ``(2,
        n_xy)``."""
        s2d = self._get_sensor_locations_2d()
        grid2d = self._physical_locations_to_grid_coords(s2d)
        return s2d[:, ~self._airfoil_mask_2d[grid2d[1], grid2d[0]]]

    def _get_sensor_locations(self) -> np.ndarray:
        """Render-grid indices of the z-stacked sensors, ``(3, n_z,
        n_xy)``; the planes are centred in equal slabs of ``H``, as the JAX
        package places them."""
        s2d = self._sensor_cloud_2d()
        n_z = self._n_sensors_z
        sz = np.linspace(-self.H / 2, self.H / 2, n_z + 1)[:-1] + self.H / (2 * n_z)
        x = np.repeat(s2d[0][:, None], n_z, axis=1)
        y = np.repeat(s2d[1][:, None], n_z, axis=1)
        z = np.repeat(sz[None, :], s2d.shape[1], axis=0)
        phys = np.stack([x, y, z], axis=0)  # (3, n_xy, n_z)
        grid = self._physical_locations_to_grid_coords(
            phys.reshape(3, -1)).reshape(3, -1, n_z)
        return np.stack([grid[0].T, grid[1].T, grid[2].T])

    def _additional_initialization(self) -> None:
        super()._additional_initialization()
        # the sensor cloud, n_z-major (plane by plane, centred in equal
        # slabs of the span D), as the obs reshapes expect
        s2d = self._sensor_cloud_2d()
        n_z = self._n_sensors_z
        sz = np.linspace(-self.D / 2, self.D / 2, n_z + 1)[:-1] + self.D / (2 * n_z)
        xs = np.tile(s2d[0], (n_z, 1))
        ys = np.tile(s2d[1], (n_z, 1))
        zs = np.repeat(sz[:, None], s2d.shape[1], axis=1)
        pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3)
        self._sensor_sample3 = make_multiblock_point_plan(
            self._centers_np, pts, device=self._device)

    def _pure_global_obs(self, state: DomainState) -> dict[str, Tensor]:
        """Velocity and pressure at the z-stacked sensors, per agent:
        ``(n_agents, nspa, vd, n_xy)`` and ``(n_agents, nspa, n_xy)``
        (``(n_agents, 1, n_xy, 2)`` velocity with ``local_2d_obs``).  The
        velocity reshape is the JAX package's, a reinterpretation of the
        ``(n, vd)`` sample as ``(n_z, vd, n_xy)`` and not a transpose."""
        u = self._sensor_sample3(tuple(b.velocity for b in state.blocks))
        p = self._sensor_sample3(tuple(b.pressure for b in state.blocks))
        nspa = self._n_sensors_per_agent
        vd = 2 if self._local_2d_obs else 3
        uv = u[:vd].movedim(0, 1).reshape(self._n_sensors_z, vd, -1)
        uv = uv.reshape(self._n_agents, nspa, vd, -1)
        if self._local_2d_obs:
            uv = uv.permute(0, 1, 3, 2)
        pv = p.reshape(self._n_agents, nspa, -1)
        return {"velocity": uv, "pressure": pv}

    def _pure_local_obs(self, state: DomainState) -> dict[str, Tensor]:
        """Per-agent windows of ``local_obs_window`` segments, circular
        over the span, centred on the agent's segment."""
        g = self._pure_global_obs(state)
        offset = self._local_obs_window // 2
        out = {}
        for k, v in g.items():
            shifted = torch.roll(v, offset, dims=0)
            windows = []
            for i in range(self._n_agents):
                w = torch.roll(shifted, -i, dims=0)[: self._local_obs_window]
                if self._local_2d_obs:
                    w = w.squeeze(1).squeeze(0)
                windows.append(w)
            out[k] = torch.stack(windows, dim=0)
        return out

    def _get_local_obs(self) -> dict[str, Tensor]:
        return self._pure_local_obs(self._state)

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------
    def _pure_apply_action(self, state: DomainState, control: Tensor) -> DomainState:
        """Per segment: the three jets' action, zero-mean and
        max-normalized, scales the base profile over the segment's z-slices;
        then the fluxes are rebalanced over the jet and outflow faces."""
        a = control.reshape(self._n_agents, self._n_jets)
        v = a - torch.mean(a, dim=1, keepdim=True)
        max_v = torch.max(torch.abs(v), dim=1, keepdim=True).values
        v = torch.where(max_v > 1.0, v / max_v, v)
        v = torch.repeat_interleave(v, self._nz_per_agent, dim=0)  # (nz, n_jets)
        mult = v @ self._jet_masks                                  # (nz, nx)
        base = self._top_base_profile                               # (3, nz, 1, nx)
        profile = torch.cat([base[:2] * mult[None, :, None, :], base[2:]], dim=0)
        b, f = self._airfoil_top_block_idx, 2  # "-y" face
        blk = state.blocks[b]
        faces = list(blk.faces)
        faces[f] = replace(faces[f], velocity=profile.to(faces[f].velocity.dtype))
        state = state.replace_block(b, replace(blk, faces=tuple(faces)))
        free = self._out_faces + ((b, f),)
        return balance_boundary_fluxes(state, self._geoms, self._topo, free)

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
        """Per-agent rewards: the lift-to-drag ratio of the agent's
        segment, mixed with the global reward by ``local_reward_weight``."""
        _, global_reward, info = self._pure_end(carry, records)
        all_cds = info.pop("all_cds")
        all_cls = info.pop("all_cls")
        seg = self.D / self._n_agents
        local_cd = all_cds.reshape(self._n_agents, -1).sum(dim=1) / seg
        local_cl = all_cls.reshape(self._n_agents, -1).sum(dim=1) / seg
        local_rewards = self._reward(local_cd, local_cl)
        agent_rewards = (self._local_reward_weight * local_rewards
                         + (1 - self._local_reward_weight) * global_reward)
        info["global_reward"] = global_reward
        return self._pure_local_obs(carry[0]), agent_rewards, info

    def _step_marl_impl(self, actions: Tensor):
        if self._local_reward_weight is None:
            raise ValueError("local_reward_weight must be set for multi-agent step.")
        return super()._step_marl_impl(actions)

    # ------------------------------------------------------------------
    # 2D warm start
    # ------------------------------------------------------------------
    def _get_domain(self):
        topo, geoms, state = super()._get_domain()
        if not self._init_from_2d:
            return topo, geoms, state
        try:
            state = self._apply_2d_initial_state(state)
        except FileNotFoundError:
            self._logger.warning(
                "2D initial domain not found on disk; starting the 3D flow "
                "from the uniform initial state instead.")
        return topo, geoms, state

    def _apply_2d_initial_state(self, state: DomainState) -> DomainState:
        """Broadcast a saved 2D initial domain's velocity over the span (no
        z component).  The snapshot's index is drawn from the env's numpy
        generator; the 3D ids at every Reynolds number use the 2D states of
        at most Re 3000.  The warm start stops at the first block whose
        shape does not match: that block and the ones after it keep the
        uniform state, the ones before it the 2D field (as in the JAX
        package)."""
        idx = int(self._np_rng.integers(0, 10)) if self._np_rng is not None else 0
        two_d_id = f"airfoil_2D_Re{int(min(self._reynolds_number, 3000))}"
        path = (data_utils.initial_domain_dir(two_d_id)
                / f"{EnvMode.TRAIN.value}_{idx:02d}")
        _, _, state_2d = load_domain(path, dtype=self._dtype, device=self._device)
        for b in range(len(state.blocks)):
            blk = state.blocks[b]
            u2 = state_2d.blocks[b].velocity  # (2, ny, nx)
            if tuple(u2.shape) != tuple(blk.velocity[:2, 0].shape):
                self._logger.warning(
                    "2D/3D shape mismatch for block %d; skipping 2D init.", b)
                return state
            u3 = torch.zeros_like(blk.velocity)
            u3[:2] = u2[:, None].to(u3.dtype)
            state = state.replace_block(b, replace(blk, velocity=u3))
        return state
