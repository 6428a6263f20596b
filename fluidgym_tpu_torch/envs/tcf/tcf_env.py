"""Turbulent channel flow (TCF) environments (counterpart of
``fluidgym_tpu/envs/tcf/tcf_env.py``):

* a 3D channel at Re_tau in {180, 330, 550}; viscosity = delta / Re_cl with
  Re_cl from the empirical wall relation;
* dynamic bulk forcing from the measured mean wall stress, plus optional
  Smagorinsky LES with Van Driest damping (``C_smag``, 0 for every
  registered id);
* the Reichardt profile plus divergence-free curl noise as the generated
  state;
* actions: per-(x, z)-tile blowing and suction at the bottom (or both)
  wall(s), scaled to zero net mass flux and |u_wall|;
* observations: the fluctuating velocity (u, v) and the pressure on the
  y+ = 15 plane; MARL local obs are windows of per-agent means shifted
  upstream;
* reward ``1 - tau_bottom / tau_ref`` from the wall stress of every sim
  step of the env step;
* ``TCF3DBothEnv`` actuates and observes both walls, with mirrored
  top-wall frames.

Frames show |u| on the mid z-plane of the channel grid (``viridis``); with
``render_3d`` also an iso-surface of the Q-criterion.
"""

from __future__ import annotations

import csv
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.core.domain import DomainState
from fluidgym_tpu_torch.envs.fluid_env import FluidEnv
from fluidgym_tpu_torch.envs.tcf import tools as TCF_tools
from fluidgym_tpu_torch.envs.tcf.grid import (channel_grid, channel_info,
                                              make_channel_flow_domain,
                                              make_dynamic_forcing_hook,
                                              van_driest_sqr_from_centers)
from fluidgym_tpu_torch.envs.util.obs_extraction import extract_moving_window_2d_x_z
from fluidgym_tpu_torch.solver import piso
from fluidgym_tpu_torch.solver.piso import ADAPTIVE, Hooks, SimConfig
from fluidgym_tpu_torch.solver.sgs import make_smagorinsky_hook, velocity_gradients
from fluidgym_tpu_torch.types import EnvMode
from fluidgym_tpu_torch.utils import data_utils

Tensor = torch.Tensor

SMALL_TCF_3D_DEFAULT_CONFIG = {
    "resolution_y": 65,
    "resolution_x_z": 64,
    "actor_size": 2,
    "L": np.pi,
    "D": np.pi / 2,
    "reynolds_number_wall": 180,
    "adaptive_cfl": 0.1,
    "step_length": 0.6,
    "episode_length": 1000,
    "local_obs_window": 1,
    "local_reward_weight": 0.0,
    "use_marl": True,
    "C_smag": 0.0,
    "use_van_driest": False,
    "init_with_noise": True,
    "load_initial_domain": True,
    "load_domain_statistics": True,
    "randomize_initial_state": True,
    "enable_actions": True,
    "differentiable": False,
}

LARGE_TCF_3D_DEFAULT_CONFIG = {
    **SMALL_TCF_3D_DEFAULT_CONFIG,
    "resolution_x_z": 128,
    "L": 2 * np.pi,
    "D": np.pi,
}


class TCF3DBottomEnv(FluidEnv):
    """Turbulent channel flow with bottom-wall blowing and suction."""

    _actuation: str = "bottom"
    _default_render_key: str = "x-y-velocity"
    _supports_marl = True
    _scale_actions: bool = True
    _delta: float = 1.0
    _H: float = 2.0
    _y_obs_wall: float = 15.0
    _metrics: list[str] = ["wall_stress", "wall_stress_bottom", "wall_stress_top"]

    def __init__(
        self,
        resolution_y: int,
        resolution_x_z: int,
        L: float,
        D: float,
        actor_size: int,
        reynolds_number_wall: float,
        adaptive_cfl: float,
        step_length: float,
        episode_length: int,
        local_obs_window: int,
        local_reward_weight: float,
        use_marl: bool,
        C_smag: float = 0.0,
        use_van_driest: bool = False,
        init_with_noise: bool = True,
        dtype=None,
        debug: bool = False,
        load_initial_domain: bool = True,
        load_domain_statistics: bool = True,
        randomize_initial_state: bool = True,
        enable_actions: bool = True,
        differentiable: bool = False,
        device=None,
    ):
        self._L = float(L)
        self._D = float(D)
        self._re_wall = float(reynolds_number_wall)
        self._re_center = TCF_tools.Re_wall_to_cl(self._re_wall)
        self._viscosity = self._delta / self._re_center
        self._u_wall = self._re_wall / self._re_center
        self._x = int(resolution_x_z)
        self._y = int(resolution_y)
        self._z = int(resolution_x_z)
        self._grid_refinement_strength = 2 if resolution_x_z < 64 else 1
        self._C_smag = float(C_smag)
        self._use_van_driest = bool(use_van_driest)
        self._init_with_noise = bool(init_with_noise)
        self._actor_size = int(actor_size)
        self._local_obs_window = int(local_obs_window)
        self._local_reward_weight = float(local_reward_weight)
        self._channel_info: dict | None = None

        # the step length is given in wall units
        step_length = step_length * TCF_tools.t_star(self._viscosity, self._u_wall)
        dt = step_length / 10

        super().__init__(
            dt=dt,
            adaptive_cfl=adaptive_cfl,
            step_length=step_length,
            episode_length=episode_length,
            ndims=3,
            use_marl=use_marl,
            dtype=dtype,
            load_initial_domain=load_initial_domain,
            load_domain_statistics=load_domain_statistics,
            randomize_initial_state=randomize_initial_state,
            enable_actions=enable_actions,
            differentiable=differentiable,
            device=device,
        )

    # ------------------------------------------------------------------
    # domain
    # ------------------------------------------------------------------
    def _channel_kw(self) -> dict:
        return dict(H=self._H, L=self._L, D=self._D, x=self._x, y=self._y,
                    z=self._z, refinement_strength=self._grid_refinement_strength,
                    n_dims=self._ndims)

    def _get_domain(self):
        if self._np_rng is None:
            raise RuntimeError("Environment must be seeded before domain creation.")
        dom, self._channel_info = make_channel_flow_domain(
            **self._channel_kw(), u_wall=self._u_wall, viscosity=self._viscosity,
            init_with_noise=self._init_with_noise, rng=self._np_rng,
            dtype=self._dtype, device=self._device)
        return dom.build()

    def _ensure_channel_info(self) -> None:
        """The static channel geometry info where the state came from disk
        (``_get_domain`` never ran); ``_get_prep_fn`` needs it, and the base
        reset calls it before ``_additional_initialization``."""
        if self._channel_info is None:
            self._channel_info = channel_info(**self._channel_kw())

    @property
    def render_shape(self) -> tuple[int, ...]:
        xr = 2 * self._x
        return (xr, int(xr / self._L * self._H), int(xr / self._L * self._D))

    @property
    def _blocks_vertex_coords(self):
        return [channel_grid(**self._channel_kw())]

    def _get_y_obs_idx(self, y_wall: float) -> int:
        """The cell row nearest to the wall distance ``y_wall`` (wall units)
        from the bottom wall."""
        y_obs = -self._delta + y_wall * self._viscosity / self._u_wall
        return int(np.argmin(np.abs(self._channel_info["y_centers"] - y_obs)))

    @property
    def _n_actors_x(self) -> int:
        return self._x // self._actor_size

    @property
    def _n_actors_z(self) -> int:
        return self._z // self._actor_size

    @property
    def n_agents(self) -> int:
        return self._n_actors_x * self._n_actors_z

    def _get_action_space(self) -> spaces.Box:
        shape = (1,) if self.use_marl else (self.n_agents, 1)
        return spaces.Box(low=-1.0, high=1.0, shape=shape, dtype=np.float32)

    def _get_observation_space(self) -> spaces.Dict:
        if self._use_marl:
            w = self._local_obs_window
            vel_shape, p_shape = (w, w, 2), (w, w)
        else:
            vel_shape, p_shape = (2, self._z, self._x), (self._z, self._x)
        return spaces.Dict({
            "velocity": spaces.Box(-np.inf, np.inf, vel_shape, np.float32),
            "pressure": spaces.Box(-np.inf, np.inf, p_shape, np.float32),
        })

    def _get_prep_fn(self) -> Hooks:
        self._ensure_channel_info()
        hooks = [make_dynamic_forcing_hook(self._geoms, self._topo,
                                           self._channel_info["d_y"])]
        if self._C_smag != 0:
            vd = None
            if self._use_van_driest:
                vd1d = van_driest_sqr_from_centers(
                    self._channel_info["y_centers"], self._u_wall,
                    self._viscosity)
                vd = (torch.as_tensor(
                    np.broadcast_to(vd1d[None, :, None],
                                    self._topo.blocks[0].shape).copy(),
                    device=self._device).to(self._dtype),)
            hooks.append(make_smagorinsky_hook(self._geoms, self._topo,
                                               self._C_smag, vd))
        return {"PRE": tuple(hooks)}

    def _get_simulation(self) -> SimConfig:
        """Solver preset, cold pressure starts (as the JAX package)."""
        return SimConfig(
            dt=self._dt,
            substeps=ADAPTIVE,
            adaptive_cfl=self._adaptive_cfl,
            corrector_steps=2,
            advection_tol=1e-6,
            pressure_tol=1e-6,
            pressure_return_best_result=True,
            velocity_corrector="FD",
            non_orthogonal=False,  # the rectilinear channel grid
            differentiable=self._differentiable,
        )

    def _additional_initialization(self) -> None:
        self._ensure_channel_info()
        self._y_obs_bottom_idx = self._get_y_obs_idx(self._y_obs_wall)
        if self._C_smag != 0 and self._state.blocks[0].viscosity is None:
            # the SGS hook rewrites it every substep; set it so that the
            # state has the same fields in every substep
            blk = self._state.blocks[0]
            self._state = self._state.replace_block(0, replace(
                blk, viscosity=torch.full(self._topo.blocks[0].shape,
                                          self._viscosity, dtype=self._dtype,
                                          device=self._device)))
        self._state = piso.make_divergence_free(self._state, self._geoms,
                                                self._topo, self._cfg)

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------
    def _action_to_control(self, action: Tensor) -> Tensor:
        """``(n_actors_x, n_actors_z)`` action grid -> the wall's velocity
        slab ``(3, z, 1, x)`` (blowing and suction in y)."""
        a = action
        if self._scale_actions:
            a = a - torch.mean(a)
            a = self._u_wall * a / torch.clamp(torch.abs(a), min=1.0)
            a = a - torch.mean(a)
        v = a.repeat_interleave(self._actor_size, dim=0).repeat_interleave(
            self._actor_size, dim=1)  # (x, z)
        zero = torch.zeros((self._z, 1, self._x), dtype=self._dtype,
                           device=a.device)
        return torch.stack([zero, v.T[:, None, :].to(self._dtype), zero])

    def _with_wall_velocity(self, state: DomainState, face: int,
                            control: Tensor) -> DomainState:
        blk = state.blocks[0]
        faces = list(blk.faces)
        faces[face] = replace(faces[face],
                              velocity=control.to(faces[face].velocity.dtype))
        return state.replace_block(0, replace(blk, faces=tuple(faces)))

    def _pure_apply_action(self, state: DomainState, action: Tensor) -> DomainState:
        a = torch.reshape(action, (self._n_actors_x, self._n_actors_z))
        return self._with_wall_velocity(state, 2, self._action_to_control(a))

    def _apply_action(self, action: Tensor) -> None:
        self._state = self._pure_apply_action(self._state, action.to(self._dtype))

    # ------------------------------------------------------------------
    # metrics and observations
    # ------------------------------------------------------------------
    @property
    def tau_ref(self) -> float:
        if "wall_stress_bottom" in self._metrics_stats:
            return self._metrics_stats["wall_stress_bottom"].mean
        return 1.0

    def _pure_wall_stress(self, state: DomainState):
        blk = state.blocks[0]
        nu = state.viscosity
        d_y = self._channel_info["d_y"]
        mean_u = torch.mean(blk.velocity[0], dim=(0, 2))
        return nu * mean_u[0] / d_y[0], nu * mean_u[-1] / d_y[1]

    def _episode_physics_violations(self, rows: list[dict]) -> list[str]:
        """Relaminarization screen: a channel episode whose mean bottom wall
        stress is below 55% of the nominal u_tau^2 is not turbulent channel
        flow (the turbulent band of the 64^3 box is 0.6-0.9x nominal,
        relaminarized states 0.35-0.47x)."""
        out = []
        tb = np.asarray([float(r["wall_stress_bottom"]) for r in rows
                         if "wall_stress_bottom" in r])
        if tb.size:
            ratio = float(tb.mean()) / float(self._u_wall) ** 2
            if ratio < 0.55:
                out.append(
                    f"wall stress {ratio:.2f}x nominal u_tau^2 — "
                    f"relaminarized (turbulent band is 0.6-0.9x at 64^3)")
        return out

    def snapshot_turbulence_ratio(self, state: DomainState | None = None) -> float:
        """``v'_rms / u_tau`` of (by default) the current state: healthy
        developed channels measure 0.3-0.65, decayed ones < 0.01."""
        blk = (state or self._state).blocks[0]
        return float(torch.std(blk.velocity[1], correction=0)) / float(self._u_wall)

    def _pure_global_obs(self, state: DomainState, y_idx: int | None = None):
        if y_idx is None:
            y_idx = self._y_obs_bottom_idx
        blk = state.blocks[0]
        u = blk.velocity
        cell = self._geoms[0].det
        mean_u = (torch.sum(u * cell[None], dim=(1, 2, 3), keepdim=True)
                  / torch.sum(cell))
        u_prime = u - mean_u
        return {"velocity": u_prime[:2, :, y_idx, :],
                "pressure": blk.pressure[:, y_idx, :]}

    def _get_global_obs(self):
        return self._pure_global_obs(self._state)

    def _pure_local_obs(self, state: DomainState, y_idx: int | None = None,
                        flip_obs: bool = False):
        """Per-agent mean windows on the y+ = 15 plane."""
        if y_idx is None:
            y_idx = self._y_obs_bottom_idx
        blk = state.blocks[0]
        u_slice = blk.velocity[:2, :, y_idx, :]
        p_slice = blk.pressure[:, y_idx, :]
        u_prime = u_slice - u_slice.mean(dim=(1, 2), keepdim=True)
        w = self._local_obs_window

        def win(field, pad_x):
            return extract_moving_window_2d_x_z(
                field, self._n_actors_x, self._n_actors_z, self._actor_size,
                w, w, pad_x=pad_x, pad_z=w // 2)

        lo_ux = win(u_prime[0], pad_x=w - 1)
        lo_uy = win(u_prime[1], pad_x=w)
        lo_p = win(p_slice, pad_x=w)
        if flip_obs:
            lo_ux = torch.flip(lo_ux, dims=(2,))
            lo_uy = -torch.flip(lo_uy, dims=(2,))
            lo_p = torch.flip(lo_p, dims=(1,))
        return {"velocity": torch.stack([lo_ux, lo_uy], dim=-1), "pressure": lo_p}

    def _get_local_obs(self):
        return self._pure_local_obs(self._state)

    # ------------------------------------------------------------------
    # stepping: the action once per env step, the wall stress of every sim
    # step averaged over the env step
    # ------------------------------------------------------------------
    def _pure_reward(self, tau_total, tau_bottom):
        return 1.0 - tau_bottom / self.tau_ref

    def _pure_begin(self, carry: tuple, action: Tensor) -> tuple:
        if not self._enable_actions:
            return carry
        return (self._pure_apply_action(carry[0], torch.reshape(action, (-1,))),)

    def _pure_record(self, carry: tuple) -> tuple:
        return self._pure_wall_stress(carry[0])

    def _pure_end(self, carry: tuple, records: list):
        state = carry[0]
        tau_bottom = torch.mean(torch.stack([r[0] for r in records]))
        tau_top = torch.mean(torch.stack([r[1] for r in records]))
        tau_total = 0.5 * (tau_bottom + tau_top)
        info = {"wall_stress": tau_total, "wall_stress_bottom": tau_bottom,
                "wall_stress_top": tau_top}
        return (self._pure_global_obs(state),
                self._pure_reward(tau_total, tau_bottom), info)

    def _pure_end_marl(self, carry: tuple, records: list):
        _, global_reward, info = self._pure_end(carry, records)
        agent_rewards = global_reward * torch.ones(
            (self.n_agents,), dtype=self._dtype, device=global_reward.device)
        return (self._pure_local_obs(carry[0]), agent_rewards,
                dict(info, global_reward=global_reward))

    # ------------------------------------------------------------------
    def _randomize_domain(self) -> None:
        """Noise on velocity and pressure, then a few uncontrolled sim
        steps (the JAX package's numpy draws, in its order)."""
        max_n = int(0.01 * self._episode_length)
        n_steps = int(self._np_rng.integers(max(1, int(0.5 * max_n)),
                                            max(2, max_n))) + 1
        blk = self._state.blocks[0]
        noise = lambda t: torch.as_tensor(
            self._np_rng.normal(0, 1, tuple(t.shape)) * 0.01,
            device=t.device).to(self._dtype)
        u = blk.velocity + noise(blk.velocity)
        p = blk.pressure + noise(blk.pressure)
        self._state = self._state.replace_block(
            0, replace(blk, velocity=u, pressure=p))
        for _ in range(n_steps):
            self._run_single_step()

    def get_q_criterion(self) -> Tensor:
        """Q-criterion ``0.5 (|Omega|^2 - |S|^2)`` on the channel grid
        (Jeong & Hussain 1995)."""
        G = velocity_gradients(self._state, self._geoms, self._topo)[0]
        Gt = G.transpose(0, 1)
        S = 0.5 * (G + Gt)
        O = 0.5 * (G - Gt)
        return 0.5 * (torch.sum(O**2, dim=(0, 1)) - torch.sum(S**2, dim=(0, 1)))

    def render_fields(self) -> dict[str, Tensor]:
        """|u| on the channel grid."""
        return {"velocity_magnitude":
                torch.linalg.vector_norm(self._state.blocks[0].velocity, dim=0)}

    def _get_render_data(self, render_3d: bool, output_path=None):
        u_mag = self._render_fields_np()["velocity_magnitude"]
        data = {"x-y-velocity": self._format_render_data(
            u_mag[u_mag.shape[0] // 2], cmap="viridis")}
        if render_3d:
            from fluidgym_tpu_torch.envs.util.visualization import render_3d_iso

            q = self.get_q_criterion().detach().cpu().numpy().transpose(2, 1, 0)
            umag = u_mag.transpose(2, 1, 0)
            out = None
            if output_path is not None:
                out = output_path / f"q_criterion_{self._n_episodes}_{self._n_steps}.png"
            data["3d_q_criterion"] = render_3d_iso(
                iso_field=q, iso=[float(np.percentile(np.abs(q), 98)) or 1.0],
                color_field=umag, color_range=(0.0, float(umag.max()) or 1.0),
                output_path=out,
                extent=((0.0, self._L), (-1.0, 1.0), (0.0, self._D)),
                view_kwargs={"elev": 20, "azim": 45})
        return data

    # ------------------------------------------------------------------
    # opposition-control episodes (Choi et al. 1994), archived beside the
    # initial-domain dataset so that learned policies can be compared with
    # the classical baseline per snapshot
    # ------------------------------------------------------------------
    def _opposition_episode_path(self, mode: EnvMode, idx: int,
                                 write: bool = False) -> Path:
        root = data_utils.initial_domain_dir(self.initial_domain_id,
                                             user_only=write)
        return root / (f"{mode.value}_{idx:02d}_opposition_control_"
                       f"{self._actuation}_episode.csv")

    def save_opposition_control_episode(self, idx: int, mode: EnvMode,
                                        rows) -> None:
        """Archive the per-step metrics of an opposition-control episode;
        ``rows``: a pandas DataFrame or a list of per-step dicts."""
        path = self._opposition_episode_path(mode, idx, write=True)
        path.parent.mkdir(parents=True, exist_ok=True)
        if hasattr(rows, "to_csv"):  # DataFrame
            rows.to_csv(path, index=False)
            return
        rows = list(rows)
        if not rows:
            return
        with open(path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)

    def load_opposition_control_episode(self, idx: int, mode: EnvMode):
        """An archived opposition-control episode as a pandas DataFrame."""
        import pandas as pd

        path = self._opposition_episode_path(mode, idx)
        if not path.exists():
            raise FileNotFoundError(f"no opposition-control episode at {path}")
        return pd.read_csv(path)

    @property
    def initial_domain_id(self) -> str:
        return (f"channel_flow3D_L{self._L:.2f}_Re{int(self._re_wall)}"
                f"_Res{self._x}_Ref{self._grid_refinement_strength}")

    @property
    def id(self) -> str:
        return f"ChannelFlow3D_Re{int(self._re_wall)}_L{self._L:.2f}"


class TCF3DBothEnv(TCF3DBottomEnv):
    """Channel flow with blowing and suction at BOTH walls; the top-wall
    agents see mirrored observations."""

    _actuation = "both"

    @property
    def n_agents(self) -> int:
        return 2 * self._n_actors_x * self._n_actors_z

    @property
    def tau_ref(self) -> float:
        if "wall_stress" in self._metrics_stats:
            return self._metrics_stats["wall_stress"].mean
        return 1.0

    def _additional_initialization(self) -> None:
        super()._additional_initialization()
        self._y_obs_top_idx = (self._topo.blocks[0].shape[-2] - 1
                               - self._y_obs_bottom_idx)

    def _pure_reward(self, tau_total, tau_bottom):
        return 1.0 - tau_total / self.tau_ref

    def _pure_apply_action(self, state: DomainState, action: Tensor) -> DomainState:
        half = self._n_actors_x * self._n_actors_z
        shape = (self._n_actors_x, self._n_actors_z)
        bottom = self._action_to_control(torch.reshape(action[:half], shape))
        top = -1.0 * self._action_to_control(torch.reshape(action[half:], shape))
        state = self._with_wall_velocity(state, 2, bottom)
        return self._with_wall_velocity(state, 3, top)

    def _pure_local_obs(self, state: DomainState, y_idx=None, flip_obs=False):
        if y_idx is not None:
            return super()._pure_local_obs(state, y_idx, flip_obs)
        bottom = super()._pure_local_obs(state, self._y_obs_bottom_idx, False)
        top = super()._pure_local_obs(state, self._y_obs_top_idx, True)
        return {k: torch.cat([bottom[k], top[k]], dim=0) for k in bottom}
