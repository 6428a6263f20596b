"""Rayleigh-Benard Convection (RBC) environment base class (counterpart of
``fluidgym_tpu/envs/rbc/rbc_env_base.py``).

* single orthogonal block, wall-refined y-grid, periodic x (and z);
* temperature as passive scalar channel 0 with Dirichlet hot/cold plates;
* Boussinesq buoyancy via a PRE_VELOCITY_SETUP hook that sets the velocity
  source to ``T * buoyancy_factor`` in y;
* nu = sqrt(Pr/Ra), kappa = 1/sqrt(Ra*Pr);
* solver preset: adaptive substeps, 2 correctors, pressure tol 1e-5, FD
  corrector, return-best, cold pressure starts;
* Nusselt number Nu = 1 + sqrt(Ra*Pr) <u_y T>_vol and reward nu_ref - Nu;
* domain randomization by symmetry ops (flip/translate/noise) plus a 1-2
  time unit burn-in.
"""

from __future__ import annotations

from abc import abstractmethod
from dataclasses import replace

import numpy as np
import torch

from fluidgym_tpu_torch.core import geometry as geo
from fluidgym_tpu_torch.core.domain import DomainBuilder, DomainState
from fluidgym_tpu_torch.envs.fluid_env import FluidEnv
from fluidgym_tpu_torch.envs.util.resample import make_rectilinear_plan
from fluidgym_tpu_torch.solver.piso import ADAPTIVE, Hooks, SimConfig

Tensor = torch.Tensor


class RBCEnvBase(FluidEnv):
    """Abstract base class for RBC environments."""

    _supports_marl = True

    _T_cold: float = 0.0
    _T_hot: float = 1.0
    _heater_limit: float = 0.75
    _n_sensors_y: int = 8
    _n_sensors_per_heater: int = 4
    _resolution_scale_y: float = 2.0
    _non_uniform_grid_base: float = 1.02
    _H: float = 1.0
    _buoyancy_factor: float = 1.0
    _metrics: list[str] = ["nusselt"]

    def __init__(
        self,
        rayleigh_number: float,
        prandtl_number: float,
        n_heaters: int,
        resolution: int,
        adaptive_cfl: float,
        dt: float,
        step_length: float,
        episode_length: int,
        local_obs_window: int,
        local_reward_weight: float | None,
        uniform_grid: bool,
        aspect_ratio: float,
        use_marl: bool,
        dtype=None,
        load_initial_domain: bool = True,
        load_domain_statistics: bool = True,
        randomize_initial_state: bool = True,
        enable_actions: bool = True,
        differentiable: bool = False,
        device=None,
    ):
        self._rayleigh_number = float(rayleigh_number)
        self._prandtl_number = float(prandtl_number)
        self._heater_width = int(resolution)
        self._n_heaters = int(n_heaters)
        self._local_reward_weight = local_reward_weight
        self._local_obs_window = int(local_obs_window)
        self._uniform_grid = bool(uniform_grid)

        self._aspect_ratio = float(aspect_ratio) * np.pi
        self._x = int(resolution * n_heaters)
        self._y = round(self._resolution_scale_y * self._x / self._aspect_ratio)
        self._L = self._H * self._aspect_ratio
        self._kinematic_viscosity = (prandtl_number / rayleigh_number) ** 0.5
        self._thermal_diffusivity = (rayleigh_number * prandtl_number) ** -0.5

        super().__init__(
            dt=dt,
            adaptive_cfl=adaptive_cfl,
            step_length=step_length,
            episode_length=episode_length,
            ndims=self._ndims,
            dtype=dtype,
            use_marl=use_marl,
            load_initial_domain=load_initial_domain,
            load_domain_statistics=load_domain_statistics,
            randomize_initial_state=randomize_initial_state,
            enable_actions=enable_actions,
            differentiable=differentiable,
            device=device,
        )
        self._sensor_locations = torch.as_tensor(
            self._get_sensor_locations(), dtype=torch.long, device=self._device)

    # ------------------------------------------------------------------
    # domain construction
    # ------------------------------------------------------------------
    def _make_vertex_grid(self) -> np.ndarray:
        grid = geo.make_wall_refined_ortho_grid(
            self._x,
            self._y,
            corner_lower=(0.0, -self._H / 2),
            corner_upper=(self._L, self._H / 2),
            wall_refinement=("-y", "+y"),
            base=1.0 if self._uniform_grid else self._non_uniform_grid_base,
        )
        if self._ndims == 3:
            grid = geo.extrude_grid_z(grid, res_z=self._x, start_z=0.0,
                                      end_z=self._L, weights_z=None, exp_base=1)
        return grid

    def _get_domain(self):
        if self._np_rng is None:
            raise RuntimeError("Environment must be seeded before domain creation.")
        grid = self._make_vertex_grid()
        dom = DomainBuilder(ndims=self._ndims, viscosity=self._kinematic_viscosity,
                            scalar_channels=1, name="RBCDomain", dtype=self._dtype,
                            device=self._device)
        dom.set_scalar_diffusivity(self._thermal_diffusivity)
        block = dom.create_block(grid, name="RBCBlock")

        # hot bottom / cold top plates; x (and z) periodic
        block.close_boundary("-y", scalar=self._T_hot)
        block.close_boundary("+y", scalar=self._T_cold)

        # linear conduction profile + perturbation (numpy draws, as in JAX)
        grad = np.linspace(self._T_hot, self._T_cold, self._y)
        if self._ndims == 2:
            T0 = np.broadcast_to(grad[:, None], (self._y, self._x))
        else:
            T0 = np.broadcast_to(grad[None, :, None], (self._x, self._y, self._x))
        T0 = T0 + self._np_rng.normal(0.0, 1.0, T0.shape) * 0.1 * (
            self._T_hot - self._T_cold)
        T0 = np.clip(T0, self._T_cold, self._T_hot)
        block.set_scalar(T0[None])
        u0 = self._np_rng.normal(0.0, 1.0, (self._ndims, *block.shape)) * 0.05
        block.set_velocity(u0)
        # the buoyancy hook rewrites the source every substep
        block.set_velocity_source(np.zeros((self._ndims, *block.shape)))
        return dom.build()

    def _get_prep_fn(self) -> Hooks:
        """Boussinesq buoyancy hook."""
        buoyancy = self._buoyancy_factor
        ndims = self._ndims

        def buoyancy_fn(state: DomainState, **kw) -> DomainState:
            blk = state.blocks[0]
            T = blk.scalar[0]
            zero = torch.zeros_like(T)
            comps = [zero, T * buoyancy] + ([zero] if ndims == 3 else [])
            src = torch.stack(comps, dim=0)
            return state.replace_block(0, replace(blk, velocity_source=src))

        return {"PRE_VELOCITY_SETUP": (buoyancy_fn,)}

    def _get_simulation(self) -> SimConfig:
        """Solver preset (cold pressure starts, as in the JAX package)."""
        return SimConfig(
            dt=self._dt,
            substeps=ADAPTIVE,
            adaptive_cfl=self._adaptive_cfl,
            corrector_steps=2,
            pressure_tol=1e-5,
            pressure_return_best_result=True,
            velocity_corrector="FD",
            non_orthogonal=False,
            differentiable=self._differentiable,
        )

    def _additional_initialization(self) -> None:
        self._resample_plan = make_rectilinear_plan(
            self._make_vertex_grid(), self.render_shape[: self._ndims])

    # ------------------------------------------------------------------
    # randomization
    # ------------------------------------------------------------------
    def _randomize_domain(self) -> None:
        blk = self._state.blocks[0]
        T = blk.scalar
        u = blk.velocity
        rng = self._np_rng
        if rng.uniform() > 0.5:  # flip x
            T = torch.flip(T, dims=(-1,))
            u = torch.flip(u, dims=(-1,))
            u = torch.cat([-u[:1], u[1:]], dim=0)
        if self._ndims == 3 and rng.uniform() > 0.5:  # flip z
            T = torch.flip(T, dims=(-3,))
            u = torch.flip(u, dims=(-3,))
            u = torch.cat([u[:2], -u[2:]], dim=0)
        x_shift = int(rng.integers(0, self._x))
        T = torch.roll(T, x_shift, dims=-1)
        u = torch.roll(u, x_shift, dims=-1)
        if self._ndims == 3:
            z_shift = int(rng.integers(0, self._x))
            T = torch.roll(T, z_shift, dims=-3)
            u = torch.roll(u, z_shift, dims=-3)
        T = T + torch.as_tensor(rng.normal(0.0, 1.0, tuple(T.shape)) * 0.05,
                                device=T.device).to(T.dtype)
        T = torch.clamp(T, self._T_cold, self._T_hot)
        u = u + torch.as_tensor(rng.normal(0.0, 1.0, tuple(u.shape)) * 0.05,
                                device=u.device).to(u.dtype)
        self._state = self._state.replace_block(0, replace(blk, scalar=T, velocity=u))
        sim_time = rng.uniform(1.0, 2.0)
        for _ in range(int(sim_time / self._dt)):
            self._run_single_step()

    # ------------------------------------------------------------------
    # field access / metrics
    # ------------------------------------------------------------------
    @property
    def render_shape(self) -> tuple[int, ...]:
        nx = self._n_heaters * 20
        height = round(nx / self._aspect_ratio)
        return (nx, height, nx)

    @property
    def nu_ref(self) -> float:
        """Reference Nusselt number for reward normalization."""
        if "nusselt" in self._metrics_stats:
            s = self._metrics_stats["nusselt"]
            return s.p50 if self._ndims == 2 else s.mean
        return 0.0

    @property
    def n_agents(self) -> int:
        if self._use_marl:
            return self._n_heaters if self._ndims == 2 else self._n_heaters**2
        return 1

    @property
    def _n_sensors_x(self) -> int:
        return self._n_heaters * self._n_sensors_per_heater

    @abstractmethod
    def _get_sensor_locations(self) -> np.ndarray: ...

    @abstractmethod
    def _pure_apply_action(self, state: DomainState, action: Tensor) -> DomainState: ...

    @abstractmethod
    def _pure_global_obs(self, state: DomainState) -> dict[str, Tensor]: ...

    @abstractmethod
    def _pure_local_obs(self, state: DomainState) -> dict[str, Tensor]: ...

    @abstractmethod
    def _pure_local_rewards(self, state: DomainState) -> Tensor: ...

    def _apply_action(self, action: Tensor) -> None:
        self._state = self._pure_apply_action(self._state, action.to(self._dtype))

    def _get_global_obs(self) -> dict[str, Tensor]:
        return self._pure_global_obs(self._state)

    def _get_local_obs(self) -> dict[str, Tensor]:
        return self._pure_local_obs(self._state)

    def _get_sensor_locations_2d(self) -> np.ndarray:
        """Sensor pixel grid on the render image."""
        nx, ny = self.render_shape[:-1]
        sx = np.linspace(0, nx, self._n_sensors_x + 1)[:-1] + nx / (2 * self._n_sensors_x)
        sy = np.linspace(0, ny, self._n_sensors_y + 1)[:-1] + ny / (2 * self._n_sensors_y)
        gx, gy = np.meshgrid(sx, sy, indexing="ij")
        return np.stack([gx, gy], axis=-1).reshape(-1, 2).T.round().astype(np.int32)

    def get_temperature(self) -> Tensor:
        return self._resample_plan(self._state.blocks[0].scalar[0])

    def get_velocity(self) -> Tensor:
        return self._resample_plan(self._state.blocks[0].velocity)

    def get_pressure(self) -> Tensor:
        return self._resample_plan(self._state.blocks[0].pressure)

    def _pure_nusselt(self, state: DomainState) -> Tensor:
        blk = state.blocks[0]
        return self._compute_nusselt(T=blk.scalar[0][None],
                                     u_y=blk.velocity[1][None],
                                     cell_size=self._geoms[0].det)

    def _compute_nusselt(self, T: Tensor, u_y: Tensor, cell_size: Tensor) -> Tensor:
        """Nu = 1 + sqrt(Ra Pr) <u_y T>_vol."""
        is_batched = T.dim() == self._ndims + 1
        dims = tuple(range(1, self._ndims + 1)) if is_batched else tuple(range(self._ndims))
        if is_batched:
            cell_size = cell_size[None]
        mean_uyT = (torch.sum(u_y * T * cell_size, dim=dims)
                    / torch.sum(cell_size, dim=dims))
        coef = torch.sqrt(torch.tensor(self._rayleigh_number * self._prandtl_number,
                                       dtype=T.dtype, device=T.device))
        return 1.0 + coef * mean_uyT

    def compute_global_nusselt(self) -> Tensor:
        return self._pure_nusselt(self._state)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _pure_begin(self, carry: tuple, action: Tensor) -> tuple:
        """Set the heater profile from the action (once per env step)."""
        if not self._enable_actions:
            return carry
        return (self._pure_apply_action(carry[0], action),)

    def _pure_end(self, carry: tuple, records: list):
        """Nusselt number, observations and reward after the sim steps."""
        state = carry[0]
        nu = self._pure_nusselt(state)
        return (self._pure_global_obs(state), self.nu_ref - nu,
                {"nusselt": nu[0]})

    def _pure_end_marl(self, carry: tuple, records: list):
        _, global_reward, info = self._pure_end(carry, records)
        state = carry[0]
        if self._local_reward_weight > 0:
            local_rewards = self._pure_local_rewards(state)
        else:
            local_rewards = torch.zeros((self.n_agents,), dtype=self._dtype,
                                        device=self._device)
        agent_rewards = (self._local_reward_weight * local_rewards
                         + (1 - self._local_reward_weight) * global_reward)
        return (self._pure_local_obs(state), agent_rewards,
                dict(info, global_reward=global_reward))

    def _step_marl_impl(self, actions: Tensor):
        if self._local_reward_weight is None:
            raise ValueError("local_reward_weight must be set for multi-agent step.")
        return super()._step_marl_impl(actions)

    # ------------------------------------------------------------------
    # identifiers
    # ------------------------------------------------------------------
    @property
    def id(self) -> str:
        return (f"RBC{self._ndims}d_Ra{self._rayleigh_number}_Pr{self._prandtl_number}"
                f"_NH{self._n_heaters}_HW{self._heater_width}")

    @property
    def initial_domain_id(self) -> str:
        return (f"rbc_{self._ndims}d_Ra{self._rayleigh_number}_Pr{self._prandtl_number}"
                f"_NH{self._n_heaters}_HW{self._heater_width}")

    # ------------------------------------------------------------------
    # action smoothing
    # ------------------------------------------------------------------
    def _smooth_action_profile_1d(self, T_action: Tensor) -> Tensor:
        """Cubic blending across heater edges along the last axis: a
        per-heater value array ``(..., n_heaters)`` expanded to ``(..., x)``."""
        hw = self._heater_width
        bw = round(hw * 0.1)

        def cubic(t, A, B):
            s = t * t * (3 - 2 * t)
            return (1 - s) * A + s * B

        dev = T_action.device
        T_left = torch.roll(T_action, 1, dims=-1)
        T_right = torch.roll(T_action, -1, dims=-1)
        x_idx = torch.arange(self._x, device=dev)
        seg = x_idx // hw
        pos = x_idx % hw
        T0 = torch.index_select(T_left, -1, seg)
        T1 = torch.index_select(T_action, -1, seg)
        T2 = torch.index_select(T_right, -1, seg)
        if bw == 0:
            return T1
        left = pos < bw
        right = pos >= hw - bw
        tL = torch.clamp(pos.to(T_action.dtype) / bw + 0.5, 0.0, 1.0)
        tR = 1 - torch.roll(tL, hw - bw + 1)
        TL = cubic(tL, T0, T1)
        TR = cubic(tR, T1, T2)
        return torch.where(left, TL, torch.where(right, TR, T1))

    @staticmethod
    def _with_bottom_plate_scalar(state: DomainState, control: Tensor) -> DomainState:
        """A state with the heater temperature profile written into the -y
        face data."""
        blk = state.blocks[0]
        faces = list(blk.faces)
        f = 2  # "-y"
        fd = faces[f]
        faces[f] = replace(
            fd, scalar=torch.reshape(control, fd.scalar.shape).to(fd.scalar.dtype))
        return state.replace_block(0, replace(blk, faces=tuple(faces)))
