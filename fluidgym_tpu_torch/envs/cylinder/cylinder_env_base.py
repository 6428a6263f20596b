"""Base class of the cylinder flow environments, von Karman vortex street
(counterpart of ``fluidgym_tpu/envs/cylinder/cylinder_env_base.py``).

* 5-block curvilinear O-grid + wake block (``grid.py``), in 3D extruded
  along a periodic z of extent ``D``;
* parabolic inflow, convective outflow on the wake's +x face by a PRE hook
  (outflow advection + flux balancing, ``solver/boundaries.py``);
* solver preset: adaptive substeps, non-orthogonal corrections, pressure
  tol 1e-5 (2D) / 5e-7 (3D), FD corrector, pressure warm start with deflation,
  an upwind blend of 0.3 in the velocity advection matrix at Re >= 500,
  ``make_divergence_free`` at initialization;
* 151 wake/ring sensors gathered directly from the blocks (at mid z in
  3D);
* drag/lift from wall-stress integration around the cylinder (per
  z-slice in 3D);
* reward ``cd_ref - cd - lift_penalty*|cl|`` with action smoothing
  ``c <- c + alpha*(a - c)`` per sim step;
* domain randomization: field noise (numpy draws per block, velocity then
  pressure) + a random number of uncontrolled steps.

The uniform render grid's resample plan is built on the first
``get_velocity`` / ``get_pressure`` / ``get_vorticity`` call, not at every
reset (at 3D widths it is millions of targets and only rendering reads it).
Frames show the z-vorticity (the mid z-slice in 3D) in ``coolwarm`` over
``VORTICITY_RENDER_RANGE``.
"""

from __future__ import annotations

from abc import abstractmethod
from dataclasses import replace

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.core.domain import DomainState
from fluidgym_tpu_torch.envs.cylinder.grid import make_vortex_street_domain
from fluidgym_tpu_torch.envs.fluid_env import FluidEnv
from fluidgym_tpu_torch.envs.util.multiblock_resample import (
    make_multiblock_plan,
    make_multiblock_point_plan,
)
from fluidgym_tpu_torch.envs.util.smoothed_control import SmoothedControlMixin
from fluidgym_tpu_torch.envs.util.wall_forces import WallForcesMixin
from fluidgym_tpu_torch.solver import piso
from fluidgym_tpu_torch.solver.boundaries import make_convective_outflow_hook
from fluidgym_tpu_torch.solver.piso import ADAPTIVE, Hooks, SimConfig

Tensor = torch.Tensor


#: colour range of the rendered vorticity
VORTICITY_RENDER_RANGE = (-10, 10)


class CylinderEnvBase(SmoothedControlMixin, WallForcesMixin, FluidEnv):
    """Base class of the cylinder flow environments."""

    _default_render_key: str = "vorticity"

    H: float = 4.1
    L: float = 22.0
    D: float = 4.0  # z extent in 3D
    cylinder_diameter: float = 1.0
    _U_mean: float = 1.0
    cylinder_offset_y: float = 0.05
    _n_sensors_x_y: int = 151
    _vortex_street_refinement_base: float = 0.95
    _metrics: list[str] = ["drag", "lift"]

    def __init__(
        self,
        reynolds_number: float,
        resolution: int,
        dt: float,
        adaptive_cfl: float,
        step_length: float,
        episode_length: int,
        ndims: int,
        lift_penalty: float,
        use_marl: bool,
        dtype=None,
        load_initial_domain: bool = True,
        load_domain_statistics: bool = True,
        randomize_initial_state: bool = True,
        enable_actions: bool = True,
        differentiable: bool = False,
        device=None,
    ):
        self._reynolds_number = float(reynolds_number)
        self._circle_resolution_angular = int(resolution)
        self._lift_penalty = float(lift_penalty)
        self._ndims = ndims
        self._viscosity = self._U_mean / self._reynolds_number

        super().__init__(
            dt=dt,
            adaptive_cfl=adaptive_cfl,
            step_length=step_length,
            episode_length=episode_length,
            ndims=ndims,
            use_marl=use_marl,
            dtype=dtype,
            load_initial_domain=load_initial_domain,
            load_domain_statistics=load_domain_statistics,
            randomize_initial_state=randomize_initial_state,
            enable_actions=enable_actions,
            differentiable=differentiable,
            device=device,
        )
        (self._left_block_idx, self._top_block_idx, self._right_block_idx,
         self._bottom_block_idx, self._vortex_street_block_idx) = range(5)
        self._last_control = torch.zeros(self._control_shape, dtype=self._dtype,
                                         device=self._device)
        self._sensor_locations = self._get_sensor_locations()
        self._cylinder_mask = self._get_cylinder_mask()

    # ------------------------------------------------------------------
    # spaces
    # ------------------------------------------------------------------
    def _get_action_space(self) -> spaces.Box:
        return spaces.Box(low=-1.0, high=1.0, shape=(1,), dtype=np.float32)

    def _get_observation_space(self) -> spaces.Dict:
        return spaces.Dict({
            "velocity": spaces.Box(low=-np.inf, high=np.inf,
                                   shape=(self._n_sensors_x_y, self._ndims),
                                   dtype=np.float32),
            "pressure": spaces.Box(low=-np.inf, high=np.inf,
                                   shape=(self._n_sensors_x_y,),
                                   dtype=np.float32),
        })

    @property
    def render_shape(self) -> tuple[int, int, int]:
        z_res = min(self._circle_resolution_angular * 4, 128)
        return (int(z_res / self.H * self.L), z_res, z_res)

    @property
    def n_agents(self) -> int:
        return 1

    @property
    def _control_shape(self) -> tuple[int, ...]:
        """Shape of the smoothed control carried across sim steps."""
        return (1,)

    # ------------------------------------------------------------------
    # domain / simulation
    # ------------------------------------------------------------------
    def _build_domain(self):
        return make_vortex_street_domain(
            ndims=self._ndims,
            viscosity=self._viscosity,
            domain_height=self.H,
            domain_length=self.L,
            cylinder_radius=self.cylinder_diameter / 2,
            cylinder_offset_y=self.cylinder_offset_y,
            circle_thickness=self.cylinder_diameter / 2,
            quad_thickness_x=self.cylinder_diameter,
            circle_resolution_angular=self._circle_resolution_angular,
            vortex_street_refinement_base=self._vortex_street_refinement_base,
            vortex_street_refinement_axes=("+y", "-y"),
            dtype=self._dtype,
            device=self._device,
        )

    def _get_domain(self):
        dom, self._grid_info = self._build_domain()
        return dom.build()

    @property
    def _cd_ref(self) -> float:
        if "drag" in self._metrics_stats:
            return self._metrics_stats["drag"].mean
        return 0.0

    def _get_prep_fn(self) -> Hooks:
        char_vel = (self._U_mean,) + (0.0,) * (self._ndims - 1)
        hook = make_convective_outflow_hook(
            self._geoms, self._topo,
            out_faces=((self._vortex_street_block_idx, 1),),  # wake "+x"
            char_vel=char_vel, tol=5e-6)
        return {"PRE": (hook,)}

    def _get_simulation(self) -> SimConfig:
        return SimConfig(
            dt=self._dt,
            substeps=ADAPTIVE,
            adaptive_cfl=self._adaptive_cfl,
            corrector_steps=2,
            pressure_tol=1e-5 if self._ndims == 2 else 5e-7,
            pressure_return_best_result=True,
            velocity_corrector="FD",
            non_orthogonal=True,
            differentiable=self._differentiable,
            pressure_warm_start=True,
            pressure_deflation=True,
            # central advection is unstable at the hard tier's cell Peclet
            # number (impulsive-start blow-up); a 0.3 upwind blend is stable
            advection_upwind_blend=0.3 if self._reynolds_number >= 500 else 0.0,
        )

    def _additional_initialization(self) -> None:
        # project the loaded/initial state to divergence free
        self._state = piso.make_divergence_free(
            self._state, self._geoms, self._topo, self._cfg)
        if not hasattr(self, "_grid_info"):
            _, self._grid_info = self._build_domain()
        centers = [g.centers.detach().cpu().numpy() for g in self._geoms]
        self._centers_np = centers  # reused by subclass sensor plans
        self._resample = None  # built on first use (_render_resample)
        # the sensors gather their 151 physical points directly (mid z in 3D)
        pts = self._get_sensor_locations_2d().T
        if self._ndims == 3:
            pts = np.concatenate([pts, np.zeros((pts.shape[0], 1))], axis=1)
        self._sensor_sample = make_multiblock_point_plan(
            centers, pts, device=self._device)
        self._prepare_drag_and_lift()
        self._last_control = torch.zeros(self._control_shape, dtype=self._dtype,
                                         device=self._device)

    # ------------------------------------------------------------------
    # wall geometry + forces
    # ------------------------------------------------------------------
    def _wall_loop_spec(self):
        """(block, face, cell_slice, flip) around the cylinder, a
        counter-clockwise closed loop."""
        return [
            (self._left_block_idx, 1, (Ellipsis, slice(None), -1), False),
            (self._top_block_idx, 2, (Ellipsis, 0, slice(None)), False),
            (self._right_block_idx, 0, (Ellipsis, slice(None), 0), True),
            (self._bottom_block_idx, 3, (Ellipsis, -1, slice(None)), True),
        ]

    @property
    def _wall_dz(self) -> float:
        return self.D / self._circle_resolution_angular

    @property
    def _force_scale(self) -> float:
        return 0.5 * self._U_mean ** 2 * self.cylinder_diameter

    @property
    def _blocks_vertex_coords(self):
        """Vertex coordinate arrays per block (rebuilt from the static grid)."""
        if not hasattr(self, "_vertex_coords_cache"):
            dom, _ = self._build_domain()
            self._vertex_coords_cache = [b.coords for b in dom._blocks]
        return self._vertex_coords_cache

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------
    def _sensor_locations_to_grid_coords(self, phys: np.ndarray) -> np.ndarray:
        """Physical sensor points ``(ndims, n)`` -> integer render-grid
        indices."""
        phys = phys.copy()
        phys[0] += 2.0
        phys[0] *= (self.render_shape[0] - 1) / (self.L - 2.0)
        phys[1] += self.H / 2
        phys[1] *= (self.render_shape[1] - 1) / self.H
        if self._ndims == 3:
            phys[2] += self.H / 2
            phys[2] *= (self.render_shape[1] - 1) / self.H
        return np.round(phys).astype(np.int32)

    def _get_sensor_locations(self) -> np.ndarray:
        return self._sensor_locations_to_grid_coords(self._get_sensor_locations_2d())

    def _get_cylinder_mask(self) -> np.ndarray:
        """The cylinder's cells on the render grid, ``(y, x)`` (``(z, y,
        x)`` in 3D)."""
        r = self.cylinder_diameter / 2 * (self.render_shape[1] - 1) / self.H
        cx = round((self.render_shape[0] - 1) / self.L * 2.0)
        cy = round((self.render_shape[1] - 1) / self.H * 2.0)
        Y, X = np.ogrid[: self.render_shape[1], : self.render_shape[0]]
        mask = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2) <= r
        if self._ndims == 3:
            mask = np.repeat(mask[None], self.render_shape[2], axis=0)
        return mask

    def _get_sensor_locations_2d(self) -> np.ndarray:
        """151 wake/ring sensor positions ``(2, 151)``."""
        x_idx = np.arange(1.0, 5.0, 0.5)
        y_idx = np.arange(-1.5, 1.75, 0.5)
        gx, gy = np.meshgrid(x_idx, y_idx, indexing="ij")
        sensors = np.stack([gx.ravel(), gy.ravel()], axis=0)

        x_1 = np.arange(-0.25, 1, 0.25)
        y_1a = np.full_like(x_1, -1.5)
        y_1b = np.full_like(x_1, 1.5)
        x_2 = np.concatenate([[-0.25], np.arange(0.25, 1.25, 0.25)])
        y_2a = np.full_like(x_2, self.cylinder_diameter)
        y_2b = np.full_like(x_2, -self.cylinder_diameter)
        x_3 = np.full(3, 0.75)
        y_3 = np.array([-0.5, 0, 0.5])
        additional = np.stack([
            np.concatenate([x_1, x_1, x_2, x_2, x_3]),
            np.concatenate([y_1a, y_1b, y_2a, y_2b, y_3]),
        ], axis=0)

        angles = np.linspace(0, 2 * np.pi, 36)
        c1 = np.stack([1.0 * np.cos(angles), 1.0 * np.sin(angles)], axis=0)
        c2 = np.stack([0.625 * np.cos(angles), 0.625 * np.sin(angles)], axis=0)
        return np.concatenate([sensors, c1, c2, additional], axis=1)

    def _pure_global_obs(self, state: DomainState) -> dict[str, Tensor]:
        """Velocity/pressure at the 151 sensors."""
        u = self._sensor_sample(tuple(b.velocity for b in state.blocks))
        p = self._sensor_sample(tuple(b.pressure for b in state.blocks))
        return {"velocity": u.T[:, : self._ndims], "pressure": p}

    def _get_global_obs(self) -> dict[str, Tensor]:
        return self._pure_global_obs(self._state)

    def _render_resample(self):
        """The resample plan to the uniform render grid, built once per
        reset on first use."""
        if self._resample is None:
            gi = self._grid_info
            lower, upper = (gi["x_min"], gi["y_min"]), (gi["x_max"], gi["y_max"])
            if self._ndims == 3:
                lower, upper = lower + (-2.0,), upper + (2.0,)
            self._resample = make_multiblock_plan(
                self._centers_np, self.render_shape[: self._ndims], lower,
                upper, device=self._device)
        return self._resample

    def get_velocity(self) -> Tensor:
        """Velocity resampled to the uniform render grid, zero inside the
        cylinder."""
        u = self._render_resample()(tuple(b.velocity for b in self._state.blocks))
        mask = torch.as_tensor(self._cylinder_mask, device=u.device)
        return torch.where(mask, torch.zeros_like(u), u)

    def get_pressure(self) -> Tensor:
        return self._render_resample()(tuple(b.pressure for b in self._state.blocks))

    def get_vorticity(self) -> Tensor:
        """z-vorticity on the render grid, zero inside the cylinder."""
        u = self._render_resample()(tuple(b.velocity for b in self._state.blocks))
        return self._z_vorticity(u, (self.L - 2.0) / self.render_shape[0],
                                 self.H / self.render_shape[1], self._cylinder_mask)

    def render_fields(self) -> dict[str, Tensor]:
        return {"vorticity": self.get_vorticity()}

    def _get_render_data(self, render_3d: bool, output_path=None):
        vort = self._render_fields_np()["vorticity"]
        vmin, vmax = VORTICITY_RENDER_RANGE
        if self._ndims == 2:
            img = self._format_render_data(np.flip(vort, -1), v_min=vmin,
                                           v_max=vmax, cmap="coolwarm")
            img[self._cylinder_mask] = 0
            return {"vorticity": img}
        img = self._format_render_data(np.flip(vort[vort.shape[0] // 2], -1),
                                       v_min=vmin, v_max=vmax, cmap="coolwarm")
        img[self._cylinder_mask[0]] = 0
        return {"x-y-vorticity": img}

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    @abstractmethod
    def _pure_apply_action(self, state: DomainState, control: Tensor) -> DomainState: ...

    def _apply_action(self, action: Tensor) -> None:
        self._state = self._pure_apply_action(self._state, action.to(self._dtype))

    def _reward(self, cd: Tensor, cl: Tensor) -> Tensor:
        return self._cd_ref - cd - self._lift_penalty * torch.abs(cl)

    # ------------------------------------------------------------------
    # randomization
    # ------------------------------------------------------------------
    def _randomize_domain(self) -> None:
        """Field noise (numpy draws per block: velocity, then pressure) and
        a random number of uncontrolled steps to randomize the shedding
        phase."""
        strouhal = 0.3
        period = 1 / (strouhal * self._U_mean / self.cylinder_diameter)
        max_n = 2 * int(period / self._step_length) - 1
        n_steps = int(self._np_rng.integers(int(0.5 * max_n), max_n)) + 1

        for b in range(len(self._topo.blocks)):
            blk = self._state.blocks[b]
            noise_u = self._np_rng.normal(0, 1, tuple(blk.velocity.shape)) * 0.025
            noise_p = self._np_rng.normal(0, 1, tuple(blk.pressure.shape)) * 0.025
            u = blk.velocity + torch.as_tensor(
                noise_u, device=self._device).to(blk.velocity.dtype)
            p = blk.pressure + torch.as_tensor(
                noise_p, device=self._device).to(blk.pressure.dtype)
            self._state = self._state.replace_block(
                b, replace(blk, velocity=u, pressure=p))
        for _ in range(n_steps):
            self._run_single_step()

    # ------------------------------------------------------------------
    # state / ids
    # ------------------------------------------------------------------
    @property
    def initial_domain_id(self) -> str:
        return (f"cylinder_{self._ndims}D_Re{int(self._reynolds_number)}"
                f"_Res{self._circle_resolution_angular}")
