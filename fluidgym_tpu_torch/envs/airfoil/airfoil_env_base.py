"""Base class of the NACA 0012 airfoil flow environments (counterpart of
``fluidgym_tpu/envs/airfoil/airfoil_env_base.py``), 2D and 3D.

* 6-block C-grid around a NACA 0012 at 0-20 degrees attack angle
  (``grid.py``), merged into 3 super-blocks whose wake cut is a reflected
  (flip) seam;
* parabolic inflow, convective outflow on the two tail blocks' +x faces by
  a PRE hook, flux balancing folded into the action application;
* solver preset: adaptive substeps, non-orthogonal corrections, advection
  tol 1e-6, pressure tol 1e-7 (2D) / 1e-8 (3D), FD corrector, pressure
  warm start with deflation, ``make_divergence_free`` at initialization;
* wake + surface sensor cloud filtered by the airfoil mask;
* three synthetic jets on the upper surface at chord 0.2/0.4/0.6, parabolic
  profiles along the local wall normal, zero-mean action;
* drag/lift from wall-stress integration around front/top/bottom surfaces;
  reward ``cl/cd - cl_cd_ref`` with action smoothing
  ``c <- c + alpha*(a - c)`` per sim step;
* domain randomization: field noise (numpy draws per block, velocity then
  pressure) + a random number of uncontrolled steps.

At Re >= 3000 (the medium and hard tiers) the velocity advection matrix
takes the upwind blend 0.3 and the pressure solve the aggregation coarse
space of 8 x 8 tiles (``pressure_coarse_tile``,
``pressure_coarse_precondition``), as in the JAX package.

In 3D the C-grid is extruded over ``_res_z`` cells of a periodic span
``D`` (``grid.py``), the jets over the whole span, and drag and lift come
per z-slice.  A 3D config at Re >= 3000 raises: its aggregation coarse
space (8 x 8 x 8 tiles, 14,328 of them on the medium grid) has no kernel
form yet.  The uniform render grid's resample plan is built at the first
``get_velocity`` / ``get_pressure`` / ``get_vorticity``: in 3D it gathers
13.5 M points.  Frames show the z-vorticity (the mid z-slice in 3D) in
``coolwarm`` over the Reynolds number's ``VORTICITY_RENDER_RANGE``.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.core.domain import DomainState
from fluidgym_tpu_torch.envs.airfoil.grid import (get_jet_locations,
                                                  make_airfoil_domain,
                                                  read_airfoil)
from fluidgym_tpu_torch.envs.fluid_env import FluidEnv
from fluidgym_tpu_torch.envs.util.multiblock_resample import (
    make_multiblock_plan,
    make_multiblock_point_plan,
)
from fluidgym_tpu_torch.envs.util.profiles import get_jet_profile
from fluidgym_tpu_torch.envs.util.smoothed_control import SmoothedControlMixin
from fluidgym_tpu_torch.envs.util.wall_forces import WallForcesMixin
from fluidgym_tpu_torch.solver import piso
from fluidgym_tpu_torch.solver.boundaries import (balance_boundary_fluxes,
                                                  make_convective_outflow_hook)
from fluidgym_tpu_torch.solver.piso import ADAPTIVE, Hooks, SimConfig

Tensor = torch.Tensor

__all__ = ["AirfoilEnvBase", "points_in_polygon"]


def points_in_polygon(polygon: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Even-odd crossing test of ``points (n, 2)`` against the closed
    ``polygon (m, 2)``, with matplotlib's ``Path.contains_points`` rule for
    points on edges and vertices: per edge ``(v0, v1)`` a crossing counts
    when ``v0y >= ty`` and ``v1y >= ty`` differ and ``((v1y - ty) * (v0x -
    v1x) >= (v1x - tx) * (v0y - v1y)) == (v1y >= ty)``.  The arithmetic is
    float64, so integer inputs give matplotlib's answer bit for bit."""
    poly = np.asarray(polygon, np.float64)
    tx = np.asarray(points, np.float64)[:, 0]
    ty = np.asarray(points, np.float64)[:, 1]
    inside = np.zeros(tx.shape, bool)
    for k in range(poly.shape[0]):
        vx0, vy0 = poly[k - 1]
        vx1, vy1 = poly[k]
        yflag0 = vy0 >= ty
        yflag1 = vy1 >= ty
        hit = ((vy1 - ty) * (vx0 - vx1) >= (vx1 - tx) * (vy0 - vy1)) == yflag1
        inside ^= (yflag0 != yflag1) & hit
    return inside


#: colour range of the rendered vorticity per Reynolds number
VORTICITY_RENDER_RANGE = {1000: (-10, 10), 3000: (-12.5, 12.5), 5000: (-15, 15)}


class AirfoilEnvBase(SmoothedControlMixin, WallForcesMixin, FluidEnv):
    """Base class of the airfoil flow environments."""

    _default_render_key: str = "vorticity"

    _n_jets: int = 3
    _res_z: int = 96
    U_mean: float = 0.3
    airfoil_length: float = 1.0
    H: float = 1.4
    L: float = 4.5
    D: float = 1.4

    _metrics: list[str] = ["drag", "lift"]

    def __init__(
        self,
        reynolds_number: float,
        adaptive_cfl: float,
        step_length: float,
        episode_length: int,
        dt: float,
        attack_angle_deg: float,
        ndims: int,
        use_marl: bool,
        dtype=None,
        load_initial_domain: bool = True,
        load_domain_statistics: bool = True,
        randomize_initial_state: bool = True,
        enable_actions: bool = True,
        differentiable: bool = False,
        device=None,
    ):
        if attack_angle_deg < 0.0 or attack_angle_deg > 20.0:
            raise ValueError("Attack angle must be between 0 and 20 degrees.")
        if ndims == 3 and reynolds_number >= 3000:
            raise NotImplementedError(
                "3D airfoils at Re >= 3000 need the 3D aggregation coarse "
                "space of the pressure solve (8 x 8 x 8 tiles), which is not "
                "ported yet")
        self._reynolds_number = float(reynolds_number)
        self._attack_angle_deg = float(attack_angle_deg)
        self._ndims = ndims
        self._viscosity = (self.U_mean * self.airfoil_length) / self._reynolds_number
        self._airfoil_coords = read_airfoil(self._attack_angle_deg)
        self._airfoil_mask = self._get_airfoil_mask()
        self._sensor_locations = self._get_sensor_locations()

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

        (self._left_block_idx, self._airfoil_front_block_idx,
         self._airfoil_top_block_idx, self._airfoil_bot_block_idx,
         self._tail_upper_block_idx, self._tail_lower_block_idx) = range(6)
        self._last_control = torch.zeros(self._control_shape, dtype=self._dtype,
                                         device=self._device)

    # ------------------------------------------------------------------
    # spaces / shapes
    # ------------------------------------------------------------------
    def _get_action_space(self) -> spaces.Box:
        return spaces.Box(low=-1.0, high=1.0, shape=(self._n_jets,),
                          dtype=np.float32)

    def _get_observation_space(self) -> spaces.Dict:
        n = self._sensor_locations.shape[-1]
        return spaces.Dict({
            "velocity": spaces.Box(-np.inf, np.inf, (n, self._ndims), np.float32),
            "pressure": spaces.Box(-np.inf, np.inf, (n,), np.float32),
        })

    @property
    def render_shape(self) -> tuple[int, int, int]:
        return (600, 150, 150)

    @property
    def n_agents(self) -> int:
        return self._n_jets

    @property
    def _control_shape(self) -> tuple[int, ...]:
        return (self._n_jets,)

    @property
    def _cl_cd_ref(self) -> float:
        """Reference lift-to-drag ratio from the domain statistics."""
        if "lift" in self._metrics_stats and "drag" in self._metrics_stats:
            return self._metrics_stats["lift"].mean / self._metrics_stats["drag"].mean
        return 0.0

    # ------------------------------------------------------------------
    # domain / simulation
    # ------------------------------------------------------------------
    @property
    def _tail_grow_mul(self) -> float:
        """Wake cell growth: finer for the hard 3D case."""
        if self._ndims == 3 and self._reynolds_number >= 5000:
            return 1.001
        return 1.01

    def _build_domain(self):
        return make_airfoil_domain(
            ndims=self._ndims,
            res_z=self._res_z,
            H=self.H,
            L=self.L,
            vel_in=self.U_mean,
            attack_angle_deg=self._attack_angle_deg,
            viscosity=self._viscosity,
            tail_grow_mul=self._tail_grow_mul,
            dtype=self._dtype,
            device=self._device,
        )

    def _get_domain(self):
        dom, self._grid_info = self._build_domain()
        return dom.build()

    def _get_prep_fn(self) -> Hooks:
        char_vel = (self.U_mean,) + (0.0,) * (self._ndims - 1)
        hook = make_convective_outflow_hook(
            self._geoms, self._topo, out_faces=self._out_faces,
            char_vel=char_vel, tol=5e-6)
        return {"PRE": (hook,)}

    @property
    def _out_faces(self):
        return ((self._tail_lower_block_idx, 1), (self._tail_upper_block_idx, 1))

    def _get_simulation(self) -> SimConfig:
        return SimConfig(
            dt=self._dt,
            substeps=ADAPTIVE,
            adaptive_cfl=self._adaptive_cfl,
            corrector_steps=2,
            advection_tol=1e-6,
            pressure_tol=1e-7 if self._ndims == 2 else 1e-8,
            pressure_return_best_result=True,
            velocity_corrector="FD",
            non_orthogonal=True,
            differentiable=self._differentiable,
            pressure_warm_start=True,
            pressure_deflation=True,
            # Re >= 3000: the central scheme grows an advective instability
            # on the C-grid, so the velocity matrix takes the upwind blend,
            # on which plain Jacobi-PCG stalls above the 1e-7 tolerance; the
            # aggregation coarse space restores convergence (the JAX
            # package's settings and reasons)
            advection_upwind_blend=0.3 if self._reynolds_number >= 3000 else 0.0,
            **({"pressure_coarse_tile": 8, "pressure_coarse_precondition": True}
               if self._reynolds_number >= 3000 else {}),
        )

    def _additional_initialization(self) -> None:
        self._state = piso.make_divergence_free(
            self._state, self._geoms, self._topo, self._cfg)
        if not hasattr(self, "_grid_info"):
            _, self._grid_info = self._build_domain()
        centers = [g.centers.detach().cpu().numpy() for g in self._geoms]
        self._centers_np = centers  # reused by the 3D sensor plan
        self._resample = None  # built on first use (_render_resample)
        # the sensors gather the physical points outside the airfoil mask
        # (in 3D on the z = 0 plane)
        pts_all = self._get_sensor_locations_2d()
        grid = self._physical_locations_to_grid_coords(pts_all)
        keep = ~self._airfoil_mask_2d[grid[1], grid[0]]
        pts = pts_all[:, keep].T
        if self._ndims == 3:
            pts = np.concatenate([pts, np.zeros((pts.shape[0], 1))], axis=1)
        self._sensor_sample = make_multiblock_point_plan(
            centers, pts, device=self._device)

        self._prepare_drag_and_lift()
        self._jet_locations_top = get_jet_locations(
            self._blocks_vertex_coords[self._airfoil_top_block_idx])
        self._top_base_profile, self._jet_masks = self._get_base_jet_profiles()
        self._last_control = torch.zeros(self._control_shape, dtype=self._dtype,
                                         device=self._device)

    @property
    def _blocks_vertex_coords(self):
        """Vertex coordinate arrays per block (rebuilt from the static grid)."""
        if not hasattr(self, "_vertex_coords_cache"):
            dom, _ = self._build_domain()
            self._vertex_coords_cache = [b.coords for b in dom._blocks]
        return self._vertex_coords_cache

    # ------------------------------------------------------------------
    # wall forces
    # ------------------------------------------------------------------
    def _wall_loop_spec(self):
        """Closed contour around the airfoil: front (+x face, bottom-to-top
        nose arc) -> top surface (left to right) -> bottom surface flipped
        (right to left)."""
        return [
            (self._airfoil_front_block_idx, 1, (Ellipsis, slice(None), -1), False),
            (self._airfoil_top_block_idx, 2, (Ellipsis, 0, slice(None)), False),
            (self._airfoil_bot_block_idx, 3, (Ellipsis, -1, slice(None)), True),
        ]

    @property
    def _wall_dz(self) -> float:
        return self.D / self._res_z

    @property
    def _force_scale(self) -> float:
        return 0.5 * self.U_mean ** 2 * self.airfoil_length

    # ------------------------------------------------------------------
    # jets
    # ------------------------------------------------------------------
    def _get_base_jet_profiles(self):
        """Per-cell base jet velocity on the top block's wall face
        ``(2, 1, nx)`` (3D: ``(3, nz, 1, nx)``, the 2D profile on every
        z-slice, no z component) and static 0/1 jet masks ``(n_jets, nx)``;
        profiles point along the local wall normal."""
        vc = np.asarray(self._blocks_vertex_coords[self._airfoil_top_block_idx])
        n_cells_top = vc.shape[-1] - 1
        base = np.zeros((2, n_cells_top))
        masks = np.zeros((self._n_jets, n_cells_top))
        # the wall loop starts with the front block's cells, so the top
        # segment's normals sit behind them
        front_vc = np.asarray(
            self._blocks_vertex_coords[self._airfoil_front_block_idx])
        n_offset = front_vc.shape[-2]
        normals = self._wall_normals.detach().cpu().numpy()
        for i, (start, end) in enumerate(self._jet_locations_top):
            profile = get_jet_profile(end - start + 3)[1:-1]
            profile = profile / profile.sum()
            n = normals[:, n_offset + start: n_offset + end + 1]
            base[:, start:end + 1] = profile[None, :] * n
            masks[i, start:end + 1] = 1.0
        conv = lambda a: torch.as_tensor(a, device=self._device).to(self._dtype)
        if self._ndims == 2:
            return conv(base[:, None, :]), conv(masks)
        base3 = np.concatenate([base, np.zeros((1, n_cells_top))], axis=0)
        return (conv(np.repeat(base3[:, None, None, :], self._res_z, axis=1)),
                conv(masks))

    def _pure_action_multiplier(self, control: Tensor) -> Tensor:
        """Zero-mean, max-normalized action -> per-wall-cell multiplier."""
        v = control - torch.mean(control)
        max_v = torch.max(torch.abs(v))
        v = torch.where(max_v > 1.0, v / max_v, v)
        return v @ self._jet_masks  # (nx,)

    def _pure_apply_action(self, state: DomainState, control: Tensor) -> DomainState:
        mult = self._pure_action_multiplier(control)
        profile = self._top_base_profile * mult[None, None, :]
        b, f = self._airfoil_top_block_idx, 2  # "-y" face
        blk = state.blocks[b]
        faces = list(blk.faces)
        faces[f] = replace(faces[f], velocity=profile.to(faces[f].velocity.dtype))
        state = state.replace_block(b, replace(blk, faces=tuple(faces)))
        free = self._out_faces + ((b, f),)
        return balance_boundary_fluxes(state, self._geoms, self._topo, free)

    def _apply_action(self, action: Tensor) -> None:
        self._state = self._pure_apply_action(self._state, action.to(self._dtype))

    # ------------------------------------------------------------------
    # sensors / observations
    # ------------------------------------------------------------------
    def _physical_locations_to_grid_coords(self, phys: np.ndarray) -> np.ndarray:
        """Physical ``(2, m)`` points -> integer render-grid coordinates,
        scaled by the full render resolution and clipped to it."""
        phys = np.array(phys, dtype=np.float64, copy=True)
        phys[0] += 1.5
        phys[0] *= self.render_shape[0] / (self.L + 1.5)
        phys[1] += self.H / 2
        phys[1] *= self.render_shape[1] / self.H
        if phys.shape[0] == 3:
            phys[2] += self.D / 2
            phys[2] *= self.render_shape[1] / self.D
        out = np.round(phys).astype(np.int32)
        limits = (self.render_shape[0] - 1, self.render_shape[1] - 1,
                  self.render_shape[1] - 1)
        for d in range(phys.shape[0]):
            out[d] = np.clip(out[d], 0, limits[d])
        return out

    def _get_airfoil_mask(self) -> np.ndarray:
        """``(ny, nx)`` bool over the render grid (3D: ``(nz, ny, nx)``, the
        same on every z-slice): True inside the airfoil (matplotlib's
        ``Path.contains_points`` rule, ``points_in_polygon``)."""
        coords = self._physical_locations_to_grid_coords(self._airfoil_coords)
        nx, ny = self.render_shape[0], self.render_shape[1]
        xx, yy = np.meshgrid(np.arange(nx), np.arange(ny))
        pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
        mask = points_in_polygon(coords[:2].T, pts).reshape(ny, nx)
        if self._ndims == 3:
            mask = np.repeat(mask[None], self.render_shape[2], axis=0)
        return mask

    @property
    def _airfoil_mask_2d(self) -> np.ndarray:
        """The airfoil mask of one z-slice, ``(ny, nx)``."""
        return self._airfoil_mask if self._ndims == 2 else self._airfoil_mask[0]

    def _get_sensor_locations_2d(self) -> np.ndarray:
        """Wake + near-surface sensor cloud ``(2, 186)``."""
        def mesh(xs, ys):
            gx, gy = np.meshgrid(xs, ys, indexing="ij")
            return np.stack([gx.ravel(), gy.ravel()], axis=0)

        y_in = np.linspace(-self.H / 2, self.H / 2, 10)[1:-1]
        wake_coarse = mesh(np.arange(1.5, 2.6, 0.125), y_in)
        wake_fine = mesh(np.arange(1.05, 1.45, 0.05), y_in)
        surface = mesh(np.linspace(-0.125, self.airfoil_length, 10),
                       np.linspace(-0.5, 0.125, 8))
        return np.concatenate([wake_coarse, wake_fine, surface], axis=1)

    def _get_sensor_locations(self) -> np.ndarray:
        grid = self._physical_locations_to_grid_coords(
            self._get_sensor_locations_2d())
        keep = ~self._airfoil_mask_2d[grid[1], grid[0]]
        return grid[:, keep]

    def _pure_global_obs(self, state: DomainState) -> dict[str, Tensor]:
        u = self._sensor_sample(tuple(b.velocity for b in state.blocks))
        p = self._sensor_sample(tuple(b.pressure for b in state.blocks))
        return {"velocity": u.T, "pressure": p}

    def _get_global_obs(self) -> dict[str, Tensor]:
        return self._pure_global_obs(self._state)

    def _render_resample(self):
        """The resample plan to the uniform render grid, built once per
        reset at first use (3D: over a ``D``-wide span)."""
        if self._resample is None:
            gi = self._grid_info
            lower, upper = (gi["x_min"], gi["y_min"]), (gi["x_max"], gi["y_max"])
            if self._ndims == 3:
                lower, upper = lower + (-self.D / 2,), upper + (self.D / 2,)
            self._resample = make_multiblock_plan(
                self._centers_np, self.render_shape[: self._ndims], lower,
                upper, device=self._device)
        return self._resample

    def get_velocity(self) -> Tensor:
        """Velocity resampled to the uniform render grid, zero inside the
        airfoil."""
        u = self._render_resample()(tuple(b.velocity for b in self._state.blocks))
        mask = torch.as_tensor(self._airfoil_mask, device=u.device)
        return torch.where(mask, torch.zeros_like(u), u)

    def get_pressure(self) -> Tensor:
        return self._render_resample()(
            tuple(b.pressure for b in self._state.blocks))

    def get_vorticity(self) -> Tensor:
        """z-vorticity on the render grid, zero inside the airfoil."""
        u = self._render_resample()(tuple(b.velocity for b in self._state.blocks))
        return self._z_vorticity(u, (self.L + 1.5) / self.render_shape[0],
                                 self.H / self.render_shape[1], self._airfoil_mask)

    def render_fields(self) -> dict[str, Tensor]:
        return {"vorticity": self.get_vorticity()}

    def _get_render_data(self, render_3d: bool, output_path=None):
        vort = self._render_fields_np()["vorticity"]
        vmin, vmax = VORTICITY_RENDER_RANGE.get(int(self._reynolds_number),
                                                (-10, 10))
        if self._ndims == 3:
            vort = vort[vort.shape[0] // 2]
        img = self._format_render_data(np.flip(vort, (-2, -1)), v_min=vmin,
                                       v_max=vmax, cmap="coolwarm")
        return {"vorticity" if self._ndims == 2 else "x-y-vorticity": img}

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _reward(self, cd: Tensor, cl: Tensor) -> Tensor:
        return (cl / cd) - self._cl_cd_ref

    # ------------------------------------------------------------------
    # randomization
    # ------------------------------------------------------------------
    def _randomize_domain(self) -> None:
        """Field noise (numpy draws per block: velocity, then pressure) and
        a random number of uncontrolled steps."""
        max_n = int(0.05 * self._episode_length)
        n_steps = int(self._np_rng.integers(int(0.5 * max_n), max(max_n, 1))) + 1
        for b in range(len(self._topo.blocks)):
            blk = self._state.blocks[b]
            noise_u = self._np_rng.normal(0, 1, tuple(blk.velocity.shape)) * 0.01
            noise_p = self._np_rng.normal(0, 1, tuple(blk.pressure.shape)) * 0.01
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
        return f"airfoil_{self._ndims}D_Re{int(self._reynolds_number)}"

    @property
    def id(self) -> str:
        return f"Airfoil{self._ndims}D_Re{int(self._reynolds_number)}"

