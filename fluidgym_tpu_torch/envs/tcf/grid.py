"""Grid and domain setup for turbulent channel flow (counterpart of
``fluidgym_tpu/envs/tcf/grid.py``): the wall-refined y grid, the channel
vertex grid, the Reichardt mean profile, Van Driest damping, the dynamic
bulk forcing from the measured wall stress, and the channel domain builder
(Reichardt profile plus curl noise, no-slip walls in y, periodic x and z).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from fluidgym_tpu_torch.core import geometry as geo
from fluidgym_tpu_torch.core.domain import DomainBuilder, DomainState
from fluidgym_tpu_torch.envs.util.curl_noise import curl_noise_3d

__all__ = ["channel_info", "make_channel_flow_domain",
           "make_dynamic_forcing_hook", "reichardt_profile",
           "van_driest_sqr_from_centers"]


def _make_y_weights(N: int = 1, ny_half: int = 48) -> np.ndarray:
    """Two-sided geometric wall refinement of the y vertices."""
    ny = 2 * (ny_half // N)
    r = 1.2 ** (N / 2)
    h0 = 0.5 * (1 - r) / (1 - r ** (ny / 2))
    h = 0.0
    y = [0.0] * ny
    for i in range((ny - 2) // 2):
        h += h0 * (r**i)
        y[i] = h
        y[ny - i - 2] = 1 - h
    y[ny // 2 - 1] = 0.5
    y[ny - 1] = 1.0
    return np.asarray([0.0] + y)


def _make_grid(H, L, D, x, y_half, yN, z, dims=3, global_scale=None):
    """Channel vertex grid: ``(dims, [z+1,] y+1, x+1)``."""
    assert x % 4 == 0
    delta = H / 2
    if global_scale is not None:
        y_weights = geo.make_weights_exp_global(y_half * 2, global_scale, "BOTH")
    else:
        y_weights = _make_y_weights(ny_half=y_half * yN, N=yN)
    corners = [(-L / 2, -delta), (L / 2, -delta), (-L / 2, delta), (L / 2, delta)]
    y = len(y_weights) - 1
    grid = geo.generate_grid_vertices_2d(
        (y + 1, x + 1), corners, None, x_weights=y_weights)
    if dims == 3:
        grid = geo.extrude_grid_z(grid, z, start_z=-D / 2, end_z=D / 2, exp_base=1)
    return grid


def reichardt_profile(y_centers: np.ndarray, u_wall: float, viscosity: float,
                      delta: float = 1.0) -> np.ndarray:
    """Reichardt mean velocity profile over the wall distance."""
    k = 0.41
    y_wall = (delta - np.abs(y_centers)) * u_wall / viscosity
    y11 = y_wall / 11.0
    u_plus = (1 / k) * np.log(1 + k * y_wall) + 7.8 * (
        1 - np.exp(-y11) - y11 * np.exp(-y_wall / 3)
    )
    return u_plus * u_wall


def van_driest_sqr_from_centers(y_centers, u_wall: float, viscosity: float,
                                delta: float = 1.0):
    """Squared Van Driest damping from the wall distance."""
    wall_distance = (delta - np.abs(y_centers)) * u_wall / viscosity
    scale = 1 - np.exp(-wall_distance / 25.0)
    return scale * scale


def make_dynamic_forcing_hook(geoms, topo, d_y: tuple[float, float]):
    """PRE hook: the streamwise velocity source equal to the mean wall shear
    stress of both walls, from the state on the device (no host sync)."""

    def hook(state: DomainState, **kw) -> DomainState:
        blk = state.blocks[0]
        nu = state.viscosity
        mean_u = torch.mean(blk.velocity[0], dim=(0, 2))  # mean over (z, x)
        tau_n = nu * mean_u[0] / d_y[0]
        tau_p = nu * mean_u[-1] / d_y[1]
        forcing = 0.5 * (tau_n + tau_p)
        zero = torch.zeros_like(blk.velocity[1:])
        src = torch.cat([forcing + torch.zeros_like(blk.velocity[:1]), zero])
        return state.replace_block(0, replace(blk, velocity_source=src))

    return hook


def _info(grid: np.ndarray, n_dims: int) -> dict:
    centers = geo.cell_centers(grid)
    y_centers = centers[1, 0, :, 0] if n_dims == 3 else centers[1, :, 0]
    return {
        "y_centers": np.asarray(y_centers),
        "d_y": (float(1 + y_centers[0]), float(1 - y_centers[-1])),
    }


def channel_grid(H: float, L: float, D: float, x: int, y: int, z: int,
                 refinement_strength: int, n_dims: int) -> np.ndarray:
    """The channel's vertex grid (the one ``make_channel_flow_domain``
    builds the block on)."""
    return _make_grid(H=H, L=L, D=D, x=x, y_half=y // 2,
                      yN=refinement_strength, z=z, dims=n_dims)


def channel_info(H: float, L: float, D: float, x: int, y: int, z: int,
                 refinement_strength: int, n_dims: int) -> dict:
    """The channel's static geometry info (``y_centers`` and the wall
    distances ``d_y`` of the first and last cell centres), from the grid
    alone: what ``make_channel_flow_domain`` returns beside the domain."""
    return _info(channel_grid(H, L, D, x, y, z, refinement_strength, n_dims),
                 n_dims)


def make_channel_flow_domain(
    H: float, L: float, D: float, x: int, y: int, z: int,
    refinement_strength: int, n_dims: int, u_wall: float, viscosity: float,
    init_with_noise: bool = True, rng: np.random.Generator | None = None,
    dtype=None, device=None,
):
    """The channel domain builder and its info: no-slip y walls (closing
    ``-y`` also closes ``+y``: the periodic pair is severed), periodic x
    and z, the Reichardt profile plus curl noise as the initial velocity."""
    grid = _make_grid(H=H, L=L, D=D, x=x, y_half=y // 2,
                      yN=refinement_strength, z=z, dims=n_dims)
    ny = grid.shape[-2] - 1
    nz = grid.shape[-3] - 1 if n_dims == 3 else None

    dom = DomainBuilder(ndims=n_dims, viscosity=viscosity, scalar_channels=0,
                        name="ChannelDomain", dtype=dtype, device=device)
    blk = dom.create_block(grid, name="ChannelBlock")
    blk.close_boundary("-y")  # also closes "+y"

    info = _info(grid, n_dims)
    u_profile = reichardt_profile(info["y_centers"], u_wall, viscosity)
    if n_dims == 3:
        vel = np.zeros((3, nz, ny, x))
        vel[0] = u_profile[None, :, None]
        if init_with_noise:
            rng = rng or np.random.default_rng(0)
            noise = curl_noise_3d((x, ny, nz), (2 / x, 2 / ny, 2 / nz), rng)
            mag = np.linalg.norm(noise, axis=0)
            noise *= 0.5 * vel[0:1] / max(mag.max(), 1e-12)
            vel = vel + noise
    else:
        vel = np.zeros((2, ny, x))
        vel[0] = u_profile[:, None]
    blk.set_velocity(vel)
    blk.set_velocity_source(np.zeros_like(vel))  # rewritten by the forcing hook
    return dom, info
