"""Grid generation for the cylinder vortex-street environment (counterpart
of ``fluidgym_tpu/envs/cylinder/grid.py``): an O-grid of four torus segments
around the cylinder, each merged with a transfinite quad extending to the
channel walls / inflow, plus a wall-refined rectilinear wake block; five
blocks in all, stitched with CONNECTED faces.
"""

from __future__ import annotations

import numpy as np

from fluidgym_tpu_torch.core import geometry as geo
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.envs.util.profiles import get_inflow_profile

__all__ = ["make_vortex_street_domain", "CYLINDER_BLOCKS"]

# block index order
CYLINDER_BLOCKS = ("left", "top", "right", "bottom", "vortex_street")


def make_vortex_street_domain(
    ndims: int,
    viscosity: float,
    domain_height: float,
    domain_length: float,
    cylinder_radius: float,
    cylinder_offset_y: float,
    circle_thickness: float,
    quad_thickness_x: float,
    circle_resolution_angular: int,
    vortex_street_refinement_base: float,
    vortex_street_refinement_axes: tuple[str, ...],
    dtype=None,
    device=None,
):
    """Build the 5-block cylinder domain on ``device``; returns ``(builder,
    info)`` where info holds block indices and geometric extents."""
    res = circle_resolution_angular
    quad_thickness_y = quad_thickness_x + cylinder_offset_y
    actual_height = 2 * cylinder_radius + 2 * circle_thickness + 2 * quad_thickness_y
    if abs(domain_height - actual_height) > 1e-9:
        raise ValueError(
            f"domain_height ({domain_height}) does not match the calculated "
            f"height ({actual_height})"
        )
    x_min = -(cylinder_radius + circle_thickness + quad_thickness_x)
    x_max = domain_length + x_min

    t_r1, t_r2 = cylinder_radius, cylinder_radius + circle_thickness

    def swap(g):  # torch.movedim(-1, -2)
        return np.swapaxes(g, -1, -2)

    # torus segments and their orientations
    circle_top = geo.make_torus_2d(res, t_r1, t_r2, 135, -90)  # y up, x right
    circle_right = np.flip(swap(geo.make_torus_2d(res, t_r1, t_r2, 45, -90)), -2)
    circle_bot = np.flip(geo.make_torus_2d(res, t_r1, t_r2, -45, -90), (-2, -1))
    circle_left = np.flip(swap(geo.make_torus_2d(res, t_r1, t_r2, -135, -90)), -1)

    quad_r_outer_x = cylinder_radius + circle_thickness + quad_thickness_x
    quad_r_outer_y = cylinder_radius + circle_thickness + quad_thickness_y
    quad_r_outer_y_top = quad_r_outer_y + cylinder_offset_y
    quad_r_outer_y_bot = quad_r_outer_y - cylinder_offset_y
    quad_r_inner = np.sin(np.deg2rad(45)) * t_r2

    circle_res_radial = circle_top.shape[-2] - 1
    quad_res_angular = res + 1
    quad_res_radial = int(
        np.ceil(quad_thickness_y / circle_thickness * circle_res_radial)
    )

    quad_corners_top = [(-quad_r_inner, quad_r_inner), (quad_r_inner, quad_r_inner),
                        (-quad_r_outer_x, quad_r_outer_y_top),
                        (quad_r_outer_x, quad_r_outer_y_top)]
    quad_corners_right = [(quad_r_inner, -quad_r_inner),
                          (quad_r_outer_x, -quad_r_outer_y_bot),
                          (quad_r_inner, quad_r_inner),
                          (quad_r_outer_x, quad_r_outer_y_top)]
    quad_corners_bot = [(-quad_r_outer_x, -quad_r_outer_y_bot),
                        (quad_r_outer_x, -quad_r_outer_y_bot),
                        (-quad_r_inner, -quad_r_inner), (quad_r_inner, -quad_r_inner)]
    quad_corners_left = [(-quad_r_outer_x, -quad_r_outer_y_bot),
                         (-quad_r_inner, -quad_r_inner),
                         (-quad_r_outer_x, quad_r_outer_y_top),
                         (-quad_r_inner, quad_r_inner)]

    def border(line):  # (2, N) -> (N, 2)
        return np.moveaxis(np.asarray(line), 0, 1)

    quad_border_top = [None, None, border(circle_top[:, -1, :]), None]
    quad_border_right = [border(circle_right[:, :, -1]), None, None, None]
    quad_border_bot = [None, None, None, border(circle_bot[:, 0, :])]
    quad_border_left = [None, border(circle_left[:, :, 0]), None, None]

    quad_top = geo.generate_grid_vertices_2d(
        (quad_res_radial, quad_res_angular), quad_corners_top, quad_border_top)
    quad_bot = geo.generate_grid_vertices_2d(
        (quad_res_radial, quad_res_angular), quad_corners_bot, quad_border_bot)
    x_weights = geo.make_weights_exp(
        quad_res_angular - 1, base=vortex_street_refinement_base, refinement="BOTH")
    quad_right = geo.generate_grid_vertices_2d(
        (quad_res_angular, quad_res_radial), quad_corners_right, quad_border_right,
        x_weights=x_weights)
    quad_left = geo.generate_grid_vertices_2d(
        (quad_res_angular, quad_res_radial), quad_corners_left, quad_border_left)

    left_coords = np.concatenate([quad_left[:, :, :-1], circle_left], axis=-1)
    top_coords = np.concatenate([circle_top[:, :-1, :], quad_top], axis=-2)
    right_coords = np.concatenate([circle_right[:, :, :-1], quad_right], axis=-1)
    bottom_coords = np.concatenate([quad_bot[:, :-1, :], circle_bot], axis=-2)

    vs_res_x = int(quad_res_radial / quad_thickness_y * 18)
    vs_coords = geo.make_wall_refined_ortho_grid(
        vs_res_x, res,
        corner_lower=(-1 * x_min, -quad_r_outer_y_bot),
        corner_upper=(x_max, quad_r_outer_y_top),
        wall_refinement=vortex_street_refinement_axes,
        base=vortex_street_refinement_base,
    )

    grids = [left_coords, bottom_coords, top_coords, right_coords, vs_coords]
    if ndims == 3:
        grids = [geo.extrude_grid_z(g, res_z=res, start_z=-2, end_z=2, exp_base=1)
                 for g in grids]
        (left_coords, bottom_coords, top_coords, right_coords, vs_coords) = grids

    dom = DomainBuilder(ndims=ndims, viscosity=viscosity, scalar_channels=0,
                        name="CylinderDomain", dtype=dtype,
                        device=device)

    inflow = get_inflow_profile(
        h=domain_height - 2 * cylinder_offset_y, res_y=res, n_dims=ndims,
        res_z=res if ndims == 3 else None)

    left = dom.create_block(left_coords, name="BlockCylinderLeft")
    left.close_boundary("-x", velocity=inflow)  # inflow
    left.close_boundary("+x")  # cylinder wall

    top = dom.create_block(top_coords, name="BlockCylinderTop")
    top.close_boundary("+y")  # channel wall
    top.close_boundary("-y")  # cylinder wall

    right = dom.create_block(right_coords, name="BlockCylinderRight")
    right.close_boundary("-x")  # cylinder wall

    bottom = dom.create_block(bottom_coords, name="BlockCylinderBottom")
    bottom.close_boundary("-y")  # channel wall
    bottom.close_boundary("+y")  # cylinder wall

    vs = dom.create_block(vs_coords, name="BlockVortexStreet")
    vs.close_boundary("+y")
    vs.close_boundary("-y")
    vs.close_boundary("+x", velocity=inflow)  # outflow initialized with inflow

    # connections; block order: left=0, top=1, right=2, bottom=3, vs=4
    L, T, R, B, V = 0, 1, 2, 3, 4
    if ndims == 2:
        dom.connect_blocks(L, "+y", T, "-x", "+y")
        dom.connect_blocks(L, "-y", B, "-x", "-y")
        dom.connect_blocks(R, "+y", T, "+x", "-y")
        dom.connect_blocks(R, "-y", B, "+x", "+y")
        dom.connect_blocks(R, "+x", V, "-x", "-y")
    else:
        dom.connect_blocks(L, "+y", T, "-x", "-z", "+y")
        dom.connect_blocks(L, "-y", B, "-x", "-z", "-y")
        dom.connect_blocks(R, "+y", T, "+x", "-z", "-y")
        dom.connect_blocks(R, "-y", B, "+x", "-z", "+y")
        dom.connect_blocks(R, "+x", V, "-x", "-y", "-z")

    info = {
        "block_order": CYLINDER_BLOCKS,
        "x_min": x_min,
        "x_max": x_max,
        "y_min": -quad_r_outer_y_bot,
        "y_max": quad_r_outer_y_top,
        "outflow": (V, 1),  # (block, face "+x")
    }
    return dom, info
