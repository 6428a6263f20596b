"""Grid generation for the NACA 0012 airfoil environments (counterpart of
``fluidgym_tpu/envs/airfoil/grid.py``): a 6-block C-type decomposition
around the airfoil -- a rectilinear inflow box, three body-fitted blocks
wrapping the front / top / bottom surfaces (transfinite grids with the
airfoil polyline as one border, exponentially refined toward the wall), and
two wake blocks behind the trailing edge with geometrically growing
streamwise spacing, meeting along the wake cut with the along-cut axis
reversed.  In 3D every block is extruded over ``res_z`` cells in z, the z
faces stay periodic, and the wake cut reverses x and keeps z.
"""

from __future__ import annotations

import numpy as np

from fluidgym_tpu_torch.core import geometry as geo
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.envs.airfoil.coords import naca0012_sharp_coords
from fluidgym_tpu_torch.envs.util.profiles import get_inflow_profile

__all__ = ["JET_CENTERS", "JET_WIDTH", "read_airfoil", "make_airfoil_domain",
           "get_jet_locations", "AIRFOIL_BLOCKS"]

# jet arcs on the top surface, by chord position
JET_CENTERS = (0.2, 0.4, 0.6)
JET_WIDTH = 0.08

# block index order
AIRFOIL_BLOCKS = ("left", "airfoil_front", "airfoil_top", "airfoil_bot",
                  "tail_upper", "tail_lower")


def read_airfoil(attack_angle_deg: float) -> np.ndarray:
    """NACA 0012 surface polyline rotated by the attack angle; ``(2, N)``."""
    coords = naca0012_sharp_coords()
    if attack_angle_deg != 0.0:
        a = -np.deg2rad(attack_angle_deg)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        coords = rot @ coords
    return coords


def get_jet_locations(top_block_coords: np.ndarray) -> list[list[int]]:
    """[start, end] vertex-index pairs of each jet on the top surface.
    ``top_block_coords`` is the AirfoilTop block's vertex array
    ``(2, ny+1, nx+1)`` or ``(3, nz+1, ny+1, nx+1)``; the airfoil surface
    is its y=0 vertex line (of the first z-slice in 3D)."""
    c = np.asarray(top_block_coords)
    if c.shape[0] == 3:
        c = c[:2, 0]
    surface_x = c[0, 0, :]
    jets = []
    for center in JET_CENTERS:
        lo, hi = center - JET_WIDTH / 2, center + JET_WIDTH / 2
        jets.append([int(np.argmin(np.abs(surface_x - lo))),
                     int(np.argmin(np.abs(surface_x - hi)))])
    return jets


def _line_point_distance(o: np.ndarray, d: np.ndarray, p) -> np.ndarray:
    """Distance from point p to the lines (origin o, direction d); (2,N)."""
    num = np.abs(d[0] * (o[1] - p[1]) - (o[0] - p[0]) * d[1])
    return num / np.sqrt(d[0] ** 2 + d[1] ** 2)


def _front_corner_split(normals_front: np.ndarray, half_height: float,
                        front_x_width: float, attack_angle_deg: float):
    """Indices (within the nose segment) where the front block's outer
    boundary turns the domain corners."""
    ang = 180.0 - np.rad2deg(np.arctan2(normals_front[1], normals_front[0]))
    ang = np.where(ang < 180.0, ang, ang - 360.0) - attack_angle_deg
    corner = np.rad2deg(np.arctan2(half_height, front_x_width))
    upper = ang > 0
    closest_top = int(np.argmin(np.abs(ang[upper] - corner)))
    closest_bot = int(np.argmin(np.abs(ang[~upper] + corner)))
    return closest_top, int(upper.sum()) + closest_bot


def make_airfoil_domain(
    ndims: int,
    H: float,
    L: float,
    vel_in: float,
    attack_angle_deg: float,
    viscosity: float,
    tail_grow_mul: float,
    normal_res: int = 96,
    dtype=None,
    device=None,
    res_z: int | None = None,
):
    """Build the 6-block airfoil domain on ``device`` (3D: extruded over
    ``res_z`` cells spanning ``[-H/2, H/2]``); returns ``(builder, info)``."""
    if ndims == 3 and not res_z:
        raise ValueError("a 3D airfoil domain needs res_z >= 1")
    offset_left = 1.5
    front_x_width = 0.5
    ghh = H / 2

    normal_base = 0.97
    nw = geo.make_weights_exp(normal_res - 1, normal_base, "START")
    nwr = geo.make_weights_exp(normal_res - 1, normal_base, "END")

    af = read_airfoil(attack_angle_deg)  # (2, N): TE -> top -> LE -> bot -> TE
    n_af = af.shape[1]

    # extended polyline for central-difference surface normals
    end_spacing = np.linalg.norm(af[:, 1] - af[:, 0])
    end_ext = af[:, :1] + np.array([[end_spacing], [0.0]])
    ext = np.concatenate([end_ext, af, end_ext], axis=1)
    sp2 = ext[:, 2:] - ext[:, :-2]
    normals = np.stack([sp2[1], -sp2[0]])
    normals = normals / np.linalg.norm(normals, axis=0, keepdims=True)

    # wake cell sizes grow geometrically from the finest surface cell
    seg = np.linalg.norm(ext[:, 1:] - ext[:, :-1], axis=0)
    min_size = float(seg.min())
    tail_sizes = [min_size]
    tail_dist = min_size
    while tail_dist < ghh:
        tail_sizes.append(tail_sizes[-1] * tail_grow_mul)
        tail_dist += tail_sizes[-1]
    tail_weights = np.concatenate([[0.0], np.cumsum(tail_sizes) / tail_dist])
    tail_res_x = len(tail_weights)

    # split the surface into top / front(nose) / bottom segments where the
    # surface normals aim at the upper/lower-left domain corners
    half = n_af // 2
    d_top = _line_point_distance(af[:, :half], normals[:, :half], (0.0, ghh))
    min_d_top_idx = int(np.argmin(d_top))
    d_bot = _line_point_distance(af[:, half:], normals[:, half:], (0.0, -ghh))
    min_d_bot_idx = int(np.argmin(d_bot)) + half

    len_bot = (n_af - 1 - min_d_bot_idx) + 1
    nose = slice(min_d_top_idx + 1, min_d_bot_idx)
    upper_corner_idx, lower_corner_idx = _front_corner_split(
        normals[:, nose], ghh, front_x_width, attack_angle_deg)
    upper_corner_idx += 7
    lower_corner_idx += 7

    top_slice = slice(0, len_bot + upper_corner_idx + 3)
    front_slice = slice(len_bot + upper_corner_idx + 2,
                        len_bot + lower_corner_idx + 3)
    bot_slice = slice(len_bot + lower_corner_idx + 2, None)

    af_top = af[:, top_slice][:, ::-1]      # leading -> trailing, y > 0
    af_front = af[:, front_slice][:, ::-1]  # bottom -> top around the nose
    af_bot = af[:, bot_slice]               # leading -> trailing, y < 0
    res_top = af_top.shape[1]
    res_front = af_front.shape[1]
    res_bot = af_bot.shape[1]

    start_top, end_top = af_top[:, 0], af_top[:, -1]
    start_bot, end_bot = af_bot[:, 0], af_bot[:, -1]

    def border(line):  # (2, N) -> (N, 2)
        return np.moveaxis(np.asarray(line), 0, 1)

    grid_left = geo.generate_grid_vertices_2d(
        (res_front, int(0.75 * normal_res)),
        [(-offset_left, -ghh), (-front_x_width, -ghh),
         (-offset_left, ghh), (-front_x_width, ghh)],
    )
    grid_top = geo.generate_grid_vertices_2d(
        (normal_res, res_top),
        [tuple(start_top), tuple(end_top),
         (-front_x_width, ghh), (end_top[0], ghh)],
        [None, None, border(af_top), None],
        x_weights=nwr,
    )
    grid_front = geo.generate_grid_vertices_2d(
        (res_front, normal_res),
        [(-front_x_width, -ghh), tuple(start_bot),
         (-front_x_width, ghh), tuple(start_top)],
        [None, border(af_front), None, None],
        y_weights=nw,
    )
    grid_bot = geo.generate_grid_vertices_2d(
        (normal_res, res_bot),
        [(-front_x_width, -ghh), (end_bot[0], -ghh),
         tuple(start_bot), tuple(end_bot)],
        [None, None, None, border(af_bot)],
        x_weights=nw,
    )
    grid_tail_upper = geo.generate_grid_vertices_2d(
        (normal_res, tail_res_x),
        [tuple(end_top), (L, end_top[1]),
         (end_top[0], ghh), (L, ghh)],
        x_weights=nwr, y_weights=tail_weights,
    )
    grid_tail_lower = geo.generate_grid_vertices_2d(
        (normal_res, tail_res_x),
        [(end_bot[0], -ghh), (L, -ghh),
         tuple(end_bot), (L, end_bot[1])],
        x_weights=nw, y_weights=tail_weights,
    )

    grids = [grid_left, grid_front, grid_top, grid_bot,
             grid_tail_upper, grid_tail_lower]
    if ndims == 3:
        grids = [geo.extrude_grid_z(g, res_z=res_z, start_z=-H / 2,
                                    end_z=H / 2, exp_base=1) for g in grids]

    dom = DomainBuilder(ndims=ndims, viscosity=viscosity, scalar_channels=0,
                        name="AirfoilDomain", dtype=dtype, device=device)

    left = dom.create_block(grids[0], name="LeftBlock")
    front = dom.create_block(grids[1], name="AirfoilFront")
    top = dom.create_block(grids[2], name="AirfoilTop")
    bot = dom.create_block(grids[3], name="AirfoilBot")
    tail_u = dom.create_block(grids[4], name="TailUpper")
    tail_l = dom.create_block(grids[5], name="TailLower")

    inflow = get_inflow_profile(h=H, res_y=res_front - 1, n_dims=ndims,
                                res_z=res_z if ndims == 3 else None) * vel_in
    left.close_boundary("-x", velocity=inflow)

    # channel walls
    left.close_boundary("+y")
    left.close_boundary("-y")
    top.close_boundary("+y")
    tail_u.close_boundary("+y")
    tail_l.close_boundary("-y")

    # airfoil surfaces
    front.close_boundary("+x")
    top.close_boundary("-y")
    bot.close_boundary("+y")

    # outflow, initialized with the free-stream velocity (per-cell varying)
    out_shape = ((ndims, normal_res - 1, 1) if ndims == 2
                 else (ndims, res_z, normal_res - 1, 1))
    outflow = np.zeros(out_shape)
    outflow[0] = vel_in
    tail_u.close_boundary("+x", velocity=outflow)
    tail_l.close_boundary("+x", velocity=outflow.copy())

    # untouched z faces stay periodic
    LB, F, T, B, TU, TL = range(6)
    if ndims == 2:
        dom.connect_blocks(LB, "+x", F, "-x", "-y")
        dom.connect_blocks(F, "+y", T, "-x", "+y")
        dom.connect_blocks(F, "-y", B, "-x", "-y")
        dom.connect_blocks(T, "+x", TU, "-x", "-y")
        dom.connect_blocks(B, "+x", TL, "-x", "-y")
        # the wake cut: the two tail blocks meet with the along-cut axis
        # reversed
        dom.connect_blocks(TU, "-y", TL, "+y", "-x")
    else:
        dom.connect_blocks(LB, "+x", F, "-x", "-y", "-z")
        dom.connect_blocks(F, "+y", T, "-x", "-z", "+y")
        dom.connect_blocks(F, "-y", B, "-x", "-z", "-y")
        dom.connect_blocks(T, "+x", TU, "-x", "-y", "-z")
        dom.connect_blocks(B, "+x", TL, "-x", "-y", "-z")
        # the wake cut reverses x and keeps z
        dom.connect_blocks(TU, "-y", TL, "+y", "-z", "-x")

    info = {
        "block_order": AIRFOIL_BLOCKS,
        "x_min": -offset_left,
        "x_max": L,
        "y_min": -ghh,
        "y_max": ghh,
        "out_faces": ((TU, 1), (TL, 1)),  # (block, "+x")
        "airfoil_coords": af,
        "normal_res": normal_res,
    }
    return dom, info
