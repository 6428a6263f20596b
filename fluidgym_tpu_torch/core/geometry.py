"""Grid generation and curvilinear metric computation (host-side, numpy).

The port's own copy of ``fluidgym_tpu/core/geometry.py``: pure numpy, no
framework dependency, so both packages build bit-identical grids and metric
transforms from the same parameters.

* weight functions / 2D vertex generation / wall-refined grids / z-extrusion
  (PICT ``shapes.py``);
* cell metric transforms (M, M^-1, det) from vertex coordinates: columns of
  M are differences of opposite face-center coordinates (PICT
  ``grid_gen.cu`` ``k_CoordsToTransforms``).

Conventions
-----------
* Vertex coordinate arrays have shape ``(ndims, *vertex_shape)`` with spatial
  axes ordered ``[z, ]y, x`` (x fastest / last) and channel order ``x, y[, z]``.
* Cell arrays have shape ``(*spatial)`` with the same ordering.
* Physical axis ``d`` (0=x, 1=y, 2=z) lives on array axis ``-(d+1)``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "make_weights_exp",
    "make_weights_exp_global",
    "make_weights_cos",
    "generate_grid_vertices_2d",
    "make_wall_refined_ortho_grid",
    "make_uniform_grid",
    "extrude_grid_z",
    "coords_to_transforms",
    "cell_centers",
    "is_orthogonal",
    "make_torus_2d",
]


# ---------------------------------------------------------------------------
# 1D vertex weight distributions (reference shapes.py:398-448)
# ---------------------------------------------------------------------------

def make_weights_exp(res: int, base: float, refinement: str) -> np.ndarray:
    """Cumulative vertex weights in [0, 1] from geometrically growing cells.

    ``refinement``: "START" refines toward the low end, "END" toward the high
    end, "BOTH" toward both walls.
    """
    exponents = list(range(res))
    if refinement == "END":
        exponents.reverse()
    elif refinement == "BOTH":
        exponents = exponents[: res // 2] + list(reversed(exponents))[res // 2 :]
    elif refinement != "START":
        raise ValueError(f"unknown refinement {refinement!r}")
    sizes = np.asarray([float(base) ** e for e in exponents], dtype=np.float64)
    w = np.concatenate([[0.0], np.cumsum(sizes) / sizes.sum()])
    return w


def make_weights_exp_global(res: int, global_scale: float, refinement: str) -> np.ndarray:
    """Exp weights parameterized by total first/last cell-size ratio."""
    resolution = res // 2 if refinement == "BOTH" else res
    base = float(global_scale) ** (1.0 / (resolution - 1))
    return make_weights_exp(res, base, refinement)


def make_weights_cos(res: int, refinement: str) -> np.ndarray:
    """Cosine-spaced vertex weights (used for channel-flow wall refinement)."""
    if refinement == "START":
        c_start, c_end, n_mul, n_add = 0.0, np.pi / 2, -1.0, 1.0
    elif refinement == "END":
        c_start, c_end, n_mul, n_add = np.pi / 2, np.pi, -1.0, 0.0
    elif refinement == "BOTH":
        c_start, c_end, n_mul, n_add = 0.0, np.pi, -0.5, 0.5
    else:
        raise ValueError(f"unknown refinement {refinement!r}")
    t = np.arange(res + 1, dtype=np.float64) / res
    return np.cos(c_start * (1 - t) + c_end * t) * n_mul + n_add


# ---------------------------------------------------------------------------
# 2D vertex grids (reference shapes.py:450-583)
# ---------------------------------------------------------------------------

def generate_grid_vertices_2d(
    res_yx: tuple[int, int],
    corner_vertices,
    border_vertices=None,
    x_weights=None,
    y_weights=None,
) -> np.ndarray:
    """Transfinite interpolation of a 2D vertex grid from corners/borders.

    Parameters mirror the reference ``generate_grid_vertices_2D``:
    ``res_yx`` is the VERTEX resolution ``[ny+1, nx+1]``; corners are ordered
    ``[-x-y, +x-y, -x+y, +x+y]`` as (x, y) tuples; ``border_vertices`` is an
    optional list of 4 polylines ``[-x, +x, -y, +y]`` (each an array of (x, y)
    points of matching resolution); weights are per-axis cumulative vertex
    positions in [0, 1] (uniform if None).

    Returns array of shape ``(2, ny+1, nx+1)``.
    """
    ny, nx = int(res_yx[0]), int(res_yx[1])
    corners = np.asarray(corner_vertices, dtype=np.float64)  # (4, 2)
    if corners.shape != (4, 2):
        raise ValueError("corner_vertices must be 4 (x,y) tuples")

    ty = np.asarray(x_weights if x_weights is not None else np.linspace(0, 1, ny))
    tx = np.asarray(y_weights if y_weights is not None else np.linspace(0, 1, nx))
    if len(tx) != nx or len(ty) != ny:
        raise ValueError("weight lengths must match vertex resolution")

    def _border(idx, c0, c1, n):
        if border_vertices is not None and border_vertices[idx] is not None:
            b = np.asarray(border_vertices[idx], dtype=np.float64)
            if b.shape != (n, 2):
                raise ValueError(f"border {idx} must have shape ({n}, 2)")
            return b
        t = (ty if idx < 2 else tx)[:, None]
        return corners[c0] * (1 - t) + corners[c1] * t

    # borders: [-x (c0->c2), +x (c1->c3), -y (c0->c1), +y (c2->c3)]
    b_xm = _border(0, 0, 2, ny)
    b_xp = _border(1, 1, 3, ny)
    b_ym = _border(2, 0, 1, nx)
    b_yp = _border(3, 2, 3, nx)

    u = tx[None, :, None]  # along x
    v = ty[:, None, None]  # along y
    # transfinite interpolation (Coons patch)
    grid = (
        (1 - u) * b_xm[:, None, :]
        + u * b_xp[:, None, :]
        + (1 - v) * b_ym[None, :, :]
        + v * b_yp[None, :, :]
        - (1 - u) * (1 - v) * corners[0][None, None, :]
        - u * (1 - v) * corners[1][None, None, :]
        - (1 - u) * v * corners[2][None, None, :]
        - u * v * corners[3][None, None, :]
    )  # (ny, nx, 2)
    return np.moveaxis(grid, -1, 0)  # (2, ny, nx)


def make_wall_refined_ortho_grid(
    res_x: int,
    res_y: int,
    corner_lower=(0.0, 0.0),
    corner_upper=(1.0, 1.0),
    wall_refinement=(),
    base: float | tuple[float, float] = 1.05,
) -> np.ndarray:
    """Rectilinear grid with exponential wall refinement.

    Matches reference ``shapes.make_wall_refined_ortho_grid`` (shapes.py:585):
    ``wall_refinement`` lists walls among {-x, +x, -y, +y}; ``base`` is the
    geometric growth factor (1.0 => uniform).  Returns ``(2, res_y+1, res_x+1)``.
    """
    if not isinstance(base, (list, tuple)):
        base = (base, base)
    corners = [
        tuple(corner_lower),
        (corner_upper[0], corner_lower[1]),
        (corner_lower[0], corner_upper[1]),
        tuple(corner_upper),
    ]

    def _w(res, b, lo, hi):
        if b == 1.0 or (lo not in wall_refinement and hi not in wall_refinement):
            return None
        if lo in wall_refinement and hi in wall_refinement:
            return make_weights_exp(res, base=b, refinement="BOTH")
        if lo in wall_refinement:
            return make_weights_exp(res, base=b, refinement="START")
        return make_weights_exp(res, base=b, refinement="END")

    # naming follows the reference: y_weights vary along x, x_weights along y
    y_w = _w(res_x, base[0], "-x", "+x")
    x_w = _w(res_y, base[1], "-y", "+y")
    return generate_grid_vertices_2d(
        (res_y + 1, res_x + 1), corners, None, x_weights=x_w, y_weights=y_w
    )


def make_torus_2d(
    res: int,
    r1: float,
    r2: float,
    start_angle: float,
    angle: float,
    offset=None,
) -> np.ndarray:
    """Annulus-segment grid (reference shapes.make_torus_2D, shapes.py:679).

    ``res``: angular cell resolution; radial resolution is chosen for
    approximately square cells growing linearly with radius.  Angles in
    degrees, ``start_angle=0`` on the +x axis, positive angle counter-
    clockwise.  Returns ``(2, ny+1, nx+1)`` with x along the angle and y along
    the radius.
    """
    if res <= 1 or r1 <= 0 or r2 <= r1:
        raise ValueError("invalid torus parameters")
    start_angle = start_angle % 360
    x = res + 1
    rad_step = np.deg2rad(angle / (x - 1))
    start_rad = np.deg2rad(start_angle)
    end_rad = start_rad + np.deg2rad(angle)
    corners = [
        (np.cos(start_rad) * r1, np.sin(start_rad) * r1),
        (np.cos(end_rad) * r1, np.sin(end_rad) * r1),
        (np.cos(start_rad) * r2, np.sin(start_rad) * r2),
        (np.cos(end_rad) * r2, np.sin(end_rad) * r2),
    ]
    lower_border = np.asarray(
        [(np.cos(start_rad + rad_step * i) * r1,
          np.sin(start_rad + rad_step * i) * r1) for i in range(x)]
    )
    upper_border = np.asarray(
        [(np.cos(start_rad + rad_step * i) * r2,
          np.sin(start_rad + rad_step * i) * r2) for i in range(x)]
    )

    # roughly square cells, width growing linearly with radius
    r = r2 - r1
    sizes = []
    d = r1
    width_scale = 2 * np.pi / x * (abs(angle) / 360)
    while d < r2:
        width = d * width_scale
        sizes.append(width)
        d += width
    scale = (d - r1) / r
    sizes = [w / scale for w in sizes]
    y = len(sizes) + 1
    x_weights = np.concatenate([[0.0], np.cumsum(sizes) / r])

    grid = generate_grid_vertices_2d(
        (y, x), corners, [None, None, lower_border, upper_border],
        x_weights=x_weights,
    )
    if offset is not None:
        grid = grid + np.asarray(offset, np.float64).reshape(2, 1, 1)
    return grid


def make_uniform_grid(res, lower, upper) -> np.ndarray:
    """Uniform rectilinear grid. ``res``/``lower``/``upper`` are per physical
    axis (x, y[, z]). Returns ``(d, *vertex_shape)`` with z,y,x axis order."""
    res = tuple(int(r) for r in res)
    d = len(res)
    axes = [np.linspace(lower[i], upper[i], res[i] + 1) for i in range(d)]
    # meshgrid in z,y,x order; component order x,y,z
    mesh = np.meshgrid(*axes[::-1], indexing="ij")  # [z][y][x] arrays
    return np.stack(mesh[::-1], axis=0)


def extrude_grid_z(
    grid: np.ndarray,
    res_z: int,
    start_z: float = 0.0,
    end_z: float = 1.0,
    weights_z=None,
    exp_base: float | None = None,
) -> np.ndarray:
    """Extrude a 2D vertex grid along z (reference shapes.py:641).

    Default (no ``weights_z``, no ``exp_base``): UNIFORM z spacing, matching
    the reference; pass ``exp_base`` explicitly for exponential BOTH-wall
    z refinement.  Returns ``(3, res_z+1, ny+1, nx+1)``.
    """
    if grid.ndim != 3 or grid.shape[0] != 2:
        raise ValueError("grid must have shape (2, ny+1, nx+1)")
    if weights_z is not None:
        w = np.asarray(weights_z, dtype=np.float64)
        if len(w) != res_z + 1:
            raise ValueError(
                f"weights_z must have length res_z+1={res_z + 1}, "
                f"got {len(w)}")
    elif exp_base and exp_base != 1:
        w = make_weights_exp(res_z, base=exp_base, refinement="BOTH")
    else:
        w = np.linspace(0.0, 1.0, res_z + 1)
    z = start_z + (end_z - start_z) * w  # (nz+1,)
    nz1 = len(z)
    xy = np.broadcast_to(grid[:, None], (2, nz1) + grid.shape[1:])
    zz = np.broadcast_to(
        z[:, None, None], (nz1,) + grid.shape[1:]
    )[None]
    return np.concatenate([xy, zz], axis=0)


# ---------------------------------------------------------------------------
# Metric transforms (reference grid_gen.cu:299 k_CoordsToTransforms)
# ---------------------------------------------------------------------------

def _face_center_delta(coords: np.ndarray, d: int) -> np.ndarray:
    """Per-cell difference of opposite face-center coordinates along physical
    axis ``d``; returns ``(ndims, *spatial)`` = column d of M."""
    ndims = coords.shape[0]
    ax = coords.ndim - 1 - d  # array axis for physical axis d
    upper = np.take(coords, range(1, coords.shape[ax]), axis=ax)
    lower = np.take(coords, range(0, coords.shape[ax] - 1), axis=ax)
    delta = upper - lower  # vertex-resolution along other axes
    # average over the remaining vertex axes to get face centers
    for od in range(ndims):
        if od == d:
            continue
        oax = coords.ndim - 1 - od
        hi = np.take(delta, range(1, delta.shape[oax]), axis=oax)
        lo = np.take(delta, range(0, delta.shape[oax] - 1), axis=oax)
        delta = 0.5 * (hi + lo)
    return delta


def coords_to_transforms(coords: np.ndarray):
    """Compute per-cell metric tensors from vertex coordinates.

    Returns ``(M, Minv, det)`` with shapes ``(*spatial, d, d)``, ``(*spatial,
    d, d)``, ``(*spatial)``; ``M[..., i, k] = dx_i/dxi_k`` via opposite
    face-center differences, exactly as the reference's
    ``CoordsToTransforms`` (grid_gen.cu:299-355).
    """
    ndims = coords.shape[0]
    cols = [np.moveaxis(_face_center_delta(coords, d), 0, -1) for d in range(ndims)]
    M = np.stack(cols, axis=-1)  # (*spatial, i, k)
    det = np.linalg.det(M)
    Minv = np.linalg.inv(M)
    return M, Minv, det


def cell_centers(coords: np.ndarray) -> np.ndarray:
    """Cell centers as the mean of cell corner vertices; ``(d, *spatial)``."""
    ndims = coords.shape[0]
    out = coords
    for d in range(ndims):
        ax = coords.ndim - 1 - d
        hi = np.take(out, range(1, out.shape[ax]), axis=ax)
        lo = np.take(out, range(0, out.shape[ax] - 1), axis=ax)
        out = 0.5 * (hi + lo)
    return out


def is_orthogonal(M: np.ndarray, tol: float = 1e-10) -> bool:
    """True if the metric tensor is diagonal everywhere (rectilinear grid)."""
    d = M.shape[-1]
    off = M * (1.0 - np.eye(d))
    return bool(np.all(np.abs(off) <= tol * (1.0 + np.abs(M).max())))
