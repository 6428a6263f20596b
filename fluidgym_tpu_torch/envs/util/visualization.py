"""3D rendering helpers on host arrays: iso-surfaces and voxels
(counterpart of ``fluidgym_tpu/envs/util/visualization.py``).

matplotlib is imported inside each function (the card's machine has none).
scikit-image's marching cubes draws the iso-surface where it is installed;
otherwise the surface is the set of iso-crossing cells drawn as a coloured
3D scatter, so 3D rendering works without it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["render_3d_iso", "render_3d_voxels"]

DEFAULT_VIEW_KWARGS = {"elev": 20, "azim": 45}


def _fig_to_array(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def _iso_crossing_points(field: np.ndarray, level: float):
    """Cell centers where |field| crosses the iso level (fallback surface)."""
    f = np.abs(field) >= level
    # surface = inside cells with at least one outside neighbor
    surface = f.copy()
    interior = f.copy()
    for ax in range(3):
        interior &= np.roll(f, 1, axis=ax) & np.roll(f, -1, axis=ax)
    surface &= ~interior
    return np.argwhere(surface)


def render_3d_iso(
    iso_field: np.ndarray,
    iso: float | list[float],
    color_range: tuple[float, float],
    output_path: Path | None = None,
    color_field: np.ndarray | None = None,
    colormap: str = "rainbow",
    extent=((0.0, 1.0), (0.0, 1.0), (0.0, 1.0)),
    figsize: tuple[int, int] = (10, 8),
    view_kwargs: dict | None = None,
) -> np.ndarray:
    """Iso-surface render of a 3D field ``(X, Y, Z)``; returns an RGB
    array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import Normalize

    if iso_field.ndim != 3:
        raise ValueError("Field must have shape (X, Y, Z).")
    if color_field is not None and iso_field.shape != color_field.shape:
        raise ValueError("`color_field` must have the same shape as `iso_field`.")
    if not isinstance(iso, (list, tuple)):
        iso = [iso]

    # swap y and z so that z is "up" in the plot
    iso_field = np.transpose(iso_field, (0, 2, 1))
    if color_field is not None:
        color_field = np.transpose(color_field, (0, 2, 1))
    extent = ((extent[0][0], extent[0][1]),
              (extent[2][0], extent[2][1]),
              (extent[1][0], extent[1][1]))
    spacing = tuple((extent[d][1] - extent[d][0]) / iso_field.shape[d]
                    for d in range(3))

    norm = Normalize(vmin=color_range[0], vmax=color_range[1])
    cmap = plt.get_cmap(colormap)

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")

    try:
        from skimage import measure  # optional

        for level in iso:
            from mpl_toolkits.mplot3d.art3d import Poly3DCollection

            verts, faces, _, _ = measure.marching_cubes(
                np.abs(iso_field), level=level, spacing=spacing,
                allow_degenerate=True)
            if color_field is None:
                face_colors = cmap(norm(level))
            else:
                ijk = (verts / np.asarray(spacing)).astype(int)
                ijk = np.minimum(ijk, np.asarray(iso_field.shape) - 1)
                vals = color_field[ijk[:, 0], ijk[:, 1], ijk[:, 2]]
                face_colors = cmap(norm(vals[faces].mean(axis=1)))
            for d in range(3):
                verts[:, d] += extent[d][0]
            mesh = Poly3DCollection(verts[faces], alpha=0.7)
            mesh.set_facecolor(face_colors)
            ax.add_collection3d(mesh)
    except ImportError:
        for level in iso:
            pts = _iso_crossing_points(iso_field, level)
            if len(pts) == 0:
                continue
            coords = pts * np.asarray(spacing) + np.asarray(
                [e[0] for e in extent])
            if color_field is None:
                colors = cmap(norm(level))
            else:
                vals = color_field[pts[:, 0], pts[:, 1], pts[:, 2]]
                colors = cmap(norm(vals))
            ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2],
                       c=colors, s=2, alpha=0.5, linewidths=0)

    ax.invert_xaxis()
    ax.invert_yaxis()
    ax.set_axis_off()
    ax.view_init(**{**DEFAULT_VIEW_KWARGS, **(view_kwargs or {})})
    ax.set_xlim(extent[0][1], extent[0][0])
    ax.set_ylim(extent[1][0], extent[1][1])
    ax.set_zlim(extent[2][0], extent[2][1])
    ax.set_box_aspect(tuple(e[1] - e[0] for e in extent))
    fig.subplots_adjust(left=-0.1, right=1.07, top=1.1, bottom=-0.1)

    if output_path is not None:
        plt.savefig(output_path, dpi=150, bbox_inches="tight")
    buf = _fig_to_array(fig)
    plt.close(fig)
    return buf


def render_3d_voxels(
    field: np.ndarray,
    ds: int,
    field_range: tuple[float, float],
    output_path: Path | None = None,
    colormap: str = "viridis",
    threshold: float = 0.5,
    figsize: tuple[int, int] = (10, 8),
    view_kwargs: dict | None = None,
) -> np.ndarray:
    """Downsampled voxel render of a 3D scalar field; returns an RGB
    array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import Normalize

    f = field[::ds, ::ds, ::ds]
    norm = Normalize(vmin=field_range[0], vmax=field_range[1])
    cmap = plt.get_cmap(colormap)
    filled = norm(f) > threshold
    colors = cmap(norm(f))
    colors[..., 3] = 0.6

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(111, projection="3d")
    ax.voxels(filled, facecolors=colors, edgecolor=None)
    ax.set_axis_off()
    ax.view_init(**{**DEFAULT_VIEW_KWARGS, **(view_kwargs or {})})
    if output_path is not None:
        plt.savefig(output_path, dpi=150, bbox_inches="tight")
    buf = _fig_to_array(fig)
    plt.close(fig)
    return buf
