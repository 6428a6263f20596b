"""Per-field image and raw-array dumps of simulation fields on the host
(counterpart of ``fluidgym_tpu/utils/field_io.py``).

Each field (already resampled to the uniform render grid and copied to the
host) is written as a colormapped PNG, one image per channel, a 3D field as
its three axis mid-slices, and all of them together as one lossless float32
``.npz``.  matplotlib is imported inside the function that draws.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["save_field_png", "save_fields_npz", "save_field_images"]


def save_field_png(field: np.ndarray, path: str | Path, cmap: str = "viridis",
                   vmin: float | None = None, vmax: float | None = None) -> Path:
    """Write one 2D scalar field as a colormapped PNG.  Rows are flipped so
    +y points up in the image."""
    import matplotlib
    import matplotlib.image as mpimg

    field = np.asarray(field, np.float64)
    if field.ndim != 2:
        raise ValueError(f"save_field_png needs a 2D field, got {field.shape}")
    lo = np.nanmin(field) if vmin is None else vmin
    hi = np.nanmax(field) if vmax is None else vmax
    norm = np.clip((field - lo) / (hi - lo + 1e-30), 0.0, 1.0)
    rgba = matplotlib.colormaps[cmap](norm[::-1])
    path = Path(str(path) + ".png")  # with_suffix truncates at dots in ids
    path.parent.mkdir(parents=True, exist_ok=True)
    mpimg.imsave(path, rgba)
    return path


def save_fields_npz(fields: dict[str, np.ndarray], path: str | Path) -> Path:
    """Lossless float32 dump of named fields."""
    path = Path(str(path) + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, **{k: np.asarray(v, np.float32) for k, v in fields.items()})
    return path


def _slices_2d(field: np.ndarray):
    """2D views of a field for imaging: identity in 2D, axis mid-slices in
    3D."""
    if field.ndim == 2:
        yield "", field
    elif field.ndim == 3:
        nz, ny, nx = field.shape
        yield "_xy", field[nz // 2]
        yield "_xz", field[:, ny // 2]
        yield "_yz", field[:, :, nx // 2]
    else:
        raise ValueError(f"expected 2D/3D field, got shape {field.shape}")


#: field names whose leading axis is a channel axis (velocity components,
#: passive-scalar channels) rather than a spatial axis
CHANNEL_FIELDS = ("velocity", "scalar", "temperature", "velocity_source")


def save_field_images(fields: dict[str, np.ndarray], output_path: str | Path,
                      prefix: str = "fields", cmap: str = "viridis",
                      cmaps: dict[str, str] | None = None,
                      channel_fields: tuple[str, ...] = CHANNEL_FIELDS,
                      ) -> list[Path]:
    """Dump named fields as PNGs (per channel, per 3D mid-slice) plus one
    lossless npz.

    ``fields``: name -> array ``(*spatial)``, or ``(C, *spatial)`` for names
    in ``channel_fields`` (which get one image per channel).  Returns the
    written paths.
    """
    output_path = Path(output_path)
    written = []
    flat: dict[str, np.ndarray] = {}
    for name, arr in fields.items():
        arr = np.asarray(arr)
        if name in channel_fields and arr.ndim >= 3:
            channels = [(f"{name}{c}", arr[c]) for c in range(arr.shape[0])]
        else:
            channels = [(name, arr)]
        for cname, comp in channels:
            flat[cname] = comp
            for suffix, sl in _slices_2d(comp):
                written.append(save_field_png(
                    sl, output_path / f"{prefix}_{cname}{suffix}",
                    cmap=(cmaps or {}).get(name, cmap)))
    written.append(save_fields_npz(flat, output_path / f"{prefix}_raw"))
    return written
