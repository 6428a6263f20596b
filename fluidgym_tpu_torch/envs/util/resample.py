"""Block-to-uniform-grid resampling for observations (counterpart of
``fluidgym_tpu/envs/util/resample.py``, rectilinear single-block plans).

Grid geometry is static per env config, so interpolation indices and
weights are computed once on the host; each call is a chain of per-axis
gathers and linear interpolation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["RectilinearResamplePlan", "make_rectilinear_plan"]


@dataclass(frozen=True)
class _AxisPlan:
    idx0: tuple[int, ...]
    idx1: tuple[int, ...]
    w: tuple[float, ...]


@dataclass(frozen=True)
class RectilinearResamplePlan:
    """Precomputed per-axis linear interpolation plan; ``axes`` are ordered
    like the array's spatial axes ([z, ]y, x)."""

    axes: tuple[_AxisPlan, ...]
    out_shape: tuple[int, ...]  # array-ordered ([z, ]y, x)
    _device_cache: dict = field(default_factory=dict, compare=False,
                                hash=False, repr=False)

    def _tensors(self, device, dtype):
        key = (device, dtype)
        if key not in self._device_cache:
            self._device_cache[key] = [
                (torch.tensor(p.idx0, device=device),
                 torch.tensor(p.idx1, device=device),
                 torch.tensor(p.w, dtype=dtype, device=device))
                for p in self.axes]
        return self._device_cache[key]

    def __call__(self, field_: torch.Tensor) -> torch.Tensor:
        """Resample ``field (..., *spatial)`` to ``(..., *out_shape)``."""
        ndims = len(self.axes)
        for i, (idx0, idx1, w) in enumerate(
                self._tensors(field_.device, field_.dtype)):
            ax = field_.dim() - ndims + i
            lo = torch.index_select(field_, ax, idx0)
            hi = torch.index_select(field_, ax, idx1)
            shape = [1] * field_.dim()
            shape[ax] = w.shape[0]
            w = w.reshape(shape)
            field_ = lo * (1 - w) + hi * w
        return field_


def _axis_plan(src_centers: np.ndarray, lo: float, hi: float, n_out: int) -> _AxisPlan:
    """Linear interpolation plan from monotone source centers to ``n_out``
    uniform target cell centers spanning [lo, hi] (clamped extrapolation)."""
    t = (np.arange(n_out) + 0.5) / n_out
    targets = lo + (hi - lo) * t
    src = np.asarray(src_centers, np.float64)
    i1 = np.searchsorted(src, targets)
    i1 = np.clip(i1, 1, len(src) - 1)
    i0 = i1 - 1
    denom = src[i1] - src[i0]
    w = np.clip((targets - src[i0]) / np.where(denom == 0, 1.0, denom), 0.0, 1.0)
    return _AxisPlan(idx0=tuple(int(v) for v in i0),
                     idx1=tuple(int(v) for v in i1),
                     w=tuple(float(v) for v in w))


def make_rectilinear_plan(vertex_coords: np.ndarray,
                          out_shape_xyz: tuple[int, ...]) -> RectilinearResamplePlan:
    """Resample plan for a rectilinear block: ``vertex_coords (ndims,
    *vertex_shape)``; ``out_shape_xyz`` in physical (x, y[, z]) order."""
    coords = np.asarray(vertex_coords, np.float64)
    ndims = coords.shape[0]
    if len(out_shape_xyz) != ndims:
        raise ValueError("out_shape must have one entry per dimension")
    axes = []
    for i in range(ndims):
        d = ndims - 1 - i
        ax = coords.ndim - 1 - d
        idx = [0] * coords.ndim
        idx[0] = d
        idx[ax] = slice(None)
        line = coords[tuple(idx)]
        centers = 0.5 * (line[1:] + line[:-1])
        axes.append(_axis_plan(centers, float(line[0]), float(line[-1]),
                               int(out_shape_xyz[d])))
    out_shape = tuple(int(out_shape_xyz[ndims - 1 - i]) for i in range(ndims))
    return RectilinearResamplePlan(axes=tuple(axes), out_shape=out_shape)
