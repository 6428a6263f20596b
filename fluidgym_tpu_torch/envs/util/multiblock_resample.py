"""Multi-block curvilinear -> uniform grid or point resampling by
precomputed gathers (counterpart of
``fluidgym_tpu/envs/util/multiblock_resample.py``).

The grid geometry is static per env config, so an inverse-distance plan (k
nearest source cell centres over ALL blocks per target) is built once on
the host with scipy's KD-tree; each call is then a gather and a weighted
sum on the env's device.  Targets with no source cell within ``max_dist``
(e.g. inside the cylinder) get weight zero and resolve to 0.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_multiblock_plan", "make_multiblock_point_plan"]


def _point_weights(pts: np.ndarray, targets: np.ndarray, k: int,
                   max_dist_factor: float):
    """k-NN inverse-distance-squared weights of ``targets`` against source
    points ``pts``; targets with no source within ``max_dist`` get zero."""
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(pts).query(targets, k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    max_dist = max_dist_factor * np.median(dist[:, 0]) + 1e-12
    w = 1.0 / np.maximum(dist, 1e-10) ** 2
    w[dist[:, 0:1] > max_dist * np.ones_like(dist)] = 0.0
    w = w * (dist[:, 0] <= max_dist)[:, None]
    norm = w.sum(axis=1, keepdims=True)
    return idx, w / np.where(norm == 0, 1.0, norm)


def _gather_fn(idx: np.ndarray, w: np.ndarray, ndims: int, out_shape, device):
    """``fields -> (C?, *out_shape)``: the weighted gather over the
    concatenation of all blocks' cells."""
    idx_t = torch.as_tensor(idx.astype(np.int64).T, device=device)   # (k, nt)
    w_t = torch.as_tensor(w.astype(np.float32).T, device=device)     # (k, nt)

    def sample(fields):
        lead = fields[0].shape[:fields[0].dim() - ndims]
        flat = torch.cat([f.reshape(lead + (-1,)) for f in fields], dim=-1)
        out = torch.sum(flat[..., idx_t] * w_t.to(flat.dtype), dim=-2)
        return out.reshape(lead + tuple(out_shape))

    return sample


def make_multiblock_plan(centers_list: list[np.ndarray],
                         out_shape_xyz: tuple[int, ...],
                         bounds_lower: tuple[float, ...],
                         bounds_upper: tuple[float, ...], k: int = 4,
                         max_dist_factor: float = 2.0, device=None):
    """Resample plan to a uniform grid.  ``centers_list``: per-block cell
    centres ``(ndims, *spatial)``; ``out_shape_xyz`` in physical (x, y[, z])
    order.  Returns ``resample(fields) -> (C?, *out_shape)``."""
    ndims = len(out_shape_xyz)
    pts = np.concatenate([c.reshape(ndims, -1).T for c in centers_list], axis=0)
    axes = [bounds_lower[d] + (np.arange(out_shape_xyz[d]) + 0.5)
            * (bounds_upper[d] - bounds_lower[d]) / out_shape_xyz[d]
            for d in range(ndims)]
    mesh = np.meshgrid(*axes[::-1], indexing="ij")  # [z][y][x]
    targets = np.stack([m.ravel() for m in mesh[::-1]], axis=-1)
    out_shape = tuple(int(out_shape_xyz[ndims - 1 - i]) for i in range(ndims))
    idx, w = _point_weights(pts, targets, k, max_dist_factor)
    return _gather_fn(idx, w, ndims, out_shape, device)


def make_multiblock_point_plan(centers_list: list[np.ndarray],
                               points: np.ndarray, k: int = 4,
                               max_dist_factor: float = 2.0, device=None):
    """Gather plan for arbitrary physical target points ``(n, ndims)``.
    Returns ``sample(fields) -> (C?, n)`` (used for the sensor
    observations)."""
    ndims = centers_list[0].shape[0]
    pts = np.concatenate([c.reshape(ndims, -1).T for c in centers_list], axis=0)
    idx, w = _point_weights(pts, np.asarray(points, np.float64), k,
                            max_dist_factor)
    return _gather_fn(idx, w, ndims, (idx.shape[0],), device)
