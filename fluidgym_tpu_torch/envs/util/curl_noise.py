"""Divergence-free (curl) noise for turbulence seeding (counterpart of
``fluidgym_tpu/envs/util/curl_noise.py``; numpy, the same draws from the
same ``np.random.Generator`` and the same field bit for bit).

A smooth random vector potential from low-wavenumber Fourier modes and its
analytic curl: divergence-free by construction and periodic in all axes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["curl_noise_3d"]


def curl_noise_3d(shape_xyz: tuple[int, int, int], scale: tuple[float, float, float],
                  rng: np.random.Generator, n_modes: int = 24) -> np.ndarray:
    """Periodic divergence-free velocity noise.

    ``shape_xyz`` = (x, y, z) cell resolution; ``scale`` sets the feature
    size per axis (larger scale -> larger structures).  Returns ``(3, z, y,
    x)`` in float64.
    """
    nx, ny, nz = shape_xyz
    # integer wavenumbers, low-frequency band scaled per axis
    kmax = np.maximum(1, (np.asarray([nx, ny, nz]) *
                          np.asarray(scale)).astype(int))
    k = np.stack([rng.integers(-kmax[d], kmax[d] + 1, size=n_modes)
                  for d in range(3)], axis=1).astype(np.float64)  # (m, 3)
    k[np.all(k == 0, axis=1)] = 1.0
    amp = rng.normal(size=(n_modes, 3)) / (1.0 + np.linalg.norm(k, axis=1)[:, None])
    phase = rng.uniform(0, 2 * np.pi, size=n_modes)

    x = (np.arange(nx) + 0.5) / nx
    y = (np.arange(ny) + 0.5) / ny
    z = (np.arange(nz) + 0.5) / nz
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")

    # vector potential A = a sin(th) and its analytic curl
    two_pi = 2 * np.pi
    u = np.zeros((3, nz, ny, nx))
    for m in range(n_modes):
        th = two_pi * (k[m, 0] * X + k[m, 1] * Y + k[m, 2] * Z) + phase[m]
        c = np.cos(th)
        a = amp[m]
        kx, ky, kz = two_pi * k[m]
        # (dAz/dy - dAy/dz, dAx/dz - dAz/dx, dAy/dx - dAx/dy)
        u[0] += (a[2] * ky - a[1] * kz) * c
        u[1] += (a[0] * kz - a[2] * kx) * c
        u[2] += (a[1] * kx - a[0] * ky) * c
    return u
