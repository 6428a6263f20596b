"""Flow profile generators (counterpart of
``fluidgym_tpu/envs/util/profiles.py``; numpy, host side)."""

from __future__ import annotations

import numpy as np

__all__ = ["get_jet_profile", "get_inflow_profile"]


def get_jet_profile(h: int) -> np.ndarray:
    """Parabolic jet profile over ``h`` cells, max-normalized to 1."""
    y = np.linspace(-h / 2, h / 2, h)
    profile = 6 * (h / 2 - y) * (h / 2 + y) / h**2
    return profile / profile.max()


def get_inflow_profile(h: float, res_y: int, n_dims: int,
                       res_z: int | None = None) -> np.ndarray:
    """Parabolic inflow profile, mean-normalized to 1; returns
    ``(ndims, *face_shape)`` with the face along -x (size 1 in x)."""
    y = np.linspace(-h / 2, h / 2, res_y)
    profile = 6 * (h / 2 - y) * (h / 2 + y) / h**2
    profile = profile / profile.mean()
    if n_dims == 2:
        inflow = np.zeros((2, res_y, 1))
        inflow[0, :, 0] = profile
    else:
        if res_z is None:
            raise ValueError("res_z must be provided for 3D inflow profile.")
        inflow = np.zeros((3, res_z, res_y, 1))
        inflow[0] = profile[None, :, None]
    return inflow
