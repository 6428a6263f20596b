"""NACA 0012 airfoil surface coordinates, sharp trailing edge (counterpart
of ``fluidgym_tpu/envs/airfoil/coords.py``; numpy, host side).

The standard 4-digit-series profile is generated analytically with the
sharp-trailing-edge coefficient set (last coefficient 0.1036 closes the
trailing edge exactly), cosine-clustered in chord so the leading and
trailing edges are finely resolved.
"""

from __future__ import annotations

import numpy as np

__all__ = ["naca0012_sharp_coords"]

_THICKNESS = 0.12


def _half_thickness(x: np.ndarray) -> np.ndarray:
    """Sharp-TE NACA 4-digit thickness distribution (y_t at chord x)."""
    return (_THICKNESS / 0.2) * (
        0.2969 * np.sqrt(x)
        - 0.1260 * x
        - 0.3516 * x**2
        + 0.2843 * x**3
        - 0.1036 * x**4
    )


def naca0012_sharp_coords(n_side: int = 82) -> np.ndarray:
    """Closed surface polyline of a sharp-TE NACA 0012.

    Returns ``(2, 2*n_side)``: the loop starts at the trailing edge (1, 0),
    runs over the upper surface to (just short of) the leading edge, then
    back along the lower surface to (1, 0), the order the grid builder
    expects.
    """
    # cosine clustering; stop one step short of x=0 so the leading edge is a
    # fine +-y vertex pair rather than a degenerate sharp point
    theta = np.linspace(0.0, np.pi, n_side + 1)[:-1]
    x = 0.5 * (1.0 + np.cos(theta))
    y = _half_thickness(x)
    top = np.stack([x, y], axis=0)            # TE -> LE, y >= 0
    bot = np.stack([x, -y], axis=0)[:, ::-1]  # LE -> TE, y <= 0
    return np.concatenate([top, bot], axis=1)
