"""Turbulent-channel-flow wall-unit conversions that the envs use
(counterpart of ``fluidgym_tpu/envs/tcf/tools.py``), as plain floats.  The
other conversions and the interpolation of reference DNS profiles come
with the port of the TCF statistics modules."""

from __future__ import annotations

__all__ = ["Re_wall_to_cl", "t_star"]


def Re_wall_to_cl(Re_wall: float) -> float:
    """Centreline Reynolds number from Re_tau (the empirical wall relation)."""
    return (Re_wall / 0.116) ** (1 / 0.88)


def t_star(visc: float, u_wall: float) -> float:
    """Wall time unit."""
    return visc / (u_wall**2)
