"""Observation extraction: per-agent moving windows (counterpart of
``fluidgym_tpu/envs/util/obs_extraction.py``: the 2D window of RBC2D and
the 3D window of RBC3D)."""

from __future__ import annotations

import torch

__all__ = ["extract_moving_window_2d", "extract_moving_window_3d"]


def extract_moving_window_2d(field: torch.Tensor, n_agents: int,
                             agent_width: int,
                             n_agents_per_window: int) -> torch.Tensor:
    """Local windows for agents in a row: ``field (Y, X)`` with ``X ==
    n_agents * agent_width``; windows wrap circularly over agents.  Returns
    ``(n_agents, Y, n_agents_per_window * agent_width)``."""
    if field.dim() != 2:
        raise ValueError("field must be 2D (Y, X)")
    Y, X = field.shape
    if X != n_agents * agent_width:
        raise ValueError("X must equal n_agents * agent_width")
    blocks = field.reshape(Y, n_agents, agent_width)
    pad = n_agents_per_window // 2
    if pad:
        # wrap padding over the agent axis (jnp.pad mode="wrap"); a window
        # wider than the agent row wraps repeatedly
        idx = torch.arange(-pad, n_agents + pad, device=field.device) % n_agents
        blocks = torch.index_select(blocks, 1, idx)
    windows = [
        blocks[:, i: i + n_agents_per_window, :].reshape(
            Y, n_agents_per_window * agent_width)
        for i in range(n_agents)
    ]
    return torch.stack(windows, dim=0)


def extract_moving_window_3d(field: torch.Tensor, n_agents: int,
                             agent_width: int,
                             n_agents_per_window: int) -> torch.Tensor:
    """Local 3D windows for agents tiled over (z, x) at full y extent:
    ``field (Z, Y, X)`` with ``Z == X == n_agents * agent_width``; windows
    wrap circularly.  Returns ``(n_agents**2, w, Y, w)`` with ``w =
    n_agents_per_window * agent_width``, agent order z-major."""
    if field.dim() != 3:
        raise ValueError("field must be 3D (Z, Y, X)")
    Z, Y, X = field.shape
    if Z != n_agents * agent_width or X != n_agents * agent_width:
        raise ValueError("Z and X must equal n_agents * agent_width")
    w = n_agents_per_window * agent_width
    pad = (n_agents_per_window // 2) * agent_width
    # wrap padding of z and x (jnp.pad mode="wrap"), repeating if wider
    iz = torch.arange(-pad, Z + pad, device=field.device) % Z
    ix = torch.arange(-pad, X + pad, device=field.device) % X
    padded = torch.index_select(torch.index_select(field, 0, iz), 2, ix)
    out = [padded[z0: z0 + w, :, x0: x0 + w]
           for z0 in range(0, Z, agent_width)
           for x0 in range(0, X, agent_width)]
    return torch.stack(out, dim=0)
