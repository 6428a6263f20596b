"""Observation extraction: per-agent moving windows (counterpart of
``fluidgym_tpu/envs/util/obs_extraction.py``, the 2D window used by RBC2D)."""

from __future__ import annotations

import torch

__all__ = ["extract_moving_window_2d"]


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
