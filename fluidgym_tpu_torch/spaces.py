"""Minimal observation/action spaces.

The port's own ``Box`` and ``Dict``, mirroring what the JAX envs build with
``gymnasium.spaces`` (shape, dtype, low, high, ``contains``, ``sample``)
without importing gymnasium, which the card's machine does not have.  A
gymnasium adapter belongs with the wrappers.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


class Box:
    """A box in R^n with per-element bounds (numpy-backed like gymnasium)."""

    def __init__(self, low, high, shape=None, dtype=np.float32) -> None:
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def contains(self, x) -> bool:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        if x.shape != self.shape:
            return False
        return bool(np.all(x >= self.low) and np.all(x <= self.high))

    def __contains__(self, x) -> bool:
        return self.contains(x)

    def sample(self, generator: torch.Generator | None = None) -> np.ndarray:
        """Uniform sample inside finite bounds (normal where unbounded)."""
        low = torch.as_tensor(self.low, dtype=torch.float64)
        high = torch.as_tensor(self.high, dtype=torch.float64)
        u = torch.rand(self.shape, generator=generator, dtype=torch.float64)
        n = torch.randn(self.shape, generator=generator, dtype=torch.float64)
        finite = torch.isfinite(low) & torch.isfinite(high)
        lo = torch.where(finite, low, torch.zeros_like(low))
        hi = torch.where(finite, high, torch.zeros_like(high))
        out = torch.where(finite, lo + (hi - lo) * u, n)
        return out.numpy().astype(self.dtype)

    def __repr__(self) -> str:
        return f"Box({self.shape}, {self.dtype})"


class Dict(Mapping):
    """An ordered mapping of named sub-spaces."""

    def __init__(self, spaces: dict) -> None:
        self.spaces = dict(spaces)

    def __getitem__(self, key):
        return self.spaces[key]

    def __iter__(self):
        return iter(self.spaces)

    def __len__(self) -> int:
        return len(self.spaces)

    def contains(self, x) -> bool:
        if not isinstance(x, Mapping) or set(x) != set(self.spaces):
            return False
        return all(self.spaces[k].contains(x[k]) for k in self.spaces)

    def __contains__(self, x) -> bool:
        # Mapping's key membership would shadow the space semantics
        return self.contains(x)

    def sample(self, generator: torch.Generator | None = None) -> dict:
        return {k: s.sample(generator) for k, s in self.spaces.items()}

    def __repr__(self) -> str:
        return f"Dict({self.spaces!r})"
