"""Misc helpers (counterpart of ``fluidgym_tpu/utils/helpers.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["seed_all"]


def seed_all(seed: int) -> torch.Generator:
    """Seed Python's ``random``, numpy's global generator and torch (every
    CUDA device too, where there is one); returns a CPU ``torch.Generator``
    seeded from ``seed``, in the place of the JAX package's PRNG key."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)
    return torch.Generator().manual_seed(int(seed))
