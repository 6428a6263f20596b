"""Global configuration singleton.

Counterpart of ``fluidgym_tpu/config.py``: the default floating dtype and
the local data path used for initial-domain datasets.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

_VALID_DTYPES = (torch.float32, torch.float64)


class Config:
    """Process-global configuration (dtype, data path)."""

    def __init__(self) -> None:
        self._dtype = torch.float32
        self._data_path: Path | None = None

    @property
    def dtype(self) -> torch.dtype:
        """Default floating dtype for simulation tensors."""
        return self._dtype

    @dtype.setter
    def dtype(self, value) -> None:
        if value not in _VALID_DTYPES:
            raise ValueError(f"dtype must be one of {_VALID_DTYPES}, got {value}")
        self._dtype = value

    @property
    def data_path(self) -> Path:
        """Local directory holding user-generated initial-domain datasets."""
        if self._data_path is not None:
            return self._data_path
        env = os.environ.get("FLUIDGYM_TPU_DATA")
        if env:
            return Path(env)
        return Path.home() / ".cache" / "fluidgym_tpu"

    @data_path.setter
    def data_path(self, value) -> None:
        self._data_path = Path(value)


config = Config()
