"""Space-flattening helpers over the port's own ``spaces.Box`` /
``spaces.Dict`` (counterpart of ``fluidgym_tpu/wrappers/util.py``)."""

from __future__ import annotations

import numpy as np

from fluidgym_tpu_torch import spaces

__all__ = ["flatten_box_space", "flatten_dict_space"]


def flatten_box_space(space: spaces.Box) -> spaces.Box:
    """Flatten a Box space to 1D."""
    return spaces.Box(low=space.low.flatten(), high=space.high.flatten(),
                      dtype=space.dtype)


def flatten_dict_space(space: spaces.Dict, keys: list[str] | None = None) -> spaces.Box:
    """Concatenate selected Box subspaces of a Dict space into one flat Box,
    in the order of ``keys`` (all of the space's keys by default)."""
    if not isinstance(space, spaces.Dict):
        raise TypeError(f"Expected spaces.Dict, got {type(space)}")
    if keys is not None:
        for k in keys:
            if k not in space.spaces:
                raise KeyError(f"Key {k!r} not found in the Dict space.")
        items = [(k, space.spaces[k]) for k in keys]
    else:
        items = list(space.spaces.items())

    lows, highs, dtypes = [], [], []
    for k, s in items:
        if not isinstance(s, spaces.Box):
            raise TypeError(f"Only Box subspaces supported, but key {k!r} is {type(s)}")
        lows.append(np.asarray(s.low).reshape(-1))
        highs.append(np.asarray(s.high).reshape(-1))
        dtypes.append(s.dtype)
    if not lows:
        raise ValueError("Dict space contains no Box subspaces to flatten.")
    out_dtype = np.result_type(*dtypes, np.float32)
    return spaces.Box(
        low=np.concatenate(lows).astype(out_dtype, copy=False),
        high=np.concatenate(highs).astype(out_dtype, copy=False),
        dtype=out_dtype,
    )
