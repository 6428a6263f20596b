"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for another device.
There is no silent fallback: asking for the card on a host without one
raises, naming the ``device="cpu"`` option."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fluidgym_tpu_torch runs on a CUDA device by default, and none is "
            "available here; pass device=\"cpu\" to run on the host (the "
            "kernels' plain PyTorch versions run there)."
        )
    return dev
