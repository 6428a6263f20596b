"""fluidgym_tpu_torch: the PyTorch/CUDA port of FluidGym-TPU.

A second package beside the JAX reference ``fluidgym_tpu``: the same env
ids, ``reset``/``step`` contract and PISO solver, in PyTorch, with the TPU's
Pallas kernels rewritten by hand in CUDA for the H100 (``ops/``, sources in
``csrc/``).  It imports neither JAX nor the JAX package.

``fluidgym_tpu_torch.make(id, device=None, **kwargs)``: ``device=None`` runs
on the CUDA card (and raises if there is none); pass ``device="cpu"`` to run
on the host, where the kernels' plain PyTorch versions take their place.
"""

from fluidgym_tpu_torch.config import config
from fluidgym_tpu_torch.registry import make, register, registry

from fluidgym_tpu_torch import envs as _envs  # noqa: E402,F401  (registration)

__all__ = ["config", "make", "register", "registry"]
__version__ = "0.1.0"
