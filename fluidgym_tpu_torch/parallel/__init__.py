"""Batched environments (counterpart of ``fluidgym_tpu/parallel``):
``BatchedFluidEnv`` steps ``n_envs`` copies of one env config as one batch
on one card.  Mesh sharding (``parallel/spatial.py``, ``multihost.py``) is
not ported yet."""

from fluidgym_tpu_torch.parallel.batched_env import BatchedFluidEnv

__all__ = ["BatchedFluidEnv"]
