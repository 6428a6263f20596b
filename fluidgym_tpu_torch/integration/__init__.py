"""RL-framework adapters (Gymnasium, PettingZoo, SB3, TorchRL) over the
port's envs (counterpart of ``fluidgym_tpu/integration``).  Each optional
package is imported inside the module that needs it, in a ``try`` block."""

from fluidgym_tpu_torch.integration.gymnasium import GymFluidEnv

__all__ = ["GymFluidEnv"]
