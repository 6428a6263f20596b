"""Rayleigh-Benard Convection environments (2D in this port)."""

from fluidgym_tpu_torch.envs.rbc.rbc_env_2d import RBC_2D_DEFAULT_CONFIG, RBCEnv2D
from fluidgym_tpu_torch.envs.rbc.rbc_env_base import RBCEnvBase

__all__ = ["RBC_2D_DEFAULT_CONFIG", "RBCEnv2D", "RBCEnvBase"]
