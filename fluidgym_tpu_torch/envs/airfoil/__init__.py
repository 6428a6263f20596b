"""NACA 0012 airfoil environments."""

from fluidgym_tpu_torch.envs.airfoil.airfoil_env_2d import (
    AIRFOIL_2D_DEFAULT_CONFIG,
    AirfoilEnv2D,
)
from fluidgym_tpu_torch.envs.airfoil.airfoil_env_3d import (
    AIRFOIL_3D_DEFAULT_CONFIG,
    AirfoilEnv3D,
)
from fluidgym_tpu_torch.envs.airfoil.airfoil_env_base import AirfoilEnvBase

__all__ = ["AIRFOIL_2D_DEFAULT_CONFIG", "AIRFOIL_3D_DEFAULT_CONFIG",
           "AirfoilEnv2D", "AirfoilEnv3D", "AirfoilEnvBase"]
