"""Cylinder flow environments (jet actuation, 2D and 3D, in this port)."""

from fluidgym_tpu_torch.envs.cylinder.jet_cylinder_env_2d import (
    CYLINDER_JET_2D_DEFAULT_CONFIG,
    CylinderJetEnv2D,
)
from fluidgym_tpu_torch.envs.cylinder.jet_cylinder_env_3d import (
    CYLINDER_JET_3D_DEFAULT_CONFIG,
    CylinderJetEnv3D,
)

__all__ = ["CYLINDER_JET_2D_DEFAULT_CONFIG", "CYLINDER_JET_3D_DEFAULT_CONFIG",
           "CylinderJetEnv2D", "CylinderJetEnv3D"]
