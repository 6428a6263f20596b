"""Cylinder flow environments (jet actuation in 2D and 3D, wall rotation in
2D, in this port)."""

from fluidgym_tpu_torch.envs.cylinder.jet_cylinder_env_2d import (
    CYLINDER_JET_2D_DEFAULT_CONFIG,
    CylinderJetEnv2D,
)
from fluidgym_tpu_torch.envs.cylinder.jet_cylinder_env_3d import (
    CYLINDER_JET_3D_DEFAULT_CONFIG,
    CylinderJetEnv3D,
)
from fluidgym_tpu_torch.envs.cylinder.rotating_cylinder_env_2d import (
    CYLINDER_ROT_2D_DEFAULT_CONFIG,
    CylinderRotEnv2D,
)

__all__ = ["CYLINDER_JET_2D_DEFAULT_CONFIG", "CYLINDER_JET_3D_DEFAULT_CONFIG",
           "CYLINDER_ROT_2D_DEFAULT_CONFIG", "CylinderJetEnv2D",
           "CylinderJetEnv3D", "CylinderRotEnv2D"]
