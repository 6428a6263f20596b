"""Cylinder flow environments (2D jet actuation in this port)."""

from fluidgym_tpu_torch.envs.cylinder.jet_cylinder_env_2d import (
    CYLINDER_JET_2D_DEFAULT_CONFIG,
    CylinderJetEnv2D,
)

__all__ = ["CYLINDER_JET_2D_DEFAULT_CONFIG", "CylinderJetEnv2D"]
