"""Environment families and registration.  This port registers
``RBC2D-easy-v0``, ``CylinderJet2D-easy-v0`` and ``Airfoil2D-easy-v0``; the
other ids of the JAX package follow slice by slice."""

from fluidgym_tpu_torch.envs.fluid_env import EnvState, FluidEnv
from fluidgym_tpu_torch.registry import register

__all__ = ["EnvState", "FluidEnv"]


def _register_rbc() -> None:
    from fluidgym_tpu_torch.envs.rbc import RBC_2D_DEFAULT_CONFIG, RBCEnv2D

    register("RBC2D-easy-v0", RBCEnv2D, RBC_2D_DEFAULT_CONFIG,
             rayleigh_number=8e4, adaptive_cfl=0.8)


def _register_cylinder() -> None:
    from fluidgym_tpu_torch.envs.cylinder import (
        CYLINDER_JET_2D_DEFAULT_CONFIG, CylinderJetEnv2D)

    register("CylinderJet2D-easy-v0", CylinderJetEnv2D,
             CYLINDER_JET_2D_DEFAULT_CONFIG, reynolds_number=100, resolution=24)


def _register_airfoil() -> None:
    from fluidgym_tpu_torch.envs.airfoil import (
        AIRFOIL_2D_DEFAULT_CONFIG, AirfoilEnv2D)

    register("Airfoil2D-easy-v0", AirfoilEnv2D, AIRFOIL_2D_DEFAULT_CONFIG,
             reynolds_number=1e3)


_register_rbc()
_register_cylinder()
_register_airfoil()
