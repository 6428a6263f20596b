"""Environment families and registration.  This port registers the 12
RBC ids (2D and 3D), the three CylinderJet2D ids, the three CylinderRot2D
ids, the three CylinderJet3D ids, the 12 TCF ids, the three Airfoil2D ids
and Airfoil3D-easy: 37 of the JAX package's 39 ids, with the same merged
defaults.  Airfoil3D-medium and -hard (Re >= 3000) need the 3D aggregation
coarse space of the pressure solve and are not registered."""

from fluidgym_tpu_torch.envs.fluid_env import EnvState, FluidEnv
from fluidgym_tpu_torch.registry import register

__all__ = ["EnvState", "FluidEnv"]


def _register_rbc() -> None:
    from fluidgym_tpu_torch.envs.rbc import (RBC_2D_DEFAULT_CONFIG,
                                             RBC_3D_DEFAULT_CONFIG, RBCEnv2D,
                                             RBCEnv3D)

    # 2D RBC
    register("RBC2D-easy-v0", RBCEnv2D, RBC_2D_DEFAULT_CONFIG,
             rayleigh_number=8e4, adaptive_cfl=0.8)
    register("RBC2D-medium-v0", RBCEnv2D, RBC_2D_DEFAULT_CONFIG,
             rayleigh_number=4e5, adaptive_cfl=0.5)
    register("RBC2D-hard-v0", RBCEnv2D, RBC_2D_DEFAULT_CONFIG,
             rayleigh_number=8e5, adaptive_cfl=0.5)
    register("RBC2D-wide-easy-v0", RBCEnv2D, RBC_2D_DEFAULT_CONFIG,
             aspect_ratio=2, n_heaters=24, rayleigh_number=8e4)
    register("RBC2D-wide-medium-v0", RBCEnv2D, RBC_2D_DEFAULT_CONFIG,
             aspect_ratio=2, n_heaters=24, rayleigh_number=4e5, adaptive_cfl=0.5)
    register("RBC2D-wide-hard-v0", RBCEnv2D, RBC_2D_DEFAULT_CONFIG,
             aspect_ratio=2, n_heaters=24, rayleigh_number=8e5, adaptive_cfl=0.5)

    # 3D RBC
    register("RBC3D-easy-v0", RBCEnv3D, RBC_3D_DEFAULT_CONFIG,
             rayleigh_number=6e3, adaptive_cfl=0.5)
    register("RBC3D-medium-v0", RBCEnv3D, RBC_3D_DEFAULT_CONFIG,
             rayleigh_number=8e3, adaptive_cfl=0.5)
    register("RBC3D-hard-v0", RBCEnv3D, RBC_3D_DEFAULT_CONFIG,
             rayleigh_number=1e4, adaptive_cfl=0.5)
    register("RBC3D-wide-easy-v0", RBCEnv3D, RBC_3D_DEFAULT_CONFIG,
             aspect_ratio=2, n_heaters=16, rayleigh_number=6e3, adaptive_cfl=0.5)
    register("RBC3D-wide-medium-v0", RBCEnv3D, RBC_3D_DEFAULT_CONFIG,
             aspect_ratio=2, n_heaters=16, rayleigh_number=8e3, adaptive_cfl=0.5)
    register("RBC3D-wide-hard-v0", RBCEnv3D, RBC_3D_DEFAULT_CONFIG,
             aspect_ratio=2, n_heaters=16, rayleigh_number=1e4, adaptive_cfl=0.5)


def _register_cylinder() -> None:
    from fluidgym_tpu_torch.envs.cylinder import (
        CYLINDER_JET_2D_DEFAULT_CONFIG, CYLINDER_JET_3D_DEFAULT_CONFIG,
        CYLINDER_ROT_2D_DEFAULT_CONFIG, CylinderJetEnv2D, CylinderJetEnv3D,
        CylinderRotEnv2D)

    register("CylinderJet2D-easy-v0", CylinderJetEnv2D,
             CYLINDER_JET_2D_DEFAULT_CONFIG, reynolds_number=100, resolution=24)
    register("CylinderJet2D-medium-v0", CylinderJetEnv2D,
             CYLINDER_JET_2D_DEFAULT_CONFIG, reynolds_number=250, resolution=32)
    register("CylinderJet2D-hard-v0", CylinderJetEnv2D,
             CYLINDER_JET_2D_DEFAULT_CONFIG, reynolds_number=500, resolution=32)
    register("CylinderJet3D-easy-v0", CylinderJetEnv3D,
             CYLINDER_JET_3D_DEFAULT_CONFIG, reynolds_number=100, resolution=24)
    register("CylinderJet3D-medium-v0", CylinderJetEnv3D,
             CYLINDER_JET_3D_DEFAULT_CONFIG, reynolds_number=250, resolution=32)
    register("CylinderJet3D-hard-v0", CylinderJetEnv3D,
             CYLINDER_JET_3D_DEFAULT_CONFIG, reynolds_number=500, resolution=48)
    register("CylinderRot2D-easy-v0", CylinderRotEnv2D,
             CYLINDER_ROT_2D_DEFAULT_CONFIG, reynolds_number=100, resolution=24)
    register("CylinderRot2D-medium-v0", CylinderRotEnv2D,
             CYLINDER_ROT_2D_DEFAULT_CONFIG, reynolds_number=250, resolution=32)
    register("CylinderRot2D-hard-v0", CylinderRotEnv2D,
             CYLINDER_ROT_2D_DEFAULT_CONFIG, reynolds_number=500, resolution=32)


def _register_tcf() -> None:
    from fluidgym_tpu_torch.envs.tcf import (LARGE_TCF_3D_DEFAULT_CONFIG,
                                             SMALL_TCF_3D_DEFAULT_CONFIG,
                                             TCF3DBothEnv, TCF3DBottomEnv)

    for diff, re_wall in (("easy", 180), ("medium", 330), ("hard", 550)):
        register(f"TCFSmall3D-bottom-{diff}-v0", TCF3DBottomEnv,
                 SMALL_TCF_3D_DEFAULT_CONFIG, reynolds_number_wall=re_wall)
        register(f"TCFSmall3D-both-{diff}-v0", TCF3DBothEnv,
                 SMALL_TCF_3D_DEFAULT_CONFIG, reynolds_number_wall=re_wall)
        register(f"TCFLarge3D-bottom-{diff}-v0", TCF3DBottomEnv,
                 LARGE_TCF_3D_DEFAULT_CONFIG, reynolds_number_wall=re_wall)
        register(f"TCFLarge3D-both-{diff}-v0", TCF3DBothEnv,
                 LARGE_TCF_3D_DEFAULT_CONFIG, reynolds_number_wall=re_wall)


def _register_airfoil() -> None:
    from fluidgym_tpu_torch.envs.airfoil import (
        AIRFOIL_2D_DEFAULT_CONFIG, AIRFOIL_3D_DEFAULT_CONFIG, AirfoilEnv2D,
        AirfoilEnv3D)

    register("Airfoil2D-easy-v0", AirfoilEnv2D, AIRFOIL_2D_DEFAULT_CONFIG,
             reynolds_number=1e3)
    register("Airfoil2D-medium-v0", AirfoilEnv2D, AIRFOIL_2D_DEFAULT_CONFIG,
             reynolds_number=3e3)
    register("Airfoil2D-hard-v0", AirfoilEnv2D, AIRFOIL_2D_DEFAULT_CONFIG,
             reynolds_number=5e3)
    register("Airfoil3D-easy-v0", AirfoilEnv3D, AIRFOIL_3D_DEFAULT_CONFIG,
             reynolds_number=1e3)


_register_rbc()
_register_cylinder()
_register_tcf()
_register_airfoil()
