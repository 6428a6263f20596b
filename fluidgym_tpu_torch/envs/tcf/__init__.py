"""Turbulent channel flow environments."""

from fluidgym_tpu_torch.envs.tcf.tcf_env import (LARGE_TCF_3D_DEFAULT_CONFIG,
                                                 SMALL_TCF_3D_DEFAULT_CONFIG,
                                                 TCF3DBothEnv, TCF3DBottomEnv)

__all__ = ["LARGE_TCF_3D_DEFAULT_CONFIG", "SMALL_TCF_3D_DEFAULT_CONFIG",
           "TCF3DBothEnv", "TCF3DBottomEnv"]
