"""2D airfoil aerodynamic-efficiency environment (counterpart of
``fluidgym_tpu/envs/airfoil/airfoil_env_2d.py``): three independently
scaled synthetic jets on the upper surface, zero-mean max-normalized action,
reward ``cl/cd - cl_cd_ref``.
"""

from __future__ import annotations

from fluidgym_tpu_torch.envs.airfoil.airfoil_env_base import AirfoilEnvBase

AIRFOIL_2D_DEFAULT_CONFIG = {
    "reynolds_number": 3e3,
    "dt": 0.05,
    "step_length": 0.25,
    "adaptive_cfl": 0.8,
    "episode_length": 300,
    "attack_angle_deg": 10.0,
    "use_marl": False,
    "load_initial_domain": True,
    "load_domain_statistics": True,
    "randomize_initial_state": True,
    "enable_actions": True,
    "differentiable": False,
}


class AirfoilEnv2D(AirfoilEnvBase):
    """2D NACA 0012 with three upper-surface synthetic jets."""

    def __init__(self, **kwargs):
        super().__init__(ndims=2, **kwargs)
