"""Environment wrappers (counterpart of ``fluidgym_tpu/wrappers``)."""

from fluidgym_tpu_torch.wrappers.action_noise import ActionNoise
from fluidgym_tpu_torch.wrappers.flatten_obs import FlattenObservation
from fluidgym_tpu_torch.wrappers.fluid_wrapper import FluidWrapper
from fluidgym_tpu_torch.wrappers.obs_extraction import ObsExtraction
from fluidgym_tpu_torch.wrappers.sensor_noise import SensorNoise

__all__ = [
    "ActionNoise",
    "FlattenObservation",
    "FluidWrapper",
    "ObsExtraction",
    "SensorNoise",
]
