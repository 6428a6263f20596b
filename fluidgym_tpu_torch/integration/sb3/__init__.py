"""Stable-Baselines3 integration (VecEnv and evaluation tooling)."""

from fluidgym_tpu_torch.integration.sb3.eval_callback import EvalCallback
from fluidgym_tpu_torch.integration.sb3.util import (evaluate_model,
                                                     plot_eval_sequence,
                                                     test_model)
from fluidgym_tpu_torch.integration.sb3.vec_env import VecFluidEnv

__all__ = ["EvalCallback", "VecFluidEnv", "evaluate_model",
           "plot_eval_sequence", "test_model"]
