"""CylinderJet2D-easy's case of ``scripts/validate_gradients.py`` against
the JAX package, in float64 on the CPU (``resolution=8,
step_length=dt=0.05``, solver tolerances 1e-10, one port step from
``reset(seed=0)``): d(reward)/d(action) through ``_pure_step`` within
1e-5 of max|g| (``check_action_gradient`` in
``tests/test_torch_diff_env.py``).  A file of its own: the JAX package's
trace of the gradient takes ~45 s on the CPU."""

import torch

from test_torch_diff_env import check_action_gradient

torch.set_num_threads(1)


def test_action_gradient_matches_jax():
    check_action_gradient("cylinder2d")
