"""2D cylinder flow with wall-rotation actuation (counterpart of
``fluidgym_tpu/envs/cylinder/rotating_cylinder_env_2d.py``): the action sets
a tangential unit velocity on the four cylinder-wall faces, scaled by the
control.  It reads the jet env's datasets (the same initial domains).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from fluidgym_tpu_torch.core.domain import DomainState
from fluidgym_tpu_torch.envs.cylinder.cylinder_env_base import CylinderEnvBase

Tensor = torch.Tensor

CYLINDER_ROT_2D_DEFAULT_CONFIG = {
    "reynolds_number": 1e2,
    "resolution": 24,
    "dt": 1e-2,
    "adaptive_cfl": 0.8,
    "step_length": 0.25,
    "episode_length": 80,
    "lift_penalty": 1.0,
    "use_marl": False,
    "load_initial_domain": True,
    "load_domain_statistics": True,
    "randomize_initial_state": True,
    "enable_actions": True,
    "differentiable": False,
}


class CylinderRotEnv2D(CylinderEnvBase):
    """Flow around a rotating cylinder."""

    def __init__(self, **kwargs):
        super().__init__(ndims=2, **kwargs)

    def _additional_initialization(self) -> None:
        super()._additional_initialization()
        self._wall_velocities = self._get_boundary_velocities()

    def _get_boundary_velocities(self) -> dict:
        """Tangential unit velocities on the four cylinder-wall faces, by
        ``(block, face)``, in face-slab layout: ``(ndims, ny, 1)`` on an
        x-face, ``(ndims, 1, nx)`` on a y-face."""

        def coords_to_velocities(coords_boundary: np.ndarray) -> np.ndarray:
            centers = 0.5 * (coords_boundary[:, :-1] + coords_boundary[:, 1:])
            theta = np.arctan2(centers[1], centers[0])
            return np.stack([np.sin(theta), -np.cos(theta)], axis=0)

        vcs = self._blocks_vertex_coords
        lines = {
            (self._left_block_idx, 1): np.asarray(vcs[self._left_block_idx])[:, :, -1],
            (self._top_block_idx, 2): np.asarray(vcs[self._top_block_idx])[:, 0, :],
            (self._right_block_idx, 0): np.asarray(vcs[self._right_block_idx])[:, :, 0],
            (self._bottom_block_idx, 3): np.asarray(vcs[self._bottom_block_idx])[:, -1, :],
        }
        out = {}
        for (b, f), line in lines.items():
            v = coords_to_velocities(line)
            v = v[:, :, None] if f // 2 == 0 else v[:, None, :]
            out[(b, f)] = torch.as_tensor(v, device=self._device).to(self._dtype)
        return out

    def _pure_apply_action(self, state: DomainState, control: Tensor) -> DomainState:
        """Scale the wall's tangential velocities by the control."""
        c = control.reshape(())
        for (b, f), base in self._wall_velocities.items():
            blk = state.blocks[b]
            faces = list(blk.faces)
            faces[f] = replace(faces[f], velocity=(base * c).to(
                faces[f].velocity.dtype))
            state = state.replace_block(b, replace(blk, faces=tuple(faces)))
        return state

    @property
    def id(self) -> str:
        return f"RotatingCylinder{self._ndims}D_Re{self._reynolds_number}"
