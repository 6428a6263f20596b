"""2D cylinder flow with jet actuation (counterpart of
``fluidgym_tpu/envs/cylinder/jet_cylinder_env_2d.py``): two synthetic jets
as +-10 degree arcs at the top/bottom of the cylinder wall, parabolic jet
profiles rotated into the local wall-normal direction; the action scales
the jet velocity.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from fluidgym_tpu_torch.core.domain import DomainState
from fluidgym_tpu_torch.envs.cylinder.cylinder_env_base import CylinderEnvBase
from fluidgym_tpu_torch.envs.util.profiles import get_jet_profile

Tensor = torch.Tensor

CYLINDER_JET_2D_DEFAULT_CONFIG = {
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


class CylinderJetEnv2D(CylinderEnvBase):
    """Flow around a cylinder controlled by two wall jets."""

    _jet_angle: float = 10.0  # degrees

    def _differentiable_ported(self) -> bool:
        # CylinderJet2D-easy (Re 100: no upwind blend) at resolution 24 or
        # less: K3 / K2-mb at C = 8, forward and transposed
        return (self._reynolds_number == 100
                and self._circle_resolution_angular <= 24)

    def __init__(self, **kwargs):
        super().__init__(ndims=2, **kwargs)

    def _additional_initialization(self) -> None:
        super()._additional_initialization()
        self._top_velocity, self._bottom_velocity = self._get_boundary_velocities()

    def _get_boundary_velocities(self):
        """Base jet velocity profiles on the top/bottom cylinder-wall faces,
        in face-slab layout ``(ndims, 1, nx)``."""

        def coords_to_velocities(coords_boundary: np.ndarray, direction: str):
            centers = 0.5 * (coords_boundary[:, :-1] + coords_boundary[:, 1:])
            if direction == "top":
                angles = np.pi / 2 - np.arctan2(centers[1], centers[0])
            else:
                angles = -np.pi / 2 - np.arctan2(centers[1], centers[0])
            deg = np.rad2deg(angles)
            deg_abs = np.abs(deg).copy()
            deg_abs[deg_abs > self._jet_angle] = 0.0
            nz = np.where(deg_abs > 0.0)[0]
            min_idx, max_idx = nz[0] - 1, nz[-1] + 1
            profile = get_jet_profile(int(max_idx - min_idx + 1))
            velocities = np.zeros_like(centers)
            for i, mag in zip(range(min_idx, max_idx + 1), profile):
                a = np.deg2rad(deg[i])
                velocities[0, i] = mag * np.sin(a)
                velocities[1, i] = mag * np.cos(a)
            return velocities

        vcs = self._blocks_vertex_coords
        top_v = coords_to_velocities(np.asarray(vcs[self._top_block_idx])[:, 0, :],
                                     "top")
        bottom_v = coords_to_velocities(
            np.asarray(vcs[self._bottom_block_idx])[:, -1, :], "bottom")
        conv = lambda a: torch.as_tensor(a[:, None, :], device=self._device).to(
            self._dtype)
        return conv(top_v), conv(bottom_v)

    def _pure_apply_action(self, state: DomainState, control: Tensor) -> DomainState:
        """Scale the jet profiles by the control."""
        c = control.reshape(())
        # top block "-y" face (2) and bottom block "+y" face (3)
        for b, f, base in ((self._top_block_idx, 2, self._top_velocity),
                           (self._bottom_block_idx, 3, self._bottom_velocity)):
            blk = state.blocks[b]
            faces = list(blk.faces)
            faces[f] = replace(faces[f], velocity=(base * c).to(
                faces[f].velocity.dtype))
            state = state.replace_block(b, replace(blk, faces=tuple(faces)))
        return state

    @property
    def id(self) -> str:
        return f"JetCylinder2D_Re{self._reynolds_number}"
