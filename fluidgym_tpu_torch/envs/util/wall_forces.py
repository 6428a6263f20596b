"""Drag and lift from wall-stress integration around a closed body contour
(counterpart of ``fluidgym_tpu/envs/util/wall_forces.py``).

A body's wall is an ordered loop of ``(block, face, cell_slice, flip)``
segments; its static geometry (normals, distances, segment lengths) is
prepared on the host once, and the per-step fields are gathered with tensor
ops on the env's device.  In 3D the loop is one z-slice of the extruded
wall and the forces come per z-slice.
"""

from __future__ import annotations

import numpy as np
import torch

from fluidgym_tpu_torch.core.domain import DomainState
from fluidgym_tpu_torch.envs.util.forces import (compute_forces_2d,
                                                 compute_forces_3d,
                                                 wall_distance_from_vertices)

Tensor = torch.Tensor

__all__ = ["WallForcesMixin"]


class WallForcesMixin:
    """Hosts provide ``_wall_loop_spec()`` (list of (block, face,
    cell_slice, flip)), ``_blocks_vertex_coords``, ``_geoms``, ``_ndims``,
    ``_dtype``, ``_device``, ``_viscosity`` and ``_force_scale``."""

    def _wall_loop_spec(self):  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def _force_scale(self) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def _prepare_drag_and_lift(self) -> None:
        """Static wall geometry: inward normals, wall distances, tangent and
        face lengths."""
        spec = self._wall_loop_spec()
        coords_list, centers_list = [], []
        for i, (b, f, sl, flip) in enumerate(spec):
            vc = np.asarray(self._blocks_vertex_coords[b])
            cc = self._geoms[b].centers.detach().cpu().numpy()
            if self._ndims == 3:  # one z-slice of the wall line
                vc, cc = vc[:2, 0], cc[:2, 0]
            bc, cl = vc[sl], cc[sl]
            if flip:
                bc = bc[..., ::-1]
                cl = cl[..., ::-1]
            if i != len(spec) - 1:
                bc = bc[..., :-1]
            coords_list.append(bc)
            centers_list.append(cl)
        cell_coords = np.concatenate(coords_list, axis=-1)   # (2, N+1)
        cell_centers = np.concatenate(centers_list, axis=-1)  # (2, N)

        conv = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                         device=self._device).to(self._dtype)
        cc_left = np.roll(cell_centers, -1, axis=-1)
        cc_right = np.roll(cell_centers, 1, axis=-1)
        self._tangent_lengths = conv(
            np.sqrt(((cc_left - cc_right) ** 2).sum(axis=0)))
        d, n = wall_distance_from_vertices(cell_coords, cell_centers)
        self._wall_distances = conv(d)
        self._wall_normals = conv(n)
        xw, yw = cell_coords[0], cell_coords[1]
        self._wall_face_lengths = conv(
            np.sqrt((xw[1:] - xw[:-1]) ** 2 + (yw[1:] - yw[:-1]) ** 2))

    def _collect_wall_fields(self, state: DomainState):
        """Per-wall-cell (u_cell, u_boundary, p_cell) around the body."""
        u_list, ub_list, p_list = [], [], []
        for b, f, sl, flip in self._wall_loop_spec():
            blk = state.blocks[b]
            u = blk.velocity[sl]          # (ndims, [Z,] N)
            p = blk.pressure[sl]
            # squeeze the face axis to match the wall line layout
            ub = blk.faces[f].velocity.squeeze(-1 - f // 2)
            if flip:
                u, p, ub = (torch.flip(t, dims=(-1,)) for t in (u, p, ub))
            u_list.append(u)
            ub_list.append(ub)
            p_list.append(p)
        return (torch.cat(u_list, dim=-1), torch.cat(ub_list, dim=-1),
                torch.cat(p_list, dim=-1))

    def _pure_drag_lift(self, state: DomainState):
        """``(cd, cl)``: 0-d tensors in 2D, per z-slice ``(Z,)`` in 3D."""
        u_cell, u_b, p_cell = self._collect_wall_fields(state)
        if self._ndims == 2:
            forces = compute_forces_2d(
                u_cell, u_b, p_cell, self._wall_normals, self._tangent_lengths,
                self._wall_distances, self._wall_face_lengths, self._viscosity)
        else:
            forces = compute_forces_3d(
                u_cell, u_b, p_cell, self._wall_normals, self._tangent_lengths,
                self._wall_distances, self._wall_face_lengths * self._wall_dz,
                self._viscosity)
        scale = self._force_scale
        return forces[0] / scale, forces[1] / scale
