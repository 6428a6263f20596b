"""Wall-force computation: drag/lift from viscous + pressure stress
(counterpart of ``fluidgym_tpu/envs/util/forces.py``).

Wall distances and normals come from the wall's vertex segments (host side,
static geometry); the stress integration ``F = sum (2 nu S - p I) n dA``
takes normal derivatives from the wall-adjacent cells and tangential
derivatives from the neighbouring wall cells.  In 3D the wall is a 2D
contour extruded along z: the same integration per z-slice
(``compute_forces_3d``).
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

__all__ = ["wall_distance_from_vertices", "compute_forces_2d",
           "compute_forces_3d"]


def wall_distance_from_vertices(vc: np.ndarray, centers: np.ndarray):
    """Distances of wall-adjacent cell centres to the wall and inward unit
    normals.  ``vc (2, N+1)`` wall vertex line, ``centers (2, N)`` adjacent
    cell centres.  Host side (numpy)."""
    v0, v1 = vc[:, :-1], vc[:, 1:]
    e = v1 - v0
    eps = 1e-20
    t = e / (np.linalg.norm(e, axis=0, keepdims=True) + eps)
    n = np.stack([t[1], -t[0]], axis=0)
    m = 0.5 * (v0 + v1)
    d = np.abs(((centers - m) * n).sum(axis=0))
    d = np.maximum(d, eps)
    return d, -n  # normals flipped to point into the fluid


def compute_forces_2d(u_cell: Tensor, u_boundary: Tensor, p_cell: Tensor,
                      wall_normals: Tensor, tangent_lengths: Tensor,
                      wall_distances: Tensor, wall_face_lengths: Tensor,
                      viscosity) -> Tensor:
    """Total ``(Fx, Fy)`` on a closed 2D wall; every per-wall-cell tensor is
    laid out along one closed loop of N cells."""
    wall_tangents = torch.stack([wall_normals[1], -wall_normals[0]], dim=0)
    u_left = torch.roll(u_cell, -1, dims=1)
    u_right = torch.roll(u_cell, 1, dims=1)

    du_dn = (u_cell[0] - u_boundary[0]) / wall_distances
    dv_dn = (u_cell[1] - u_boundary[1]) / wall_distances
    du_dt = (u_right[0] - u_left[0]) / (2 * tangent_lengths)
    dv_dt = (u_right[1] - u_left[1]) / (2 * tangent_lengths)

    du_dx = du_dn * wall_normals[0] + du_dt * wall_tangents[0]
    du_dy = du_dn * wall_normals[1] + du_dt * wall_tangents[1]
    dv_dx = dv_dn * wall_normals[0] + dv_dt * wall_tangents[0]
    dv_dy = dv_dn * wall_normals[1] + dv_dt * wall_tangents[1]

    G = torch.stack([torch.stack([du_dx, du_dy], dim=-1),
                     torch.stack([dv_dx, dv_dy], dim=-1)], dim=-2)  # (N, 2, 2)
    S = 0.5 * (G + G.transpose(-1, -2))
    eye = torch.eye(2, dtype=S.dtype, device=S.device)
    stress = 2 * viscosity * S - p_cell[:, None, None] * eye
    traction = torch.einsum("nij,jn->ni", stress, wall_normals)  # (N, 2)
    return torch.sum(traction * wall_face_lengths[:, None], dim=0)


def compute_forces_3d(u_cell: Tensor, u_boundary: Tensor, p_cell: Tensor,
                      wall_normals: Tensor, tangent_lengths: Tensor,
                      wall_distances: Tensor, wall_face_areas: Tensor,
                      viscosity) -> Tensor:
    """Per-z-slice ``(Fx, Fy)`` on an extruded wall: ``u_cell``,
    ``u_boundary (3, Z, N)``, ``p_cell (Z, N)``, the per-wall-cell geometry
    ``(N,)`` (one z-slice of the contour); returns ``(2, Z)``."""
    wall_tangents = torch.stack([wall_normals[1], -wall_normals[0]], dim=0)
    u_left = torch.roll(u_cell, -1, dims=-1)
    u_right = torch.roll(u_cell, 1, dims=-1)

    du_dn = (u_cell[0] - u_boundary[0]) / wall_distances
    dv_dn = (u_cell[1] - u_boundary[1]) / wall_distances
    du_dt = (u_right[0] - u_left[0]) / (2 * tangent_lengths)
    dv_dt = (u_right[1] - u_left[1]) / (2 * tangent_lengths)

    du_dx = du_dn * wall_normals[0] + du_dt * wall_tangents[0]
    du_dy = du_dn * wall_normals[1] + du_dt * wall_tangents[1]
    dv_dx = dv_dn * wall_normals[0] + dv_dt * wall_tangents[0]
    dv_dy = dv_dn * wall_normals[1] + dv_dt * wall_tangents[1]

    G = torch.stack([torch.stack([du_dx, du_dy], dim=-1),
                     torch.stack([dv_dx, dv_dy], dim=-1)], dim=-2)  # (Z, N, 2, 2)
    S = 0.5 * (G + G.transpose(-1, -2))
    eye = torch.eye(2, dtype=S.dtype, device=S.device)
    stress = 2 * viscosity * S - p_cell[..., None, None] * eye
    traction = torch.einsum("znij,jn->zni", stress, wall_normals)  # (Z, N, 2)
    return torch.sum(traction * wall_face_areas[None, :, None], dim=1).T
