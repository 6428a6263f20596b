"""Boundary-update hooks: convective outflow and flux balancing (counterpart
of ``fluidgym_tpu/solver/boundaries.py``).

* ``update_advective_boundaries``: advect the prescribed values of outflow
  faces toward the adjacent interior values with the interpolation weight
  ``t = 1 - 1/(1 + 2*dt*u_adv)``, ``u_adv`` the outward contravariant
  component of a characteristic velocity at the face;
* ``balance_boundary_fluxes``: rescale the outflow boundary velocity so the
  net volumetric flux through all FIXED boundaries vanishes, whenever the
  imbalance exceeds ``0.01 * tol``.  The test and the scale stay on the
  device (``torch.where``): no host sync.

Both are ``DomainState -> DomainState`` functions used as "PRE" hooks of the
PISO substep.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from fluidgym_tpu_torch.core.domain import (BoundKind, DomainState, DomainTopo,
                                            face_axis, face_sign)
from fluidgym_tpu_torch.solver.stencil import (_boundary_flux, _slab,
                                               _slab_trailing)

Tensor = torch.Tensor

__all__ = ["update_advective_boundaries", "balance_boundary_fluxes",
           "make_convective_outflow_hook"]


def update_advective_boundaries(state: DomainState, geoms, topo: DomainTopo,
                                out_faces: tuple[tuple[int, int], ...],
                                char_vel: tuple[float, ...], dt) -> DomainState:
    """Advect outflow-face velocity (and scalar) toward the interior values.
    ``out_faces``: (block, face) pairs; ``char_vel``: characteristic
    velocity."""
    blk0 = state.blocks[0].velocity
    cv = torch.tensor(char_vel, dtype=blk0.dtype, device=blk0.device)
    for b, f in out_faces:
        blk = state.blocks[b]
        geom = geoms[b]
        d = face_axis(f)
        if topo.blocks[b].orthogonal:
            adv = _slab(geom.det * geom.minv_diag[d], f) * cv[d]
        else:
            minv_row = _slab_trailing(geom.minv, f, 2)[..., d, :]
            adv = _slab(geom.det, f) * torch.einsum("...i,i->...", minv_row, cv)
        # outward-positive: an outflow through a LOWER face has a negative
        # contravariant velocity
        adv = face_sign(f) * adv
        t = 1.0 - 1.0 / (1.0 + dt * 2.0 * adv)

        faces = list(blk.faces)
        fd = faces[f]
        new_vel = fd.velocity - t * (fd.velocity - _slab(blk.velocity, f))
        new_scal = fd.scalar
        if fd.scalar is not None and blk.scalar is not None:
            new_scal = fd.scalar - t * (fd.scalar - _slab(blk.scalar, f))
        faces[f] = replace(fd, velocity=new_vel, scalar=new_scal)
        state = state.replace_block(b, replace(blk, faces=tuple(faces)))
    return state


def balance_boundary_fluxes(state: DomainState, geoms, topo: DomainTopo,
                            free_faces: tuple[tuple[int, int], ...],
                            tol: float = 1e-5) -> DomainState:
    """Scale the velocity of ``free_faces`` so the net FIXED-boundary flux
    is zero (all free faces scaled by one factor)."""
    blk0 = state.blocks[0].velocity
    fixed_flux = torch.zeros((), dtype=blk0.dtype, device=blk0.device)
    var_flux = torch.zeros((), dtype=blk0.dtype, device=blk0.device)
    free = set(free_faces)
    for b, btopo in enumerate(topo.blocks):
        for f, spec in enumerate(btopo.faces):
            if spec.kind != BoundKind.FIXED:
                continue
            if state.blocks[b].faces[f].velocity is None:
                continue
            flux = face_sign(f) * torch.sum(
                _boundary_flux(state.blocks[b], geoms[b], btopo, f))
            if (b, f) in free:
                var_flux = var_flux + flux
            else:
                fixed_flux = fixed_flux + flux

    # only faces that contributed to var_flux may be scaled
    eligible = tuple(
        (b, f) for b, f in free_faces
        if topo.blocks[b].faces[f].kind == BoundKind.FIXED
        and state.blocks[b].faces[f].velocity is not None)

    imbalance = fixed_flux + var_flux
    needs = torch.abs(imbalance) > (tol * 0.01)
    one = torch.ones_like(var_flux)
    scale = -fixed_flux / torch.where(var_flux == 0, one, var_flux)
    scale = torch.where(needs & (var_flux != 0), scale, one)

    for b, f in eligible:
        blk = state.blocks[b]
        faces = list(blk.faces)
        faces[f] = replace(faces[f], velocity=faces[f].velocity * scale)
        state = state.replace_block(b, replace(blk, faces=tuple(faces)))
    return state


def make_convective_outflow_hook(geoms, topo: DomainTopo,
                                 out_faces: tuple[tuple[int, int], ...],
                                 char_vel: tuple[float, ...], tol: float = 5e-6):
    """A PRE hook: outflow advection, then flux balancing."""

    def hook(state: DomainState, *, time_step, **kw) -> DomainState:
        state = update_advective_boundaries(state, geoms, topo, out_faces,
                                            char_vel, time_step)
        return balance_boundary_fluxes(state, geoms, topo, out_faces, tol)

    return hook
