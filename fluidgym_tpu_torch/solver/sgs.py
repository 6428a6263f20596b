"""Subgrid-scale turbulence model and velocity gradients (counterpart of
``fluidgym_tpu/solver/sgs.py``).

Velocity gradients are central differences in index space mapped to
physical space with ``M^-1``; one-sided toward the wall value at FIXED
faces; CONNECTED and PERIODIC neighbours come from the halo or the roll.
The Smagorinsky eddy viscosity is ``nu_t = (C_s Delta)^2 |S|`` with ``|S| =
sqrt(2 S:S)`` and the filter width ``Delta = det^(1/ndims)``.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from fluidgym_tpu_torch.core.domain import BoundKind, DomainState, DomainTopo
from fluidgym_tpu_torch.solver.stencil import (_face_slab, _neighbor_field,
                                               set_region)

Tensor = torch.Tensor

__all__ = ["velocity_gradients", "smagorinsky_viscosity", "make_smagorinsky_hook"]


def velocity_gradients(state: DomainState, geoms,
                       topo: DomainTopo) -> tuple[Tensor, ...]:
    """Physical velocity gradient tensors ``G[i, j] = du_i/dx_j`` per block,
    shape ``(ndims, ndims, *s)``."""
    nd = topo.ndims
    us = tuple(b.velocity for b in state.blocks)
    out = []
    for b, (geom, btopo) in enumerate(zip(geoms, topo.blocks)):
        u = us[b]
        grads_idx = []
        for d in range(nd):
            f_lo, f_hi = 2 * d, 2 * d + 1
            val_n = _neighbor_field(us, b, f_lo, topo)
            val_p = _neighbor_field(us, b, f_hi, topo)
            for f in (f_lo, f_hi):
                if btopo.faces[f].kind != BoundKind.FIXED:
                    continue
                # one-sided toward the wall value (half-cell distance)
                slab = (slice(None),) + _face_slab(u.dim() - 1, f)
                wall = 2 * state.blocks[b].faces[f].velocity - u[slab]
                if f == f_lo:
                    val_n = set_region(val_n, slab, wall)
                else:
                    val_p = set_region(val_p, slab, wall)
            grads_idx.append((val_p - val_n) * 0.5)  # du/dxi_d, (ndims, *s)
        g_idx = torch.stack(grads_idx, dim=1)  # (i, d, *s)
        if btopo.orthogonal:
            G = g_idx * geom.minv_diag[None]  # du_i/dxi_d * 1/h_d
        else:
            # du_i/dx_j = sum_k Minv[k, j] du_i/dxi_k
            minv = torch.movedim(geom.minv, (-2, -1), (0, 1))  # (k, j, *s)
            G = (g_idx[:, :, None] * minv[None]).sum(dim=1)
        out.append(G)
    return tuple(out)


def smagorinsky_viscosity(state: DomainState, geoms, topo: DomainTopo,
                          c_smag: float) -> tuple[Tensor, ...]:
    """Per-block Smagorinsky eddy viscosity ``(C_s Delta)^2 |S|``."""
    nd = topo.ndims
    out = []
    for geom, G in zip(geoms, velocity_gradients(state, geoms, topo)):
        S = 0.5 * (G + G.transpose(0, 1))
        S_mag = torch.sqrt(2.0 * torch.sum(S * S, dim=(0, 1)))
        delta2 = geom.det ** (2.0 / nd)
        out.append((c_smag**2) * delta2 * S_mag)
    return tuple(out)


def make_smagorinsky_hook(geoms, topo: DomainTopo, c_smag: float,
                          van_driest_sqr: tuple[Tensor, ...] | None = None):
    """PRE hook setting the per-block viscosity to ``nu + nu_SGS`` (``nu_SGS``
    times the squared Van Driest damping where given)."""

    def hook(state: DomainState, **kw) -> DomainState:
        nu_t = smagorinsky_viscosity(state, geoms, topo, c_smag)
        for b in range(len(topo.blocks)):
            visc = nu_t[b]
            if van_driest_sqr is not None:
                visc = visc * van_driest_sqr[b]
            visc = visc + state.viscosity
            state = state.replace_block(
                b, replace(state.blocks[b], viscosity=visc))
        return state

    return hook
