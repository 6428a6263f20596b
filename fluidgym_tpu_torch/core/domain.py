"""Domain / Block / Boundary data model (counterpart of
``fluidgym_tpu/core/domain.py``).

* **static topology** (block shapes, boundary kinds, BC types, connectivity)
  lives in frozen, hashable dataclasses (``FaceSpec``/``BlockTopo``/
  ``DomainTopo``), identical to the JAX package's;
* **geometry** (metric determinant, inverse metric, Laplace coefficients)
  lives in ``BlockGeom``, constant during simulation;
* **simulation state** (velocity/pressure/scalar/sources + boundary values)
  lives in ``BlockState``/``DomainState`` dataclasses of tensors.  The
  solver treats them as values: a step returns a new state built with
  ``dataclasses.replace`` and never writes into the tensors it was given.

``DomainBuilder`` mirrors the JAX builder and produces the three pieces on
an explicit ``device``.  ``domain_state_from_numpy`` / ``domain_state_to_numpy``
carry a state across from (and back to) any structure with the JAX
``DomainState`` field names and numpy leaves, so both packages can step from
exactly the same state.

Layout: fields are channel-first ``(C, *spatial)`` with spatial axes ordered
``[z, ]y, x``; physical axis ``d`` (0=x,1=y,2=z) maps to array axis ``-(d+1)``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from fluidgym_tpu_torch.core import geometry as geo

Tensor = torch.Tensor

__all__ = [
    "BoundKind",
    "BCType",
    "FaceSpec",
    "BlockTopo",
    "DomainTopo",
    "FaceData",
    "BlockGeom",
    "BlockState",
    "DomainState",
    "DomainBuilder",
    "domain_state_from_numpy",
    "domain_state_to_numpy",
    "map_state",
    "state_leaves",
    "state_from_leaves",
    "face_axis",
    "face_is_upper",
    "face_sign",
    "face_shape",
    "FACE_NAMES",
]

FACE_NAMES = ("-x", "+x", "-y", "+y", "-z", "+z")


def face_axis(f: int) -> int:
    """Physical axis of face index ``f`` (faces ordered -x,+x,-y,+y,-z,+z)."""
    return f // 2


def face_is_upper(f: int) -> bool:
    return bool(f % 2)


def face_sign(f: int) -> int:
    """-1 for lower faces, +1 for upper faces."""
    return -1 + 2 * (f % 2)


def face_shape(spatial: tuple[int, ...], f: int) -> tuple[int, ...]:
    """Spatial shape of a face slab: size 1 along the face axis."""
    d = face_axis(f)
    ax = len(spatial) - 1 - d
    s = list(spatial)
    s[ax] = 1
    return tuple(s)


class BoundKind(enum.IntEnum):
    """Boundary kinds."""

    FIXED = 0       # prescribed values
    PERIODIC = 1    # wraps to the opposite face of the same block
    CONNECTED = 2   # inter-block connection (multi-block domains)


class BCType(enum.IntEnum):
    """Per-field boundary-condition type on a FIXED boundary."""

    DIRICHLET = 0
    NEUMANN = 1     # for velocity: free-slip; for scalars: prescribed gradient


@dataclass(frozen=True)
class FaceSpec:
    """Static description of one block face (see the JAX ``FaceSpec`` for
    the CONNECTED ``axes`` encoding)."""

    kind: BoundKind = BoundKind.PERIODIC
    vel_type: BCType = BCType.DIRICHLET
    scalar_types: tuple[BCType, ...] = ()
    connected_block: int = -1
    connected_face: int = -1
    axes: tuple[int, ...] = ()


@dataclass(frozen=True)
class BlockTopo:
    """Static description of one block."""

    shape: tuple[int, ...]  # spatial cell shape, ordered (z,)y,x
    faces: tuple[FaceSpec, ...]
    orthogonal: bool
    name: str = "block"

    @property
    def ndims(self) -> int:
        return len(self.shape)


@dataclass(frozen=True)
class DomainTopo:
    """Static description of the whole domain."""

    blocks: tuple[BlockTopo, ...]
    ndims: int
    scalar_channels: int = 0
    name: str = "domain"

    @property
    def has_scalar(self) -> bool:
        return self.scalar_channels > 0


@dataclass
class FaceData:
    """Boundary value tensors for a FIXED face (None otherwise):
    ``velocity (ndims, *face_shape)``, ``scalar (channels, *face_shape)``."""

    velocity: Tensor | None = None
    scalar: Tensor | None = None


@dataclass
class BlockGeom:
    """Per-cell metric data: ``det (*s)``; ``minv_diag (d, *s)`` on
    orthogonal grids else None; ``minv (*s, d, d)`` on curvilinear grids else
    None; ``alpha (d, *s) = det * |M^-1 row_d|^2``; ``centers (d, *s)``."""

    det: Tensor
    minv_diag: Tensor | None
    minv: Tensor | None
    alpha: Tensor
    centers: Tensor


@dataclass
class BlockState:
    """Dynamic per-block simulation state."""

    velocity: Tensor                  # (ndims, *s)
    pressure: Tensor                  # (*s)
    scalar: Tensor | None             # (channels, *s)
    velocity_source: Tensor | None    # (ndims, *s), acceleration units
    faces: tuple[FaceData, ...]       # len 2*ndims
    viscosity: Tensor | None = None   # optional per-cell viscosity (*s)


@dataclass
class DomainState:
    """Dynamic domain state: all blocks plus global material parameters."""

    blocks: tuple[BlockState, ...]
    viscosity: Tensor                     # () kinematic viscosity
    scalar_diffusivity: Tensor | None     # (channels,)

    def replace_block(self, i: int, block: BlockState) -> "DomainState":
        blocks = list(self.blocks)
        blocks[i] = block
        return replace(self, blocks=tuple(blocks))


# ---------------------------------------------------------------------------
# a flat view of the state (what torch.func.vmap maps over)
# ---------------------------------------------------------------------------

def map_state(state: DomainState, fn) -> DomainState:
    """``state`` with every tensor ``t`` replaced by ``fn(t)``; ``None``
    fields stay ``None``.  Tensors are visited in one fixed order: per
    block velocity, pressure, scalar, velocity_source, viscosity, then its
    faces' velocity and scalar; then the domain's viscosity and scalar
    diffusivity."""
    f = lambda t: None if t is None else fn(t)
    blocks = []
    for b in state.blocks:
        fields = [f(b.velocity), f(b.pressure), f(b.scalar),
                  f(b.velocity_source), f(b.viscosity)]
        faces = tuple(FaceData(velocity=f(fd.velocity), scalar=f(fd.scalar))
                      for fd in b.faces)
        blocks.append(BlockState(velocity=fields[0], pressure=fields[1],
                                 scalar=fields[2], velocity_source=fields[3],
                                 faces=faces, viscosity=fields[4]))
    return DomainState(blocks=tuple(blocks), viscosity=f(state.viscosity),
                       scalar_diffusivity=f(state.scalar_diffusivity))


def state_leaves(state: DomainState) -> list[Tensor]:
    """The state's tensors in ``map_state`` order, ``None`` fields left out.
    The static topology is not part of the state."""
    out: list[Tensor] = []
    map_state(state, lambda t: out.append(t) or t)
    return out


def state_from_leaves(like: DomainState, leaves) -> DomainState:
    """The inverse of ``state_leaves``: a state with ``like``'s structure
    (which fields are ``None``) holding ``leaves``."""
    it = iter(leaves)
    state = map_state(like, lambda _: next(it))
    if next(it, None) is not None:
        raise ValueError("more leaves than the state has tensors")
    return state


# ---------------------------------------------------------------------------
# carrying a state across packages
# ---------------------------------------------------------------------------

def _to_tensor(a, device, dtype):
    if a is None:
        return None
    return torch.as_tensor(np.array(a, copy=True), device=device).to(dtype)


def _to_numpy(t):
    if t is None:
        return None
    return t.detach().cpu().numpy()


def domain_state_from_numpy(tree, device=None, dtype=None) -> DomainState:
    """Build a port ``DomainState`` from any object with the JAX
    ``DomainState`` field names and array-like leaves (e.g. a JAX state after
    ``jax.tree_util.tree_map(np.asarray, state)``).  ``device`` defaults to
    the CPU here: the caller names where the state should live."""
    from fluidgym_tpu_torch.config import config

    device = torch.device("cpu" if device is None else device)
    dtype = dtype or config.dtype
    conv = lambda a: _to_tensor(a, device, dtype)
    blocks = tuple(
        BlockState(
            velocity=conv(b.velocity),
            pressure=conv(b.pressure),
            scalar=conv(b.scalar),
            velocity_source=conv(b.velocity_source),
            faces=tuple(FaceData(velocity=conv(fd.velocity),
                                 scalar=conv(fd.scalar)) for fd in b.faces),
            viscosity=conv(getattr(b, "viscosity", None)),
        )
        for b in tree.blocks
    )
    return DomainState(blocks=blocks, viscosity=conv(tree.viscosity),
                       scalar_diffusivity=conv(tree.scalar_diffusivity))


def domain_state_to_numpy(state: DomainState) -> DomainState:
    """The inverse of ``domain_state_from_numpy``: the same structure with
    numpy leaves (host copies)."""
    return map_state(state, _to_numpy)


# ---------------------------------------------------------------------------
# Host-side builder
# ---------------------------------------------------------------------------

class _BlockBuilder:
    def __init__(self, domain: "DomainBuilder", vertex_coords: np.ndarray, name: str):
        vertex_coords = np.asarray(vertex_coords, dtype=np.float64)
        if vertex_coords.ndim != vertex_coords.shape[0] + 1:
            raise ValueError(
                "vertex_coords must have shape (ndims, *vertex_shape); got "
                f"{vertex_coords.shape}"
            )
        self.domain = domain
        self.name = name
        self.coords = vertex_coords
        self.ndims = vertex_coords.shape[0]
        self.shape = tuple(n - 1 for n in vertex_coords.shape[1:])

        M, Minv, det = geo.coords_to_transforms(vertex_coords)
        self._M, self._Minv, self._det = M, Minv, det
        self.orthogonal = geo.is_orthogonal(M)
        self._alpha = np.stack(
            [det * np.sum(Minv[..., d, :] ** 2, axis=-1) for d in range(self.ndims)],
            axis=0,
        )
        self._centers = geo.cell_centers(vertex_coords)

        self.faces: list[FaceSpec] = [FaceSpec() for _ in range(2 * self.ndims)]
        self.face_data: list[FaceData] = [FaceData() for _ in range(2 * self.ndims)]

        self.velocity = np.zeros((self.ndims, *self.shape))
        self.pressure = np.zeros(self.shape)
        self.scalar = (
            np.zeros((domain.scalar_channels, *self.shape))
            if domain.scalar_channels
            else None
        )
        self.velocity_source: np.ndarray | None = None

    def _face_index(self, face: int | str) -> int:
        if isinstance(face, str):
            face = FACE_NAMES.index(face)
        if not 0 <= face < 2 * self.ndims:
            raise ValueError(f"invalid face {face} for {self.ndims}D block")
        return face

    def close_boundary(
        self,
        face: int | str,
        velocity: Any | None = None,
        scalar: Any | None = None,
        vel_type: BCType = BCType.DIRICHLET,
        scalar_types: tuple[BCType, ...] | None = None,
    ) -> None:
        """Make a face a FIXED boundary (default: no-slip wall, zero
        Dirichlet scalar).  Closing one face of a PERIODIC pair also closes
        the partner face with a default wall; closing a CONNECTED face
        severs the seam on both sides (the neighbour's face becomes a
        default wall too)."""
        f = self._face_index(face)
        c = self.domain.scalar_channels
        if self.faces[f].kind == BoundKind.CONNECTED:
            nb = self.domain._blocks[self.faces[f].connected_block]
            nf = self.faces[f].connected_face
            my_index = self.domain._blocks.index(self)
            if (nb.faces[nf].kind == BoundKind.CONNECTED
                    and nb.faces[nf].connected_block == my_index
                    and nb.faces[nf].connected_face == f):
                fs_n = face_shape(nb.shape, nf)
                nb.faces[nf] = FaceSpec(
                    kind=BoundKind.FIXED,
                    vel_type=BCType.DIRICHLET,
                    scalar_types=tuple(BCType.DIRICHLET for _ in range(c)),
                )
                nb.face_data[nf] = FaceData(
                    velocity=np.zeros((nb.ndims, *fs_n)),
                    scalar=np.zeros((c, *fs_n)) if c else None,
                )
        partner = f ^ 1
        if (
            self.faces[f].kind == BoundKind.PERIODIC
            and self.faces[partner].kind == BoundKind.PERIODIC
        ):
            fs_p = face_shape(self.shape, partner)
            self.faces[partner] = FaceSpec(
                kind=BoundKind.FIXED,
                vel_type=BCType.DIRICHLET,
                scalar_types=tuple(BCType.DIRICHLET for _ in range(c)),
            )
            self.face_data[partner] = FaceData(
                velocity=np.zeros((self.ndims, *fs_p)),
                scalar=np.zeros((c, *fs_p)) if c else None,
            )
        fs = face_shape(self.shape, f)
        if scalar_types is None:
            scalar_types = tuple(BCType.DIRICHLET for _ in range(c))
        vel = np.zeros((self.ndims, *fs)) if velocity is None else np.broadcast_to(
            np.asarray(velocity, dtype=np.float64), (self.ndims, *fs)
        ).copy()
        scal = None
        if c:
            scal = (
                np.zeros((c, *fs))
                if scalar is None
                else np.broadcast_to(np.asarray(scalar, dtype=np.float64), (c, *fs)).copy()
            )
        self.faces[f] = FaceSpec(
            kind=BoundKind.FIXED, vel_type=vel_type, scalar_types=tuple(scalar_types)
        )
        self.face_data[f] = FaceData(velocity=vel, scalar=scal)

    def set_velocity(self, velocity) -> None:
        self.velocity = np.broadcast_to(
            np.asarray(velocity, np.float64), (self.ndims, *self.shape)
        ).copy()

    def set_pressure(self, pressure) -> None:
        self.pressure = np.broadcast_to(
            np.asarray(pressure, np.float64), self.shape
        ).copy()

    def set_scalar(self, scalar) -> None:
        c = self.domain.scalar_channels
        if not c:
            raise ValueError("domain has no passive scalar channels")
        self.scalar = np.broadcast_to(
            np.asarray(scalar, np.float64), (c, *self.shape)
        ).copy()

    def set_velocity_source(self, source) -> None:
        self.velocity_source = np.broadcast_to(
            np.asarray(source, np.float64), (self.ndims, *self.shape)
        ).copy()


class DomainBuilder:
    """Imperative builder producing ``(DomainTopo, geoms, DomainState)``
    with every tensor on ``device``."""

    def __init__(
        self,
        ndims: int,
        viscosity: float,
        scalar_channels: int = 0,
        name: str = "domain",
        dtype=None,
        device=None,
    ):
        from fluidgym_tpu_torch.config import config

        self.ndims = int(ndims)
        self.viscosity = float(viscosity)
        self.scalar_channels = int(scalar_channels)
        self.scalar_diffusivity: np.ndarray | None = None
        self.name = name
        self.dtype = dtype or config.dtype
        self.device = torch.device("cpu" if device is None else device)
        self._blocks: list[_BlockBuilder] = []

    def create_block(self, vertex_coords, name: str | None = None) -> _BlockBuilder:
        b = _BlockBuilder(self, vertex_coords, name or f"block{len(self._blocks)}")
        if b.ndims != self.ndims:
            raise ValueError("block dimensionality must match domain")
        self._blocks.append(b)
        return b

    def set_scalar_diffusivity(self, diffusivity) -> None:
        self.scalar_diffusivity = np.broadcast_to(
            np.asarray(diffusivity, np.float64), (self.scalar_channels,)
        ).copy()

    def connect_blocks(
        self,
        block_a: int,
        face_a: int | str,
        block_b: int,
        face_b: int | str,
        connected_axis_a: int | str | None = None,
        connected_axis_b: int | str | None = None,
    ) -> None:
        """Connect two block faces (CONNECTED on both sides).

        ``connected_axis_a``: face index (or name like "-y") on block_b that
        block_a's first tangential axis ``(face_axis+1) % ndims`` maps onto;
        ``connected_axis_b`` likewise for the second tangential axis in 3D.
        Defaults to the aligned (non-inverted, cyclic) mapping.  The
        resulting ``FaceSpec.axes`` encoding is the JAX package's.
        """
        a = self._blocks[block_a]
        b = self._blocks[block_b]
        fa = a._face_index(face_a)
        fb = b._face_index(face_b)
        d = self.ndims
        fa_dim, fb_dim = fa // 2, fb // 2

        def _axidx(v, blk):
            return blk._face_index(v) if v is not None else None

        ca = _axidx(connected_axis_a, b)
        cb = _axidx(connected_axis_b, b)
        if d > 1 and ca is None:
            ca = (((fb_dim + 1) % d) << 1)
        if d > 2 and cb is None:
            cb = (((fb_dim + 2) % d) << 1)

        axes_a: list[int] = [fb]
        axes_b: list[int] = [fa]
        if d > 1:
            axes_a.append(ca)
            if d == 2 and (ca >> 1) != (fb_dim + 1) % d:
                # in 2D the single tangential axis must map onto the
                # neighbour's single tangential axis
                raise ValueError(
                    "invalid connection axis mapping: connected_axis_a must "
                    "be the neighbor's tangential axis in 2D")
            if d == 2 or (ca >> 1) == (fb_dim + 1) % d:
                axes_b.append((((fa_dim + 1) % d) << 1) | (ca & 1))
                swapped = False
            else:
                if (cb >> 1) != (fb_dim + 1) % d:
                    raise ValueError("invalid connection axis mapping")
                axes_b.append((((fa_dim + 2) % d) << 1) | (cb & 1))
                swapped = True
            if d > 2:
                axes_a.append(cb)
                if not swapped:
                    axes_b.append((((fa_dim + 2) % d) << 1) | (cb & 1))
                else:
                    axes_b.append((((fa_dim + 1) % d) << 1) | (ca & 1))

        # tangential extents must agree cell for cell
        fs_a = face_shape(a.shape, fa)
        fs_b = face_shape(b.shape, fb)
        if sorted(fs_a) != sorted(fs_b):
            raise ValueError(
                f"connected faces have incompatible sizes: block {block_a} "
                f"face {fa} is {fs_a}, block {block_b} face {fb} is {fs_b}")
        a.faces[fa] = FaceSpec(kind=BoundKind.CONNECTED, connected_block=block_b,
                               connected_face=fb, axes=tuple(axes_a))
        b.faces[fb] = FaceSpec(kind=BoundKind.CONNECTED, connected_block=block_a,
                               connected_face=fa, axes=tuple(axes_b))
        # a reconnected face drops its prescribed-value arrays
        a.face_data[fa] = FaceData()
        b.face_data[fb] = FaceData()

    def build(self):
        """Produce ``(topo, geoms, state)``."""
        conv = lambda a: _to_tensor(a, self.device, self.dtype)
        topo_blocks = []
        geoms = []
        states = []
        for b in self._blocks:
            topo_blocks.append(
                BlockTopo(shape=b.shape, faces=tuple(b.faces),
                          orthogonal=b.orthogonal, name=b.name)
            )
            if b.orthogonal:
                minv_diag = np.stack(
                    [b._Minv[..., d, d] for d in range(self.ndims)], axis=0)
                minv = None
            else:
                minv_diag = None
                minv = b._Minv
            geoms.append(BlockGeom(det=conv(b._det), minv_diag=conv(minv_diag),
                                   minv=conv(minv), alpha=conv(b._alpha),
                                   centers=conv(b._centers)))
            faces = tuple(FaceData(velocity=conv(fd.velocity),
                                   scalar=conv(fd.scalar))
                          for fd in b.face_data)
            states.append(BlockState(
                velocity=conv(b.velocity),
                pressure=conv(b.pressure),
                scalar=conv(b.scalar),
                velocity_source=conv(b.velocity_source),
                faces=faces,
                viscosity=None,
            ))
        topo = DomainTopo(blocks=tuple(topo_blocks), ndims=self.ndims,
                          scalar_channels=self.scalar_channels, name=self.name)
        state = DomainState(
            blocks=tuple(states),
            viscosity=conv(self.viscosity),
            scalar_diffusivity=conv(self.scalar_diffusivity),
        )
        return topo, tuple(geoms), state
