"""Core state and geometry: domain model, grid generation, metrics, IO."""

from fluidgym_tpu_torch.core import geometry
from fluidgym_tpu_torch.core.domain import (
    BCType,
    BlockGeom,
    BlockState,
    BlockTopo,
    BoundKind,
    DomainBuilder,
    DomainState,
    DomainTopo,
    FaceData,
    FaceSpec,
    domain_state_from_numpy,
    domain_state_to_numpy,
)

__all__ = [
    "geometry",
    "BCType",
    "BlockGeom",
    "BlockState",
    "BlockTopo",
    "BoundKind",
    "DomainBuilder",
    "DomainState",
    "DomainTopo",
    "FaceData",
    "FaceSpec",
    "domain_state_from_numpy",
    "domain_state_to_numpy",
]
