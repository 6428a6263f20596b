"""Domain reading: JSON topology + npz tensors (counterpart of
``fluidgym_tpu/core/domain_io.py``, the package's own ``format_version``
layout that every bundled dataset uses).

Not ported yet: ``save_domain`` (dataset generation and checkpoints) and
reading the PICT reference layout (``spatialDims``-marked files, which
raise ``NotImplementedError``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from fluidgym_tpu_torch.core.domain import (
    BCType,
    BlockGeom,
    BlockState,
    BlockTopo,
    BoundKind,
    DomainState,
    DomainTopo,
    FaceData,
    FaceSpec,
)

__all__ = ["load_domain"]


def _spec_from_json(d: dict) -> FaceSpec:
    return FaceSpec(
        kind=BoundKind[d["kind"]],
        vel_type=BCType[d["vel_type"]],
        scalar_types=tuple(BCType[t] for t in d["scalar_types"]),
        connected_block=d.get("connected_block", -1),
        connected_face=d.get("connected_face", -1),
        axes=tuple(d.get("axes", ())),
    )


def load_domain(path: str | Path, dtype=None, device=None):
    """Read ``<path>.json`` + ``<path>.npz`` into ``(topo, geoms, state)``
    with every tensor on ``device`` (the CPU if None)."""
    from fluidgym_tpu_torch.config import config

    dtype = dtype or config.dtype
    device = torch.device("cpu" if device is None else device)
    path = Path(path)
    json_path = path.with_suffix(".json")
    npz_path = path.with_suffix(".npz")
    if not json_path.exists() or not npz_path.exists():
        raise FileNotFoundError(f"domain files not found at {path}(.json/.npz)")
    with open(json_path) as fh:
        meta = json.load(fh)
    if "format_version" not in meta:
        raise NotImplementedError(
            f"{json_path} is not in the package's own domain layout; the "
            "reference (PICT) layout reader is not ported yet")
    with np.load(npz_path) as npz:
        data = {k: npz[k] for k in npz.files}

    def get(key):
        if key is None:
            return None
        return torch.as_tensor(data[key], device=device).to(dtype)

    topo_blocks = []
    geoms = []
    states = []
    for b in meta["blocks"]:
        topo_blocks.append(BlockTopo(
            shape=tuple(b["shape"]),
            faces=tuple(_spec_from_json(f) for f in b["faces"]),
            orthogonal=bool(b["orthogonal"]),
            name=b["name"],
        ))
        geoms.append(BlockGeom(det=get(b["det"]), minv_diag=get(b["minv_diag"]),
                               minv=get(b["minv"]), alpha=get(b["alpha"]),
                               centers=get(b["centers"])))
        states.append(BlockState(
            velocity=get(b["velocity"]),
            pressure=get(b["pressure"]),
            scalar=get(b["scalar"]),
            velocity_source=get(b["velocity_source"]),
            faces=tuple(FaceData(velocity=get(f["velocity"]),
                                 scalar=get(f["scalar"])) for f in b["faces"]),
            viscosity=get(b.get("block_viscosity")),
        ))
    topo = DomainTopo(
        blocks=tuple(topo_blocks),
        ndims=int(meta["ndims"]),
        scalar_channels=int(meta["scalar_channels"]),
        name=meta.get("name", "domain"),
    )
    state = DomainState(blocks=tuple(states), viscosity=get(meta["viscosity"]),
                        scalar_diffusivity=get(meta["scalar_diffusivity"]))
    return topo, tuple(geoms), state
