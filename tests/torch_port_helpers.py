"""Shared helpers of the ``test_torch_*`` files (the PyTorch port's tests).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU and data crosses as numpy arrays.
"""

import numpy as np
import pytest
import torch

#: small RBC2D config: 16 x 10 cells, short steps, no dataset files
SMALL_RBC_KW = dict(
    n_heaters=4,
    resolution=4,
    load_initial_domain=False,
    load_domain_statistics=False,
    randomize_initial_state=False,
    episode_length=5,
    step_length=0.1,
    dt=0.05,
    local_obs_window=3,
)


def require_cuda() -> torch.device:
    """The CUDA device, or skip: called inside a test or fixture, never at
    import (workers must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card's machine run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py`")
    return torch.device("cuda")


def spd_stencil(shape, ndims, seed=0, shift=0.05):
    """Random diagonally-dominant SPD stencil in StencilOp layout
    (symmetric negative off-coefficients, periodic wrap), float32 numpy."""
    rng = np.random.default_rng(seed)
    offs = []
    for d in range(ndims):
        ax = len(shape) - 1 - d
        c = rng.uniform(0.5, 1.5, size=shape)
        offs.extend([-c, -np.roll(c, -1, axis=ax)])
    off = np.stack(offs, axis=0)
    diag = -off.sum(axis=0) + shift
    return diag.astype(np.float32), off.astype(np.float32)


def nonsym_stencil(shape, ndims, seed=0, skew=0.4):
    """Random non-symmetric, diagonally dominant advection-like stencil."""
    rng = np.random.default_rng(seed)
    offs = []
    for _ in range(2 * ndims):
        offs.append(-rng.uniform(0.2, 1.0, size=shape)
                    + skew * rng.uniform(-1.0, 1.0, size=shape))
    off = np.stack(offs, axis=0)
    diag = np.abs(off).sum(axis=0) + 0.5
    return diag.astype(np.float32), off.astype(np.float32)


def assert_rel(a, b, rtol, what=""):
    """max|a - b| <= rtol * max|b| (relative to the field's scale)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max()
    assert err <= rtol * scale, f"{what}: max|diff| {err:.3e} > {rtol:g} * {scale:.3e}"

#: small CylinderJet2D config: resolution 16 (5 blocks, 2 super-blocks),
#: two sim steps of dt 0.01 per env step, no dataset files
CYL_KW = dict(
    resolution=16,
    load_initial_domain=False,
    load_domain_statistics=False,
    randomize_initial_state=False,
    step_length=0.02,
    dt=0.01,
)


def jax_domain_state(host, dtype=np.float32):
    """A JAX package ``DomainState`` from a port state with numpy leaves
    (``domain_state_to_numpy``), every array cast to ``dtype``.  Imports JAX
    here, so the card-only tests, which import this module, stay JAX-free."""
    import jax.numpy as jnp

    from fluidgym_tpu.core import domain as jdom

    f = lambda a: None if a is None else jnp.asarray(np.asarray(a, dtype))
    blocks = tuple(
        jdom.BlockState(
            velocity=f(b.velocity), pressure=f(b.pressure), scalar=f(b.scalar),
            velocity_source=f(b.velocity_source),
            faces=tuple(jdom.FaceData(velocity=f(fd.velocity), scalar=f(fd.scalar))
                        for fd in b.faces),
            viscosity=f(b.viscosity))
        for b in host.blocks)
    return jdom.DomainState(blocks=blocks, viscosity=f(host.viscosity),
                            scalar_diffusivity=f(host.scalar_diffusivity))
