"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  This file imports
neither JAX nor the JAX package, so on the card's machine (which has no JAX)
it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Bar: iteration counts within 3, ``max|dx| <= 1e-3 max|x|`` (the kernel sums
its dot products in another order than PyTorch), zero-RHS lanes exactly 0.
"""

import numpy as np
import pytest
import torch

import fluidgym_tpu_torch
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.core import geometry
from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge, piso
from fluidgym_tpu_torch.solver.stencil import StencilOp
from torch_port_helpers import (SMALL_RBC_KW, assert_rel, nonsym_stencil,
                                require_cuda, spd_stencil)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

SHAPE = (61, 96)  # the RBC2D-easy-v0 block


def _lanes(seed, L, scale_lane=1, zero_lane=2):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(L,) + SHAPE).astype(np.float32)
    if L > zero_lane:
        B[zero_lane] = 0.0
    if L > scale_lane:
        B[scale_lane] *= 1e-3
    return B


@pytest.mark.parametrize("L,shift,tol", [(1, 0.05, 1e-5), (4, 1e-3, 1e-7)])
def test_k1_kernel_matches_plain(L, shift, tol):
    dev = require_cuda()
    diag, off = (torch.from_numpy(a).to(dev) for a in spd_stencil(SHAPE, 2, 0, shift))
    B = torch.from_numpy(_lanes(1, L)).to(dev)
    n = SHAPE[0] * SHAPE[1]
    kw = dict(ndims=2, maxiter=2000, stall_iters=250, precondition=True,
              return_best=True)
    launches = cg_cuda.fused_cg.launches
    x, info = cg_cuda.fused_cg(diag, off, B, tol=tol, **kw)
    assert cg_cuda.fused_cg.launches == launches + 1
    xp, ip, rp = cg_cuda.fused_cg_plain(diag[None], off[None], B, None,
                                        tol2_sum=cg_cuda.tol2_sum_f32(tol, n), **kw)
    torch.cuda.synchronize()
    assert abs(int(info.iterations[0]) - int(ip[0])) <= 3
    assert torch.equal(info.iterations, info.iterations[:1].expand(L))
    if L > 2:
        assert bool((x[2] == 0).all())
    assert_rel(x.cpu().numpy(), xp.cpu().numpy(), 1e-3)


@pytest.mark.parametrize("C,warm", [(1, True), (2, True), (3, False)])
def test_k2_kernel_matches_plain(C, warm):
    dev = require_cuda()
    topo = DomainBuilder(ndims=2, viscosity=0.01)
    topo.create_block(geometry.make_uniform_grid((SHAPE[1], SHAPE[0]),
                                                 (0, 0), (1.0, 1.0)))
    plan = block_merge.trivial_plan(topo.build()[0])
    diag, off = (torch.from_numpy(a).to(dev) for a in nonsym_stencil(SHAPE, 2, C))
    b = torch.from_numpy(_lanes(2 + C, C)).to(dev)
    x0 = 0.5 * b if warm else None
    n = SHAPE[0] * SHAPE[1]
    kw = dict(maxiter=2000, stall_iters=250, precondition=True,
              return_best=False)
    launches = cg_cuda_mb.fused_bicgstab_mb.launches
    xs, info = cg_cuda_mb.fused_bicgstab_mb(
        plan, (diag,), (off,), (b,), None if x0 is None else (x0,),
        tol=1e-6, **kw)
    assert cg_cuda_mb.fused_bicgstab_mb.launches == launches + 1
    xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(
        diag[None], off[None], b, x0, ndims=2,
        tol2_sum=cg_cuda.tol2_sum_f32(1e-6, n), **kw)
    torch.cuda.synchronize()
    assert bool(info.converged)
    assert abs(int(info.iterations) - int(ip[0])) <= 3
    assert_rel(xs[0].cpu().numpy(), xp.cpu().numpy(), 1e-3)


def test_env_step_on_card_goes_through_kernels():
    require_cuda()
    k1, k2 = cg_cuda.fused_cg.launches, cg_cuda_mb.fused_bicgstab_mb.launches
    plain = cg_cuda.fused_cg_plain.calls + cg_cuda_mb.fused_bicgstab_plain.calls
    env = fluidgym_tpu_torch.make("RBC2D-easy-v0", **SMALL_RBC_KW)
    env.reset(seed=0)
    obs, reward, *_ , info = env.step(np.zeros(env.action_space.shape, np.float32))
    assert cg_cuda.fused_cg.launches > k1
    assert cg_cuda_mb.fused_bicgstab_mb.launches > k2
    assert (cg_cuda.fused_cg_plain.calls
            + cg_cuda_mb.fused_bicgstab_plain.calls) == plain
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert np.isfinite(float(info["nusselt"]))


@pytest.mark.parametrize("case", ["float64", "channel_stencil"])
def test_card_solve_without_a_kernel_raises(case):
    """On the card a system the kernels do not take raises; nothing falls
    back to linsolve's plain loops."""
    dev = require_cuda()
    builder = DomainBuilder(ndims=2, viscosity=0.01)
    builder.create_block(geometry.make_uniform_grid((SHAPE[1], SHAPE[0]),
                                                    (0, 0), (1.0, 1.0)))
    topo = builder.build()[0]
    diag, off = (torch.from_numpy(a).to(dev) for a in spd_stencil(SHAPE, 2, 0))
    b = torch.from_numpy(_lanes(7, 1)[0]).to(dev)
    if case == "float64":
        diag, off, b = diag.double(), off.double(), b.double()
        expected = ValueError
    else:
        diag, off = diag.expand(2, *SHAPE), off.expand(2, *off.shape)
        expected = NotImplementedError
    for symmetric in (True, False):
        with pytest.raises(expected):
            piso._solve((StencilOp(diag=diag, off=off),), (b,), topo,
                        tol=1e-5, maxiter=100, symmetric=symmetric,
                        return_best=True)
