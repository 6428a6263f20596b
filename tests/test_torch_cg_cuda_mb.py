"""K2 (fluidgym_tpu_torch.ops.cg_cuda_mb): the plain PyTorch version against
the TPU kernel ``fluidgym_tpu.ops.cg_pallas_mb.fused_bicgstab_mb`` over
``block_merge.trivial_plan``, in interpret mode.

Lanes are solve components (and batch entries under ``jax.vmap``), each
with its own NORM2_NORMALIZED stopping test, one shared iteration counter.
Parity bar (Krylov solves): both converge, iteration counts within 2,
solutions within ``max|dx| <= 1e-4 max|x|`` at tol 1e-6 (these systems are
well conditioned, so the tolerance pins the solution that closely).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidgym_tpu.core import geometry as jgeo
from fluidgym_tpu.core.domain import DomainBuilder as JDomainBuilder
from fluidgym_tpu.ops import cg_pallas_mb
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge
from torch_port_helpers import assert_rel, nonsym_stencil

torch.set_num_threads(1)

SHAPE = (12, 24)
KW = dict(maxiter=400, stall_iters=250, precondition=True, return_best=False)


def _plans():
    grid = jgeo.make_uniform_grid((SHAPE[1], SHAPE[0]), (0, 0), (2.0, 1.0))
    jd = JDomainBuilder(ndims=2, viscosity=0.01)
    jb = jd.create_block(grid)
    jb.close_boundary("-y")
    jtopo = jd.build()[0]
    td = DomainBuilder(ndims=2, viscosity=0.01)
    tb = td.create_block(grid)
    tb.close_boundary("-y")
    ttopo = td.build()[0]
    return jbm.trivial_plan(jtopo), block_merge.trivial_plan(ttopo)


def _jax(plan, diag, off, b, x0, tol, **kw):
    kw = {**KW, **kw}
    xs, info = cg_pallas_mb.fused_bicgstab_mb(
        plan, (jnp.asarray(diag),), (jnp.asarray(off),), (jnp.asarray(b),),
        None if x0 is None else (jnp.asarray(x0),), tol=tol, interpret=True,
        **kw)
    return np.asarray(xs[0]), info


def _port(plan, diag, off, b, x0, tol, **kw):
    kw = {**KW, **kw}
    xs, info = cg_cuda_mb.fused_bicgstab_mb(
        plan, (torch.from_numpy(diag),), (torch.from_numpy(off),),
        (torch.from_numpy(b),), None if x0 is None else (torch.from_numpy(x0),),
        tol=tol, **kw)
    return xs[0].numpy(), info


def test_trivial_plan_matches_jax():
    jplan, tplan = _plans()
    assert len(tplan.superblocks) == 1 and tplan.fixups == ()
    assert tplan.superblocks[0].shape == jplan.superblocks[0].shape
    assert tplan.ndims == jplan.ndims


@pytest.mark.parametrize("C,warm", [(1, True), (2, False), (2, True)])
def test_plain_k2_matches_pallas(C, warm):
    jplan, tplan = _plans()
    diag, off = nonsym_stencil(SHAPE, 2, seed=C)
    rng = np.random.default_rng(10 + C)
    b = rng.normal(size=(C,) + SHAPE).astype(np.float32)
    x0 = (b * 0.3).astype(np.float32) if warm else None
    xj, ij = _jax(jplan, diag, off, b, x0, 1e-6)
    xt, it = _port(tplan, diag, off, b, x0, 1e-6)
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    assert_rel(xt, xj, 1e-4, f"C={C} warm={warm}")
    np.testing.assert_allclose(float(it.residual), float(ij.residual),
                               rtol=0.5, atol=1e-7)


def test_plain_k2_per_component_stopping_and_zero_lane():
    """Components of very different scale: each lane must meet the
    tolerance on its own (the JAX kernel's per-component test, tighter than
    linsolve.bicgstab's joint one); an all-zero component stays zero."""
    jplan, tplan = _plans()
    diag, off = nonsym_stencil(SHAPE, 2, seed=4)
    rng = np.random.default_rng(4)
    b = rng.normal(size=(3,) + SHAPE).astype(np.float32)
    b[1] *= 1e-3
    b[2] = 0.0
    tol = 1e-6
    xj, ij = _jax(jplan, diag, off, b, None, tol)
    xt, it = _port(tplan, diag, off, b, None, tol)
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    assert (xt[2] == 0).all()
    assert_rel(xt[:2], xj[:2], 1e-4)
    # per-lane true residual of the port's solution
    mv = lambda v: cg_cuda.roll_matvec(torch.from_numpy(diag)[None],
                                       torch.from_numpy(off)[None], v, 2)
    r = (torch.from_numpy(b) - mv(torch.from_numpy(xt))).reshape(3, -1)
    rmse = torch.sqrt((r * r).mean(dim=1))
    assert float(rmse[1]) <= 2 * tol, rmse


def test_plain_k2_vmap_batch_lockstep_and_stall():
    """A vmapped batch folds batch x components onto lanes in the JAX
    kernel; the port's plain version runs the same lanes in lockstep.  A
    tolerance below fp32 reach ends the solve by stall patience."""
    jplan, _ = _plans()
    diag, off = nonsym_stencil(SHAPE, 2, seed=8)
    rng = np.random.default_rng(8)
    B = rng.normal(size=(2, 2) + SHAPE).astype(np.float32)
    B[1, 0] *= 1e-2
    for tol, stall in ((1e-6, 250), (1e-10, 15)):
        kw = {**KW, "stall_iters": stall, "return_best": True}

        def one(b):
            return cg_pallas_mb.fused_bicgstab_mb(
                jplan, (jnp.asarray(diag),), (jnp.asarray(off),), (b,),
                tol=tol, interpret=True, **kw)

        xs_j, info_j = jax.vmap(one)(jnp.asarray(B))
        n = SHAPE[0] * SHAPE[1]
        xt, itt, rst = cg_cuda_mb.fused_bicgstab_plain(
            torch.from_numpy(diag)[None], torch.from_numpy(off)[None],
            torch.from_numpy(B.reshape((4,) + SHAPE)), None, ndims=2,
            tol2_sum=cg_cuda.tol2_sum_f32(tol, n), **kw)
        it_j = np.asarray(info_j.iterations)
        assert np.all(it_j == it_j[0]) and np.all(itt.numpy() == int(itt[0]))
        assert abs(int(itt[0]) - int(it_j[0])) <= 2
        conv_t = (rst.numpy() <= cg_cuda.tol2_sum_f32(tol, n)).reshape(2, 2).all(1)
        np.testing.assert_array_equal(conv_t, np.asarray(info_j.converged))
        assert_rel(xt.numpy().reshape(B.shape), np.asarray(xs_j[0]),
                   1e-4 if tol > 1e-8 else 1e-3, f"tol={tol}")
