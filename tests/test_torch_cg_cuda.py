"""K1 (fluidgym_tpu_torch.ops.cg_cuda): the plain PyTorch version against
the TPU kernel ``fluidgym_tpu.ops.cg_pallas.fused_cg`` in interpret mode.

On the CPU the wrapper ``fused_cg`` runs the plain version, so these tests
hold the port's lockstep semantics (shared iteration counter, per-lane
freeze, stall patience, return-best, the 100-iteration true-residual
refresh, zero-RHS lanes) against the Pallas kernel's.  Parity bar (Krylov
solves): both converge (or both stop the same way), iteration counts within
3, solutions within the error the tolerance allows (``max|dx| <= 2e-4
max|x|`` at tol 1e-6 on these well-scaled systems).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidgym_tpu.ops import cg_pallas
from fluidgym_tpu_torch.ops import cg_cuda
from torch_port_helpers import assert_rel, spd_stencil

torch.set_num_threads(1)

KW = dict(maxiter=400, stall_iters=250, precondition=True, return_best=True)


def _jax_lanes(diag, off, B, ndims, tol, x0=None, **kw):
    """The Pallas kernel over a lane batch (its custom_vmap rule folds the
    batch onto in-kernel lanes, as the env batch does)."""
    kw = {**KW, **kw}

    def one(b, x):
        return cg_pallas.fused_cg(jnp.asarray(diag), jnp.asarray(off), b,
                                  x0=x, ndims=ndims, tol=tol, interpret=True,
                                  **kw)

    if x0 is None:
        x, info = jax.vmap(lambda b: one(b, None))(jnp.asarray(B))
    else:
        x, info = jax.vmap(one)(jnp.asarray(B), jnp.asarray(x0))
    return (np.asarray(x), np.asarray(info.iterations),
            np.asarray(info.converged), np.asarray(info.residual))


def _port_lanes(diag, off, B, ndims, tol, x0=None, **kw):
    # chunk = every lane: one lockstep loop, as the Pallas kernel runs them
    kw = {**KW, "chunk": B.shape[0], **kw}
    x, info = cg_cuda.fused_cg(
        torch.from_numpy(diag), torch.from_numpy(off), torch.from_numpy(B),
        None if x0 is None else torch.from_numpy(x0), ndims=ndims, tol=tol,
        **kw)
    return (x.numpy(), info.iterations.numpy(), info.converged.numpy(),
            info.residual.numpy())


@pytest.mark.parametrize("shape,ndims", [((12, 32), 2), ((4, 6, 16), 3)])
def test_plain_k1_matches_pallas_multilane_with_zero_lane(shape, ndims):
    diag, off = spd_stencil(shape, ndims, seed=0)
    rng = np.random.default_rng(1)
    B = rng.normal(size=(3,) + shape).astype(np.float32)
    B[1] = 0.0                       # zero RHS -> zero solution
    B[2] *= 1e-3                     # converges at its own speed
    xj, itj, cj, rj = _jax_lanes(diag, off, B, ndims, 1e-6)
    xt, itt, ct, rt = _port_lanes(diag, off, B, ndims, 1e-6)
    assert cj.all() and ct.all()
    assert np.all(itt == itt[0]), "one shared iteration counter"
    assert np.abs(itt.astype(int) - itj.astype(int)).max() <= 3
    assert (xt[1] == 0).all()
    for lane in (0, 2):
        assert_rel(xt[lane], xj[lane], 2e-4, f"lane {lane}")
    assert (rt <= 1e-6).all()


def test_plain_k1_past_iteration_100_and_stall():
    """A near-singular operator: the lockstep loop runs past iteration 100
    (true-residual refresh, applied to frozen lanes too) and a lane that
    cannot reach the tight tolerance stops by stall patience and returns
    its best iterate."""
    shape, ndims = (16, 24), 2
    diag, off = spd_stencil(shape, ndims, seed=5, shift=2e-4)
    rng = np.random.default_rng(7)
    B = rng.normal(size=(4,) + shape).astype(np.float32)
    B[2] = 0.0
    B[3] *= 1e-2
    kw = dict(maxiter=600, stall_iters=40)
    xj, itj, cj, rj = _jax_lanes(diag, off, B, ndims, 2e-8, **kw)
    xt, itt, ct, rt = _port_lanes(diag, off, B, ndims, 2e-8, **kw)
    assert int(itt[0]) > 100 and int(itj[0]) > 100
    assert abs(int(itt[0]) - int(itj[0])) <= 3
    np.testing.assert_array_equal(ct, cj)
    assert not ct[0], "lane 0 should stall at this tolerance"
    assert (xt[2] == 0).all() and ct[2]
    # a stalled lane returns its best iterate; in the fp32 stagnation regime
    # the best residual is rounding noise, so both sides only agree on its
    # order of magnitude (factor 4), above the tolerance
    assert rt[0] > 2e-8 and rj[0] > 2e-8
    assert 0.25 <= rt[0] / rj[0] <= 4.0
    for lane in (0, 1, 3):
        assert_rel(xt[lane], xj[lane], 2e-3, f"lane {lane}")


def test_plain_k1_warm_start_and_no_precond():
    shape, ndims = (10, 20), 2
    diag, off = spd_stencil(shape, ndims, seed=2)
    rng = np.random.default_rng(3)
    B = rng.normal(size=(2,) + shape).astype(np.float32)
    x0 = rng.normal(size=(2,) + shape).astype(np.float32)
    for pre in (True, False):
        xj, itj, cj, _ = _jax_lanes(diag, off, B, ndims, 1e-6, x0=x0,
                                    precondition=pre)
        xt, itt, ct, _ = _port_lanes(diag, off, B, ndims, 1e-6, x0=x0,
                                     precondition=pre)
        assert cj.all() and ct.all()
        assert abs(int(itt[0]) - int(itj[0])) <= 3
        assert_rel(xt, xj, 2e-4, f"precondition={pre}")


def test_wrapper_dispatch_counts():
    """CPU tensors take the plain version and never count a launch."""
    diag, off = spd_stencil((8, 16), 2)
    B = np.ones((1, 8, 16), np.float32)
    launches = cg_cuda.fused_cg.launches
    calls = cg_cuda.fused_cg_plain.calls
    cg_cuda.fused_cg(torch.from_numpy(diag), torch.from_numpy(off),
                     torch.from_numpy(B), ndims=2, tol=1e-5)
    assert cg_cuda.fused_cg.launches == launches
    assert cg_cuda.fused_cg_plain.calls == calls + 1
