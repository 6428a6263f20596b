"""``fluidgym_tpu_torch.solver.linsolve`` (unbatched CG / BiCGStab) against
``fluidgym_tpu.solver.linsolve`` on the same stencil systems.  Parity bar
(Krylov solves): both converge (or stop the same way), iteration counts
within 3, solutions within ``max|dx| <= 2e-4 max|x|`` at tol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidgym_tpu.solver import linsolve as jls
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.solver import linsolve as tls
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import assert_rel, nonsym_stencil, spd_stencil

torch.set_num_threads(1)
SHAPE = (14, 20)


def _systems(kind, seed, shift=0.05):
    diag, off = (spd_stencil(SHAPE, 2, seed, shift) if kind == "spd"
                 else nonsym_stencil(SHAPE, 2, seed))
    jop = jst.StencilOp(diag=jnp.asarray(diag), off=jnp.asarray(off))
    top = tst.StencilOp(diag=torch.from_numpy(diag), off=torch.from_numpy(off))
    jmv = lambda v: (jst.stencil_apply(jop, v[0], 2),)
    tmv = lambda v: (tst.stencil_apply(top, v[0], 2),)
    jpc = lambda r: (r[0] / jop.diag,)
    tpc = lambda r: (r[0] / top.diag,)
    return (jmv, jpc), (tmv, tpc)


def _run(solver, kind, b, x0=None, seed=0, shift=0.05, **kw):
    (jmv, jpc), (tmv, tpc) = _systems(kind, seed, shift)
    jx, ji = getattr(jls, solver)(jmv, (jnp.asarray(b),),
                                  None if x0 is None else (jnp.asarray(x0),),
                                  precond=jpc, **kw)
    tx, ti = getattr(tls, solver)(tmv, (torch.from_numpy(b),),
                                  None if x0 is None else (torch.from_numpy(x0),),
                                  precond=tpc, **kw)
    return (np.asarray(jx[0]), ji), (tx[0].numpy(), ti)


@pytest.mark.parametrize("solver,kind", [("cg", "spd"), ("bicgstab", "nonsym")])
@pytest.mark.parametrize("warm", [False, True])
def test_solver_matches_jax(solver, kind, warm):
    rng = np.random.default_rng(1)
    b = rng.normal(size=SHAPE).astype(np.float32)
    x0 = rng.normal(size=SHAPE).astype(np.float32) if warm else None
    (jx, ji), (tx, ti) = _run(solver, kind, b, x0, tol=1e-6, maxiter=500)
    assert bool(ji.converged) and bool(ti.converged)
    assert abs(int(ji.iterations) - int(ti.iterations)) <= 3
    assert_rel(tx, jx, 2e-4, solver)


@pytest.mark.parametrize("solver,kind", [("cg", "spd"), ("bicgstab", "nonsym")])
def test_zero_rhs_gives_zero(solver, kind):
    (_, _), (tx, ti) = _run(solver, kind, np.zeros(SHAPE, np.float32),
                            tol=1e-6)
    assert (tx == 0).all() and bool(ti.converged)


def test_cg_refresh_stall_and_return_best():
    """A near-singular SPD system at a tolerance below fp32 reach: the loop
    passes the 100-iteration true-residual refresh and ends by stall
    patience, returning its best iterate (not converged)."""
    rng = np.random.default_rng(4)
    b = rng.normal(size=SHAPE).astype(np.float32)
    (jx, ji), (tx, ti) = _run("cg", "spd", b, seed=6, shift=2e-4, tol=1e-9,
                              maxiter=800, stall_iters=30)
    assert not bool(ji.converged) and not bool(ti.converged)
    assert 100 < int(ti.iterations) < 800 and 100 < int(ji.iterations) < 800
    assert 0.25 <= float(ti.residual) / float(ji.residual) <= 4.0
    assert_rel(tx, jx, 2e-3, "best iterate")
