"""The pieces of the RBC3D path in the PyTorch port against ``fluidgym_tpu``
(CPU), on the same numpy-seeded inputs:

* K2 over a 3D ``trivial_plan``: the plain version against the TPU kernel
  ``cg_pallas_mb.fused_bicgstab_mb`` in interpret mode, with 1 lane (the
  temperature solve) and 3 lanes (the velocity solve); bars of
  ``tests/test_torch_cg_cuda_mb.py`` (both converge, iterations within 2,
  ``max|dx| <= 1e-4 max|x|`` at tol 1e-6);
* ``extract_moving_window_3d``, bit for bit, with windows that wrap (and
  one wider than the agent row);
* ``geometry.extrude_grid_z`` and the 3D render plan
  (``resample.make_rectilinear_plan``), exactly / to 1e-6.

K1 in 3D is held against the TPU kernel in ``tests/test_torch_cg_cuda.py``
at the JAX test's 3D shape (4, 8, 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidgym_tpu.core import geometry as jgeo
from fluidgym_tpu.core.domain import DomainBuilder as JDomainBuilder
from fluidgym_tpu.envs.util.obs_extraction import \
    extract_moving_window_3d as jwindow
from fluidgym_tpu.envs.util.resample import make_rectilinear_plan as jplan_of
from fluidgym_tpu.ops import cg_pallas_mb
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu_torch.core import geometry as tgeo
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.envs.util.obs_extraction import extract_moving_window_3d
from fluidgym_tpu_torch.envs.util.resample import make_rectilinear_plan
from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge
from torch_port_helpers import assert_rel, nonsym_stencil

torch.set_num_threads(1)

SHAPE = (6, 8, 16)  # (Z, Y, X): periodic x and z, closed +-y, as RBC3D
KW = dict(maxiter=400, stall_iters=250, precondition=True, return_best=False)


def _rbc3d_grid(nx=16, ny=8, nz=6):
    g2 = jgeo.make_wall_refined_ortho_grid(
        nx, ny, corner_lower=(0.0, -0.5), corner_upper=(np.pi, 0.5),
        wall_refinement=("-y", "+y"), base=1.02)
    return jgeo.extrude_grid_z(g2, res_z=nz, start_z=0.0, end_z=np.pi,
                               weights_z=None, exp_base=1)


def _plans():
    grid = _rbc3d_grid()
    jd = JDomainBuilder(ndims=3, viscosity=0.01)
    jb = jd.create_block(grid)
    jb.close_boundary("-y")
    jb.close_boundary("+y")
    td = DomainBuilder(ndims=3, viscosity=0.01)
    tb = td.create_block(grid)
    tb.close_boundary("-y")
    tb.close_boundary("+y")
    return jbm.trivial_plan(jd.build()[0]), block_merge.trivial_plan(td.build()[0])


def test_trivial_plan_3d_matches_jax():
    jp, tp = _plans()
    assert tp.ndims == jp.ndims == 3
    assert len(tp.superblocks) == 1 and tp.fixups == ()
    # super-block shapes are in physical (x, y, z) order
    assert tp.superblocks[0].shape == jp.superblocks[0].shape == SHAPE[::-1]


@pytest.mark.parametrize("C,warm", [(1, True), (3, False), (3, True)])
def test_plain_k2_3d_matches_pallas(C, warm):
    jp, tp = _plans()
    diag, off = nonsym_stencil(SHAPE, 3, seed=20 + C)
    rng = np.random.default_rng(30 + C)
    b = rng.normal(size=(C,) + SHAPE).astype(np.float32)
    if C == 3:
        b[1] *= 1e-3  # components of very different scale stop on their own
    x0 = (b * 0.3).astype(np.float32) if warm else None
    tol = 1e-6
    xj, ij = cg_pallas_mb.fused_bicgstab_mb(
        jp, (jnp.asarray(diag),), (jnp.asarray(off),), (jnp.asarray(b),),
        None if x0 is None else (jnp.asarray(x0),), tol=tol, interpret=True,
        **KW)
    xt, it = cg_cuda_mb.fused_bicgstab_mb(
        tp, (torch.from_numpy(diag),), (torch.from_numpy(off),),
        (torch.from_numpy(b),), None if x0 is None else (torch.from_numpy(x0),),
        tol=tol, **KW)
    xj, xt = np.asarray(xj[0]), xt[0].numpy()
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    assert_rel(xt, xj, 1e-4, f"C={C} warm={warm}")
    # each lane meets the tolerance on its own (periodic +-z neighbours)
    mv = lambda v: cg_cuda.roll_matvec(torch.from_numpy(diag)[None].double(),
                                       torch.from_numpy(off)[None].double(), v, 3)
    r = (torch.from_numpy(b).double() - mv(torch.from_numpy(xt).double()))
    rmse = torch.sqrt((r.reshape(C, -1) ** 2).mean(dim=1))
    assert bool((rmse <= 2 * tol).all()), rmse


@pytest.mark.parametrize("n_agents,agent_width,win",
                         [(4, 2, 3), (3, 3, 1), (2, 3, 5), (8, 4, 3)])
def test_moving_window_3d_matches_jax(n_agents, agent_width, win):
    rng = np.random.default_rng(n_agents * 10 + win)
    Z = X = n_agents * agent_width
    field = rng.normal(size=(Z, 5, X)).astype(np.float32)
    out = extract_moving_window_3d(torch.from_numpy(field), n_agents,
                                   agent_width, win)
    ref = np.asarray(jwindow(jnp.asarray(field), n_agents, agent_width, win))
    assert tuple(out.shape) == ref.shape == (n_agents ** 2, win * agent_width,
                                             5, win * agent_width)
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError):
        extract_moving_window_3d(torch.from_numpy(field[:-1]), n_agents,
                                 agent_width, win)


@pytest.mark.parametrize("exp_base,weights", [(1, False), (1.05, False), (None, True)])
def test_extrude_grid_z_matches_jax(exp_base, weights):
    g2 = jgeo.make_wall_refined_ortho_grid(
        12, 7, corner_lower=(0.0, -0.5), corner_upper=(2.0, 0.5),
        wall_refinement=("-y", "+y"), base=1.02)
    wz = np.linspace(0.0, 1.0, 10) ** 1.5 if weights else None
    kw = dict(res_z=9, start_z=0.5, end_z=3.0, weights_z=wz, exp_base=exp_base)
    ref = jgeo.extrude_grid_z(g2, **kw)
    out = tgeo.extrude_grid_z(g2, **kw)
    assert out.shape == ref.shape == (3, 10, 8, 13)
    np.testing.assert_array_equal(out, ref)


def test_render_plan_3d_matches_jax():
    """The RBC3D render plan: render shape (x, y, z) = (40, 13, 40) from a
    (16, 10, 16) block, array order (Z, Y, X)."""
    grid = _rbc3d_grid(16, 10, 16)
    out_xyz = (40, 13, 40)
    tp = make_rectilinear_plan(grid, out_xyz)
    jp = jplan_of(grid, out_xyz)
    assert tp.out_shape == jp.out_shape == (40, 13, 40)
    for a, b in zip(tp.axes, jp.axes):
        assert (a.idx0, a.idx1, a.w) == (b.idx0, b.idx1, b.w)
    rng = np.random.default_rng(5)
    field = rng.normal(size=(3, 16, 10, 16)).astype(np.float32)
    out = tp(torch.from_numpy(field))
    ref = np.asarray(jp(jnp.asarray(field)))
    assert tuple(out.shape) == ref.shape == (3, 40, 13, 40)
    assert_rel(out.numpy(), ref, 1e-6, "resampled field")
