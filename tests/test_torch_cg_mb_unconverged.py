"""K3's plain version against the TPU kernel ``fused_cg_mb(...,
interpret=True)`` in float64 on the hardest solves of the cylinder's
impulsive start, at the registered width (resolution 24, 14,232 cells):
the two cold projections of ``make_divergence_free`` from a uniform flow
(capped at 1000 iterations; both end unconverged by stall patience, at 782
and 799 iterations) and the two pressure correctors of the first sim step
(3,355 iterations converged, and 1,260 ending unconverged by stall
patience).  These are the solves where a difference in return-best, stall
patience or the true-residual refresh every 100 iterations would show.

The systems are recorded from the port's own run (``reset`` and one sim
step of dt 0.01, float64) and handed to both solvers as numpy arrays.  Bar:
the same iteration count and convergence flag, the best residual within
1e-8 relative and ``max|dx| <= 1e-9 max|x|``: float64 rounding of two
summation orders of the same arithmetic over thousands of iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu_torch
from fluidgym_tpu.envs.cylinder.grid import make_vortex_street_domain as jgrid
from fluidgym_tpu.ops import cg_pallas_mb
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu_torch.ops import cg_cuda_mb
from torch_port_helpers import CYL_KW

torch.set_num_threads(1)
ID = "CylinderJet2D-easy-v0"
GRID_KW = dict(ndims=2, viscosity=0.01, domain_height=4.1, domain_length=22.0,
               cylinder_radius=0.5, cylinder_offset_y=0.05, circle_thickness=0.5,
               quad_thickness_x=1.0, circle_resolution_angular=24,
               vortex_street_refinement_base=0.95,
               vortex_street_refinement_axes=("+y", "-y"))


@pytest.fixture(scope="module")
def recorded(monkeypatch_module):
    calls = []
    real = cg_cuda_mb.fused_cg_mb

    def record(plan, diags, offs, bs, x0s=None, **kw):
        out = real(plan, diags, offs, bs, x0s, **kw)
        np_ = lambda ts: None if ts is None else [t.numpy().copy() for t in ts]
        calls.append(dict(plan=plan, diags=np_(diags), offs=np_(offs), bs=np_(bs),
                          x0s=np_(x0s), kw=kw,
                          x=np_(out[0]), info=[np.asarray(v) for v in out[1]]))
        return out

    monkeypatch_module.setattr(cg_cuda_mb, "fused_cg_mb", record)
    kw = {**CYL_KW, "resolution": 24, "step_length": 0.01, "dt": 0.01}
    env = fluidgym_tpu_torch.make(ID, device="cpu", dtype=torch.float64, **kw)
    env.reset(seed=0)
    env.step(np.array([0.5], np.float32))
    return calls


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_recorded_solves(recorded):
    its = [int(c["info"][1]) for c in recorded]
    conv = [bool(c["info"][0]) for c in recorded]
    assert len(recorded) == 4, its
    assert [c["kw"]["maxiter"] for c in recorded] == [1000, 1000, 5000, 5000]
    assert not conv[0] and not conv[1] and min(its[:2]) > 250, (its, conv)
    assert min(its[2:]) > 1000 and not all(conv[2:]), (its, conv)


@pytest.mark.parametrize("k", range(4), ids=["projection_1", "projection_2",
                                             "corrector_1", "corrector_2"])
def test_k3_plain_matches_kernel_float64(recorded, k):
    c = recorded[k]
    jplan = jbm.merge_plan(jgrid(**GRID_KW)[0].build()[0])
    assert [sb.shape for sb in jplan.superblocks] == [
        sb.shape for sb in c["plan"].superblocks]
    with jax.enable_x64(True):
        j = lambda xs: None if xs is None else tuple(jnp.asarray(x) for x in xs)
        xj, ij = cg_pallas_mb.fused_cg_mb(jplan, j(c["diags"]), j(c["offs"]),
                                          j(c["bs"]), j(c["x0s"]), interpret=True,
                                          **c["kw"])
        xj = [np.asarray(x) for x in xj]
        ij = [np.asarray(v) for v in ij]
    conv_t, it_t, res_t = c["info"]
    assert int(it_t) == int(ij[1]), (int(it_t), int(ij[1]))
    assert bool(conv_t) == bool(ij[0])
    assert abs(float(res_t) - float(ij[2])) <= 1e-8 * float(ij[2])
    scale = max(np.abs(x).max() for x in xj)
    err = max(np.abs(a - b).max() for a, b in zip(c["x"], xj))
    assert err <= 1e-9 * scale, (err, scale)
