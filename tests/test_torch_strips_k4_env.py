"""The slice end to end: CylinderJet2D-easy-v0 at resolution 16 with the
fused stencil apply (K4) and the strip-coarse pressure preconditioner
(``SimConfig.pressure_coarse_strips``, K3-coarse) switched on, the port
against the JAX package, 3 env steps of 2 sim steps.

On the CPU the JAX package's ``"auto"`` routing declines its merged kernel
(its availability probe fails off the TPU) and then ignores the strips, so
the tests force the kernel route with ``cg_pallas.set_fused_cg(True)`` (the
kernels then run in interpret mode), and check that the strips were taken
(``fused_cg_mb`` traced with ``coarse_strips=True``; far fewer pressure
iterations than without).

Both tests start from ONE numpy state, the JAX package's after
``reset(seed=0)`` and 3 steps on its default route: past the impulsive
start, whose first float32 pressure solves are rounding-decided in either
package: there the two packages' answers differ by more than 1e-4 in lift
with or without K4, and with the strips they vary with the process's
earlier work.

* K4, the strips off: the same algorithm in both packages.  Every obs, the
  reward, drag and lift <= 1e-4 relative (measured <= 6.1e-5, in pressure)
  and the pressure iterations within 3 per solve (measured equal); and the
  port's K4 run equals its roll-formulation run bit for bit.
* The strips on (and K4): the port's ``coarse_inverse`` projects the
  constant mode out of ``(E + eps I)^-1``, a deliberate difference (the JAX
  form amplifies float32 rounding by ~1/eps along E's near-null mode, and
  from this state it leaves some pressure solves unconverged).  The test patches the JAX
  package's ``coarse_inverse`` at run time to the same projected form, so
  both packages run one algorithm.  That preconditioner stays
  rounding-sensitive along the mode (the float32 operator's rows sum to
  ~1e-8, so 1_K is E's null vector only to that level), so the velocity
  obs holds to 1e-4 (measured 2.3e-5) and the pressure obs, drag, lift and
  reward to 1e-2 (measured 1.5e-3, 8.7e-5, 3.6e-3 and 6.8e-4); the
  pressure iterations within 3 per solve (measured <= 3 per env step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.ops import cg_pallas, cg_pallas_mb
from fluidgym_tpu.ops import stencil_pallas as jsp
from fluidgym_tpu.solver import coarse_strips as jcs
from fluidgym_tpu_torch.core.domain import domain_state_from_numpy
from fluidgym_tpu_torch.ops import cg_cuda_mb, stencil_cuda
from test_torch_cylinder_env import _np, _rel
from torch_port_helpers import CYL_KW

torch.set_num_threads(1)
ID = "CylinderJet2D-easy-v0"
ACTIONS = (0.5, -0.3, 0.8)


@pytest.fixture
def switches():
    """Both packages' kernels on (JAX in interpret mode); restored after."""
    jsp.set_pallas_interpret(True)
    jsp.set_pallas_stencil(True)
    cg_pallas.set_fused_cg(True)
    stencil_cuda.set_stencil_kernel(True)
    try:
        yield
    finally:
        stencil_cuda.set_stencil_kernel(False)
        cg_pallas.set_fused_cg("auto")
        jsp.set_pallas_stencil(False)
        jsp.set_pallas_interpret(False)


def _steps(env):
    out = []
    for a in ACTIONS:
        obs, reward, _, _, info = env.step(np.array([a], np.float32))
        out.append(dict(velocity=_np(obs["velocity"]), pressure=_np(obs["pressure"]),
                        reward=_np(reward), drag=_np(info["drag"]),
                        lift=_np(info["lift"]),
                        iterations=int(np.asarray(info["pressure_iterations"])),
                        converged=bool(np.asarray(info["pressure_converged"]))))
    return out


def _port_env(jenv, strips):
    tenv = fluidgym_tpu_torch.make(ID, device="cpu", **CYL_KW)
    tenv.reset(seed=0)
    tenv._cfg = dataclasses.replace(tenv._cfg, pressure_coarse_strips=strips)
    tenv._state = domain_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jenv._state))
    return tenv


def _jax_env(state, strips):
    jenv = fluidgym_tpu.make(ID, **CYL_KW)
    jenv.reset(seed=0)
    jenv._cfg = dataclasses.replace(jenv._cfg, pressure_coarse_strips=strips)
    if state is not None:
        jenv._state = state
    return jenv


KEYS = ("velocity", "pressure", "reward", "drag", "lift")


@pytest.fixture(scope="module")
def warm():
    """The JAX env after ``reset(seed=0)`` and 3 steps on its default route
    (no kernel, no strips): past the impulsive start."""
    base = fluidgym_tpu.make(ID, **CYL_KW)
    base.reset(seed=0)
    for _ in range(3):
        base.step(np.array([0.2], np.float32))
    return base


def test_k4_steps_match_jax(warm, switches):
    base = warm
    jj = _steps(_jax_env(base._state, strips=False))
    calls = stencil_cuda.stencil_apply_plain.calls
    tenv = _port_env(base, strips=False)
    tj = _steps(tenv)
    assert stencil_cuda.stencil_apply_plain.calls > calls
    stencil_cuda.set_stencil_kernel(False)
    tr = _steps(_port_env(base, strips=False))
    n_solves = 2 * tenv.n_sim_steps
    for i in range(len(ACTIONS)):
        assert tj[i]["converged"] and jj[i]["converged"], i
        for k in KEYS:
            assert _rel(tj[i][k], jj[i][k]) <= 1e-4, (i, k, _rel(tj[i][k], jj[i][k]))
            assert np.array_equal(tj[i][k], tr[i][k]), (i, k)
        assert abs(tj[i]["iterations"] - jj[i]["iterations"]) <= 3 * n_solves


def test_strips_steps_match_jax(warm, switches, monkeypatch):
    traced = []
    real = cg_pallas_mb.fused_cg_mb

    def spy(*a, **k):
        traced.append(k.get("coarse_strips", False))
        return real(*a, **k)

    real_inv = jcs.coarse_inverse

    def projected(plan, sp, merged_ops, eps_rel=1e-6):
        inv = real_inv(plan, sp, merged_ops, eps_rel)
        Q = jnp.eye(sp.K, dtype=inv.dtype) - 1.0 / sp.K
        return Q @ inv @ Q

    monkeypatch.setattr(cg_pallas_mb, "fused_cg_mb", spy)
    monkeypatch.setattr(jcs, "coarse_inverse", projected)
    jenv = _jax_env(warm._state, strips=True)
    tenv = _port_env(jenv, strips=True)
    tjac = _port_env(jenv, strips=False)
    traced.clear()  # the resets' projections ran without strips
    k3 = cg_cuda_mb.fused_cg_mb_plain.calls
    js, ts = _steps(jenv), _steps(tenv)
    assert traced and all(traced), traced
    assert cg_cuda_mb.fused_cg_mb_plain.calls > k3
    first_jacobi = _steps(tjac)[0]["iterations"]
    assert ts[0]["iterations"] < 0.75 * first_jacobi, (ts[0], first_jacobi)
    n_solves = 2 * tenv.n_sim_steps
    for i in range(len(ACTIONS)):
        assert ts[i]["converged"] and js[i]["converged"], i
        for k, bar in (("velocity", 1e-4), ("pressure", 1e-2), ("drag", 1e-2),
                       ("lift", 1e-2), ("reward", 1e-2)):
            assert _rel(ts[i][k], js[i][k]) <= bar, (i, k, _rel(ts[i][k], js[i][k]))
        assert abs(ts[i]["iterations"] - js[i]["iterations"]) <= 3 * n_solves
