"""The differentiable solve of the PyTorch port against the JAX package's
``lax.custom_linear_solve`` path, in float64 on the CPU.

* ``stencil.transpose_ops``: ``<y, A x> = <A^T y, x>`` within 1e-12
  relative on RBC2D (periodic x, walls), CylinderJet2D at resolution 8 (5
  blocks, CONNECTED seams) and the Airfoil2D C-grid (a reflected seam), and
  its matvec equals ``torch.func.vjp`` of ``domain_apply``;
* ``piso._solve(..., differentiable=True)`` on the four kernel forms (K1,
  K2 over the trivial plan, K3 with the deflation guess, K2-mb): value and
  gradients in ``b``, ``diag`` and ``off`` against the JAX package's
  ``_solve(..., differentiable=True)`` within 1e-6 relative at tol 1e-10
  (the twins of ``tests/test_cg_pallas.py:171`` and
  ``tests/test_cg_pallas_mb.py:456``), through the kernels' plain versions;
* a PISO substep on the 12^2 Taylor-Green box (the twin of
  ``tests/test_solver.py:154``): the gradient against central finite
  differences (5e-2, as there) and against ``jax.grad`` (1e-6);
* ``piso_fixed_steps(use_remat=True)``: the same gradient bit for bit, with
  every solve of the checkpointed substeps run again in the backward;
* the masked adaptive loop (``diff_adaptive_max_substeps``): the dt
  sequence (read from the JAX package's substeps by a ``PRE`` hook) and the
  state equal the JAX package's, with and without the stretch;
* ``diff_tools.state_vjp`` against the JAX package's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.core import domain as jdom
from fluidgym_tpu.core import geometry as jgeo
from fluidgym_tpu.envs.util import diff_tools as jdt
from fluidgym_tpu.solver import piso as jpiso
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.core import domain as tdom
from fluidgym_tpu_torch.core import geometry as tgeo
from fluidgym_tpu_torch.envs.fluid_env import env_state_to_numpy
from fluidgym_tpu_torch.envs.util import diff_tools as tdt
from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import piso as tpiso
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import (CYL_KW, SMALL_RBC_KW, assert_rel,
                                jax_domain_state, spd_stencil)

torch.set_num_threads(1)
F64 = torch.float64


def _np(t):
    return t.detach().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _envs(env_id, **kw):
    """The port's env (float64, ``reset(seed=0)``) and the JAX package's
    topology, geometry and the port's state in JAX form."""
    t = fluidgym_tpu_torch.make(env_id, device="cpu", dtype=F64, **kw)
    t.reset(seed=0)
    with jax.enable_x64(True):
        j = fluidgym_tpu.make(env_id, dtype=jnp.float64, **kw)
        j.reset(seed=0)
        host = env_state_to_numpy(t.get_state()).domain
        jstate = jax_domain_state(host, np.float64)
    return t, j, jstate


RBC = ("RBC2D-easy-v0", tuple(SMALL_RBC_KW.items()))
CYL = ("CylinderJet2D-easy-v0", tuple(dict(CYL_KW, resolution=8).items()))


def _env(case):
    return _envs(case[0], **dict(case[1]))


def _adv_ops(t, j, jstate, dt=0.01):
    tops = tst.build_advection_ops(t._state, t._geoms, t._topo,
                                   t._state.viscosity, torch.tensor(dt, dtype=F64))
    jops = jst.build_advection_ops(jstate, j._geoms, j._topo, jstate.viscosity,
                                   jnp.asarray(dt, jnp.float64))
    return tops, jops


def _pressure_ops(t, j, jstate):
    tadv, jadv = _adv_ops(t, j, jstate)
    return (tst.build_pressure_ops(tuple(o.diag for o in tadv), t._geoms, t._topo),
            jst.build_pressure_ops(tuple(o.diag for o in jadv), j._geoms, j._topo))


# ---------------------------------------------------------------------------
# transpose_ops
# ---------------------------------------------------------------------------

AIRFOIL = ("Airfoil2D-easy-v0", (("randomize_initial_state", False),
                                 ("step_length", 0.05), ("dt", 0.05)))


@pytest.mark.parametrize("case", [RBC, CYL, AIRFOIL],
                         ids=["rbc2d", "cylinder2d", "airfoil2d"])
def test_transpose_ops_adjoint(case):
    t = fluidgym_tpu_torch.make(case[0], device="cpu", dtype=F64,
                                **dict(case[1]))
    t.reset(seed=0)
    topo = t._topo
    ops = tst.build_advection_ops(t._state, t._geoms, topo, t._state.viscosity,
                                  torch.tensor(0.01, dtype=F64))
    rng = np.random.default_rng(3)
    rand = lambda lead: tuple(torch.from_numpy(rng.normal(size=lead + tuple(b.shape)))
                              for b in topo.blocks)
    ops_t = tst.transpose_ops(ops, topo)
    for lead in ((), (2,)):  # a scalar field and the velocity's components
        x, y = rand(lead), rand(lead)
        lhs = sum(torch.sum(a * b) for a, b in zip(y, tst.domain_apply(ops, x, topo)))
        rhs = sum(torch.sum(a * b) for a, b in zip(tst.domain_apply(ops_t, y, topo), x))
        assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs)), (lead, lhs, rhs)
        _, vjp = torch.func.vjp(lambda *xs: tst.domain_apply(ops, xs, topo), *x)
        for a, b in zip(vjp(y), tst.domain_apply(ops_t, y, topo)):
            assert_rel(_np(b), _np(a), 1e-13, f"{case[0]} A^T y vs vjp")
    # the transpose of the transpose is the operator again
    for o, tt in zip(ops, tst.transpose_ops(ops_t, topo)):
        assert torch.equal(o.off, tt.off)


# ---------------------------------------------------------------------------
# the four kernel forms against the JAX package's custom_linear_solve
# ---------------------------------------------------------------------------

def _periodic_topo(mod, shape):
    return mod.DomainTopo(ndims=2, blocks=(mod.BlockTopo(
        shape=shape, orthogonal=True,
        faces=tuple(mod.FaceSpec(kind=mod.BoundKind.PERIODIC)
                    for _ in range(4))),))


def _system(form):
    """``(port ops, JAX ops, port topo, JAX topo, b shapes, solve kw,
    defl)`` of one kernel form; ``defl``: the port's and the JAX package's
    ``x0_fn`` (K3), else None."""
    rng = np.random.default_rng(13)
    if form == "K1":
        shape = (8, 32)
        diag, off = (a.astype(np.float64) for a in spd_stencil(shape, 2, seed=13))
        tops = (tst.StencilOp(torch.from_numpy(diag), torch.from_numpy(off)),)
        jops = (jst.StencilOp(jnp.asarray(diag), jnp.asarray(off)),)
        return (tops, jops, _periodic_topo(tdom, shape), _periodic_topo(jdom, shape),
                [shape], dict(symmetric=True, precondition=True), None)
    t, j, jstate = _env(RBC if form == "K2" else CYL)
    if form in ("K2", "K2-mb"):
        tops, jops = _adv_ops(t, j, jstate)
        shapes = [(2,) + tuple(b.shape) for b in t._topo.blocks]
        return (tops, jops, t._topo, j._topo, shapes,
                dict(symmetric=False, precondition=False), None)
    # K3: the cylinder's pressure system from a warm start and the
    # deflation guess (the JAX package's x0_fn path), its diagonal shifted
    # by 1% of its mean: the all-Neumann system is singular, and at tol
    # 1e-10 a random right-hand side stalls on the null-space drift of the
    # iterate (the port's plain K3: a residual floor of 5.6e-7 in float64)
    tops, jops = _pressure_ops(t, j, jstate)
    shift = 0.01 * float(torch.mean(torch.cat([o.diag.reshape(-1) for o in tops])))
    tops = tuple(tst.StencilOp(o.diag + shift, o.off) for o in tops)
    jops = tuple(jst.StencilOp(o.diag + shift, o.off) for o in jops)
    base = [rng.normal(size=tuple(b.shape)) for b in t._topo.blocks]
    defl = (
        functools.partial(tpiso._make_deflation_x0(tops, t._topo, F64),
                          base=tuple(torch.from_numpy(a) for a in base)),
        functools.partial(jpiso._make_deflation_x0(jops, j._topo, jnp.float64),
                          base=tuple(jnp.asarray(a) for a in base)))
    return (tops, jops, t._topo, j._topo, [tuple(b.shape) for b in t._topo.blocks],
            dict(symmetric=True, precondition=True), defl)


@pytest.mark.parametrize("form", ["K1", "K2", "K3", "K2-mb"])
def test_diff_solve_matches_jax(form):
    with jax.enable_x64(True):
        tops, jops, ttopo, jtopo, shapes, kw, defl = _system(form)
        rng = np.random.default_rng(14)
        b = [rng.normal(size=s) for s in shapes]
        w = [rng.normal(size=s) for s in shapes]
        n = len(shapes)
        common = dict(tol=1e-10, maxiter=4000, return_best=True, **kw)

        def jloss(diags, offs, bs):
            ops = tuple(jst.StencilOp(d, o) for d, o in zip(diags, offs))
            x, _ = jpiso._solve(ops, bs, jtopo, use_bicg=not kw["symmetric"],
                                differentiable=True,
                                x0_fn=None if defl is None else defl[1], **common)
            return sum(jnp.sum(wi * xi) for wi, xi in zip(w, x)), x

        jargs = (tuple(o.diag for o in jops), tuple(o.off for o in jops),
                 tuple(jnp.asarray(a) for a in b))
        (jv, jx), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(*jargs)

    leaves = [t.clone().requires_grad_(True) for t in
              [o.diag for o in tops] + [o.off for o in tops]
              + [torch.from_numpy(a) for a in b]]
    ops = tuple(tst.StencilOp(leaves[i], leaves[n + i]) for i in range(n))
    before = (cg_cuda.fused_cg_plain.calls, cg_cuda_mb.fused_cg_mb_plain.calls,
              cg_cuda_mb.fused_bicgstab_plain.calls)
    x, info = tpiso._solve(ops, tuple(leaves[2 * n:]), ttopo, differentiable=True,
                           x0_fn=None if defl is None else defl[0], **common)
    assert x[0].grad_fn is not None
    assert "ImplicitSolve" in type(x[0].grad_fn).__name__
    v = sum(torch.sum(torch.from_numpy(wi) * xi) for wi, xi in zip(w, x))
    v.backward()
    after = (cg_cuda.fused_cg_plain.calls, cg_cuda_mb.fused_cg_mb_plain.calls,
             cg_cuda_mb.fused_bicgstab_plain.calls)
    # one forward and one transposed solve, both by the kernel's plain version
    k = {"K1": 0, "K3": 1}.get(form, 2)
    assert after[k] - before[k] == 2 and sum(after) - sum(before) == 2
    assert bool(info.converged) and int(info.iterations) == -1
    assert abs(float(v.detach()) - float(jv)) <= 1e-6 * abs(float(jv))
    for xi, jxi in zip(x, jx):
        assert_rel(_np(xi), np.asarray(jxi), 1e-6, f"{form} x")
    names = ["diag"] * n + ["off"] * n + ["b"] * n
    jflat = list(jg[0]) + list(jg[1]) + list(jg[2])
    for name, leaf, jgi in zip(names, leaves, jflat):
        assert_rel(_np(leaf.grad), np.asarray(jgi), 1e-6, f"{form} d/d{name}")


@pytest.mark.parametrize("coarse", ["strips", "agg"])
def test_diff_solve_with_a_coarse_space_raises(coarse):
    """The coarse spaces of the pressure solve (K3-coarse, K3-agg) are not
    ported to the differentiable solve: it raises rather than run them."""
    shape = (8, 32)
    diag, off = (torch.from_numpy(a.astype(np.float64))
                 for a in spd_stencil(shape, 2, seed=13))
    kw = dict(coarse_strips=True) if coarse == "strips" else dict(agg=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tpiso._solve((tst.StencilOp(diag, off),), (torch.ones(shape, dtype=F64),),
                     _periodic_topo(tdom, shape), tol=1e-8, maxiter=100,
                     symmetric=True, return_best=True, differentiable=True, **kw)


# ---------------------------------------------------------------------------
# a PISO substep, and the checkpointed rollout
# ---------------------------------------------------------------------------

def _taylor_green_box(mod, geo, dtype, n=12, L=2 * np.pi, nu=0.05):
    dom = mod.DomainBuilder(ndims=2, viscosity=nu, dtype=dtype)
    dom.create_block(geo.make_uniform_grid((n, n), (0.0, 0.0), (L, L)))
    x = (np.arange(n) + 0.5) / n * L
    X, Y = np.meshgrid(x, x, indexing="xy")
    dom._blocks[0].set_velocity(0.5 * np.stack([np.sin(X) * np.cos(Y),
                                                -np.cos(X) * np.sin(Y)]))
    return dom.build()


def _tg_loss(state, geoms, topo, cfg, dt, n_steps=1, use_remat=False):
    def loss(vel0):
        s = state.replace_block(0, dataclasses.replace(state.blocks[0],
                                                       velocity=vel0))
        s = tpiso.piso_fixed_steps(s, geoms, topo, cfg, dt, n_steps,
                                   use_remat=use_remat)
        return torch.sum(s.blocks[0].velocity ** 2)

    return loss


def test_substep_gradient_matches_fd_and_jax():
    topo, geoms, state = _taylor_green_box(tdom, tgeo, F64)
    cfg = tpiso.SimConfig(pressure_tol=1e-8, advection_tol=1e-8)
    assert cfg.differentiable
    dt = torch.tensor(0.05, dtype=F64)
    loss = _tg_loss(state, geoms, topo, cfg, dt)
    v0 = state.blocks[0].velocity.clone().requires_grad_(True)
    loss(v0).backward()
    g = v0.grad
    assert bool(torch.isfinite(g).all())

    direction = torch.from_numpy(np.random.default_rng(0).normal(size=tuple(v0.shape)))
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss(v0 + eps * direction))
              - float(loss(v0 - eps * direction))) / (2 * eps)
    analytic = float(torch.sum(g * direction))
    assert abs(fd - analytic) / (abs(fd) + 1e-6) < 5e-2

    with jax.enable_x64(True):
        jtopo, jgeoms, jstate = _taylor_green_box(jdom, jgeo, jnp.float64)
        jcfg = jpiso.SimConfig(pressure_tol=1e-8, advection_tol=1e-8)

        def jloss(vel0):
            s = jstate.replace_block(0, dataclasses.replace(jstate.blocks[0],
                                                            velocity=vel0))
            s = jpiso.piso_substep(s, jgeoms, jtopo, jcfg,
                                   jnp.asarray(0.05, jnp.float64))
            return jnp.sum(s.blocks[0].velocity ** 2)

        jg = jax.grad(jloss)(jstate.blocks[0].velocity)
    assert_rel(_np(g), np.asarray(jg), 1e-6, "d(KE)/d(u0)")


def test_remat_gradient_bit_equal():
    topo, geoms, state = _taylor_green_box(tdom, tgeo, F64)
    cfg = tpiso.SimConfig(pressure_tol=1e-10, advection_tol=1e-10)
    dt = torch.tensor(0.02, dtype=F64)
    grads, calls = [], []
    for remat in (False, True):
        loss = _tg_loss(state, geoms, topo, cfg, dt, n_steps=2, use_remat=remat)
        v0 = state.blocks[0].velocity.clone().requires_grad_(True)
        c0 = (cg_cuda.fused_cg_plain.calls, cg_cuda_mb.fused_bicgstab_plain.calls)
        loss(v0).backward()
        c1 = (cg_cuda.fused_cg_plain.calls, cg_cuda_mb.fused_bicgstab_plain.calls)
        grads.append(v0.grad)
        calls.append(tuple(b - a for a, b in zip(c0, c1)))
    assert torch.equal(grads[0], grads[1])
    # 2 substeps of 2 pressure + 1 velocity solves; their transposed solves;
    # with remat every forward solve runs once more in the backward
    assert calls[0] == (8, 4)
    assert calls[1] == (12, 6)


# ---------------------------------------------------------------------------
# the masked adaptive loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_scan", [8, 2])
def test_masked_adaptive_loop_matches_jax(n_scan):
    """At CFL 0.2 the 0.5-long step needs 3 CFL substeps: 8 iterations
    take them as the CFL rule gives them, 2 stretch them to 0.25 each."""
    kw = dict(dt=0.5, substeps=tpiso.ADAPTIVE, adaptive_cfl=0.2,
              pressure_tol=1e-10, advection_tol=1e-10,
              diff_adaptive_max_substeps=n_scan)
    topo, geoms, state = _taylor_green_box(tdom, tgeo, F64)
    log = []
    out, info = tpiso.single_step_info(state, geoms, topo,
                                       tpiso.SimConfig(**kw), dt_log=log)
    dts = [float(d) for d in log]

    with jax.enable_x64(True):
        jtopo, jgeoms, jstate = _taylor_green_box(jdom, jgeo, jnp.float64)
        jdts = []

        def record(s, time_step):
            jax.debug.callback(lambda t: jdts.append(float(t)), time_step)
            return s

        jout = jax.jit(lambda s: jpiso.single_step(
            s, jgeoms, jtopo, jpiso.SimConfig(**kw), {"PRE": (record,)}))(jstate)
        jax.effects_barrier()
    assert len(dts) == len(jdts) == (3 if n_scan == 8 else 2), (dts, jdts)
    np.testing.assert_allclose(dts, jdts, rtol=1e-12)
    assert abs(sum(dts) - 0.5) <= 1e-12
    if n_scan == 2:
        assert dts == [0.25, 0.25]
    assert_rel(_np(out.blocks[0].velocity), np.asarray(jout.blocks[0].velocity),
               1e-8, "velocity after the step")
    assert bool(info.pressure_converged) and int(info.pressure_iterations) == 0


# ---------------------------------------------------------------------------
# diff_tools
# ---------------------------------------------------------------------------

def test_state_vjp_matches_jax():
    env = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", dtype=F64,
                                  differentiable=True, **SMALL_RBC_KW)
    env.reset(seed=0)
    cfg = dataclasses.replace(env._cfg, pressure_tol=1e-10, advection_tol=1e-10)

    def step(s):
        s = tpiso.piso_fixed_steps(s, env._geoms, env._topo, cfg, 0.02, 2,
                                   env._hooks)
        return s.blocks[0].velocity, s.blocks[0].scalar

    out, grads = tdt.state_vjp(step, env._state)
    arrays = tdt.get_state_arrays(env._state)
    assert [tuple(g.shape) for g in grads] == [tuple(a.shape) for a in arrays]
    assert not any(t.requires_grad for t in out)
    flat = tdt.get_flat_state(env)
    assert flat.shape == (sum(a.numel() for a in arrays),)
    back = tdt.replace_state_arrays(env._state, arrays)
    assert torch.equal(tdt.get_flat_state(back), flat)

    with jax.enable_x64(True):
        jenv = fluidgym_tpu.make("RBC2D-easy-v0", dtype=jnp.float64,
                                 differentiable=True, **SMALL_RBC_KW)
        jenv.reset(seed=0)
        jstate = jax_domain_state(env_state_to_numpy(env.get_state()).domain,
                                  np.float64)
        jcfg = dataclasses.replace(jenv._cfg, pressure_tol=1e-10,
                                   advection_tol=1e-10)

        def jstep(s):
            s = jpiso.piso_fixed_steps(s, jenv._geoms, jenv._topo, jcfg,
                                       jnp.asarray(0.02, jnp.float64), 2,
                                       jenv._hooks)
            return s.blocks[0].velocity, s.blocks[0].scalar

        jout, jgrads = jdt.state_vjp(jstep, jstate)
    for name, a, b in zip(("velocity", "scalar"), out, jout):
        assert_rel(_np(a), np.asarray(b), 1e-8, f"out {name}")
    for name, a, b in zip(("velocity", "scalar"), grads, jgrads):
        assert_rel(_np(a), np.asarray(b), 1e-6, f"d/d{name}")
