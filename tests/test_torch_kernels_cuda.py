"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one.  This file imports
neither JAX nor the JAX package, so on the card's machine (which has no JAX)
it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Bar: iteration counts within 3 (K2: 2 for the merged form), ``max|dx| <=
1e-3 max|x|`` (K2 merged: 1e-4) (the kernel sums
its dot products in another order than PyTorch), zero-RHS lanes exactly 0.
Multi-lane checks of one lockstep loop pass ``chunk=lanes`` (one block).
The chunk grid: every entry at 130 lanes, folded from a ``torch.func.vmap``
batch with one operator per lane, in chunks of 33 (4 blocks, the last one
ragged) against the plain version in the same chunks; and at the card's
default chunk (1 lane per block at 130 lanes), every lane bit-equal to a
1-lane launch of its system (K3-coarse: with the Einv the batch computed).
K3-coarse: the same converged flags and iterations within 3, as K3 (the
kernel's restriction sums each strip in another order than the plain
version's too).
K4: within 1e-6 of max|y| (it rounds like the plain version, in the same
order).
"""

import numpy as np
import pytest
import torch

import fluidgym_tpu_torch
from fluidgym_tpu_torch.core.domain import DomainBuilder
from fluidgym_tpu_torch.core import geometry
from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge, coarse_strips, piso
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
    # chunk=L: every lane in one block, one lockstep loop
    x, info = cg_cuda.fused_cg(diag, off, B, tol=tol, chunk=L, **kw)
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


# ---------------------------------------------------------------------------
# K3 and K2-mb: the merged frame of the CylinderJet2D-easy-v0 O-grid
# ---------------------------------------------------------------------------

def _cylinder_systems(dev):
    """Pressure and velocity advection systems of the bundled res-24
    cylinder snapshot, in the merged frame (2 super-blocks, 2 fixups)."""
    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.solver import stencil as st
    from fluidgym_tpu_torch.utils import data_utils

    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir("cylinder_2D_Re100_Res24") / "test_00",
        device=dev)
    plan = block_merge.merge_plan(topo)
    dt = torch.tensor(0.005, device=dev)
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    return topo, state, plan, adv, p_ops


def _packed(plan, ops):
    m = block_merge.pack_ops(plan, ops)
    return tuple(a[0] for a in m), tuple(a[1] for a in m)


@pytest.mark.parametrize("lanes,warm", [(1, False), (1, True), (3, False)])
def test_k3_kernel_matches_plain(lanes, warm):
    dev = require_cuda()
    topo, state, plan, _, p_ops = _cylinder_systems(dev)
    diags, offs = _packed(plan, p_ops)
    g = torch.Generator().manual_seed(lanes)
    xs = tuple(torch.randn((lanes,) + tuple(d.shape), generator=g).to(dev)
               for d in diags)
    bs = block_merge.merged_apply(plan, tuple(zip(diags, offs)), xs)
    if lanes == 3:
        bs = tuple(torch.stack([b[0], 1e-3 * b[1], 0 * b[2]]) for b in bs)
    x0s = (tuple(x + 0.01 * torch.randn(x.shape, generator=g).to(dev) for x in xs)
           if warm else None)
    kw = dict(tol=1e-6, maxiter=3000, stall_iters=250, precondition=True,
              return_best=True)
    launches = cg_cuda_mb.fused_cg_mb.launches
    xk, ik = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s, chunk=lanes,
                                    **kw)
    assert cg_cuda_mb.fused_cg_mb.launches == launches + 1
    b = cg_cuda_mb.flatten_fields(plan, bs)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(
        plan, diag, off, b, None if x0s is None else
        cg_cuda_mb.flatten_fields(plan, x0s),
        tol2_sum=cg_cuda.tol2_sum_f32(1e-6, b.shape[1]),
        **{k: v for k, v in kw.items() if k != "tol"})
    torch.cuda.synchronize()
    assert abs(int(ik.iterations.max()) - int(ip.max())) <= 3
    xk = cg_cuda_mb.flatten_fields(plan, xk)
    if lanes == 3:
        assert bool((xk[2] == 0).all())
        assert int(ik.iterations[0]) > 100
    assert_rel(xk.cpu().numpy(), xp.cpu().numpy(), 1e-3)


@pytest.mark.parametrize("warm", [False, True])
def test_k2_merged_kernel_matches_plain(warm):
    dev = require_cuda()
    topo, state, plan, adv, _ = _cylinder_systems(dev)
    diags, offs = _packed(plan, adv)
    vel = [b.velocity for b in state.blocks]
    per_c = [block_merge.pack_fields(plan, tuple(v[c] for v in vel))
             for c in range(2)]
    x0s = tuple(torch.stack([per_c[c][s] for c in range(2)]) for s in range(2))
    bs = tuple(x * 100.0 for x in x0s)
    kw = dict(tol=1e-6, maxiter=2000, stall_iters=250, precondition=True,
              return_best=False)
    launches = cg_cuda_mb.fused_bicgstab_mb.merged_launches
    xk, ik = cg_cuda_mb.fused_bicgstab_mb(plan, diags, offs, bs,
                                          x0s if warm else None, **kw)
    assert cg_cuda_mb.fused_bicgstab_mb.merged_launches == launches + 1
    b = cg_cuda_mb.flatten_fields(plan, bs)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(
        diag, off, b, cg_cuda_mb.flatten_fields(plan, x0s) if warm else None,
        ndims=2, plan=plan, tol2_sum=cg_cuda.tol2_sum_f32(1e-6, b.shape[1]),
        **{k: v for k, v in kw.items() if k != "tol"})
    torch.cuda.synchronize()
    assert bool(ik.converged)
    assert abs(int(ik.iterations) - int(ip.max())) <= 2
    assert_rel(cg_cuda_mb.flatten_fields(plan, xk).cpu().numpy(),
               xp.cpu().numpy(), 1e-4)


def _airfoil_systems(dev):
    """Pressure and velocity advection systems of the bundled Airfoil2D
    ``train_00`` snapshot at full width, in the merged frame (3
    super-blocks, 6 fixups, 2 of them the reflected wake cut)."""
    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.solver import stencil as st
    from fluidgym_tpu_torch.utils import data_utils

    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir("airfoil_2D_Re1000") / "train_00",
        device=dev)
    plan = block_merge.merge_plan(topo)
    assert len(plan.superblocks) == 3 and not plan.identity_seams
    dt = torch.tensor(0.01, device=dev)
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    return topo, state, plan, adv, p_ops


@pytest.mark.parametrize("algo", ["cg", "bicgstab"])
def test_merged_flip_plan_kernel_matches_plain(algo):
    """A merge plan with flip seams (the airfoil's C-grid cut): its kernels
    (K3, and K2 in merged form) launch, count as the flip forms and match
    their plain versions."""
    dev = require_cuda()
    topo, state, plan, adv, p_ops = _airfoil_systems(dev)
    S = len(plan.superblocks)
    g = torch.Generator().manual_seed(5)
    if algo == "cg":
        diags, offs = _packed(plan, p_ops)
        xs = tuple(torch.randn((1,) + tuple(d.shape), generator=g).to(dev)
                   for d in diags)
        bs = block_merge.merged_apply(plan, tuple(zip(diags, offs)), xs)
        x0s, C, tol, it_tol, rel = None, 1, 1e-6, 3, 1e-3
        counter = (cg_cuda_mb.fused_cg_mb, "flip_launches")
        kw = dict(maxiter=3000, stall_iters=250, precondition=True,
                  return_best=True)
    else:
        diags, offs = _packed(plan, adv)
        vel = [b.velocity for b in state.blocks]
        per_c = [block_merge.pack_fields(plan, tuple(v[c] for v in vel))
                 for c in range(2)]
        x0s = tuple(torch.stack([per_c[c][s] for c in range(2)])
                    for s in range(S))
        bs = tuple(x * 100.0 for x in x0s)
        C, tol, it_tol, rel = 2, 1e-6, 2, 1e-4
        counter = (cg_cuda_mb.fused_bicgstab_mb, "merged_flip_launches")
        kw = dict(maxiter=2000, stall_iters=250, precondition=True,
                  return_best=False)
    fn = cg_cuda_mb.fused_cg_mb if algo == "cg" else cg_cuda_mb.fused_bicgstab_mb
    before = getattr(*counter)
    identity = (cg_cuda_mb.fused_cg_mb.launches,
                cg_cuda_mb.fused_bicgstab_mb.merged_launches)
    xk, ik = fn(plan, diags, offs, bs, x0s, tol=tol, **kw)
    assert getattr(*counter) == before + 1
    assert identity == (cg_cuda_mb.fused_cg_mb.launches,
                        cg_cuda_mb.fused_bicgstab_mb.merged_launches)
    b = cg_cuda_mb.flatten_fields(plan, bs)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    x0 = None if x0s is None else cg_cuda_mb.flatten_fields(plan, x0s)
    tol2 = cg_cuda.tol2_sum_f32(tol, b.shape[1])
    if algo == "cg":
        xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(plan, diag, off, b, x0,
                                                  tol2_sum=tol2, **kw)
    else:
        xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(
            diag, off, b, x0, ndims=2, plan=plan, tol2_sum=tol2, **kw)
    torch.cuda.synchronize()
    assert bool(torch.as_tensor(ik.converged).all())
    assert abs(int(torch.as_tensor(ik.iterations).max()) - int(ip.max())) <= it_tol
    assert_rel(cg_cuda_mb.flatten_fields(plan, xk).cpu().numpy(),
               xp.cpu().numpy(), rel)


def test_airfoil_step_on_card_goes_through_kernels():
    require_cuda()
    f = cg_cuda_mb.fused_cg_mb
    k2 = cg_cuda_mb.fused_bicgstab_mb
    before = (f.flip_launches, k2.merged_flip_launches)
    plain = (cg_cuda_mb.fused_cg_mb_plain.calls
             + cg_cuda_mb.fused_bicgstab_plain.calls)
    env = fluidgym_tpu_torch.make(
        "Airfoil2D-easy-v0", randomize_initial_state=False,
        load_domain_statistics=False, step_length=0.05, dt=0.05)
    env.reset(seed=0)
    obs, reward, *_, info = env.step(np.array([1.0, -0.5, -0.5], np.float32))
    assert f.flip_launches > before[0] and k2.merged_flip_launches > before[1]
    assert (cg_cuda_mb.fused_cg_mb_plain.calls
            + cg_cuda_mb.fused_bicgstab_plain.calls) == plain
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert np.isfinite(float(reward)) and np.isfinite(float(info["drag"]))
    assert bool(info["pressure_converged"])


def test_cylinder_step_on_card_goes_through_kernels():
    require_cuda()
    k3 = cg_cuda_mb.fused_cg_mb.launches
    k2 = cg_cuda_mb.fused_bicgstab_mb.merged_launches
    plain = (cg_cuda_mb.fused_cg_mb_plain.calls
             + cg_cuda_mb.fused_bicgstab_plain.calls)
    env = fluidgym_tpu_torch.make(
        "CylinderJet2D-easy-v0", resolution=16, load_initial_domain=False,
        load_domain_statistics=False, randomize_initial_state=False,
        step_length=0.02, dt=0.01)
    env.reset(seed=0)
    obs, reward, *_ , info = env.step(np.full((1,), 0.5, np.float32))
    assert cg_cuda_mb.fused_cg_mb.launches > k3
    assert cg_cuda_mb.fused_bicgstab_mb.merged_launches > k2
    assert (cg_cuda_mb.fused_cg_mb_plain.calls
            + cg_cuda_mb.fused_bicgstab_plain.calls) == plain
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert np.isfinite(float(info["drag"]))


# ---------------------------------------------------------------------------
# K3-coarse (strip-coarse PCG, identity and flip seams) and K4 (stencil)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,lanes,warm", [
    ("cylinder", 1, False), ("cylinder", 1, True), ("cylinder", 3, False),
    ("airfoil", 1, False)])
def test_k3_coarse_kernel_matches_plain(case, lanes, warm):
    dev = require_cuda()
    systems = _cylinder_systems if case == "cylinder" else _airfoil_systems
    topo, state, plan, _, p_ops = systems(dev)
    diags, offs = _packed(plan, p_ops)
    g = torch.Generator().manual_seed(11 + lanes)
    xs = tuple(torch.randn((lanes,) + tuple(d.shape), generator=g).to(dev)
               for d in diags)
    bs = block_merge.merged_apply(plan, tuple(zip(diags, offs)), xs)
    if lanes == 3:
        bs = tuple(torch.stack([b[0], 1e-3 * b[1], 0 * b[2]]) for b in bs)
    x0s = (tuple(x + 0.01 * torch.randn(x.shape, generator=g).to(dev) for x in xs)
           if warm else None)
    # 3 lanes: tight enough to pass the iteration-100 refresh (169 at 3e-7)
    tol = 3e-7 if lanes == 3 else 1e-6
    kw = dict(maxiter=3000, stall_iters=250, precondition=True, return_best=True)
    attr = "coarse_launches" if plan.identity_seams else "coarse_flip_launches"
    before = getattr(cg_cuda_mb.fused_cg_mb, attr)
    jacobi = (cg_cuda_mb.fused_cg_mb.launches, cg_cuda_mb.fused_cg_mb.flip_launches)
    xk, ik = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s, tol=tol,
                                    coarse_strips=True, chunk=lanes, **kw)
    assert getattr(cg_cuda_mb.fused_cg_mb, attr) == before + 1
    assert jacobi == (cg_cuda_mb.fused_cg_mb.launches,
                      cg_cuda_mb.fused_cg_mb.flip_launches)
    sp = coarse_strips.strip_plan(plan)
    einv = coarse_strips.coarse_inverse(plan, sp, tuple(zip(diags, offs)))
    b = cg_cuda_mb.flatten_fields(plan, bs)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(
        plan, diag, off, b, None if x0s is None else
        cg_cuda_mb.flatten_fields(plan, x0s),
        tol2_sum=cg_cuda.tol2_sum_f32(tol, b.shape[1]), coarse=(sp, einv[None]),
        **kw)
    torch.cuda.synchronize()
    conv_k = torch.as_tensor(ik.converged).reshape(-1)
    zero = (b == 0).all(dim=1)
    conv_p = (rp <= cg_cuda.tol2_sum_f32(tol, b.shape[1])) | zero
    assert torch.equal(conv_k.cpu(), conv_p.cpu())
    assert abs(int(torch.as_tensor(ik.iterations).max()) - int(ip.max())) <= 3
    xk = cg_cuda_mb.flatten_fields(plan, xk)
    if lanes == 3:
        assert bool((xk[2] == 0).all())
        assert int(ik.iterations[0]) > 100


@pytest.mark.parametrize("case,cols", [("cylinder", 1), ("cylinder", 15),
                                       ("airfoil", 1), ("airfoil", 18)])
def test_k4_kernel_matches_plain(case, cols):
    """K4 on every block of the snapshot's pressure operator, scalar and in
    the deflation setup's column form, against its plain version on the
    same CUDA tensors; and ``domain_apply`` with the switch on against the
    roll formulation."""
    from fluidgym_tpu_torch.ops import stencil_cuda
    from fluidgym_tpu_torch.solver import stencil as st

    dev = require_cuda()
    systems = _cylinder_systems if case == "cylinder" else _airfoil_systems
    topo, _, _, _, p_ops = systems(dev)
    g = torch.Generator().manual_seed(cols)
    lead = () if cols == 1 else (cols,)
    xs = tuple(torch.randn(lead + tuple(o.diag.shape), generator=g).to(dev)
               for o in p_ops)
    launches = stencil_cuda.stencil_apply.launches
    plain = stencil_cuda.stencil_apply_plain.calls
    for b, (op, x) in enumerate(zip(p_ops, xs)):
        halos = tuple(st._halo_layer(xs, b, f, topo) for f in range(4))
        yk = stencil_cuda.stencil_apply(op.diag, op.off, x, halos)
        yp = stencil_cuda.stencil_apply_plain(op.diag, op.off, x, halos)
        assert_rel(yk.cpu().numpy(), yp.cpu().numpy(), 1e-6, f"block {b}")
    ref = st.domain_apply(p_ops, xs, topo)
    stencil_cuda.set_stencil_kernel(True)
    try:
        out = st.domain_apply(p_ops, xs, topo)
    finally:
        stencil_cuda.set_stencil_kernel(False)
    torch.cuda.synchronize()
    for a, r in zip(out, ref):
        assert_rel(a.cpu().numpy(), r.cpu().numpy(), 1e-6, "domain_apply")
    assert stencil_cuda.stencil_apply.launches == launches + 2 * len(p_ops)
    assert stencil_cuda.stencil_apply_plain.calls == plain + len(p_ops)


# ---------------------------------------------------------------------------
# the chunk grid: 130 lanes of a vmapped batch, one launch
# ---------------------------------------------------------------------------

LANES, CHUNK = 130, 33


def _lane_scales(dev, L):
    """One positive operator scale per lane (a per-lane operator that stays
    SPD / diagonally dominant)."""
    return torch.linspace(0.5, 2.0, L, device=dev)


def _lane_rhs(xs, L):
    """L right-hand sides from random fields: scales 1e-3..1 and lane 2
    zero (it must come back exactly 0)."""
    scale = torch.logspace(-3, 0, L, device=xs[0].device)
    scale[2] = 0.0
    return tuple(x * scale.reshape((L,) + (1,) * (x.dim() - 1)) for x in xs)


def _chunk_case(form, dev):
    """``(wrapper(chunk) -> (x (L, n), iterations (L,)), plain(chunk) -> (x,
    iterations), single(l) -> x (n,), counter, attr, it_tol, rel)`` for one
    kernel form; the wrapper runs under ``torch.func.vmap`` over LANES
    systems with one operator each."""
    L = LANES
    s = _lane_scales(dev, L)
    lane = lambda t: s.reshape((L,) + (1,) * t.dim())
    g = torch.Generator().manual_seed(130)
    if form in ("K1", "K2"):
        n = SHAPE[0] * SHAPE[1]
        stencil = spd_stencil if form == "K1" else nonsym_stencil
        d0, o0 = (torch.from_numpy(a).to(dev) for a in stencil(SHAPE, 2, 3))
        C = 1 if form == "K1" else 2
        E = L // C
        diag, off = d0 * lane(d0), o0 * lane(o0)
        xs = _lane_rhs((torch.randn((L,) + SHAPE, generator=g).to(dev),), L)[0]
        b = cg_cuda.roll_matvec(diag, off, xs, 2)
        tol, kw = (1e-6, dict(maxiter=3000, stall_iters=250, precondition=True,
                              return_best=form == "K1"))
        tol2 = cg_cuda.tol2_sum_f32(tol, n)
        if form == "K1":
            def wrapper(chunk):
                f = lambda d, o, bb: cg_cuda.fused_cg(d, o, bb[None], ndims=2,
                                                      tol=tol, chunk=chunk, **kw)
                x, info = torch.func.vmap(f)(diag, off, b)
                return x[:, 0], info.iterations[:, 0], info.converged[:, 0]

            def single(l):
                return cg_cuda.fused_cg(diag[l], off[l], b[l:l + 1], ndims=2,
                                        tol=tol, **kw)[0][0]

            def plain(chunk):
                x, it, rs = cg_cuda.fused_cg_plain(diag, off, b, None, ndims=2,
                                                   tol2_sum=tol2, chunk=chunk,
                                                   **kw)
                return x, it, _converged(b, rs, tol2)
            return wrapper, plain, single, cg_cuda.fused_cg, "launches", 3, 1e-3
        plan = block_merge.trivial_plan(_single_block_topo())
        # E envs of C = 2 components: component lanes share their env's operator
        de, oe = diag[::C], off[::C]
        be = b.reshape((E, C) + SHAPE)

        def wrapper(chunk):
            f = lambda d, o, bb: cg_cuda_mb.fused_bicgstab_mb(
                plan, (d,), (o,), (bb,), tol=tol, chunk=chunk, **kw)
            xs_, info = torch.func.vmap(f)(de, oe, be)
            return xs_[0].reshape((L,) + SHAPE), None, info.converged.all()

        def single(l):
            e, c = divmod(l, C)
            return cg_cuda_mb.fused_bicgstab_mb(
                plan, (de[e],), (oe[e],), (be[e, c:c + 1],), tol=tol,
                **kw)[0][0][0]

        def plain(chunk):
            x, it, rs = cg_cuda_mb.fused_bicgstab_plain(
                de.repeat_interleave(C, 0), oe.repeat_interleave(C, 0), b,
                None, ndims=2, tol2_sum=tol2, chunk=chunk, **kw)
            return x, None, _converged(b, rs, tol2).all()
        return (wrapper, plain, single, cg_cuda_mb.fused_bicgstab_mb,
                "launches", 2, 1e-4)
    systems = _airfoil_systems if form == "K3-flip" else _cylinder_systems
    topo, state, plan, adv, p_ops = systems(dev)
    diags, offs = _packed(plan, adv if form == "K2-mb" else p_ops)
    d1, o1 = cg_cuda_mb.flatten_ops(plan, diags, offs)
    n = d1.shape[1]
    if form == "K2-mb":
        C, E = 2, L // 2
        scale = s[::2]
    else:
        C, E, scale = 1, L, s
    dl = tuple(d * scale.reshape((E,) + (1,) * d.dim()) for d in diags)
    ol = tuple(o * scale.reshape((E,) + (1,) * o.dim()) for o in offs)
    xr = tuple(torch.randn((L,) + tuple(d.shape), generator=g).to(dev)
               for d in diags)
    xr = _lane_rhs(xr, L)
    lane_ops = [tuple(zip((d.repeat_interleave(C, 0)[l] for d in dl),
                          (o.repeat_interleave(C, 0)[l] for o in ol)))
                for l in range(L)]
    b_flat = torch.stack([
        cg_cuda_mb.flatten_fields(plan, block_merge.merged_apply(
            plan, lane_ops[l], tuple(x[l:l + 1] for x in xr)))[0]
        for l in range(L)])
    bs = cg_cuda_mb.unflatten_fields(plan, b_flat)
    coarse = form == "K3-coarse"
    tol = 1e-6
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    kw = dict(maxiter=3000, stall_iters=250, precondition=True,
              return_best=form != "K2-mb")
    dflat = torch.cat([d.reshape(E, -1) for d in dl], 1).repeat_interleave(C, 0)
    oflat = torch.cat([o.reshape(E, o.shape[1], -1) for o in ol],
                      2).repeat_interleave(C, 0)
    if form == "K2-mb":
        be = tuple(x.reshape((E, C) + tuple(x.shape[1:])) for x in bs)

        def wrapper(chunk):
            f = lambda d, o, bb: cg_cuda_mb.fused_bicgstab_mb(
                plan, d, o, bb, tol=tol, chunk=chunk, **kw)
            xs_, info = torch.func.vmap(f)(dl, ol, be)
            return cg_cuda_mb.flatten_fields(
                plan, tuple(x.reshape((L,) + tuple(x.shape[2:])) for x in xs_)
            ), None, info.converged.all()

        def single(l):
            e, c = divmod(l, C)
            xs_, _ = cg_cuda_mb.fused_bicgstab_mb(
                plan, tuple(d[e] for d in dl), tuple(o[e] for o in ol),
                tuple(x[e, c:c + 1] for x in be), tol=tol, **kw)
            return cg_cuda_mb.flatten_fields(plan, xs_)[0]

        def plain(chunk):
            x, it, rs = cg_cuda_mb.fused_bicgstab_plain(
                dflat, oflat, b_flat, None, ndims=2, plan=plan, tol2_sum=tol2,
                chunk=chunk, **kw)
            return x, None, _converged(b_flat, rs, tol2).all()
        return (wrapper, plain, single, cg_cuda_mb.fused_bicgstab_mb,
                "merged_launches", 2, 1e-4)

    def wrapper(chunk):
        f = lambda d, o, bb: cg_cuda_mb.fused_cg_mb(
            plan, d, o, bb, tol=tol, chunk=chunk, coarse_strips=coarse, **kw)
        xs_, info = torch.func.vmap(f)(dl, ol, bs)
        return (cg_cuda_mb.flatten_fields(plan, xs_), info.iterations,
                info.converged)

    def single(l):
        if coarse:
            # a 1-lane launch with the lane's own Einv as the batch computed
            # it (a batched float64 inverse may round differently)
            return cg_cuda_mb._launch_merged(
                "cg", plan, dflat[l:l + 1], oflat[l:l + 1], b_flat[l:l + 1],
                None, tol2_sum=tol2, chunk=1, coarse=(sp, einv_b[l:l + 1]),
                **kw)[0][0]
        xs_, _ = cg_cuda_mb.fused_cg_mb(
            plan, tuple(d[l] for d in dl), tuple(o[l] for o in ol),
            tuple(x[l:l + 1] for x in bs), tol=tol, **kw)
        return cg_cuda_mb.flatten_fields(plan, xs_)[0]

    if coarse:
        sp = coarse_strips.strip_plan(plan)
        einv_b = torch.func.vmap(lambda d, o: coarse_strips.coarse_inverse(
            plan, sp, tuple(zip(d, o))))(dl, ol)

    def plain(chunk):
        cz = (sp, einv_b) if coarse else None
        x, it, rs = cg_cuda_mb.fused_cg_mb_plain(
            plan, dflat, oflat, b_flat, None, tol2_sum=tol2, coarse=cz,
            chunk=chunk, **kw)
        return x, it, _converged(b_flat, rs, tol2)
    attr = {"K3": "launches", "K3-flip": "flip_launches",
            "K3-coarse": "coarse_launches"}[form]
    # K3-coarse: a chunk's count is the max over its 33 lanes, and the
    # strip-coarse preconditioner's convergence tail is decided by float32
    # rounding (kernel 156 vs plain 164 in the last chunk, both converged)
    it_tol = 10 if coarse else 3
    return wrapper, plain, single, cg_cuda_mb.fused_cg_mb, attr, it_tol, 1e-3


def _converged(b, rs, tol2):
    """Per-lane converged flags as the wrappers report them."""
    return (rs <= tol2) | (b.reshape(b.shape[0], -1) == 0).all(dim=1)


def _single_block_topo():
    dom = DomainBuilder(ndims=2, viscosity=0.01)
    dom.create_block(geometry.make_uniform_grid((SHAPE[1], SHAPE[0]),
                                                (0, 0), (1.0, 1.0)))
    return dom.build()[0]


@pytest.mark.parametrize("form", ["K1", "K2", "K2-mb", "K3", "K3-flip",
                                  "K3-coarse"])
def test_chunk_grid_130_lanes(form):
    """130 lanes of a vmapped batch in one launch: chunks of 33 against the
    plain version in the same chunks (the same converged flags, iterations
    per lane within the bar, solutions within the bar, the zero lane exactly
    0); at the default chunk every lane bit-equal to a 1-lane launch of its
    own system."""
    dev = require_cuda()
    wrapper, plain, single, counter, attr, it_tol, rel = _chunk_case(form, dev)
    before = getattr(counter, attr)
    xk, ik, ck = wrapper(CHUNK)
    assert getattr(counter, attr) == before + 1
    xp, ip, cp = plain(CHUNK)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(xk).all())
    assert bool((xk[2] == 0).all())
    assert torch.equal(ck.cpu(), cp.cpu())
    if ik is not None:
        assert (ik.cpu() - ip.cpu()).abs().max() <= it_tol
        # one shared counter per chunk
        for c0 in range(0, LANES, CHUNK):
            assert len(set(ik[c0:c0 + CHUNK].tolist())) == 1
    assert_rel(xk.cpu().numpy(), xp.cpu().numpy(), rel, form)
    x1 = wrapper(None)[0]
    assert getattr(counter, attr) == before + 2
    for l in range(LANES):
        assert torch.equal(x1[l], single(l)), f"{form} lane {l}"
