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
The cluster arm of K3 / K2-mb (one lane over C blocks): at every C in 2, 4,
8, 16 that the card holds for the lanes, on the cylinder's and the
airfoil's full-width pressure and velocity systems, cold and warm, past the
iteration-100 refresh and on the cylinder's impulsive start (maxiter 5000):
the same converged flags as the plain version, iterations within 3, x
within the bars above; two runs bit-equal; C = 1 through the wrapper
bit-equal to the chunk grid's raw launch, and every C bit-equal to C = 1
(its sums are the one-block form's).
The cluster arm of K3-coarse / K3-coarse-flip: at every C in 2, 4, 8, 16
whose rows fit and whose clusters the card holds, on the cylinder's and
the airfoil's full-width pressure systems cold, warm from the deflated
guess, 3 cylinder lanes past the iteration-100 refresh and return-best on
an unconverged solve: x, iterations and residual bit-equal to the chunk
grid, twice; the wrapper at the rule's C against the plain version as
above; K > 128, a bad cluster size and C > 1 with chunk > 1 refused; 64 and
130 lanes take C = 1.  Only these:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py \
        -k "coarse"
The resident arm of K1 / K2 (one lane per block, its rows and four vectors
in shared memory): at the RBC2D-easy block, K1 at 1, 4 (past the refresh)
and 130 lanes, K2's temperature and velocity systems cold and warm,
bit-equal to the chunk grid (x, iterations, residual), two runs
bit-equal, both within the bars above of the plain version.
K1-3D and K2-3D (RBC3D's roll forms, the chunk grid): at the RBC3D-easy
(64, 41, 64) and RBC3D-wide (128, 41, 128) blocks, K1 with 1 and 3 lanes
(one lane per block, and one lockstep block) and K2 with 1 and 3 lanes,
cold and warm, within the bars above; a small RBC3D env step takes them
for every solve.
Their spread arm (one lane over G co-resident blocks of a cooperative
launch): at both RBC3D blocks, K1 on 1 and 2 lanes and K2's temperature and
velocity systems, at every G the card holds and in both layouts, bit-equal
to the chunk grid, five launches back to back bit-equal; a grid the card
cannot hold raises; a full-width RBC3D step takes it for every solve.
K3-3D and K2-mb-3D (CylinderJet3D's merged forms: identity seams, periodic
z): on the bundled snapshot's full-width pressure (1 and 3 lanes) and
velocity (3 lanes) systems, within the bars above and with the plain
version's converged flags; ``default_cluster`` gives 1 for these lanes and
the launcher refuses C > 1 (the rows do not fit); a full-width sim step
takes them for every solve.
Their spread arm (one merged lane over G co-resident blocks, the rows and
the neighbour table read from L2): on the small (resolution 8) and the
full-width CylinderJet3D plans, K3 on 1 and 3 lanes cold and warm and K2-mb
on the 3 velocity components, at every G the card holds and in both
layouts, bit-equal to the chunk grid, five launches back to back bit-equal;
``merged_arm`` gives G = 128 (1 lane) and 32 (3 lanes) at full width; a
grid the card cannot hold raises; a full-width sim step takes it for every
K3-3D and K2-mb-3D launch.  At CylinderJet3D-hard's width (2,481,408
cells) the 3 velocity lanes go one per launch at G = 128, bit-equal to the
3-lane chunk grid; a full-width CylinderRot2D step takes the cluster arm
for every K3 and K2-mb launch.  Only these:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py \
        -k "merged_spread or cylinder3d or rot2d"
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


# ---------------------------------------------------------------------------
# the cluster arm of K3 and K2-mb: one lane over a thread-block cluster
# ---------------------------------------------------------------------------

def _impulsive_start_system(dev):
    """The pressure system of the cylinder's first substep from a uniform
    flow (the impulsive start, whose cold solves run hundreds to thousands
    of iterations), at full width."""
    from fluidgym_tpu_torch.solver import stencil as st

    env = fluidgym_tpu_torch.make(
        "CylinderJet2D-easy-v0", load_initial_domain=False,
        load_domain_statistics=False, randomize_initial_state=False)
    env.reset(seed=0)
    state, geoms, topo = env._state, env._geoms, env._topo
    dt = torch.tensor(float(env.dt), device=dev)
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    hbyA = st.pressure_rhs_vec(state, geoms, topo, adv,
                               tuple(b.velocity for b in state.blocks),
                               state.viscosity, dt)
    rhs = tuple(-d for d in st.divergence_of(hbyA, state, geoms, topo))
    plan = block_merge.merge_plan(topo)
    return plan, p_ops, block_merge.pack_fields(plan, rhs)


def _cluster_case(case, dev):
    """``(plan, diags, offs, bs, x0s, algo, tol, maxiter, it_past, rel)``
    for one cluster-arm case on a full-width system."""
    system, algo, start = case
    if system == "impulsive":
        plan, p_ops, rhs = _impulsive_start_system(dev)
        diags, offs = _packed(plan, p_ops)
        n = sum(d.numel() for d in diags)
        mean = sum(r.sum() for r in rhs) / n
        bs = tuple((r - mean).unsqueeze(0) for r in rhs)
        return plan, diags, offs, bs, None, "cg", 1e-5, 5000, 100, 1e-3
    systems = _cylinder_systems if system == "cylinder" else _airfoil_systems
    topo, state, plan, adv, p_ops = systems(dev)
    g = torch.Generator().manual_seed(23)
    if algo == "cg":
        diags, offs = _packed(plan, p_ops)
        xs = tuple(torch.randn((1,) + tuple(d.shape), generator=g).to(dev)
                   for d in diags)
        bs = block_merge.merged_apply(plan, tuple(zip(diags, offs)), xs)
        x0s = (tuple(x + 0.01 * torch.randn(x.shape, generator=g).to(dev)
                     for x in xs) if start == "warm" else None)
        # "refresh": tight enough to pass the iteration-100 true-residual
        # refresh, which gathers x across the blocks' ranges
        tol, past = (1e-7, 100) if start == "refresh" else (1e-6, 0)
        return plan, diags, offs, bs, x0s, "cg", tol, 3000, past, 1e-3
    diags, offs = _packed(plan, adv)
    vel = [b.velocity for b in state.blocks]
    S = len(plan.superblocks)
    per_c = [block_merge.pack_fields(plan, tuple(v[c] for v in vel))
             for c in range(2)]
    x0s = tuple(torch.stack([per_c[c][s] for c in range(2)]) for s in range(S))
    bs = tuple(x * 100.0 for x in x0s)
    return (plan, diags, offs, bs, x0s if start == "warm" else None,
            "bicgstab", 1e-6, 2000, 0, 1e-4)


@pytest.mark.parametrize("case", [
    ("cylinder", "cg", "cold"), ("cylinder", "cg", "warm"),
    ("cylinder", "cg", "refresh"), ("cylinder", "bicgstab", "cold"),
    ("cylinder", "bicgstab", "warm"), ("airfoil", "cg", "cold"),
    ("airfoil", "cg", "warm"), ("airfoil", "bicgstab", "warm"),
    ("impulsive", "cg", "cold")], ids=lambda c: "-".join(c))
def test_cluster_arm_matches_plain(case):
    """K3 / K2-mb (both seam forms) at every cluster size the card holds
    for the lanes, against the plain version; two runs bit-equal; C = 1
    through the wrapper bit-equal to the chunk grid's raw launch, and every
    C bit-equal to C = 1 (x, iterations, converged)."""
    dev = require_cuda()
    plan, diags, offs, bs, x0s, algo, tol, maxiter, past, rel = _cluster_case(
        case, dev)
    cg = algo == "cg"
    fn = cg_cuda_mb.fused_cg_mb if cg else cg_cuda_mb.fused_bicgstab_mb
    kw = dict(maxiter=maxiter, stall_iters=250, precondition=True,
              return_best=cg)
    b = cg_cuda_mb.flatten_fields(plan, bs)
    x0 = None if x0s is None else cg_cuda_mb.flatten_fields(plan, x0s)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    L, n = b.shape
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    if cg:
        xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(plan, diag, off, b, x0,
                                                  tol2_sum=tol2, **kw)
    else:
        xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(
            diag, off, b, x0, ndims=2, plan=plan, tol2_sum=tol2, **kw)
    conv_p = (rp <= tol2).cpu()
    assert int(ip.max()) > past
    raw = cg_cuda_mb._launch_merged(algo, plan, diag, off, b, x0,
                                    tol2_sum=tol2, chunk=1, cluster=1, **kw)
    x_raw = raw[0].clone()
    taken = [C for C in cg_cuda_mb.CLUSTER_SIZES
             if cg_cuda_mb.rows_fit(n, C, 2)
             and cg_cuda_mb.max_active_clusters(algo, 2, C, n, dev) >= L]
    assert taken, "the card holds no cluster of any size"
    for C in [1] + taken:
        before = fn.cluster_launches
        runs = [fn(plan, diags, offs, bs, x0s, tol=tol, cluster=C, **kw)
                for _ in range(2)]
        assert fn.cluster_launches == before + (2 if C > 1 else 0)
        (xs1, info1), (xs2, info2) = runs
        x1 = cg_cuda_mb.flatten_fields(plan, xs1)
        x2 = cg_cuda_mb.flatten_fields(plan, xs2)
        torch.cuda.synchronize()
        assert torch.equal(x1, x2), f"C={C}: two runs differ"
        it1 = torch.as_tensor(info1.iterations).reshape(-1)
        assert torch.equal(it1, torch.as_tensor(info2.iterations).reshape(-1))
        conv = torch.as_tensor(info1.converged).reshape(-1).cpu()
        assert torch.equal(conv, conv_p if cg else conv_p.all().reshape(1)), C
        assert abs(int(it1.max()) - int(ip.max())) <= 3, (C, it1, ip)
        assert_rel(x1.cpu().numpy(), xp.cpu().numpy(), rel, f"C={C}")
        if C == 1:
            assert torch.equal(x1, x_raw)
            x_c1, it_c1, conv_c1 = x1, it1, conv
        else:
            assert torch.equal(x1, x_c1), f"C={C}: x differs from C = 1"
            assert torch.equal(it1, it_c1) and torch.equal(conv, conv_c1), C


# ---------------------------------------------------------------------------
# the cluster arm of K3-coarse and K3-coarse-flip
# ---------------------------------------------------------------------------

def _strips_system(system, dev):
    """``(plan, diags, offs, b (1, n), guess (1, n))``: the pressure system
    of one substep of the bundled snapshot at full width (the cylinder's
    res-24 ``test_00`` at dt 0.005, the airfoil's ``train_00`` at dt 0.01),
    its RHS mean-free and the deflated warm start from the snapshot's
    pressure, as the main path builds them."""
    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.solver import stencil as st
    from fluidgym_tpu_torch.utils import data_utils

    data_id, split, dt = {
        "cylinder": ("cylinder_2D_Re100_Res24", "test_00", 0.005),
        "airfoil": ("airfoil_2D_Re1000", "train_00", 0.01)}[system]
    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir(data_id) / split, device=dev)
    plan = block_merge.merge_plan(topo)
    dt = torch.tensor(dt, device=dev)
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    hbyA = st.pressure_rhs_vec(state, geoms, topo, adv,
                               tuple(b.velocity for b in state.blocks),
                               state.viscosity, dt)
    rhs = tuple(-d for d in st.divergence_of(hbyA, state, geoms, topo))
    n = sum(r.numel() for r in rhs)
    mean = sum(r.sum() for r in rhs) / n
    rhs = tuple(r - mean for r in rhs)
    guess = piso._make_deflation_x0(p_ops, topo, torch.float32)(
        rhs, base=tuple(b.pressure for b in state.blocks))
    diags, offs = _packed(plan, p_ops)
    pack = lambda fs: cg_cuda_mb.flatten_fields(plan, tuple(
        p.unsqueeze(0) for p in block_merge.pack_fields(plan, fs)))
    return plan, diags, offs, pack(rhs), pack(guess)


#: (system, start): cold, warm from the deflated guess, 3 lanes past the
#: iteration-100 refresh (one lane per cluster: A x for a random x, the RHS
#: scaled 1e-3, a zero RHS), and return-best on a solve cut at 40
#: iterations, unconverged
COARSE_CLUSTER_CASES = [
    ("cylinder", "cold"), ("cylinder", "warm"), ("cylinder", "3 lanes"),
    ("cylinder", "unconverged"), ("airfoil", "cold"), ("airfoil", "warm"),
    ("airfoil", "unconverged")]


@pytest.mark.parametrize("case", COARSE_CLUSTER_CASES,
                         ids=lambda c: "-".join(c).replace(" ", "_"))
def test_coarse_cluster_arm_bit_equal_to_chunk_grid(case):
    """K3-coarse (the cylinder, K = 34) and K3-coarse-flip (the airfoil,
    K = 59) on the cluster arm at every C in 2, 4, 8, 16 whose rows fit and
    whose clusters the card holds for the lanes: x, iterations and residual
    bit-equal to the chunk grid's (C = 1), twice; the wrapper at the rule's
    C bit-equal to it too, counted as a cluster launch, with the plain
    version's converged flags and iterations within 3."""
    dev = require_cuda()
    system, start = case
    plan, diags, offs, b, guess = _strips_system(system, dev)
    L, n = b.shape
    tol = 1e-7 if system == "airfoil" else 1e-6
    x0, maxiter, past = None, 5000, 0
    if start == "warm":
        x0 = guess
    elif start == "3 lanes":
        g = torch.Generator().manual_seed(3)
        diag1, off1 = cg_cuda_mb.flatten_ops(plan, diags, offs)
        lane0 = cg_cuda_mb._merged_mv(plan, diag1, off1)(
            torch.randn((1, n), generator=g).to(dev))[0]
        b = torch.stack([lane0, 1e-3 * b[0], torch.zeros_like(b[0])])
        L, tol, past = 3, 3e-7, 100
    elif start == "unconverged":
        maxiter = 40
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    sp = coarse_strips.strip_plan(plan)
    einv = coarse_strips.coarse_inverse(plan, sp, tuple(zip(diags, offs)))[None]
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    kw = dict(tol2_sum=tol2, maxiter=maxiter, stall_iters=250,
              precondition=True, return_best=True, coarse=(sp, einv), chunk=1)

    def run(C):
        launch = cg_cuda_mb.merged_launcher("cg", plan, diag, off, b, x0,
                                            cluster=C, **kw)
        out = [tuple(t.clone() for t in launch()) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(*out)), f"C={C}: runs differ"
        return out[0]

    ref = run(1)
    assert bool(torch.isfinite(ref[0]).all())
    assert int(ref[1].max()) > past
    if start == "unconverged":
        assert int(ref[1].max()) == maxiter and not bool((ref[2] <= tol2).any())
    if start == "3 lanes":
        assert bool((ref[0][2] == 0).all())
    taken = [C for C in cg_cuda_mb.CLUSTER_SIZES
             if cg_cuda_mb.rows_fit(n, C, 2) and cg_cuda_mb.max_active_clusters(
                 "cg_coarse", 2, C, n, dev) >= L]
    assert taken, "the card holds no coarse cluster of any size"
    for C in taken:
        got = run(C)
        assert all(torch.equal(u, v) for u, v in zip(got, ref)), (
            f"C={C}: not bit-equal to the chunk grid (iterations "
            f"{got[1].tolist()} vs {ref[1].tolist()})")
    # the wrapper: the rule's C, its own Einv (the same computation)
    rule = cg_cuda_mb.merged_arm(L, n, 2, 1, dev, "cg_coarse")[0]
    assert rule in taken, (rule, taken)
    before = (cg_cuda_mb.fused_cg_mb.cluster_launches,
              cg_cuda_mb.fused_cg_mb.coarse_launches
              + cg_cuda_mb.fused_cg_mb.coarse_flip_launches)
    xs, info = cg_cuda_mb.fused_cg_mb(
        plan, diags, offs, cg_cuda_mb.unflatten_fields(plan, b),
        None if x0 is None else cg_cuda_mb.unflatten_fields(plan, x0),
        tol=tol, maxiter=maxiter, stall_iters=250, coarse_strips=True)
    assert (cg_cuda_mb.fused_cg_mb.cluster_launches,
            cg_cuda_mb.fused_cg_mb.coarse_launches
            + cg_cuda_mb.fused_cg_mb.coarse_flip_launches) == (
                before[0] + 1, before[1] + 1)
    xw = cg_cuda_mb.flatten_fields(plan, xs)
    torch.cuda.synchronize()
    assert torch.equal(xw, ref[0])
    assert torch.equal(info.iterations.reshape(-1).cpu(), ref[1].cpu())
    # the plain version one lane per chunk, as the kernels take them
    xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(
        plan, diag, off, b, x0, tol2_sum=tol2, maxiter=maxiter, stall_iters=250,
        precondition=True, return_best=True, coarse=(sp, einv), chunk=1)
    zero = (b == 0).all(dim=1)
    conv_p = ((rp <= tol2) | zero).cpu()
    assert torch.equal(info.converged.reshape(-1).cpu(), conv_p)
    assert int((ref[1].cpu().long() - ip.cpu().long()).abs().max()) <= 3


def test_coarse_cluster_arm_refusals_and_batches():
    """The coarse entry still refuses K > FG_MAX_K (128), a cluster size
    outside 1, 2, 4, 8, 16 and C > 1 with a chunk of several lanes; a batch
    of more lanes than the card holds coarse clusters (64, 130) takes C = 1
    for both systems, a single lane C > 1."""
    dev = require_cuda()
    from fluidgym_tpu_torch.ops import _build

    lib = _build.library()
    plan, diags, offs, b, _ = _strips_system("cylinder", dev)
    n = b.shape[1]
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    nbr = cg_cuda_mb.neighbor_table(plan, dev)
    ptr, cells, cidx = cg_cuda_mb.strip_lists(plan, dev)
    bufs = [torch.empty_like(b) for _ in range(6)]
    it = torch.empty(2, dtype=torch.int32, device=dev)
    einv = torch.zeros(129 * 129, device=dev)

    def status(lanes, chunk, cluster, K):
        return lib.fg_cg_mb_coarse_solve(
            b.data_ptr(), diag.data_ptr(), off.data_ptr(), nbr.data_ptr(),
            b.data_ptr(), bufs[0].data_ptr(), it.data_ptr(), bufs[1].data_ptr(),
            bufs[2].data_ptr(), bufs[3].data_ptr(), bufs[4].data_ptr(),
            bufs[5].data_ptr(), einv.data_ptr(), ptr.data_ptr(),
            cells.data_ptr(), cidx.data_ptr(), lanes, chunk, cluster, n, 2, 0,
            K, 1.0, 1, 250, 1, 1, 0, torch.cuda.current_stream(dev).cuda_stream)

    invalid = 1  # cudaErrorInvalidValue, before any launch
    for lanes, chunk, cluster, K in ((1, 1, 1, 129), (1, 1, 8, 129),
                                     (1, 1, 3, 34), (2, 2, 8, 34),
                                     (1, 1, 8, 0)):
        assert status(lanes, chunk, cluster, K) == invalid, (chunk, cluster, K)
    torch.cuda.synchronize()
    for system in ("cylinder", "airfoil"):
        n_s = _strips_system(system, dev)[3].shape[1]
        assert cg_cuda_mb.merged_arm(1, n_s, 2, 1, dev, "cg_coarse")[0] > 1
        for lanes in (64, 130):
            assert cg_cuda_mb.merged_arm(lanes, n_s, 2, 1, dev,
                                         "cg_coarse") == (1, 0, False), (system, lanes)


# ---------------------------------------------------------------------------
# the resident arm of K1 and K2: one lane in one block's shared memory
# ---------------------------------------------------------------------------

def _resident_case(case, dev):
    """``(algo, diag (1|L, *SHAPE), off, b (L, *SHAPE), x0, tol, past)`` at
    the RBC2D-easy block: K1 at 1 lane, at 4 lanes past the iteration-100
    refresh (lane 1 scaled 1e-3, lane 2 zero) and at 130 lanes with one
    operator each (scales 1e-3..1, lane 2 zero); K2's temperature (1 lane)
    and velocity (2 lanes) systems, cold or warm.  ``past``: an iteration
    some lane must pass."""
    t = lambda a: torch.from_numpy(a).to(dev)
    if case == "K1-1":
        diag, off = (t(a)[None] for a in spd_stencil(SHAPE, 2, 0, 0.05))
        return "cg", diag, off, t(_lanes(1, 1)), None, 1e-5, 0
    if case == "K1-4-refresh":
        diag, off = (t(a)[None] for a in spd_stencil(SHAPE, 2, 0, 1e-3))
        return "cg", diag, off, t(_lanes(1, 4)), None, 1e-7, 100
    if case == "K1-130":
        L = LANES
        d0, o0 = (t(a) for a in spd_stencil(SHAPE, 2, 3))
        s = _lane_scales(dev, L)
        diag = d0 * s.reshape(L, 1, 1)
        off = o0 * s.reshape(L, 1, 1, 1)
        g = torch.Generator().manual_seed(131)
        xs = _lane_rhs((torch.randn((L,) + SHAPE, generator=g).to(dev),), L)[0]
        return "cg", diag, off, cg_cuda.roll_matvec(diag, off, xs, 2), None, 1e-6, 0
    _, what, start = case.split("-")
    L = 1 if what == "temperature" else 2
    diag, off = (t(a)[None] for a in nonsym_stencil(SHAPE, 2, L))
    b = t(_lanes(5 + L, L, scale_lane=3))
    return "bicgstab", diag, off, b, 0.5 * b if start == "warm" else None, 1e-6, 0


@pytest.mark.parametrize("case", ["K1-1", "K1-4-refresh", "K1-130",
                                  "K2-temperature-cold", "K2-temperature-warm",
                                  "K2-velocity-cold", "K2-velocity-warm"])
def test_resident_arm_bit_equal_to_chunk_grid(case):
    """One lane per block: the resident arm (rows and four vectors in
    shared memory) returns the chunk grid's x, iterations and residual bit
    for bit, run after run; both within today's bars of the plain version
    (the same converged flags, iterations within 3, x within 1e-3 of
    max|x|, zero lanes exactly 0); the wrapper takes the arm by the rule."""
    dev = require_cuda()
    algo, diag, off, b, x0, tol, past = _resident_case(case, dev)
    cg = algo == "cg"
    mod = cg_cuda if cg else cg_cuda_mb
    L = b.shape[0]
    n = SHAPE[0] * SHAPE[1]
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    kw = dict(maxiter=3000, stall_iters=250, precondition=True, return_best=cg)
    runs = []
    for arm in (False, True, True, False):
        launch = mod.launcher(diag, off, b, x0, ndims=2, chunk=1, resident=arm,
                              tol2_sum=tol2, **kw)
        runs.append(tuple(v.clone() for v in launch()))
    torch.cuda.synchronize()
    same = lambda u, v: all(torch.equal(a, c) for a, c in zip(u, v))
    assert same(runs[0], runs[3]), "the chunk grid: two runs differ"
    assert same(runs[1], runs[2]), "the resident arm: two runs differ"
    assert same(runs[1], runs[0]), "the resident arm differs from the chunk grid"
    x, it, rs = runs[1]
    plain = cg_cuda.fused_cg_plain if cg else cg_cuda_mb.fused_bicgstab_plain
    xp, ip, rp = plain(diag, off, b, x0, ndims=2, tol2_sum=tol2, chunk=1, **kw)
    torch.cuda.synchronize()
    zero = (b.reshape(L, -1) == 0).all(dim=1)
    assert torch.equal(((rs <= tol2) | zero).cpu(), ((rp <= tol2) | zero).cpu())
    assert int((it.long() - ip.long()).abs().max()) <= 3, (it, ip)
    assert int(it.max()) > past
    assert_rel(x.cpu().numpy(), xp.cpu().numpy(), 1e-3, case)
    assert bool((x[zero] == 0).all())
    # the wrapper picks the arm itself (default chunk 1 at up to 132 lanes)
    fn = cg_cuda.fused_cg if cg else cg_cuda_mb.fused_bicgstab_mb
    before = (fn.launches, fn.resident_launches)
    if cg:
        xw = cg_cuda.fused_cg(diag if diag.shape[0] > 1 else diag[0],
                              off if off.shape[0] > 1 else off[0], b, x0,
                              ndims=2, tol=tol, **kw)[0]
    else:
        xw = cg_cuda_mb.fused_bicgstab_mb(
            block_merge.trivial_plan(_single_block_topo()), (diag[0],),
            (off[0],), (b,), None if x0 is None else (x0,), tol=tol, **kw)[0][0]
    assert (fn.launches, fn.resident_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(xw, x)


# ---------------------------------------------------------------------------
# K1-3D and K2-3D: the 3D roll forms of RBC3D (the chunk grid, one lane per
# block; no 3D lane fits the resident arm)
# ---------------------------------------------------------------------------

#: the blocks of RBC3D-easy-v0 and of the RBC3D-wide ids, (Z, Y, X)
SHAPES_3D = {"easy": (64, 41, 64), "wide": (128, 41, 128)}


def _rbc3d_operator(shape, dev, symmetric):
    """A periodic-x/z stencil whose +-y wall faces carry off = 0, as RBC3D's
    plates do: SPD (K1) or diagonally dominant non-symmetric (K2)."""
    make = spd_stencil if symmetric else nonsym_stencil
    diag, off = make(shape, 3, seed=sum(shape))
    off[2, :, 0, :] = 0.0   # -y face of the bottom row
    off[3, :, -1, :] = 0.0  # +y face of the top row
    if symmetric:
        diag = -off.sum(axis=0) + 0.05
    return torch.from_numpy(diag).to(dev), torch.from_numpy(off).to(dev)


def _rbc3d_rhs(shape, L, dev, seed):
    """L mean-free right-hand sides: lane 1 scaled 1e-3, lane 2 zero."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(L,) + shape).astype(np.float32)
    B -= B.reshape(L, -1).mean(axis=1).reshape((L, 1, 1, 1))
    if L > 1:
        B[1] *= 1e-3
    if L > 2:
        B[2] = 0.0
    return torch.from_numpy(B).to(dev)


@pytest.mark.parametrize("size", list(SHAPES_3D))
@pytest.mark.parametrize("L,chunk", [(1, None), (3, None), (3, 3)])
def test_k1_3d_kernel_matches_plain(size, L, chunk):
    """K1 in 3D at RBC3D's shapes, one lane per block (the default) and 3
    lanes in one lockstep block: the bars of the 2D K1 test; every launch
    counts as a 3D one and none takes the resident arm."""
    dev = require_cuda()
    shape = SHAPES_3D[size]
    diag, off = _rbc3d_operator(shape, dev, True)
    B = _rbc3d_rhs(shape, L, dev, 11)
    n = int(np.prod(shape))
    tol = 1e-5
    kw = dict(ndims=3, maxiter=2000, stall_iters=250, precondition=True,
              return_best=True)
    f = cg_cuda.fused_cg
    before = (f.launches, f.launches_3d, f.resident_launches)
    x, info = f(diag, off, B, tol=tol, chunk=chunk, **kw)
    assert (f.launches, f.launches_3d, f.resident_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    xp, ip, rp = cg_cuda.fused_cg_plain(
        diag[None], off[None], B, None, tol2_sum=cg_cuda.tol2_sum_f32(tol, n),
        chunk=L if chunk else 1, **kw)
    torch.cuda.synchronize()
    assert bool(info.converged.all())
    assert int((info.iterations.long() - ip.long()).abs().max()) <= 3
    if L > 2:
        assert bool((x[2] == 0).all())
    assert_rel(x.cpu().numpy(), xp.cpu().numpy(), 1e-3, f"{size} L={L}")
    # the true residual (float64) of each converged lane meets the tolerance
    r = B.double() - cg_cuda.roll_matvec(diag[None].double(),
                                         off[None].double(), x.double(), 3)
    rmse = torch.sqrt((r.reshape(L, -1) ** 2).mean(dim=1))
    assert bool((rmse <= 2 * tol).all()), rmse


@pytest.mark.parametrize("size", list(SHAPES_3D))
@pytest.mark.parametrize("C,warm", [(1, True), (3, False), (3, True)])
def test_k2_3d_kernel_matches_plain(size, C, warm):
    """K2 over a 3D trivial plan at RBC3D's shapes: 1 lane (the temperature
    solve) and 3 (the velocity solve), cold and warm."""
    dev = require_cuda()
    shape = SHAPES_3D[size]
    dom = DomainBuilder(ndims=3, viscosity=0.01)
    blk = dom.create_block(geometry.make_uniform_grid(
        (shape[2], shape[1], shape[0]), (0, 0, 0), (1.0, 1.0, 1.0)))
    blk.close_boundary("-y")
    blk.close_boundary("+y")
    plan = block_merge.trivial_plan(dom.build()[0])
    diag, off = _rbc3d_operator(shape, dev, False)
    b = _rbc3d_rhs(shape, C, dev, 12)
    x0 = 0.5 * b if warm else None
    n = int(np.prod(shape))
    kw = dict(maxiter=2000, stall_iters=250, precondition=True,
              return_best=False)
    f = cg_cuda_mb.fused_bicgstab_mb
    before = (f.launches, f.launches_3d, f.resident_launches)
    xs, info = f(plan, (diag,), (off,), (b,), None if x0 is None else (x0,),
                 tol=1e-6, **kw)
    assert (f.launches, f.launches_3d, f.resident_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(
        diag[None], off[None], b, x0, ndims=3,
        tol2_sum=cg_cuda.tol2_sum_f32(1e-6, n), chunk=1, **kw)
    torch.cuda.synchronize()
    assert bool(info.converged)
    assert abs(int(info.iterations) - int(ip.max())) <= 3
    assert_rel(xs[0].cpu().numpy(), xp.cpu().numpy(), 1e-3, f"{size} C={C}")
    if C > 2:
        assert bool((xs[0][2] == 0).all())


def test_rbc3d_step_on_card_goes_through_3d_kernels():
    """A small RBC3D env step on the card: every solve a K1-3D or K2-3D
    launch (2 each per substep), no plain version."""
    require_cuda()
    k1, k2 = cg_cuda.fused_cg, cg_cuda_mb.fused_bicgstab_mb
    before = (k1.launches, k1.launches_3d, k2.launches, k2.launches_3d)
    plain = cg_cuda.fused_cg_plain.calls + cg_cuda_mb.fused_bicgstab_plain.calls
    env = fluidgym_tpu_torch.make("RBC3D-easy-v0",
                                  **dict(SMALL_RBC_KW, use_marl=False))
    env.reset(seed=0)
    obs, reward, *_, info = env.step(np.zeros(env.action_space.shape, np.float32))
    d = [a - b for a, b in zip(
        (k1.launches, k1.launches_3d, k2.launches, k2.launches_3d), before)]
    assert d[0] > 0 and d[0] == d[1] and d[2] == d[3] == d[0], d
    assert (cg_cuda.fused_cg_plain.calls
            + cg_cuda_mb.fused_bicgstab_plain.calls) == plain
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert np.isfinite(float(info["nusselt"]))


# ---------------------------------------------------------------------------
# the spread arm of K1-3D and K2-3D: one lane over G co-resident blocks
# ---------------------------------------------------------------------------

def _spread_case(case, shape, dev):
    """``(algo, diag (1, *shape), off, b (L, *shape), x0, tol)`` at an RBC3D
    block: K1 on 1 lane and on 2 (the second a scaled right-hand side);
    K2's temperature (1 lane) and velocity (3 lanes, lane 2 zero) systems,
    cold or warm."""
    algo, what, start = (case.split("-") + ["cold"])[:3]
    if algo == "K1":
        diag, off = _rbc3d_operator(shape, dev, True)
        return "cg", diag[None], off[None], _rbc3d_rhs(shape, int(what), dev,
                                                       21), None, 1e-5
    diag, off = _rbc3d_operator(shape, dev, False)
    b = _rbc3d_rhs(shape, 1 if what == "temperature" else 3, dev, 22)
    return ("bicgstab", diag[None], off[None], b,
            0.5 * b if start == "warm" else None, 1e-6)


@pytest.mark.parametrize("size", list(SHAPES_3D))
@pytest.mark.parametrize("case", ["K1-1", "K1-2", "K2-temperature-warm",
                                  "K2-velocity-cold", "K2-velocity-warm"])
def test_spread_arm_bit_equal_to_chunk_grid(size, case):
    """One lane over G blocks: at every G the card holds for the lanes, in
    both layouts, the spread arm returns the chunk grid's x, iterations and
    residual bit for bit; five launches back to back on one stream (one
    barrier buffer, no host sync between) give the same bits; the result
    is within the 3D bars of the plain version; the wrapper takes the
    rule's G and counts it."""
    dev = require_cuda()
    shape = SHAPES_3D[size]
    algo, diag, off, b, x0, tol = _spread_case(case, shape, dev)
    cg = algo == "cg"
    mod = cg_cuda if cg else cg_cuda_mb
    L, n = b.shape[0], int(np.prod(shape))
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    kw = dict(ndims=3, maxiter=2000, stall_iters=250, precondition=True,
              return_best=cg, tol2_sum=tol2, chunk=1)
    grid = tuple(v.clone() for v in mod.launcher(diag, off, b, x0, **kw)())
    same = lambda u: all(torch.equal(a, c) for a, c in zip(u, grid))
    rule = cg_cuda.default_spread(L, n, 3, 1, dev, algo)
    assert rule == {1: 128, 2: 64, 3: 32}[L]
    for G in cg_cuda.SPREAD_SIZES:
        if L * G > cg_cuda.spread_capacity(algo, 3, G, True, n, dev):
            continue
        for chains in (True, False):
            launch = mod.launcher(diag, off, b, x0, spread=G, chains=chains, **kw)
            if G == rule and chains == cg_cuda.spread_chains(n, G, 3):
                runs = [tuple(v.clone() for v in launch()) for _ in range(5)]
            else:
                runs = [launch()]
            torch.cuda.synchronize()
            for i, run in enumerate(runs):
                assert same(run), f"G={G} chains={chains} launch {i}"
    plain = cg_cuda.fused_cg_plain if cg else cg_cuda_mb.fused_bicgstab_plain
    xp, ip, rp = plain(diag, off, b, x0, **{k: v for k, v in kw.items()})
    torch.cuda.synchronize()
    x, it, rs = grid
    assert int((it.long() - ip.long()).abs().max()) <= 3, (it, ip)
    assert_rel(x.cpu().numpy(), xp.cpu().numpy(), 1e-3, case)
    zero = (b.reshape(L, -1) == 0).all(dim=1)
    assert bool((x[zero] == 0).all())
    fn = cg_cuda.fused_cg if cg else cg_cuda_mb.fused_bicgstab_mb
    before = (fn.launches, fn.spread_launches)
    if cg:
        xw = fn(diag[0], off[0], b, x0, ndims=3, tol=tol, maxiter=2000,
                stall_iters=250, precondition=True, return_best=True)[0]
    else:
        dom = DomainBuilder(ndims=3, viscosity=0.01)
        blk = dom.create_block(geometry.make_uniform_grid(
            (shape[2], shape[1], shape[0]), (0, 0, 0), (1.0, 1.0, 1.0)))
        blk.close_boundary("-y")
        blk.close_boundary("+y")
        xw = fn(block_merge.trivial_plan(dom.build()[0]), (diag[0],),
                (off[0],), (b,), None if x0 is None else (x0,), tol=tol,
                maxiter=2000, stall_iters=250, precondition=True,
                return_best=False)[0][0]
    assert (fn.launches, fn.spread_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(xw, x)


def test_spread_arm_refuses_a_grid_it_cannot_hold():
    """Two lanes at G = 128 are 256 blocks, more than the card holds at
    once: the cooperative launch is refused and raises, through the raw
    launcher and through the wrapper under a pin; nothing falls back."""
    dev = require_cuda()
    shape = SHAPES_3D["easy"]
    diag, off = _rbc3d_operator(shape, dev, True)
    b = _rbc3d_rhs(shape, 2, dev, 23)
    n = int(np.prod(shape))
    assert 2 * 128 > cg_cuda.spread_capacity("cg", 3, 128, True, n, dev)
    kw = dict(ndims=3, maxiter=50, stall_iters=250, precondition=True,
              return_best=True)
    with pytest.raises(RuntimeError, match="cudaError"):
        cg_cuda.launcher(diag[None], off[None], b, None, chunk=1, spread=128,
                         tol2_sum=cg_cuda.tol2_sum_f32(1e-5, n), **kw)()
    f = cg_cuda.fused_cg
    before = (f.launches, f.spread_launches, cg_cuda.fused_cg_plain.calls)
    with cg_cuda.pinned_spread(128), pytest.raises(RuntimeError):
        f(diag, off, b, tol=1e-5, **kw)
    assert (f.launches, f.spread_launches,
            cg_cuda.fused_cg_plain.calls) == before
    # the card is still usable: a launch it can hold runs
    x, info = f(diag, off, b, tol=1e-5, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())


def test_rbc3d_full_width_step_takes_the_spread_arm():
    """One sim step of RBC3D-easy-v0 at full width from the bundled
    snapshot: every K1-3D and K2-3D launch on the spread arm, no plain
    version."""
    require_cuda()
    k1, k2 = cg_cuda.fused_cg, cg_cuda_mb.fused_bicgstab_mb
    keys = lambda: (k1.launches_3d, k1.spread_launches, k2.launches_3d,
                    k2.spread_launches, cg_cuda.fused_cg_plain.calls
                    + cg_cuda_mb.fused_bicgstab_plain.calls)
    env = fluidgym_tpu_torch.make("RBC3D-easy-v0", randomize_initial_state=False,
                                  step_length=0.05, episode_length=2)
    env.reset(seed=0)
    before = keys()
    obs, reward, *_, info = env.step(np.zeros((env.n_agents, 1), np.float32))
    d = [a - c for a, c in zip(keys(), before)]
    assert d[0] > 0 and d[2] > 0 and d[0] == d[1] and d[2] == d[3], d
    assert d[4] == 0, d
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert np.isfinite(float(info["nusselt"]))


# ---------------------------------------------------------------------------
# K3-3D and K2-mb-3D: the merged frame of the CylinderJet3D-easy-v0 grid
# ---------------------------------------------------------------------------

CYL3D_CELLS = 341568


def _cylinder3d_systems(dev):
    """Pressure and velocity advection systems of the bundled res-24 3D
    cylinder snapshot, in the merged frame (2 super-blocks, periodic z)."""
    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.solver import stencil as st
    from fluidgym_tpu_torch.utils import data_utils

    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir("cylinder_3D_Re100_Res24") / "train_00",
        device=dev)
    plan = block_merge.merge_plan(topo)
    assert plan.ndims == 3 and plan.identity_seams
    dt = torch.tensor(0.005, device=dev)
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    return topo, state, plan, adv, p_ops


@pytest.mark.parametrize("lanes,warm", [(1, True), (3, False)])
def test_k3_3d_kernel_matches_plain(lanes, warm):
    dev = require_cuda()
    _, _, plan, _, p_ops = _cylinder3d_systems(dev)
    diags, offs = _packed(plan, p_ops)
    g = torch.Generator().manual_seed(lanes)
    xs = tuple(torch.randn((lanes,) + tuple(d.shape), generator=g).to(dev)
               for d in diags)
    bs = block_merge.merged_apply(plan, tuple(zip(diags, offs)), xs)
    if lanes == 3:
        # lane 0 a mean-free random right-hand side, which takes the solve
        # past the iteration-100 refresh (an A x of random x does not here)
        mean = sum(x[0].sum() for x in xs) / CYL3D_CELLS
        bs = tuple(torch.stack([x[0] - mean, 1e-3 * b[1], 0 * b[2]])
                   for x, b in zip(xs, bs))
    x0s = (tuple(x + 0.01 * torch.randn(x.shape, generator=g).to(dev) for x in xs)
           if warm else None)
    kw = dict(tol=1e-6, maxiter=3000, stall_iters=250, precondition=True,
              return_best=True)
    before = (cg_cuda_mb.fused_cg_mb.launches_3d,
              cg_cuda_mb.fused_cg_mb.cluster_launches)
    xk, ik = cg_cuda_mb.fused_cg_mb(plan, diags, offs, bs, x0s, **kw)
    assert (cg_cuda_mb.fused_cg_mb.launches_3d,
            cg_cuda_mb.fused_cg_mb.cluster_launches) == (before[0] + 1, before[1])
    b = cg_cuda_mb.flatten_fields(plan, bs)
    assert b.shape == (lanes, CYL3D_CELLS)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    tol2 = cg_cuda.tol2_sum_f32(1e-6, b.shape[1])
    xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(
        plan, diag, off, b, None if x0s is None else
        cg_cuda_mb.flatten_fields(plan, x0s), tol2_sum=tol2, chunk=1,
        **{k: v for k, v in kw.items() if k != "tol"})
    torch.cuda.synchronize()
    conv = ((rp <= tol2) | (b == 0).all(dim=1)).cpu()
    assert torch.equal(ik.converged.reshape(-1).cpu(), conv)
    assert max(abs(a - c) for a, c in zip(ik.iterations.reshape(-1).tolist(),
                                          ip.tolist())) <= 3
    xk = cg_cuda_mb.flatten_fields(plan, xk)
    if lanes == 3:
        assert bool((xk[2] == 0).all())
        assert int(ik.iterations[0]) > 100
    assert_rel(xk.cpu().numpy(), xp.cpu().numpy(), 1e-3)


def test_k2_mb_3d_kernel_matches_plain():
    dev = require_cuda()
    _, state, plan, adv, _ = _cylinder3d_systems(dev)
    diags, offs = _packed(plan, adv)
    vel = [b.velocity for b in state.blocks]
    per_c = [block_merge.pack_fields(plan, tuple(v[c] for v in vel))
             for c in range(3)]
    x0s = tuple(torch.stack([per_c[c][s] for c in range(3)]) for s in range(2))
    bs = tuple(x * 200.0 for x in x0s)
    kw = dict(tol=1e-6, maxiter=2000, stall_iters=250, precondition=True,
              return_best=False)
    before = cg_cuda_mb.fused_bicgstab_mb.merged_launches_3d
    xk, ik = cg_cuda_mb.fused_bicgstab_mb(plan, diags, offs, bs, x0s, **kw)
    assert cg_cuda_mb.fused_bicgstab_mb.merged_launches_3d == before + 1
    b = cg_cuda_mb.flatten_fields(plan, bs)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    tol2 = cg_cuda.tol2_sum_f32(1e-6, b.shape[1])
    xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(
        diag, off, b, cg_cuda_mb.flatten_fields(plan, x0s), ndims=3, plan=plan,
        tol2_sum=tol2, chunk=1, **{k: v for k, v in kw.items() if k != "tol"})
    torch.cuda.synchronize()
    assert bool(ik.converged) == bool((rp <= tol2).all())
    assert abs(int(ik.iterations) - int(ip.max())) <= 2
    assert_rel(cg_cuda_mb.flatten_fields(plan, xk).cpu().numpy(),
               xp.cpu().numpy(), 1e-4)


def test_cylinder3d_takes_the_chunk_grid_and_refuses_clusters():
    """A 3D cylinder lane's rows need ~1.1 MB per block even at C = 16: the
    cluster rule gives 1 (``merged_arm`` then takes the spread arm, tested
    below), and a forced C > 1 is refused before any launch."""
    dev = require_cuda()
    _, _, plan, _, p_ops = _cylinder3d_systems(dev)
    assert not cg_cuda_mb.rows_fit(CYL3D_CELLS, 16, 3)
    assert cg_cuda_mb.default_cluster(1, CYL3D_CELLS, 3, 1, dev) == 1
    assert cg_cuda_mb.default_cluster(3, CYL3D_CELLS, 3, 1, dev, "bicgstab") == 1
    diags, offs = _packed(plan, p_ops)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    b = torch.ones((1, CYL3D_CELLS), device=dev)
    for C in cg_cuda_mb.CLUSTER_SIZES:
        with pytest.raises(ValueError, match="do not fit"):
            cg_cuda_mb.merged_launcher(
                "cg", plan, diag, off, b, None, tol2_sum=1e-6, maxiter=10,
                stall_iters=250, precondition=True, return_best=True, chunk=1,
                cluster=C)


def test_cylinder3d_full_width_step_takes_the_3d_merged_kernels():
    """One sim step of CylinderJet3D-easy-v0 at full width from the bundled
    snapshot: every K3 and K2-mb launch a 3D merged launch, no plain
    version."""
    require_cuda()
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    keys = lambda: (k3.launches, k3.launches_3d, k2.merged_launches,
                    k2.merged_launches_3d, k3.cluster_launches
                    + k2.cluster_launches, cg_cuda_mb.fused_cg_mb_plain.calls
                    + cg_cuda_mb.fused_bicgstab_plain.calls)
    env = fluidgym_tpu_torch.make("CylinderJet3D-easy-v0",
                                  randomize_initial_state=False,
                                  step_length=0.01, episode_length=2)
    env.reset(seed=0)
    before = keys()
    obs, reward, *_, info = env.step(np.zeros((8, 1), np.float32))
    d = [a - c for a, c in zip(keys(), before)]
    assert d[0] > 0 and d[2] > 0 and d[0] == d[1] == 2 * d[2] == 2 * d[3], d
    assert d[4] == 0 and d[5] == 0, d
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))


# ---------------------------------------------------------------------------
# the spread arm of K3-3D and K2-mb-3D: one merged lane over G blocks
# ---------------------------------------------------------------------------

def _cylinder3d_small(dev):
    """The CylinderJet3D grid at resolution 8 (4 jets), merged (2
    super-blocks, periodic z), with its pressure and advection operators
    after a reset from a uniform flow."""
    from fluidgym_tpu_torch.solver import stencil as st

    env = fluidgym_tpu_torch.make(
        "CylinderJet3D-easy-v0", device=dev, resolution=8, n_jets=4,
        load_initial_domain=False, load_domain_statistics=False,
        randomize_initial_state=False, step_length=0.02, dt=0.01)
    env.reset(seed=0)
    topo, geoms, state = env._topo, env._geoms, env._state
    dt = torch.tensor(0.005, device=dev)
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    return topo, state, block_merge.merge_plan(topo), adv, p_ops


def _merged_spread_case(case, size, dev):
    """``(algo, plan, diags, offs, bs, x0s, tol)`` per super-block on the
    small or the full-width CylinderJet3D plan: K3 on 1 or 3 lanes (lane 1
    scaled by 1e-3, lane 2 zero), cold or warm from a perturbed solution
    (zero on the zero lane);
    K2-mb on the 3 velocity components, warm from a perturbed velocity."""
    algo, lanes, start = case.split("-")
    _, state, plan, adv, p_ops = (_cylinder3d_small(dev) if size == "small"
                                  else _cylinder3d_systems(dev))
    assert plan.ndims == 3 and plan.identity_seams
    g = torch.Generator().manual_seed(len(case) + len(size))
    if algo == "K3":
        diags, offs = _packed(plan, p_ops)
        L = int(lanes)
        xs = tuple(torch.randn((L,) + tuple(d.shape), generator=g).to(dev)
                   for d in diags)
        bs = block_merge.merged_apply(plan, tuple(zip(diags, offs)), xs)
        if L == 3:
            bs = tuple(torch.stack([b[0], 1e-3 * b[1], 0 * b[2]]) for b in bs)
        x0s = None
        if start == "warm":  # the zero lane starts at 0: it stays exactly 0
            keep = torch.tensor([1.0, 1.0, 0.0][:L], device=dev)
            x0s = tuple((x + 0.01 * torch.randn(x.shape, generator=g).to(dev))
                        * keep.reshape((L,) + (1,) * (x.dim() - 1))
                        for x in xs)
        return "cg", plan, diags, offs, bs, x0s, 1e-6
    diags, offs = _packed(plan, adv)
    vel = [b.velocity for b in state.blocks]
    per_c = [block_merge.pack_fields(plan, tuple(v[c] for v in vel))
             for c in range(3)]
    x0s = tuple(torch.stack([per_c[c][s] for c in range(3)])
                for s in range(len(plan.superblocks)))
    x0s = tuple(x + 0.1 * torch.randn(x.shape, generator=g).to(dev)
                for x in x0s)
    return "bicgstab", plan, diags, offs, tuple(x * 200.0 for x in x0s), x0s, 1e-6


@pytest.mark.parametrize("size", ["small", "full"])
@pytest.mark.parametrize("case", ["K3-1-cold", "K3-1-warm", "K3-3-cold",
                                  "K3-3-warm", "K2mb-3-warm"])
def test_merged_spread_arm_bit_equal_to_chunk_grid(size, case):
    """One merged lane over G blocks: at every G the card holds for the
    lanes, in both layouts, the spread arm returns the chunk grid's x,
    iterations and residual bit for bit; five launches back to back on one
    stream (one barrier buffer, no host sync between) give the same bits;
    the chunk grid is within the merged bars of the plain version; at full
    width the wrapper takes the rule's G (128 for one lane, 32 for three),
    counts it and returns the same x."""
    dev = require_cuda()
    algo, plan, diags, offs, bs, x0s, tol = _merged_spread_case(case, size, dev)
    cg = algo == "cg"
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    b = cg_cuda_mb.flatten_fields(plan, bs)
    x0 = None if x0s is None else cg_cuda_mb.flatten_fields(plan, x0s)
    L, n = b.shape
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    kw = dict(maxiter=2000, stall_iters=250, precondition=True,
              return_best=cg, tol2_sum=tol2, chunk=1)
    grid = tuple(v.clone() for v in cg_cuda_mb.merged_launcher(
        algo, plan, diag, off, b, x0, **kw)())
    same = lambda u: all(torch.equal(a, c) for a, c in zip(u, grid))
    held = 0
    for G in cg_cuda.SPREAD_SIZES:
        if L * G > cg_cuda.spread_capacity(algo + "_mb", 3, G, True, n, dev):
            continue
        for chains in (True, False):
            launch = cg_cuda_mb.merged_launcher(algo, plan, diag, off, b, x0,
                                                spread=G, chains=chains, **kw)
            runs = [tuple(v.clone() for v in launch()) for _ in range(5)]
            torch.cuda.synchronize()
            for i, run in enumerate(runs):
                assert same(run), f"G={G} chains={chains} launch {i}"
            held += 1
    assert held >= 2
    if cg:
        xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(plan, diag, off, b, x0, **kw)
    else:
        xp, ip, rp = cg_cuda_mb.fused_bicgstab_plain(diag, off, b, x0, ndims=3,
                                                     plan=plan, **kw)
    torch.cuda.synchronize()
    x, it, rs = grid
    assert int((it.long() - ip.long()).abs().max()) <= (3 if cg else 2), (it, ip)
    assert_rel(x.cpu().numpy(), xp.cpu().numpy(), 1e-3 if cg else 1e-4, case)
    zero = (b == 0).all(dim=1)
    assert bool((x[zero] == 0).all())
    if size != "full":
        return
    assert cg_cuda_mb.merged_arm(L, n, 3, 1, dev, algo) == (1, {1: 128, 3: 32}[L],
                                                             False)
    fn = cg_cuda_mb.fused_cg_mb if cg else cg_cuda_mb.fused_bicgstab_mb
    counter = "spread_launches" if cg else "merged_spread_launches"
    before = getattr(fn, counter)
    xw, _ = fn(plan, diags, offs, bs, x0s, tol=tol, maxiter=2000,
               stall_iters=250, precondition=True, return_best=cg)
    assert getattr(fn, counter) == before + 1
    assert torch.equal(cg_cuda_mb.flatten_fields(plan, xw), x)


def test_merged_spread_arm_refuses_a_grid_it_cannot_hold():
    """Two full-width K3-3D lanes at G = 128 are 256 blocks, more than the
    card holds at once: the cooperative launch is refused and raises,
    through the raw launcher and through the wrapper under a pin; nothing
    falls back, and the card stays usable."""
    dev = require_cuda()
    _, plan, diags, offs, bs, _, tol = _merged_spread_case("K3-3-cold", "full",
                                                           dev)
    bs = tuple(x[:2] for x in bs)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    b = cg_cuda_mb.flatten_fields(plan, bs)
    n = b.shape[1]
    assert 2 * 128 > cg_cuda.spread_capacity("cg_mb", 3, 128, True, n, dev)
    kw = dict(maxiter=50, stall_iters=250, precondition=True, return_best=True)
    with pytest.raises(RuntimeError, match="cudaError"):
        cg_cuda_mb.merged_launcher("cg", plan, diag, off, b, None, chunk=1,
                                   spread=128,
                                   tol2_sum=cg_cuda.tol2_sum_f32(tol, n), **kw)()
    f = cg_cuda_mb.fused_cg_mb
    before = (f.launches, f.spread_launches, cg_cuda_mb.fused_cg_mb_plain.calls)
    with cg_cuda.pinned_spread(128), pytest.raises(RuntimeError):
        f(plan, diags, offs, bs, tol=tol, **kw)
    assert (f.launches, f.spread_launches,
            cg_cuda_mb.fused_cg_mb_plain.calls) == before
    xs, info = f(plan, diags, offs, bs, tol=tol, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in xs)
    assert f.spread_launches == before[1] + 1


def test_cylinder3d_full_width_step_takes_the_merged_spread_arm():
    """One sim step of CylinderJet3D-easy-v0 at full width from the bundled
    snapshot: every K3-3D and K2-mb-3D launch on the spread arm, no
    cluster launch, no plain version."""
    require_cuda()
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    keys = lambda: (k3.launches_3d, k3.spread_launches, k2.merged_launches_3d,
                    k2.merged_spread_launches, k3.cluster_launches
                    + k2.cluster_launches, cg_cuda_mb.fused_cg_mb_plain.calls
                    + cg_cuda_mb.fused_bicgstab_plain.calls)
    env = fluidgym_tpu_torch.make("CylinderJet3D-easy-v0",
                                  randomize_initial_state=False,
                                  step_length=0.01, episode_length=2)
    env.reset(seed=0)
    before = keys()
    obs, reward, *_, info = env.step(np.zeros((8, 1), np.float32))
    d = [a - c for a, c in zip(keys(), before)]
    assert d[0] > 0 and d[0] == d[1] == 2 * d[2] == 2 * d[3], d
    assert d[4] == 0 and d[5] == 0, d
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))


# ---------------------------------------------------------------------------
# the upwind blend's ids: CylinderJet3D-hard's lanes one per launch, and
# CylinderRot2D on the cluster arm
# ---------------------------------------------------------------------------

def test_merged_spread_one_lane_per_launch_bit_equal_to_chunk_grid():
    """CylinderJet3D-hard's velocity system (3 lanes of 2,481,408 cells, the
    blended matrix, from a reset of the uniform flow): a spread block's
    chain terms fill one SM, so no G holds the 3 lanes at once and
    ``merged_arm`` launches them one at a time at G = 128.  The wrapper's x
    and iterations equal the 3-lane chunk grid's raw launch bit for bit,
    twice; each lane's raw spread launch equals its chunk-grid lane (x,
    iterations, residual); every launch counts as K2-mb-3D on the spread
    arm."""
    from fluidgym_tpu_torch.solver import stencil as st

    dev = require_cuda()
    env = fluidgym_tpu_torch.make(
        "CylinderJet3D-hard-v0", load_initial_domain=False,
        load_domain_statistics=False, randomize_initial_state=False)
    env.reset(seed=0)
    topo, geoms, state = env._topo, env._geoms, env._state
    assert env._cfg.advection_upwind_blend == 0.3
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity,
                                 torch.tensor(0.003, device=dev), upwind=0.3)
    plan = block_merge.merge_plan(topo)
    diags, offs = _packed(plan, adv)
    n = sum(int(np.prod(sb.shape)) for sb in plan.superblocks)
    assert n == 2_481_408
    assert cg_cuda_mb.merged_arm(3, n, 3, 1, dev, "bicgstab") == (1, 128, True)
    assert cg_cuda_mb.merged_arm(1, n, 3, 1, dev, "cg") == (1, 128, False)
    vel = [b.velocity for b in state.blocks]
    per_c = [block_merge.pack_fields(plan, tuple(v[c] for v in vel))
             for c in range(3)]
    x0s = tuple(torch.stack([per_c[c][s] for c in range(3)])
                for s in range(len(plan.superblocks)))
    g = torch.Generator().manual_seed(17)
    bs = tuple(300.0 * x + torch.randn(x.shape, generator=g).to(dev)
               for x in x0s)
    kw = dict(maxiter=2000, stall_iters=250, precondition=True,
              return_best=False)
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    b = cg_cuda_mb.flatten_fields(plan, bs)
    x0 = cg_cuda_mb.flatten_fields(plan, x0s)
    tol2 = cg_cuda.tol2_sum_f32(1e-5, n)
    grid = tuple(v.clone() for v in cg_cuda_mb.merged_launcher(
        "bicgstab", plan, diag, off, b, x0, tol2_sum=tol2, chunk=1, **kw)())
    for lane in range(3):
        one = cg_cuda_mb.merged_launcher(
            "bicgstab", plan, diag, off, b[lane:lane + 1], x0[lane:lane + 1],
            tol2_sum=tol2, chunk=1, spread=128, **kw)()
        assert all(torch.equal(a, c[lane:lane + 1]) for a, c in zip(one, grid))
    f = cg_cuda_mb.fused_bicgstab_mb
    for _ in range(2):
        before = (f.merged_launches_3d, f.merged_spread_launches)
        xs, info = f(plan, diags, offs, bs, x0s, tol=1e-5, **kw)
        torch.cuda.synchronize()
        assert (f.merged_launches_3d - before[0],
                f.merged_spread_launches - before[1]) == (3, 3)
        assert torch.equal(cg_cuda_mb.flatten_fields(plan, xs), grid[0])
        assert int(info.iterations) == int(grid[1].max())
    with cg_cuda.pinned_spread(0):
        before = f.merged_spread_launches
        xs, _ = f(plan, diags, offs, bs, x0s, tol=1e-5, **kw)
        assert f.merged_spread_launches == before
        assert torch.equal(cg_cuda_mb.flatten_fields(plan, xs), grid[0])


def test_cylinder_rot2d_full_width_step_takes_the_cluster_arm():
    """One sim step of CylinderRot2D-hard-v0 (23,424 cells, the blend) at
    full width from the bundled snapshot with a non-zero action: every K3
    and K2-mb launch on the cluster arm, no other form, no plain version."""
    require_cuda()
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    keys = lambda: (k3.launches, k2.merged_launches,
                    k3.cluster_launches + k2.cluster_launches,
                    k3.launches_3d + k2.merged_launches_3d + k3.flip_launches
                    + k2.merged_flip_launches,
                    cg_cuda_mb.fused_cg_mb_plain.calls
                    + cg_cuda_mb.fused_bicgstab_plain.calls)
    env = fluidgym_tpu_torch.make("CylinderRot2D-hard-v0",
                                  randomize_initial_state=False,
                                  step_length=0.01, episode_length=2)
    env.reset(seed=0)
    assert sum(int(np.prod(b.shape)) for b in env._topo.blocks) == 23_424
    before = keys()
    obs, reward, *_, info = env.step(np.full((1,), 0.7, np.float32))
    d = [a - c for a, c in zip(keys(), before)]
    assert d[0] > 0 and d[0] == 2 * d[1] and d[2] == d[0] + d[1], d
    assert d[3] == 0 and d[4] == 0, d
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))


# ---------------------------------------------------------------------------
# K3-agg / K3-agg-flip: the aggregation coarse space inside K3
# ---------------------------------------------------------------------------

def _agg_system(system, dev):
    """``(plan, diags, offs, b (1, n), guess (1, n), space)``: a pressure
    system of the bundled snapshot at full width with its aggregation space
    (``piso.build_agg_coarse`` at the env's dt, on the card): the airfoil's
    Re 3000 ``train_00`` (K3-agg-flip, 8 x 8 tiles, k = 1,194, the
    blended operator at a substep's dt) or the cylinder's res-24
    ``test_00`` (K3-agg, identity seams, 8 x 8 tiles); the RHS is the
    substep's (the divergence of ``H/A``, mean-free, as the first corrector
    forms it without the deferred non-orthogonal part), the guess the
    deflated warm start from the snapshot's pressure through the same
    space."""
    from fluidgym_tpu_torch.core.domain_io import load_domain
    from fluidgym_tpu_torch.solver import nonortho
    from fluidgym_tpu_torch.solver import stencil as st
    from fluidgym_tpu_torch.utils import data_utils

    data_id, split, blend, dt_env, dt = {
        "airfoil": ("airfoil_2D_Re3000", "train_00", 0.3, 0.05, 6e-4),
        "cylinder": ("cylinder_2D_Re100_Res24", "test_00", 0.0, 0.01, 0.005),
    }[system]
    topo, geoms, state = load_domain(
        data_utils.initial_domain_dir(data_id) / split, device=dev)
    cfg = piso.SimConfig(dt=dt_env, non_orthogonal=True, differentiable=False,
                         advection_upwind_blend=blend, pressure_coarse_tile=8,
                         pressure_coarse_precondition=True)
    agg = piso.build_agg_coarse(state, geoms, topo, cfg)
    plan = agg.plan
    nu = state.viscosity
    dt = torch.tensor(dt, device=dev)
    adv = st.build_advection_ops(state, geoms, topo, nu, dt, upwind=blend)
    adv = nonortho.apply_matrix_terms(
        adv, geoms, topo, tuple(torch.ones_like(g.det) * nu for g in geoms),
        det_divide=True, field="velocity")
    p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
    hbyA = st.pressure_rhs_vec(state, geoms, topo, adv,
                               tuple(b.velocity for b in state.blocks), nu, dt)
    rhs = tuple(-d for d in st.divergence_of(hbyA, state, geoms, topo))
    n = sum(r.numel() for r in rhs)
    mean = sum(r.sum() for r in rhs) / n
    rhs = tuple(r - mean for r in rhs)
    guess = piso._make_deflation_x0(p_ops, topo, torch.float32,
                                    piso.agg_coarse_fn(agg))(
        rhs, base=tuple(b.pressure for b in state.blocks))
    diags, offs = _packed(plan, p_ops)
    pack = lambda fs: cg_cuda_mb.flatten_fields(plan, tuple(
        p.unsqueeze(0) for p in block_merge.pack_fields(plan, fs)))
    return plan, diags, offs, pack(rhs), pack(guess), agg.space


#: (system, start): cold, warm from the deflated guess, 3 lanes past the
#: iteration-100 refresh (A x for a random x, the RHS, a zero RHS; one lane
#: per cluster), and return-best on a solve cut at 40 iterations,
#: unconverged
AGG_CASES = [("airfoil", "cold"), ("airfoil", "warm"), ("airfoil", "3 lanes"),
             ("airfoil", "unconverged"), ("cylinder", "cold"),
             ("cylinder", "warm")]


@pytest.mark.parametrize("case", AGG_CASES,
                         ids=lambda c: "-".join(c).replace(" ", "_"))
def test_k3_agg_kernel_matches_plain_and_every_cluster_size(case):
    """K3-agg-flip (the airfoil, K = 1,194) and K3-agg (the cylinder): the
    chunk grid (C = 1) and every C in 2, 4, 8, 16 whose rows and tiles fit
    and whose clusters the card holds: x, iterations and residual bit-equal
    to C = 1, twice; the wrapper at the rule's C bit-equal to it, counted
    as its form and as a cluster launch; against the plain version the
    same converged flags, iterations within 3, x within 1e-3 of max|x|."""
    dev = require_cuda()
    system, start = case
    plan, diags, offs, b, guess, space = _agg_system(system, dev)
    L, n = b.shape
    tol = 1e-7 if system == "airfoil" else 1e-6
    x0, maxiter, past = None, 5000, 0
    if start == "warm":
        x0 = guess
    elif start == "3 lanes":
        g = torch.Generator().manual_seed(3)
        diag1, off1 = cg_cuda_mb.flatten_ops(plan, diags, offs)
        lane0 = cg_cuda_mb._merged_mv(plan, diag1, off1)(
            torch.randn((1, n), generator=g).to(dev))[0]
        b = torch.stack([lane0, b[0], torch.zeros_like(b[0])])
        L, past = 3, 100
    elif start == "unconverged":
        maxiter = 40
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    einv = space.einv[None]
    tol2 = cg_cuda.tol2_sum_f32(tol, n)
    kw = dict(tol2_sum=tol2, maxiter=maxiter, stall_iters=250,
              precondition=True, return_best=True, coarse=(space, einv),
              chunk=1)

    def run(C):
        launch = cg_cuda_mb.merged_launcher("cg", plan, diag, off, b, x0,
                                            cluster=C, **kw)
        out = [tuple(t.clone() for t in launch()) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(*out)), f"C={C}: runs differ"
        return out[0]

    ref = run(1)
    assert bool(torch.isfinite(ref[0]).all())
    assert int(ref[1].max()) > past
    if start == "unconverged":
        assert int(ref[1].max()) == maxiter and not bool((ref[2] <= tol2).any())
    if start == "3 lanes":
        assert bool((ref[0][2] == 0).all())
    taken = [C for C in cg_cuda_mb.CLUSTER_SIZES
             if cg_cuda_mb.rows_fit(n, C, 2, space.K)
             and cg_cuda_mb.max_active_clusters("cg_coarse", 2, C, n, dev,
                                                    space.K) >= L]
    assert taken, "the card holds no K3-agg cluster of any size"
    for C in taken:
        got = run(C)
        assert all(torch.equal(u, v) for u, v in zip(got, ref)), (
            f"C={C}: not bit-equal to the chunk grid (iterations "
            f"{got[1].tolist()} vs {ref[1].tolist()})")
    rule = cg_cuda_mb.merged_arm(L, n, 2, 1, dev, "cg_coarse", space.K)[0]
    assert rule in taken, (rule, taken)
    k3 = cg_cuda_mb.fused_cg_mb
    form = "agg_launches" if plan.identity_seams else "agg_flip_launches"
    before = (k3.cluster_launches, getattr(k3, form))
    xs, info = k3(
        plan, diags, offs, cg_cuda_mb.unflatten_fields(plan, b),
        None if x0 is None else cg_cuda_mb.unflatten_fields(plan, x0),
        tol=tol, maxiter=maxiter, stall_iters=250, agg=space)
    assert (k3.cluster_launches, getattr(k3, form)) == (
        before[0] + 1, before[1] + 1)
    xw = cg_cuda_mb.flatten_fields(plan, xs)
    torch.cuda.synchronize()
    zero = (b == 0).all(dim=1)
    assert torch.equal(xw, torch.where(zero[:, None], 0.0, ref[0]))
    assert torch.equal(info.iterations.reshape(-1).cpu(), ref[1].cpu())
    xp, ip, rp = cg_cuda_mb.fused_cg_mb_plain(
        plan, diag, off, b, x0, tol2_sum=tol2, maxiter=maxiter, stall_iters=250,
        precondition=True, return_best=True, coarse=(space, einv), chunk=1)
    conv_p = ((rp <= tol2) | zero).cpu()
    assert torch.equal(info.converged.reshape(-1).cpu(), conv_p)
    assert int((ref[1].cpu().long() - ip.cpu().long()).abs().max()) <= 3
    if start != "unconverged":
        assert_rel(ref[0].cpu().numpy(), xp.cpu().numpy(), 1e-3, "x")


def test_k3_agg_refusals():
    """The entry refuses K over FG_MAX_AGG_K (2048) or below 1, a cluster
    size outside 1, 2, 4, 8, 16, C > 1 with a chunk of several lanes and a
    3D plan; the launcher refuses K over the cap and a space of another
    plan; a batch of more lanes than the card holds clusters takes C = 1."""
    dev = require_cuda()
    from fluidgym_tpu_torch.ops import _build

    lib = _build.library()
    plan, diags, offs, b, _, space = _agg_system("airfoil", dev)
    n = b.shape[1]
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    nbr = cg_cuda_mb.neighbor_table(plan, dev)
    bufs = [torch.empty_like(b) for _ in range(6)]
    it = torch.empty(2, dtype=torch.int32, device=dev)
    einv = torch.zeros(2049 * 2049, device=dev)

    def status(lanes, chunk, cluster, K, ndims=2):
        return lib.fg_cg_mb_agg_solve(
            b.data_ptr(), diag.data_ptr(), off.data_ptr(), nbr.data_ptr(),
            b.data_ptr(), bufs[0].data_ptr(), it.data_ptr(), bufs[1].data_ptr(),
            bufs[2].data_ptr(), bufs[3].data_ptr(), bufs[4].data_ptr(),
            bufs[5].data_ptr(), einv.data_ptr(), space.ptr.data_ptr(),
            space.cells.data_ptr(), space.cidx.data_ptr(), lanes, chunk,
            cluster, n, ndims, 0, K, 1.0, 1, 250, 1, 1, 0,
            torch.cuda.current_stream(dev).cuda_stream)

    invalid = 1  # cudaErrorInvalidValue, before any launch
    for lanes, chunk, cluster, K, nd in ((1, 1, 1, 2049, 2), (1, 1, 16, 2049, 2),
                                         (1, 1, 3, 1194, 2), (2, 2, 16, 1194, 2),
                                         (1, 1, 16, 0, 2), (1, 1, 1, 1194, 3)):
        assert status(lanes, chunk, cluster, K, nd) == invalid, (chunk, cluster, K)
    # one occupancy entry for both coarse instances: K = 0 the strips,
    # 1..2048 the tiles
    occ = lib.fg_cg_mb_coarse_cluster_occupancy
    import ctypes
    out = ctypes.c_int(0)
    assert occ(2, 16, n, 2049, ctypes.addressof(out)) == invalid
    assert occ(2, 16, n, -1, ctypes.addressof(out)) == invalid
    for K in (0, space.K):
        out.value = 0
        assert occ(2, 16, n, K, ctypes.addressof(out)) == 0 and out.value >= 1, K
    torch.cuda.synchronize()
    kw = dict(tol2_sum=1.0, maxiter=10, stall_iters=250, precondition=True,
              return_best=True, chunk=1)
    big = space._replace(einv=torch.zeros(2049, 2049, device=dev), K=2049)
    with pytest.raises(ValueError, match="tiles"):
        cg_cuda_mb.merged_launcher("cg", plan, diag, off, b, None,
                                   coarse=(big, big.einv[None]), **kw)
    short = space._replace(cidx=space.cidx[:-1])
    with pytest.raises(ValueError, match="aggregation space"):
        cg_cuda_mb.merged_launcher("cg", plan, diag, off, b, None,
                                   coarse=(short, space.einv[None]), **kw)
    with pytest.raises(ValueError, match="chunk"):
        cg_cuda_mb.fused_cg_mb(plan, diags, offs,
                               cg_cuda_mb.unflatten_fields(plan, b), tol=1e-7,
                               agg=space, chunk=2, cluster=16)
    assert cg_cuda_mb.merged_arm(1, n, 2, 1, dev, "cg_coarse", space.K)[0] > 1
    for lanes in (64, 130):
        assert cg_cuda_mb.merged_arm(lanes, n, 2, 1, dev, "cg_coarse",
                                     space.K) == (1, 0, False), lanes


def test_airfoil_medium_full_width_step_takes_k3_agg_flip():
    """One sim step of Airfoil2D-medium-v0 at full width from the bundled
    ``train_00`` (no randomization): every substep's two pressure solves
    are K3-agg-flip launches on the cluster arm, its velocity solve one
    K2-mb-flip launch; no other form, no plain version."""
    require_cuda()
    k3, k2 = cg_cuda_mb.fused_cg_mb, cg_cuda_mb.fused_bicgstab_mb
    calls = {"substeps": 0}
    real = piso.piso_substep_info

    def counted(*a, **k):
        calls["substeps"] += 1
        return real(*a, **k)

    keys = lambda: (k3.agg_flip_launches, k2.merged_flip_launches,
                    k3.cluster_launches + k2.cluster_launches,
                    k3.launches + k3.flip_launches + k3.coarse_launches
                    + k3.coarse_flip_launches + k3.agg_launches
                    + k2.merged_launches, cg_cuda_mb.fused_cg_mb_plain.calls
                    + cg_cuda_mb.fused_bicgstab_plain.calls)
    env = fluidgym_tpu_torch.make("Airfoil2D-medium-v0",
                                  randomize_initial_state=False,
                                  step_length=0.05, episode_length=2)
    env.reset(seed=0)
    assert env._cfg.pressure_agg.space.K == 1194
    before = keys()
    piso.piso_substep_info = counted
    try:
        obs, reward, *_, info = env.step(np.array([0.5, -0.2, -0.3], np.float32))
    finally:
        piso.piso_substep_info = real
    d = [a - c for a, c in zip(keys(), before)]
    sub = calls["substeps"]
    assert sub > 0 and d[0] == 2 * sub and d[1] == sub, (d, sub)
    assert d[2] == 3 * sub and d[3] == 0 and d[4] == 0, d
    assert bool(info["pressure_converged"])
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))


# ---------------------------------------------------------------------------
# the channel flow: K2-3D one lane per launch at TCFLarge's width
# ---------------------------------------------------------------------------

def test_tcf_large_velocity_solve_one_lane_per_launch_bit_equal_to_chunk_grid():
    """TCFLarge3D's velocity system as the first substep of a step from the
    generated state hands it to K2 (3 lanes of (128, 64, 128) = 1,048,576
    cells, warm from the velocity): no G holds the 3 lanes at once, so
    ``roll_form_arm`` launches them one at a time at G = 128.  Each lane's
    raw spread launch equals its lane of the 3-lane chunk grid (x,
    iterations, residual); the wrapper's x and iterations equal the chunk
    grid's, twice, and count 3 K2-3D launches on the spread arm;
    ``pinned_spread(0)`` gives the same x on the chunk grid."""
    from fluidgym_tpu_torch.solver import stencil as st

    dev = require_cuda()
    env = fluidgym_tpu_torch.make(
        "TCFLarge3D-bottom-easy-v0", load_initial_domain=False,
        load_domain_statistics=False, randomize_initial_state=False)
    env.reset(seed=0)
    topo, geoms, state = env._topo, env._geoms, env._state
    state = piso._run_hooks(env._hooks, "PRE", state)
    dt = piso._cfl_ts(state, geoms, topo, env._cfg,
                      torch.tensor(env._cfg.dt, device=dev))
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    rhs = st.advection_rhs_velocity(state, geoms, topo, state.viscosity, dt)
    shape = topo.blocks[0].shape
    n = int(np.prod(shape))
    assert shape == (128, 64, 128) and n == 1_048_576
    assert cg_cuda_mb.roll_form_arm(3, n, 3, 1, dev) == (False, 128, True)
    d, o, b, x0 = adv[0].diag, adv[0].off, rhs[0], state.blocks[0].velocity
    kw = dict(maxiter=5000, stall_iters=250, precondition=True,
              return_best=False)
    tol2 = cg_cuda.tol2_sum_f32(1e-6, n)
    grid = tuple(v.clone() for v in cg_cuda_mb.launcher(
        d[None], o[None], b, x0, ndims=3, tol2_sum=tol2, chunk=1, **kw)())
    assert int(grid[1].min()) > 0
    for lane in range(3):
        one = cg_cuda_mb.launcher(
            d[None], o[None], b[lane:lane + 1], x0[lane:lane + 1], ndims=3,
            tol2_sum=tol2, chunk=1, spread=128, **kw)()
        assert all(torch.equal(a, c[lane:lane + 1]) for a, c in zip(one, grid))
    f = cg_cuda_mb.fused_bicgstab_mb
    plan = block_merge.trivial_plan(topo)
    for _ in range(2):
        before = (f.launches_3d, f.spread_launches)
        xs, info = f(plan, (d,), (o,), (b,), (x0,), tol=1e-6, **kw)
        torch.cuda.synchronize()
        assert (f.launches_3d - before[0], f.spread_launches - before[1]) == (3, 3)
        assert torch.equal(xs[0], grid[0])
        assert int(info.iterations) == int(grid[1].max())
    with cg_cuda.pinned_spread(0):
        before = f.spread_launches
        xs, _ = f(plan, (d,), (o,), (b,), (x0,), tol=1e-6, **kw)
        assert f.spread_launches == before
        assert torch.equal(xs[0], grid[0])


# ---------------------------------------------------------------------------
# Airfoil3D: the 3D flip seam (K3-3D-flip, K2-mb-3D-flip) and the spread
# arm with its chain terms in global memory
# ---------------------------------------------------------------------------

def _airfoil3d_case(dev, res_z, algo):
    """``(plan, diags, offs, bs, x0s)`` per super-block of the Airfoil3D
    C-grid extruded over ``res_z`` cells (3 super-blocks, the wake cut a
    reflected x seam, periodic z), from a free stream with seeded noise:
    K3 on one lane (a random x0 against ``A x`` of another random x), K2-mb
    on the 3 velocity components, warm from a perturbed velocity."""
    from dataclasses import replace

    from fluidgym_tpu_torch.envs.airfoil.grid import make_airfoil_domain
    from fluidgym_tpu_torch.solver import stencil as st

    dom, _ = make_airfoil_domain(ndims=3, res_z=res_z, H=1.4, L=4.5,
                                 vel_in=0.3, attack_angle_deg=10.0,
                                 viscosity=3e-4, tail_grow_mul=1.01, device=dev)
    topo, geoms, state = dom.build()
    plan = block_merge.merge_plan(topo)
    assert plan.ndims == 3 and not plan.identity_seams
    g = torch.Generator().manual_seed(res_z)
    for i, blk in enumerate(state.blocks):
        u = 0.05 * torch.randn(tuple(blk.velocity.shape), generator=g)
        u[0] += 0.3
        state = state.replace_block(i, replace(blk, velocity=u.to(dev)))
    dt = torch.tensor(0.005, device=dev)
    adv = st.build_advection_ops(state, geoms, topo, state.viscosity, dt)
    if algo == "cg":
        p_ops = st.build_pressure_ops(tuple(o.diag for o in adv), geoms, topo)
        diags, offs = _packed(plan, p_ops)
        xs = tuple(torch.randn((1,) + tuple(d.shape), generator=g).to(dev)
                   for d in diags)
        bs = block_merge.merged_apply(plan, tuple(zip(diags, offs)), xs)
        x0s = tuple(torch.randn(x.shape, generator=g).to(dev) for x in xs)
        return plan, diags, offs, bs, x0s
    diags, offs = _packed(plan, adv)
    per_c = [block_merge.pack_fields(plan, tuple(b.velocity[c]
                                                 for b in state.blocks))
             for c in range(3)]
    x0s = tuple(torch.stack([per_c[c][s] for c in range(3)])
                for s in range(len(plan.superblocks)))
    bs = tuple(200.0 * x for x in x0s)
    x0s = tuple(x + 0.1 * torch.randn(x.shape, generator=g).to(dev)
                for x in x0s)
    return plan, diags, offs, bs, x0s


@pytest.mark.parametrize("res_z", [8, 96])
@pytest.mark.parametrize("algo", ["cg", "bicgstab"])
def test_global_terms_arm_bit_equal_to_chunk_grid(res_z, algo):
    """The Airfoil3D flip plan at ``_res_z`` 8 (587,648 cells) and 96 (the
    registered 7,051,776): every lane launched alone at G = 128 with its
    chain terms in global memory returns its chunk-grid lane's x,
    iterations and residual bit for bit, twice; at 587,648 cells (whose
    terms fit) the shared-memory spread arm does too.  At full width the
    rule takes the global terms (K3 one lane at G = 128, K2-mb's 3 lanes one
    per launch) and the wrappers count K3-3D-flip / K2-mb-3D-flip on it."""
    dev = require_cuda()
    plan, diags, offs, bs, x0s = _airfoil3d_case(dev, res_z, algo)
    cg = algo == "cg"
    diag, off = cg_cuda_mb.flatten_ops(plan, diags, offs)
    b = cg_cuda_mb.flatten_fields(plan, bs)
    x0 = cg_cuda_mb.flatten_fields(plan, x0s)
    L, n = b.shape
    assert n == 73_456 * res_z
    tol = 1e-6
    kw = dict(maxiter=60 if cg else 20, stall_iters=250, precondition=True,
              return_best=cg, tol2_sum=cg_cuda.tol2_sum_f32(tol, n), chunk=1)
    grid = tuple(v.clone() for v in cg_cuda_mb.merged_launcher(
        algo, plan, diag, off, b, x0, **kw)())
    assert int(grid[1].min()) >= 1
    places = (True, False) if res_z == 8 else (True,)
    for lane in range(L):
        want = tuple(v[lane:lane + 1] for v in grid)
        for gterms in places:
            launch = cg_cuda_mb.merged_launcher(
                algo, plan, diag, off, b[lane:lane + 1], x0[lane:lane + 1],
                spread=128, global_terms=gterms, **kw)
            for i in range(2):
                got = launch()
                torch.cuda.synchronize()
                assert all(torch.equal(a, c) for a, c in zip(got, want)), (
                    f"lane {lane} global_terms={gterms} run {i}")
    if res_z != 96:
        return
    assert cg_cuda.spread_global_terms(1, n, 3)
    assert not cg_cuda.spread_global_terms(3, n, 3)
    assert cg_cuda_mb.merged_arm(L, n, 3, 1, dev, algo) == (
        (1, 128, False) if cg else (1, 128, True))
    fn = cg_cuda_mb.fused_cg_mb if cg else cg_cuda_mb.fused_bicgstab_mb
    keys = (("flip_launches_3d", "global_terms_launches") if cg else
            ("merged_flip_launches_3d", "merged_global_terms_launches"))
    before = [getattr(fn, k) for k in keys]
    xw, _ = fn(plan, diags, offs, bs, x0s, tol=tol,
               **{k: v for k, v in kw.items() if k not in ("tol2_sum",
                                                            "chunk")})
    assert [getattr(fn, k) - v for k, v in zip(keys, before)] == [L, L]
    assert torch.equal(cg_cuda_mb.flatten_fields(plan, xw), grid[0])
