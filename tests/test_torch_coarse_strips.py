"""The strip-coarse space (``fluidgym_tpu_torch/solver/coarse_strips.py``)
and K3-coarse's plain version (``ops/cg_cuda_mb.fused_cg_mb(...,
coarse_strips=True)`` on CPU tensors) against the JAX package:
``fluidgym_tpu/solver/coarse_strips.py`` and ``fused_cg_mb(...,
coarse_strips=True, interpret=True)``.

Plans: the CylinderJet2D-easy-v0 O-grid at its registered width (2
super-blocks, K = 34 strips: 6 on the (96, 37) ring + 28 on the (24, 445)
wake) and at resolution 16 (the fixture of ``tests/test_torch_cg_mb.py``),
and the Airfoil2D-easy-v0 C-grid (3 super-blocks, 2 reflected seams, K =
59).

Bars: ``E`` within 1e-5 of max|E| of the JAX package's in float32 (its E
rounds every sum in float32; the port sums in float64) and 1e-10 in
float64; one preconditioner application within 1e-9 in float64; the
solves as in ``tests/test_cg_pallas_mb.py:217``: both converge, iterations
within 3, the true blockwise residual RMSE <= 2 tol, and the solutions
within 2e-4 of max|x| up to a constant (the bar of the Jacobi-only K3
twins).  On the airfoil the port deliberately differs from the JAX
package's coarse inverse (see ``coarse_strips.coarse_inverse``), and the
test says how.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.ops import cg_pallas_mb
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu.solver import coarse_strips as jcs
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.ops import cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge as tbm
from fluidgym_tpu_torch.solver import coarse_strips as tcs
from fluidgym_tpu_torch.solver import stencil as tst
from test_torch_cg_mb import (_in_range, _pack_j, _pack_t, _rhs, airfoil,  # noqa: F401
                              systems)

torch.set_num_threads(1)
TOL = 1e-5


@pytest.fixture(scope="module")
def full_cyl():
    """The cylinder's pressure operator at its registered width, built by
    the JAX package, and the same numbers as port operators."""
    env = fluidgym_tpu.make(
        "CylinderJet2D-easy-v0", load_initial_domain=False,
        load_domain_statistics=False, randomize_initial_state=False)
    env.reset(seed=0)
    adv = jst.build_advection_ops(env._state, env._geoms, env._topo,
                                  env._state.viscosity, env._cfg.dt)
    jp = jst.build_pressure_ops(tuple(o.diag for o in adv), env._geoms,
                                env._topo)
    tt = fluidgym_tpu_torch.make(
        "CylinderJet2D-easy-v0", device="cpu", load_initial_domain=False,
        load_domain_statistics=False,
        randomize_initial_state=False)._get_domain()[0]
    tp = tuple(tst.StencilOp(torch.from_numpy(np.array(o.diag)),
                             torch.from_numpy(np.array(o.off))) for o in jp)
    return dict(jt=env._topo, tt=tt, jplan=jbm.merge_plan(env._topo),
                tplan=tbm.merge_plan(tt), jp=jp, tp=tp)


def _case(request, name):
    return request.getfixturevalue(name)


@pytest.mark.parametrize("name,K", [("full_cyl", 34), ("airfoil", 59)])
def test_strip_plan_matches_jax(request, name, K):
    sy = _case(request, name)
    jsp, tsp = jcs.strip_plan(sy["jplan"]), tcs.strip_plan(sy["tplan"])
    assert tsp.K == jsp.K == K
    assert [tuple(vars(s).values()) for s in tsp.spaces] == \
        [tuple(vars(s).values()) for s in jsp.spaces]
    for a, b in zip(tcs.restriction_matrices(sy["tplan"], tsp),
                    jcs.restriction_matrices(sy["jplan"], jsp)):
        np.testing.assert_array_equal(a, b)


def _merged_ops(sy, dtype):
    """The same merged operator for both packages, in ``dtype``."""
    jd, jo = _pack_j(sy["jplan"], sy["jp"])
    jm = tuple((jnp.asarray(np.asarray(d), dtype), jnp.asarray(np.asarray(o), dtype))
               for d, o in zip(jd, jo))
    tm = tuple((torch.from_numpy(np.asarray(d)), torch.from_numpy(np.asarray(o)))
               for d, o in jm)
    return jm, tm


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5), ("float64", 1e-10)])
@pytest.mark.parametrize("name", ["full_cyl", "airfoil"])
def test_assemble_E_matches_jax(request, name, dtype, bar):
    sy = _case(request, name)
    with jax.enable_x64(dtype == "float64"):
        jm, tm = _merged_ops(sy, getattr(jnp, dtype))
        Ej = np.asarray(jcs.assemble_E(sy["jplan"], jcs.strip_plan(sy["jplan"]), jm))
    Et = tcs.assemble_E(sy["tplan"], tcs.strip_plan(sy["tplan"]), tm)
    assert Et.dtype == getattr(torch, dtype)
    err = np.abs(Et.numpy() - Ej).max()
    assert err <= bar * np.abs(Ej).max(), (err, np.abs(Ej).max())


@pytest.mark.parametrize("name", ["full_cyl", "airfoil"])
def test_E_matches_brute_force(request, name):
    """Twin of ``tests/test_cg_pallas_mb.py:260`` in the port alone, in
    float64: ``assemble_E`` equals ``restrict(A(prolong(e_j)))`` column by
    column, the seam couplings (reflected on the airfoil) included."""
    sy = _case(request, name)
    plan = sy["tplan"]
    sp = tcs.strip_plan(plan)
    _, tm = _merged_ops(sy, jnp.float32)
    tm = tuple((d.double(), o.double()) for d, o in tm)
    E = tcs.assemble_E(plan, sp, tm)
    eye = torch.eye(sp.K, dtype=torch.float64)
    E_ref = tcs.restrict(plan, sp, tbm.merged_apply(
        plan, tm, tcs.prolong(plan, sp, eye))).T
    err = (E - E_ref).abs().max()
    assert err <= 1e-10 * E_ref.abs().max(), err


@pytest.mark.parametrize("name", ["full_cyl", "airfoil"])
def test_strip_lists_match_restrict_and_prolong(request, name):
    """The kernel's view of the strips (CSR cell lists and per-cell coarse
    index, ``cg_cuda_mb.strip_lists``) gives ``restrict``'s ``W^T r`` and
    ``prolong``'s ``W xc`` exactly."""
    sy = _case(request, name)
    plan = sy["tplan"]
    sp = tcs.strip_plan(plan)
    ptr, cells, cidx = (t.long() for t in cg_cuda_mb.strip_lists(plan, "cpu"))
    n = sum(int(np.prod(sb.shape)) for sb in plan.superblocks)
    assert ptr[-1] == len(cells) == int((cidx >= 0).sum())
    g = torch.Generator().manual_seed(0)
    r = torch.randn(n, dtype=torch.float64, generator=g)
    ref = tcs.restrict(plan, sp, cg_cuda_mb.unflatten_fields(plan, r[None]))[0]
    got = torch.stack([r[cells[ptr[k]:ptr[k + 1]]].sum() for k in range(sp.K)])
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
    xc = torch.randn(sp.K, dtype=torch.float64, generator=g)
    back = cg_cuda_mb.flatten_fields(plan, tcs.prolong(plan, sp, xc[None]))[0]
    expect = torch.where(cidx >= 0, xc[cidx.clamp(min=0)], torch.zeros(()).double())
    assert torch.equal(back, expect)


def _solve_pair(sy, b_blocks, x0_blocks=None, maxiter=3000, dtype="float32"):
    """K3-coarse in both packages on the same system, in ``dtype`` (JAX
    float64 under a scoped ``jax.enable_x64``)."""
    jplan, tplan = sy["jplan"], sy["tplan"]
    kw = dict(tol=TOL, maxiter=maxiter, stall_iters=250, precondition=True,
              return_best=True, coarse_strips=True)
    with jax.enable_x64(dtype == "float64"):
        jdt = getattr(jnp, dtype)
        jd, jo = _pack_j(jplan, sy["jp"])
        jd, jo = (tuple(a.astype(jdt) for a in t) for t in (jd, jo))
        cast = lambda xs: tuple(jnp.asarray(x, jdt) for x in xs)
        jb = jbm.pack_fields(jplan, cast(b_blocks))
        jx0 = None if x0_blocks is None else jbm.pack_fields(jplan, cast(x0_blocks))
        xj, ij = cg_pallas_mb.fused_cg_mb(jplan, jd, jo, jb, jx0,
                                          interpret=True, **kw)
        xj = [np.asarray(x) for x in xj]
    tdt = getattr(torch, dtype)
    td, to = (tuple(a.to(tdt) for a in t) for t in _pack_t(tplan, sy["tp"]))
    cast = lambda xs: tuple(torch.from_numpy(np.asarray(x)).to(tdt) for x in xs)
    tb = tbm.pack_fields(tplan, cast(b_blocks))
    tx0 = None if x0_blocks is None else tbm.pack_fields(tplan, cast(x0_blocks))
    calls = cg_cuda_mb.fused_cg_mb_plain.calls
    xt, it = cg_cuda_mb.fused_cg_mb(tplan, td, to, tb, tx0, **kw)
    assert cg_cuda_mb.fused_cg_mb_plain.calls == calls + 1
    return (xj, ij), (xt, it)


def _true_rmse(sy, xs_merged, b_blocks):
    """RMSE of the blockwise residual ``b - A x`` in float64."""
    ops = tuple(tst.StencilOp(o.diag.double(), o.off.double()) for o in sy["tp"])
    xs = tuple(x.double() for x in tbm.unpack_fields(sy["tplan"], xs_merged))
    ax = tst.domain_apply(ops, xs, sy["tt"])
    res = [torch.from_numpy(b).double() - a for b, a in zip(b_blocks, ax)]
    return float(torch.sqrt(sum((r * r).sum() for r in res)
                            / sum(r.numel() for r in res)))


def _centred(xs):
    """Solutions of the singular system up to its null space (constants)."""
    xs = [np.asarray(x, np.float64) for x in xs]
    mean = sum(x.sum() for x in xs) / sum(x.size for x in xs)
    return [x - mean for x in xs]


def _assert_coarse(sy, j, t, b_blocks, what):
    """Both converge, iterations within 3, the port's true residual within
    2 tol, and the solutions within 2e-4 of max|x| up to a constant: the
    JAX package's coarse inverse scales the constant mode by 1/eps, so its
    solution drifts along the null space by O(max|x|), which the pressure's
    mean normalisation removes."""
    (xj, ij), (xt, it) = j, t
    assert bool(ij.converged) and bool(it.converged), (what, ij, it)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 3, (what, ij, it)
    assert _true_rmse(sy, xt, b_blocks) <= 2 * TOL, what
    cj, ct = _centred(xj), _centred([x.numpy() for x in xt])
    scale = max(np.abs(x).max() for x in cj)
    err = max(np.abs(a - b).max() for a, b in zip(ct, cj))
    assert err <= 2e-4 * scale, f"{what}: max|dx| {err:.3e} > 2e-4 * {scale:.3e}"


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_k3_coarse_plain_matches_kernel_cylinder(systems, warm):
    sy = systems
    x_true = _rhs(sy["tt"], 41)
    b = _in_range(sy, x_true)
    x0 = None
    if warm:
        rng = np.random.default_rng(42)
        x0 = [x + 1e-2 * rng.standard_normal(x.shape).astype(np.float32)
              for x in x_true]
    j, t = _solve_pair(sy, b, x0)
    _assert_coarse(sy, j, t, b, "cylinder " + ("warm" if warm else "cold"))


def _exactly_singular(sy):
    """``sy`` with float64 pressure operators whose rows sum to zero to
    rounding (``diag = -sum_f off_f``).  The float32 operators' rows sum to
    ~1e-8, so 1_K is E's null vector only to that level, and the JAX
    package's coarse inverse, which scales E's near-null mode by ~1/eps,
    turns that into solver noise; on an exactly singular operator the two
    packages' preconditioners are the same function."""
    jp = tuple(jst.StencilOp(-np.asarray(o.off, np.float64).sum(0),
                             np.asarray(o.off, np.float64)) for o in sy["jp"])
    tp = tuple(tst.StencilOp(torch.from_numpy(o.diag), torch.from_numpy(o.off))
               for o in jp)
    return dict(sy, jp=jp, tp=tp)


def test_k3_coarse_flip_plain_matches_kernel_airfoil(airfoil):
    """The reflected seams.  On the float32 operator the JAX package's
    K3-coarse can stall on this system (see ``coarse_strips.coarse_inverse``)
    where the port's converges; on the exactly singular float64 operator
    both converge and agree."""
    b = _in_range(airfoil, _rhs(airfoil["tt"], 43))
    sy64 = _exactly_singular(airfoil)
    j, t = _solve_pair(sy64, b, maxiter=4000, dtype="float64")
    _assert_coarse(sy64, j, t, b, "airfoil cold, float64")
    _, (xt, it) = _solve_pair(airfoil, b, maxiter=4000)
    assert bool(it.converged), it
    assert _true_rmse(airfoil, xt, b) <= 2 * TOL


@pytest.mark.parametrize("name", ["systems", "airfoil"])
def test_coarse_preconditioner_matches_jax(request, name):
    """One application of the two-level preconditioner, ``z = D^-1 r + W
    Einv W^T r``, on a mean-free residual and the exactly singular float64
    operator: the port's plain version (what K3-coarse computes) against
    the JAX package's ``restrict``/``prolong`` with its own
    ``coarse_inverse``; the port's projection of the constant mode changes
    nothing there."""
    sy = _exactly_singular(_case(request, name))
    jplan, tplan = sy["jplan"], sy["tplan"]
    rng = np.random.default_rng(7)
    r_blocks = [rng.standard_normal(bt.shape) for bt in sy["tt"].blocks]
    mean = sum(r.sum() for r in r_blocks) / sum(r.size for r in r_blocks)
    r_blocks = [r - mean for r in r_blocks]
    with jax.enable_x64(True):
        jd, jo = _pack_j(jplan, sy["jp"])
        jsp = jcs.strip_plan(jplan)
        einv = jcs.coarse_inverse(jplan, jsp, tuple(zip(jd, jo)))
        jr = jbm.pack_fields(jplan, tuple(jnp.asarray(r) for r in r_blocks))
        corr = jcs.prolong(jplan, jsp, einv @ jcs.restrict(jplan, jsp, jr))
        zj = [np.asarray(r / d + c) for r, d, c in zip(jr, jd, corr)]
    td, to = _pack_t(tplan, sy["tp"])
    tsp = tcs.strip_plan(tplan)
    diag, _ = cg_cuda_mb.flatten_ops(tplan, td, to)
    tinv = tcs.coarse_inverse(tplan, tsp, tuple(zip(td, to)))
    precond = cg_cuda_mb._coarse_precond(tplan, tsp, tinv[None], diag, True)
    tr = tbm.pack_fields(tplan, tuple(torch.from_numpy(r) for r in r_blocks))
    zt = precond(cg_cuda_mb.flatten_fields(tplan, tuple(r[None] for r in tr)))
    zt = cg_cuda_mb.unflatten_fields(tplan, zt)
    scale = max(np.abs(z).max() for z in zj)
    err = max(np.abs(a[0].numpy() - b).max() for a, b in zip(zt, zj))
    assert err <= 1e-9 * scale, (err, scale)


def test_strips_cut_iterations(full_cyl):
    """Twin of ``tests/test_cg_pallas_mb.py:217`` in the port alone: on a
    smooth manufactured solution (the coarse space targets the smooth
    long-axis modes) the strips take fewer than 0.75x the Jacobi-only
    iterations, to the same true residual."""
    sy = full_cyl
    plan, topo = sy["tplan"], sy["tt"]
    fields = []
    for bt in topo.blocks:
        H, W = bt.shape
        yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                             indexing="ij")
        fields.append(torch.from_numpy(
            (np.sin(2 * np.pi * yy) + np.cos(2 * np.pi * xx)
             + 0.5 * np.sin(4 * np.pi * (yy + xx))).astype(np.float32)))
    b = tst.domain_apply(sy["tp"], tuple(fields), topo)
    td, to = _pack_t(plan, sy["tp"])
    bs = tbm.pack_fields(plan, b)
    kw = dict(tol=TOL, maxiter=4000)
    _, i0 = cg_cuda_mb.fused_cg_mb(plan, td, to, bs, **kw)
    xs1, i1 = cg_cuda_mb.fused_cg_mb(plan, td, to, bs, coarse_strips=True, **kw)
    assert bool(i0.converged) and bool(i1.converged)
    assert int(i1.iterations) < 0.75 * int(i0.iterations), (
        int(i0.iterations), int(i1.iterations))
    assert _true_rmse(sy, xs1, [x.numpy() for x in b]) <= 2 * TOL
