"""K4, the fused 2D stencil apply (``fluidgym_tpu_torch/ops/stencil_cuda.py``),
plain version against the JAX package's ``stencil_apply_pallas`` in
interpret mode (twins of ``tests/test_ops.py:36,43,55``), its column form,
and ``stencil.domain_apply`` with the switch on.

Bars: the forward within 1e-6 of max|y| (the same products summed in the
same face order); the gradients within 1e-4 (as the JAX package's own
test); ``domain_apply`` with the switch on equal to the roll formulation
bit for bit (the same products summed in the same order); the column form
equal to one call per column.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.ops import stencil_pallas as jsp
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.ops import stencil_cuda
from fluidgym_tpu_torch.solver import piso as tpiso
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import CYL_KW, assert_rel

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _switches():
    """JAX kernel in interpret mode; both switches restored afterwards."""
    jsp.set_pallas_interpret(True)
    try:
        yield
    finally:
        jsp.set_pallas_interpret(False)
        jsp.set_pallas_stencil(False)
        stencil_cuda.set_stencil_kernel(False)


def _data(ny=9, nx=13, seed=0, cols=()):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(ny, nx)).astype(np.float32)
    o = rng.normal(size=(4, ny, nx)).astype(np.float32)
    x = rng.normal(size=cols + (ny, nx)).astype(np.float32)
    h = tuple(rng.normal(size=cols + s).astype(np.float32)
              for s in ((ny, 1), (ny, 1), (1, nx), (1, nx)))
    return d, o, x, h


def _t(a):
    return torch.from_numpy(np.array(a))


def test_forward_matches_jax():
    d, o, x, h = _data()
    yj = jsp.stencil_apply_pallas(jnp.asarray(d), jnp.asarray(o), jnp.asarray(x),
                                  tuple(jnp.asarray(a) for a in h))
    calls = stencil_cuda.stencil_apply_plain.calls
    yt = stencil_cuda.stencil_apply(_t(d), _t(o), _t(x), tuple(_t(a) for a in h))
    assert stencil_cuda.stencil_apply_plain.calls == calls + 1
    assert_rel(yt.numpy(), np.asarray(yj), 1e-6, "forward")


def test_vjp_matches_jax():
    """The autograd backward (the JAX package's ``_bwd`` formula) against
    ``jax.grad`` through its custom VJP, for every operand and the halos."""
    d, o, x, h = _data(seed=1)

    def loss(dd, oo, xx, hh):
        return jnp.sum(jsp.stencil_apply_pallas(dd, oo, xx, hh) ** 2)

    gj = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(d), jnp.asarray(o), jnp.asarray(x),
        tuple(jnp.asarray(a) for a in h))
    ts = [_t(a).requires_grad_() for a in (d, o, x, *h)]
    y = stencil_cuda.stencil_apply(ts[0], ts[1], ts[2], tuple(ts[3:]))
    (y ** 2).sum().backward()
    for t_, j_ in zip(ts, jax.tree.leaves(gj)):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(j_), atol=1e-4)


def test_column_form_matches_scalar_calls():
    """``(k, ny, nx)`` (the deflation columns written out) equals k calls of
    the scalar form, forward and backward (the shared coefficients'
    gradients summed over the columns)."""
    d, o, x, h = _data(seed=2, cols=(5,))
    ts = [_t(a).requires_grad_() for a in (d, o, x, *h)]
    y = stencil_cuda.stencil_apply(ts[0], ts[1], ts[2], tuple(ts[3:]))
    (y ** 2).sum().backward()
    dd = torch.zeros(d.shape)
    do = torch.zeros(o.shape)
    for k in range(5):
        tk = [_t(d).requires_grad_(), _t(o).requires_grad_(),
              _t(x[k]).requires_grad_(), *(_t(a[k]).requires_grad_() for a in h)]
        yk = stencil_cuda.stencil_apply(tk[0], tk[1], tk[2], tuple(tk[3:]))
        assert torch.equal(yk, y[k].detach())
        (yk ** 2).sum().backward()
        dd += tk[0].grad
        do += tk[1].grad
        assert torch.equal(tk[2].grad, ts[2].grad[k])
        for a, b in zip(tk[3:], ts[3:]):
            assert torch.equal(a.grad, b.grad[k])
    torch.testing.assert_close(ts[0].grad, dd, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ts[1].grad, do, rtol=1e-6, atol=1e-6)


def test_other_devices_raise():
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        stencil_cuda.stencil_apply(meta(3, 4), meta(4, 3, 4), meta(3, 4),
                                   (meta(3, 1), meta(3, 1), meta(1, 4),
                                    meta(1, 4)))


@pytest.fixture(scope="module")
def cylinder():
    """The res-16 cylinder's pressure operator (A = 1, as the JAX package's
    test) built by the JAX package, the same numbers as port operators, and
    the port's topology."""
    jenv = fluidgym_tpu.make("CylinderJet2D-easy-v0", **CYL_KW)
    jenv.reset(seed=0)
    adiags = tuple(jnp.ones_like(g.det) for g in jenv._geoms)
    jp = jst.build_pressure_ops(adiags, jenv._geoms, jenv._topo)
    tenv = fluidgym_tpu_torch.make("CylinderJet2D-easy-v0", device="cpu", **CYL_KW)
    tp = tuple(tst.StencilOp(_t(o.diag), _t(o.off)) for o in jp)
    return jenv._topo, jp, tenv._get_domain()[0], tp


@pytest.mark.parametrize("cols", [None, 15], ids=["scalar", "columns"])
def test_domain_apply_switch_on_matches_off(cylinder, cols):
    """Twin of ``tests/test_ops.py:55``: ``domain_apply`` through K4 (its
    plain version here) against the roll formulation on the 5 blocks of the
    cylinder, scalar fields and the 15-column deflation form; and against
    the JAX package with its kernel switched on (interpret mode)."""
    jt, jp, tt, tp = cylinder
    rng = np.random.default_rng(3)
    lead = () if cols is None else (cols,)
    xs = tuple(rng.normal(size=lead + bt.shape).astype(np.float32)
               for bt in tt.blocks)
    txs = tuple(_t(x) for x in xs)
    ref = tst.domain_apply(tp, txs, tt)
    calls = stencil_cuda.stencil_apply_plain.calls
    stencil_cuda.set_stencil_kernel(True)
    out = tst.domain_apply(tp, txs, tt)
    assert stencil_cuda.stencil_apply_plain.calls == calls + len(tt.blocks)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)  # the same products, summed in face order
    jsp.set_pallas_stencil(True)
    jx = tuple(jnp.asarray(x) for x in xs)
    if cols is None:
        jout = jst.domain_apply(jp, jx, jt)
    else:
        jout = jax.vmap(lambda *c: jst.domain_apply(jp, c, jt))(*jx)
    for a, b in zip(out, jout):
        assert_rel(a.numpy(), np.asarray(b), 1e-6, "port vs JAX, switch on")


def test_deflation_setup_through_k4(cylinder):
    """The pressure warm start's coarse setup (15 columns) and self-gated
    guess through K4 equal the roll formulation's."""
    _, _, tt, tp = cylinder
    rng = np.random.default_rng(4)
    b = tuple(_t(rng.normal(size=bt.shape).astype(np.float32)) for bt in tt.blocks)
    base = tuple(_t(rng.normal(size=bt.shape).astype(np.float32))
                 for bt in tt.blocks)
    ref = tpiso._make_deflation_x0(tp, tt, torch.float32)(b, base=base)
    calls = stencil_cuda.stencil_apply_plain.calls
    stencil_cuda.set_stencil_kernel(True)
    out = tpiso._make_deflation_x0(tp, tt, torch.float32)(b, base=base)
    # one column-batched apply for E, one scalar apply for the gate
    assert stencil_cuda.stencil_apply_plain.calls == calls + 2 * len(tt.blocks)
    for a, r in zip(out, ref):
        assert_rel(a.numpy(), r.numpy(), 1e-6, "deflation guess")
