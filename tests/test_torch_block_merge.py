"""The port's block merge (``fluidgym_tpu_torch.solver.block_merge``)
against the JAX package's on the CylinderJet2D topology: identical merge
plans (super-blocks, placements, fixups, ``identity_seams``) at resolutions
8, 16 and 24, and ``pack_fields``/``unpack_fields``/``pack_ops``/
``merged_apply`` equal to the JAX package's (<= 1e-6 relative; the same
float32 arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidgym_tpu.envs.cylinder.grid import make_vortex_street_domain as jgrid
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu.solver import stencil as jst
from fluidgym_tpu_torch.envs.cylinder.grid import make_vortex_street_domain as tgrid
from fluidgym_tpu_torch.solver import block_merge as tbm
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import assert_rel

torch.set_num_threads(1)

GRID_KW = dict(ndims=2, viscosity=0.01, domain_height=4.1, domain_length=22.0,
               cylinder_radius=0.5, cylinder_offset_y=0.05, circle_thickness=0.5,
               quad_thickness_x=1.0, vortex_street_refinement_base=0.95,
               vortex_street_refinement_axes=("+y", "-y"))


def _topos(res):
    jt = jgrid(circle_resolution_angular=res, **GRID_KW)[0].build()[0]
    tt = tgrid(circle_resolution_angular=res, **GRID_KW)[0].build()[0]
    return jt, tt


def _plan_tuple(plan):
    return (plan.ndims,
            [(sb.shape, [(m.block, m.perm, m.inv, m.offset, m.shape)
                         for m in sb.members]) for sb in plan.superblocks],
            [(f.sb, f.face, f.window, f.src_sb, f.src_face, f.src_window, f.flip)
             for f in plan.fixups],
            plan.identity_seams)


@pytest.mark.parametrize("res", [8, 16, 24])
def test_merge_plan_matches_jax(res):
    jt, tt = _topos(res)
    jp, tp = jbm.merge_plan(jt), tbm.merge_plan(tt)
    assert jp is not None and tp is not None
    assert _plan_tuple(tp) == _plan_tuple(jp)
    assert len(tp.superblocks) == 2 and len(tp.fixups) == 2 and tp.identity_seams


def test_registered_width_plan():
    """The registered CylinderJet2D-easy-v0 width: 5 blocks -> the ring
    (37, 96) and the wake (445, 24) in physical-axis order, 14,232 cells."""
    _, tt = _topos(24)
    plan = tbm.merge_plan(tt)
    assert [sb.shape for sb in plan.superblocks] == [(37, 96), (445, 24)]
    assert sum(int(np.prod(sb.shape)) for sb in plan.superblocks) == 14232
    assert sum(int(np.prod(b.shape)) for b in tt.blocks) == 14232


def test_self_check_rejects_a_wrong_plan():
    """The plan-time self-check catches a corrupted fixup."""
    from dataclasses import replace

    _, tt = _topos(8)
    plan = tbm.merge_plan(tt)
    fx = plan.fixups[0]
    bad = replace(plan, fixups=(replace(fx, src_face=fx.src_face ^ 1),)
                  + plan.fixups[1:])
    assert tbm._self_check(tt, plan)
    assert not tbm._self_check(tt, bad)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["spatial", "lanes"])
def test_pack_unpack_apply_match_jax(lead):
    jt, tt = _topos(16)
    jp, tp = jbm.merge_plan(jt), tbm.merge_plan(tt)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(bt.shape).astype(np.float32) for bt in tt.blocks]
    diags = [rng.standard_normal(bt.shape).astype(np.float32) for bt in tt.blocks]
    offs = [rng.standard_normal((4,) + bt.shape).astype(np.float32)
            for bt in tt.blocks]
    jops = tuple(jst.StencilOp(jnp.asarray(d), jnp.asarray(o))
                 for d, o in zip(diags, offs))
    tops = tuple(tst.StencilOp(torch.from_numpy(d), torch.from_numpy(o))
                 for d, o in zip(diags, offs))
    jpk = jbm.pack_fields(jp, tuple(jnp.asarray(x) for x in xs))
    tpk = tbm.pack_fields(tp, tuple(torch.from_numpy(x) for x in xs))
    for a, b in zip(tpk, jpk):
        assert_rel(a.numpy(), np.asarray(b), 0, "pack")
    for a, b in zip(tbm.unpack_fields(tp, tpk), xs):
        assert_rel(a.numpy(), b, 0, "unpack round trip")
    jmo, tmo = jbm.pack_ops(jp, jops), tbm.pack_ops(tp, tops)
    for (jd, jo), (td, to) in zip(jmo, tmo):
        assert_rel(td.numpy(), np.asarray(jd), 0, "pack_ops diag")
        assert_rel(to.numpy(), np.asarray(jo), 0, "pack_ops off")
    # merged_apply, with optional leading lanes, against the JAX package's
    ys = [np.broadcast_to(np.asarray(p), lead + p.shape).copy() for p in jpk]
    if lead:
        ys = [y * (1 + np.arange(lead[0], dtype=np.float32)).reshape(
            lead + (1, 1)) for y in ys]
    got = tbm.merged_apply(tp, tmo, tuple(torch.from_numpy(y) for y in ys))
    for li in np.ndindex(*lead) if lead else [()]:
        ref = jbm.merged_apply(jp, jmo, tuple(jnp.asarray(y[li]) for y in ys))
        for a, b in zip(got, ref):
            assert_rel(a[li].numpy(), np.asarray(b), 1e-6, "merged_apply")
    # ... and equal to the blockwise domain_apply through unpack
    back = tbm.unpack_fields(tp, tbm.merged_apply(tp, tmo, tpk))
    for a, b in zip(back, tst.domain_apply(tops, tuple(torch.from_numpy(x)
                                                      for x in xs), tt)):
        assert_rel(a.numpy(), b.numpy(), 1e-6, "merged vs blockwise")
