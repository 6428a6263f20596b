"""Airfoil2D grid, merge plan, seam matvecs and sensor mask: the port
(``fluidgym_tpu_torch.envs.airfoil``, ``solver.block_merge``,
``ops.cg_cuda_mb.neighbor_table``) against the JAX package at the
registered width (6 blocks, 73,456 cells; no grid-size knob exists).

Bars: vertex coordinates exact (the same float64 numpy arithmetic); the
merge plan identical, 3 super-blocks with 6 fixups of which 2 are the
reflected wake cut; ``merged_apply`` equals the blockwise
``stencil.domain_apply`` (<= 1e-6 relative); the kernels' neighbour-table
matvec equals ``merged_apply`` (<= 1e-6 relative, 2 lanes) on the airfoil
plan and on a two-block box whose right half is rotated by 180 degrees; the
airfoil mask equals matplotlib's ``Path.contains_points`` bit for bit at
attack angles 0, 10 and 20 degrees, with the JAX package's sensor count.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from fluidgym_tpu.envs.airfoil.grid import make_airfoil_domain as jgrid
from fluidgym_tpu.solver import block_merge as jbm
from fluidgym_tpu_torch.core import geometry as tgeo
from fluidgym_tpu_torch.core.domain import BoundKind, DomainBuilder
from fluidgym_tpu_torch.envs.airfoil.grid import make_airfoil_domain as tgrid
from fluidgym_tpu_torch.ops import cg_cuda_mb
from fluidgym_tpu_torch.solver import block_merge as tbm
from fluidgym_tpu_torch.solver import coarse_strips
from fluidgym_tpu_torch.solver import stencil as tst
from torch_port_helpers import assert_rel

torch.set_num_threads(1)

GRID_KW = dict(ndims=2, H=1.4, L=4.5, vel_in=0.3, attack_angle_deg=10.0,
               viscosity=3e-4, tail_grow_mul=1.01)


@pytest.fixture(scope="module")
def doms():
    jd, jinfo = jgrid(res_z=0, **GRID_KW)
    td, tinfo = tgrid(**GRID_KW)
    return jd, jinfo, td, tinfo, td.build()


def _plan_tuple(plan):
    return (plan.ndims,
            [(sb.shape, [(m.block, m.perm, m.inv, m.offset, m.shape)
                         for m in sb.members]) for sb in plan.superblocks],
            [(f.sb, f.face, f.window, f.src_sb, f.src_face, f.src_window, f.flip)
             for f in plan.fixups],
            plan.identity_seams)


def test_vertex_coords_and_faces_match_jax(doms):
    jd, jinfo, td, tinfo, (topo, geoms, _) = doms
    assert len(td._blocks) == 6
    for jb, tb in zip(jd._blocks, td._blocks):
        np.testing.assert_array_equal(tb.coords, np.asarray(jb.coords))
    jtopo = jd.build()[0]
    for jb, tb in zip(jtopo.blocks, topo.blocks):
        assert tb.shape == jb.shape
        for jf, tf in zip(jb.faces, tb.faces):
            assert (int(tf.kind), tf.connected_block, tf.connected_face,
                    tuple(tf.axes or ())) == (int(jf.kind), jf.connected_block,
                                              jf.connected_face,
                                              tuple(jf.axes or ()))
    assert sum(int(np.prod(b.shape)) for b in topo.blocks) == 73456
    for k in ("x_min", "x_max", "y_min", "y_max", "out_faces", "normal_res"):
        assert tinfo[k] == jinfo[k]
    for g in geoms:
        assert float(g.det.min()) > 0


def test_3d_grid_raises():
    """A 3D grid needs its span's cells (the 3D grid itself is held against
    the JAX package in ``tests/test_torch_airfoil3d_ops.py``)."""
    with pytest.raises(ValueError, match="res_z"):
        tgrid(**{**GRID_KW, "ndims": 3})


def test_merge_plan_matches_jax(doms):
    """Twin of ``tests/test_block_merge.py:151``: 3 super-blocks, 6 fixups,
    2 of them the reflected wake cut (same face on both sides, axis 1
    reversed, 301 cells long)."""
    jd, _, _, _, (topo, _, _) = doms
    tp, jp = tbm.merge_plan(topo), jbm.merge_plan(jd.build()[0])
    assert tp is not None and jp is not None
    assert _plan_tuple(tp) == _plan_tuple(jp)
    assert [s for s in coarse_strips.sb_array_shapes(tp)] == [
        (11, 166), (377, 95), (377, 95)]
    assert len(tp.fixups) == 6 and not tp.identity_seams
    cut = [f for f in tp.fixups if any(f.flip)]
    assert len(cut) == 2
    for f in cut:
        assert f.sb != f.src_sb and f.face == f.src_face
        assert f.flip == (False, True)
        lo, hi = f.window[1]
        assert hi - lo == 301


def _random_ops(topo, seed):
    """Random float32 stencil coefficients; FIXED faces carry off = 0 on
    their boundary layer, as every operator of the solver does."""
    rng = np.random.default_rng(seed)

    class Op:
        def __init__(self, d, o):
            self.diag, self.off = d, o

    ops = []
    for bt in topo.blocks:
        off = rng.uniform(-1, 0, (4,) + bt.shape).astype(np.float32)
        for f, spec in enumerate(bt.faces):
            if spec.kind == BoundKind.FIXED:
                ax = 1 - f // 2
                idx = [slice(None)] * 2
                idx[ax] = slice(-1, None) if f % 2 else slice(0, 1)
                off[(f,) + tuple(idx)] = 0.0
        ops.append(Op(torch.from_numpy(rng.uniform(1, 2, bt.shape)
                                       .astype(np.float32)),
                      torch.from_numpy(off)))
    return tuple(ops)


def test_merged_apply_matches_domain_apply(doms):
    """Twin of ``tests/test_block_merge.py:165``: the merged-frame matvec
    (rolls + slab fixups, the flip slabs reversed) is the blockwise halo
    apply, permuted."""
    _, _, _, _, (topo, _, _) = doms
    plan = tbm.merge_plan(topo)
    ops = _random_ops(topo, 4)
    rng = np.random.default_rng(5)
    xs = tuple(torch.from_numpy(rng.standard_normal(bt.shape).astype(np.float32))
               for bt in topo.blocks)
    want = tst.domain_apply(ops, xs, topo)
    got = tbm.unpack_fields(plan, tbm.merged_apply(
        plan, tbm.pack_ops(plan, ops), tbm.pack_fields(plan, xs)))
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert err <= 1e-6 * scale, (err, scale)


def _rotated_box_topo(n=16):
    """The two-block box of ``tests/test_multiblock.py:118``: the right
    half rotated by 180 degrees, joined on both x faces with the tangential
    axis inverted."""
    L = 2 * np.pi
    dom = DomainBuilder(ndims=2, viscosity=0.02)
    left = tgeo.make_uniform_grid((n // 2, n), (0, 0), (L / 2, L))
    right = tgeo.make_uniform_grid((n // 2, n), (L / 2, 0), (L, L))
    dom.create_block(left)
    dom.create_block(right[:, ::-1, ::-1].copy())
    dom.connect_blocks(0, "+x", 1, "+x", "+y")
    dom.connect_blocks(0, "-x", 1, "-x", "+y")
    return dom.build()[0]


@pytest.mark.parametrize("which", ["airfoil", "rotated_box"])
def test_neighbor_table_matvec_matches_merged_apply(doms, which):
    """What ``csrc/merged.cuh`` computes (one gather per face through the
    table) equals ``merged_apply`` with 2 lanes."""
    topo = doms[4][0] if which == "airfoil" else _rotated_box_topo()
    plan = tbm.merge_plan(topo)
    assert plan is not None
    mops = tbm.pack_ops(plan, _random_ops(topo, 1))
    td, to = tuple(m[0] for m in mops), tuple(m[1] for m in mops)
    rng = np.random.default_rng(0)
    xs = tuple(torch.from_numpy(rng.standard_normal((2,) + tuple(d.shape))
                                .astype(np.float32)) for d in td)
    ref = tbm.merged_apply(plan, tuple(zip(td, to)), xs)
    diag, off = cg_cuda_mb.flatten_ops(plan, td, to)
    nbr = cg_cuda_mb.neighbor_table(plan, "cpu").long()
    v = cg_cuda_mb.flatten_fields(plan, xs)
    y = diag * v
    for f in range(4):
        y = y + off[:, f] * v[:, nbr[f]]
    assert_rel(y.numpy(), cg_cuda_mb.flatten_fields(plan, ref).numpy(), 1e-6,
               f"table matvec ({which})")


def test_neighbor_table_rejects_overlapping_fixups(doms):
    """``merged_apply`` adds each fixup's delta where the table replaces
    the neighbour, so two fixups on one (super-block, face, cell) would make
    them differ; the table refuses such a plan."""
    plan = tbm.merge_plan(doms[4][0])
    bad = replace(plan, fixups=plan.fixups + (plan.fixups[-1],))
    with pytest.raises(ValueError, match="overlap"):
        cg_cuda_mb.neighbor_table(bad, "cpu")


def _bare(cls, angle):
    """An env instance without ``__init__``: just enough for the mask and
    sensor methods."""
    from fluidgym_tpu_torch.envs.airfoil.grid import read_airfoil

    env = object.__new__(cls)
    env._ndims = 2
    env._airfoil_coords = read_airfoil(angle)
    return env


@pytest.mark.parametrize("angle", [0.0, 10.0, 20.0])
def test_airfoil_mask_matches_matplotlib(angle):
    from matplotlib.path import Path as MplPath

    from fluidgym_tpu.envs.airfoil import AirfoilEnv2D as JEnv
    from fluidgym_tpu_torch.envs.airfoil import AirfoilEnv2D as TEnv

    env = _bare(TEnv, angle)
    coords = env._physical_locations_to_grid_coords(env._airfoil_coords)
    nx, ny = env.render_shape[:2]
    xx, yy = np.meshgrid(np.arange(nx), np.arange(ny))
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1)
    want = MplPath(coords[:2].T).contains_points(pts).reshape(ny, nx)
    got = env._get_airfoil_mask()
    assert got.dtype == np.bool_ and got.shape == (ny, nx)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 800
    # the sensors the mask keeps: the JAX package's, point for point
    env._airfoil_mask = got
    jenv = _bare(JEnv, angle)
    jenv._airfoil_mask = jenv._get_airfoil_mask()
    np.testing.assert_array_equal(env._get_sensor_locations(),
                                  jenv._get_sensor_locations())
