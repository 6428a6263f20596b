"""Domain model, geometry, domain IO and data access of the PyTorch port
against the JAX package (exact: the same numpy code builds both, and
float64 -> float32 casts round the same way)."""

import jax
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.core import domain_io as jio
from fluidgym_tpu.core import geometry as jgeo
from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.core import domain_io as tio
from fluidgym_tpu_torch.core import geometry as tgeo
from fluidgym_tpu_torch.core.domain import (domain_state_from_numpy,
                                            domain_state_to_numpy)
from fluidgym_tpu_torch.utils import data_utils
from torch_port_helpers import SMALL_RBC_KW

torch.set_num_threads(1)

RBC_EASY_ID = "rbc_2d_Ra80000.0_Pr0.7_NH12_HW8"


def _leaves(state):
    """(name, array) pairs of a DomainState-like object, JAX or port."""
    out = [("viscosity", state.viscosity),
           ("scalar_diffusivity", state.scalar_diffusivity)]
    for i, b in enumerate(state.blocks):
        for k in ("velocity", "pressure", "scalar", "velocity_source", "viscosity"):
            out.append((f"b{i}.{k}", getattr(b, k)))
        for f, fd in enumerate(b.faces):
            out.append((f"b{i}.f{f}.velocity", fd.velocity))
            out.append((f"b{i}.f{f}.scalar", fd.scalar))
    return out


def _np(a):
    if a is None:
        return None
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_states_equal(a, b):
    for (ka, va), (kb, vb) in zip(_leaves(a), _leaves(b)):
        assert ka == kb
        if va is None or vb is None:
            assert va is None and vb is None, ka
            continue
        np.testing.assert_array_equal(_np(va), _np(vb), err_msg=ka)


def assert_topos_equal(jt, tt):
    assert (jt.ndims, jt.scalar_channels, jt.name) == (tt.ndims, tt.scalar_channels, tt.name)
    for jb, tb in zip(jt.blocks, tt.blocks):
        assert (jb.shape, jb.orthogonal, jb.name) == (tb.shape, tb.orthogonal, tb.name)
        for jf, tf in zip(jb.faces, tb.faces):
            assert (jf.kind.name, jf.vel_type.name) == (tf.kind.name, tf.vel_type.name)
            assert [t.name for t in jf.scalar_types] == [t.name for t in tf.scalar_types]


@pytest.mark.parametrize("base", [1.0, 1.02])
def test_geometry_matches(base):
    jg = jgeo.make_wall_refined_ortho_grid(16, 10, (0.0, -0.5), (np.pi, 0.5),
                                           ("-y", "+y"), base)
    tg = tgeo.make_wall_refined_ortho_grid(16, 10, (0.0, -0.5), (np.pi, 0.5),
                                           ("-y", "+y"), base)
    np.testing.assert_array_equal(jg, tg)
    for a, b in zip(jgeo.coords_to_transforms(jg), tgeo.coords_to_transforms(tg)):
        np.testing.assert_array_equal(a, b)


def test_bundled_snapshot_loads_identically():
    """The full-width RBC2D-easy snapshot (61 x 96) read by both packages."""
    path = data_utils.initial_domain_dir(RBC_EASY_ID) / "train_00"
    assert path.with_suffix(".npz").exists()
    assert data_utils.BUNDLED_DATA.parent.name == "fluidgym_tpu"
    jt, jg, js = jio.load_domain(path)
    tt, tg, ts = tio.load_domain(path)
    assert tt.blocks[0].shape == (61, 96)
    assert_topos_equal(jt, tt)
    assert_states_equal(js, ts)
    for a, b in zip(jg, tg):
        for k in ("det", "minv_diag", "alpha", "centers"):
            np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                          getattr(b, k).numpy(), err_msg=k)
    stats = data_utils.load_statistics(RBC_EASY_ID)
    assert stats["nusselt"]["p50"] > 1.0


def test_builder_and_state_carry_across():
    """The RBC domain builder gives the same topo/geoms/state in both
    packages from the same seed, and a JAX state carried across with
    domain_state_from_numpy (and back) is unchanged."""
    jenv = fluidgym_tpu.make("RBC2D-easy-v0", **SMALL_RBC_KW)
    tenv = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **SMALL_RBC_KW)
    jenv.seed(3)
    tenv.seed(3)
    jt, jg, js = jenv._get_domain()
    tt, tg, ts = tenv._get_domain()
    assert_topos_equal(jt, tt)
    assert_states_equal(js, ts)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(np.asarray(a.alpha), b.alpha.numpy())
    carried = domain_state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    assert_states_equal(js, carried)
    back = domain_state_to_numpy(carried)
    assert_states_equal(js, back)
    assert isinstance(back.blocks[0].velocity, np.ndarray)


def test_spaces_mirror_gymnasium():
    gym = pytest.importorskip("gymnasium")
    box = spaces.Box(low=-1.0, high=1.0, shape=(4, 1), dtype=np.float32)
    gbox = gym.spaces.Box(low=-1.0, high=1.0, shape=(4, 1), dtype=np.float32)
    assert box.shape == gbox.shape and box.dtype == gbox.dtype
    np.testing.assert_array_equal(box.low, gbox.low)
    g = torch.Generator().manual_seed(0)
    s = box.sample(g)
    assert box.contains(s) and gbox.contains(s)
    assert not box.contains(np.full((4, 1), 2.0, np.float32))
    d = spaces.Dict({"a": box, "b": spaces.Box(-np.inf, np.inf, (2,))})
    assert set(d.spaces) == {"a", "b"} and d["a"] is box
    assert d.contains({"a": s, "b": np.zeros(2, np.float32)})
    assert not d.contains({"a": s})


def test_make_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; make() then runs on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fluidgym_tpu_torch.make("RBC2D-easy-v0", **SMALL_RBC_KW)
