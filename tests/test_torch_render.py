"""The port's rendering half (``FluidEnv.render_fields`` / ``render`` /
``save_gif`` / ``plot_grid`` / ``save_field_images``, each family's
``get_vorticity``, ``envs/util/visualization.py``, ``utils/field_io.py``)
against the JAX package's, per family.

The JAX env's state is loaded into the port's with ``env_state_from_numpy``;
then the render fields (the resample onto the render grid, the vorticity)
must agree within 1e-5 of their scale, and every frame within 1 of 255 per
channel with at least 99% of its pixels equal.  The 3D families run at a
small size (RBC3D with 4 heaters, CylinderJet3D at resolution 8 on a small
render grid, the channel at its test sizes), the 2D cylinder and airfoil
from their bundled snapshots at full width.
"""

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

import fluidgym_tpu
import fluidgym_tpu_torch
from fluidgym_tpu.utils import field_io as jfio
from fluidgym_tpu_torch.envs.fluid_env import env_state_from_numpy
from fluidgym_tpu_torch.utils import field_io
from torch_port_helpers import assert_rel

torch.set_num_threads(1)
FIELD_RTOL = 1e-5

RBC_KW = dict(n_heaters=4, resolution=4, load_initial_domain=False,
              load_domain_statistics=False, randomize_initial_state=False,
              episode_length=3, step_length=0.1, dt=0.05, local_obs_window=3)
SNAPSHOT_KW = dict(randomize_initial_state=False, load_domain_statistics=False)
CYL3D_KW = dict(resolution=8, n_jets=4, load_initial_domain=False,
                load_domain_statistics=False, randomize_initial_state=False,
                step_length=0.01, dt=0.01)
TCF_KW = dict(resolution_y=9, resolution_x_z=8, actor_size=2,
              load_initial_domain=False, load_domain_statistics=False,
              randomize_initial_state=False)


_PAIRS = {}


def _pair(env_id, kw, seed=0, cache=True):
    """A JAX env after ``reset(seed)`` and a port env on its state (shared
    between the tests that only read them)."""
    key = (env_id, seed, tuple(sorted(kw.items())))
    if not cache or key not in _PAIRS:
        jenv = fluidgym_tpu.make(env_id, **kw)
        jenv.reset(seed=seed)
        tenv = fluidgym_tpu_torch.make(env_id, device="cpu", **kw)
        tenv.set_state(env_state_from_numpy(jenv.get_state()))
        if not cache:
            return jenv, tenv
        _PAIRS[key] = jenv, tenv
    return _PAIRS[key]


def _same_frame(ft, fj, what):
    assert ft.dtype == np.uint8 and ft.shape == fj.shape, (what, ft.shape, fj.shape)
    d = np.abs(ft.astype(np.int16) - fj.astype(np.int16))
    assert d.max() <= 1, f"{what}: a channel differs by {d.max()}"
    equal = float((d.max(axis=-1) == 0).mean())
    assert equal >= 0.99, f"{what}: {equal:.4f} of the pixels equal"


def _check_render(jenv, tenv, getters, render_3d=False):
    for g in getters:
        t = getattr(tenv, g)()
        assert torch.is_tensor(t) and t.device == tenv.device
        assert_rel(t.numpy(), np.asarray(getattr(jenv, g)()), FIELD_RTOL, g)
    fields = tenv.render_fields()
    assert all(torch.is_tensor(v) and v.device == tenv.device
               for v in fields.values())
    tf = tenv._get_render_data(render_3d=render_3d)
    jf = jenv._get_render_data(render_3d=render_3d)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        _same_frame(tf[k], jf[k], k)
    frame = tenv.render()
    assert frame.ndim == 3 and frame.shape[-1] == 3 and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, tf[tenv._default_render_key])


def test_render():
    """Twin of ``tests/test_rbc_env.py::test_render``, held to the JAX
    frame: RBC2D's temperature on the render grid and its frame."""
    jenv, tenv = _pair("RBC2D-easy-v0", RBC_KW, seed=1)
    frame = tenv.render()
    assert frame.ndim == 3 and frame.shape[-1] == 3
    assert frame.dtype == np.uint8
    lo, hi = tenv._T_cold, tenv._T_hot + tenv._heater_limit
    assert_rel(tenv.render_fields()["temperature"].numpy(),
               (np.asarray(jenv.get_temperature()) - lo) / (hi - lo), FIELD_RTOL,
               "scaled temperature")
    _check_render(jenv, tenv, ["get_temperature", "get_velocity", "get_pressure"])


def test_render_rbc3d_small():
    jenv, tenv = _pair("RBC3D-easy-v0", RBC_KW)
    assert tenv._default_render_key == "x-y-temperature"
    _check_render(jenv, tenv, ["get_temperature"])


def test_render_cylinder2d_full_width():
    jenv, tenv = _pair("CylinderJet2D-easy-v0", SNAPSHOT_KW)
    assert tenv.render_shape == jenv.render_shape
    _check_render(jenv, tenv, ["get_vorticity", "get_velocity", "get_pressure"])
    assert float(tenv.get_vorticity().abs().max()) > 1.0  # a vortex street


def test_render_cylinder3d_small_render_grid(monkeypatch):
    """CylinderJet3D at resolution 8 on a (96, 24, 24) render grid, the
    mid-plane frame and the 3D iso-surface frame."""
    from fluidgym_tpu.envs.cylinder.jet_cylinder_env_3d import (
        CylinderJetEnv3D as JCyl3D)
    from fluidgym_tpu_torch.envs.cylinder.jet_cylinder_env_3d import CylinderJetEnv3D

    small = property(lambda self: (96, 24, 24))
    monkeypatch.setattr(JCyl3D, "render_shape", small)
    monkeypatch.setattr(CylinderJetEnv3D, "render_shape", small)
    jenv, tenv = _pair("CylinderJet3D-easy-v0", CYL3D_KW, cache=False)
    assert tuple(tenv.get_vorticity().shape) == (24, 24, 96)
    _check_render(jenv, tenv, ["get_vorticity", "get_velocity"], render_3d=True)


def test_render_airfoil2d_full_width():
    jenv, tenv = _pair("Airfoil2D-easy-v0", SNAPSHOT_KW)
    _check_render(jenv, tenv, ["get_vorticity", "get_velocity"])
    assert int(tenv._airfoil_mask.sum()) > 0
    vort = tenv.get_vorticity()
    assert bool((vort[torch.as_tensor(tenv._airfoil_mask)] == 0).all())


def test_render_channel_3d():
    jenv, tenv = _pair("TCFSmall3D-bottom-easy-v0", TCF_KW)
    assert tenv.render_shape == jenv.render_shape
    assert_rel(tenv.get_q_criterion().numpy(), np.asarray(jenv.get_q_criterion()),
               FIELD_RTOL, "Q-criterion")
    _check_render(jenv, tenv, [], render_3d=True)


def test_render_save_and_gif(tmp_path):
    """``render(save=True)`` writes one PNG per frame name, ``save_gif``
    one GIF of every frame since the reset and drops them; a reset drops
    them too."""
    from PIL import Image

    env = fluidgym_tpu_torch.make("RBC2D-easy-v0", device="cpu", **RBC_KW)
    env.reset(seed=0)
    f0 = env.render(save=True, output_path=tmp_path, filename="first")
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "first_temperature.png")), f0)
    env.step(np.full((4, 1), 0.5, np.float32))
    env.render()
    env.save_gif("ep", output_path=tmp_path)
    gif = Image.open(tmp_path / "ep_temperature.gif")
    assert gif.n_frames == 2 and gif.size == (f0.shape[1], f0.shape[0])
    assert not env._frames
    env.render()
    env.reset(seed=1)
    assert not env._frames


@pytest.mark.parametrize("env_id,kw", [("RBC2D-easy-v0", RBC_KW),
                                       ("CylinderJet2D-easy-v0", SNAPSHOT_KW),
                                       ("TCFSmall3D-bottom-easy-v0", TCF_KW)])
def test_plot_grid(tmp_path, env_id, kw):
    """The mesh wireframe of the port's grid: the JAX package's vertex
    coordinates and line count, saved as ``<name>_grid.pdf``."""
    import matplotlib.pyplot as plt

    jenv, tenv = _pair(env_id, kw)
    for jg, tg in zip(jenv._blocks_vertex_coords, tenv._blocks_vertex_coords):
        assert_rel(np.asarray(tg), np.asarray(jg), 1e-6, "vertex coordinates")
    fig, ax = tenv.plot_grid()
    jfig, jax_ax = jenv.plot_grid()
    assert len(ax.lines) == len(jax_ax.lines) > 0
    plt.close(fig)
    plt.close(jfig)
    tenv.plot_grid(output_path=tmp_path, name="g")
    assert (tmp_path / "g_grid.pdf").exists()


def test_save_field_png_and_npz(tmp_path):
    rng = np.random.default_rng(0)
    f2d = rng.normal(size=(6, 8))
    p = field_io.save_field_png(f2d, tmp_path / "f")
    assert p.exists() and p.suffix == ".png"
    img = mpimg.imread(p)
    assert img.shape[:2] == (6, 8)
    np.testing.assert_array_equal(img, mpimg.imread(jfio.save_field_png(
        f2d, tmp_path / "jax_f")))

    p2 = field_io.save_fields_npz({"a": f2d}, tmp_path / "raw")
    back = np.load(p2)
    np.testing.assert_allclose(back["a"], f2d.astype(np.float32))


def test_save_field_images_2d_channels(tmp_path):
    rng = np.random.default_rng(1)
    fields = {"velocity": rng.normal(size=(2, 6, 8)),
              "pressure": rng.normal(size=(6, 8))}
    paths = field_io.save_field_images(fields, tmp_path, prefix="t")
    jpaths = jfio.save_field_images(fields, tmp_path / "jax", prefix="t")
    names = sorted(p.name for p in paths)
    assert names == sorted(p.name for p in jpaths)
    assert "t_velocity0.png" in names
    assert "t_velocity1.png" in names
    assert "t_pressure.png" in names
    assert "t_raw.npz" in names
    raw = np.load(tmp_path / "t_raw.npz")
    assert set(raw.files) == {"velocity0", "velocity1", "pressure"}


def test_save_field_images_3d_midslices(tmp_path):
    f = np.random.default_rng(2).normal(size=(4, 6, 8))
    paths = field_io.save_field_images({"q": f}, tmp_path, prefix="v")
    names = {p.name for p in paths}
    assert {"v_q_xy.png", "v_q_xz.png", "v_q_yz.png", "v_raw.npz"} <= names
    jfio.save_field_images({"q": f}, tmp_path / "jax", prefix="v")
    for n in ("v_q_xy.png", "v_q_xz.png", "v_q_yz.png"):
        np.testing.assert_array_equal(mpimg.imread(tmp_path / n),
                                      mpimg.imread(tmp_path / "jax" / n))


def test_env_save_field_images(tmp_path):
    kw = dict(n_heaters=4, resolution=4, episode_length=3, step_length=0.1,
              dt=0.05, load_initial_domain=False, load_domain_statistics=False,
              randomize_initial_state=False)
    jenv, env = _pair("RBC2D-easy-v0", kw)
    paths = env.save_field_images(tmp_path)
    names = {p.name for p in paths}
    assert any("velocity0" in n for n in names)
    assert any("temperature" in n for n in names)
    assert any(n.endswith("_raw.npz") for n in names)
    raw = np.load([p for p in paths if p.suffix == ".npz"][0])
    # temperature on the render grid, finite, within plate bounds
    T = raw["temperature"]
    assert np.isfinite(T).all() and T.min() >= -0.01 and T.max() <= 1.76
    jpaths = jenv.save_field_images(tmp_path / "jax", prefix="j")
    jraw = np.load([p for p in jpaths if p.suffix == ".npz"][0])
    assert sorted(raw.files) == sorted(jraw.files)
    for k in jraw.files:
        assert_rel(raw[k], jraw[k], FIELD_RTOL, k)
