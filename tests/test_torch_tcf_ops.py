"""The channel flow's building blocks in the PyTorch port against
``fluidgym_tpu`` on the CPU: the wall-unit conversions, the wall-refined y
weights and the vertex grid, the cell centres and wall distances, the
Reichardt and Van Driest profiles and the curl noise (float64 numpy, to
1e-12); the dynamic forcing hook, the velocity gradients (the channel and a
skewed curvilinear block), the Smagorinsky viscosity and its hook with and
without Van Driest damping (to 1e-6 of each field's scale); and the
per-agent-mean windows against a brute-force loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidgym_tpu.core import geometry as jgeo
from fluidgym_tpu.core.domain import DomainBuilder as JDomainBuilder
from fluidgym_tpu.envs.tcf import grid as jgrid
from fluidgym_tpu.envs.tcf import tools as jtools
from fluidgym_tpu.envs.util.curl_noise import curl_noise_3d as j_curl_noise
from fluidgym_tpu.solver import sgs as jsgs
from fluidgym_tpu_torch.core import geometry as tgeo
from fluidgym_tpu_torch.core.domain import DomainBuilder as TDomainBuilder
from fluidgym_tpu_torch.envs.tcf import grid as tgrid
from fluidgym_tpu_torch.envs.tcf import tools as ttools
from fluidgym_tpu_torch.envs.util.curl_noise import curl_noise_3d as t_curl_noise
from fluidgym_tpu_torch.envs.util.obs_extraction import extract_moving_window_2d_x_z
from fluidgym_tpu_torch.solver import sgs as tsgs
from torch_port_helpers import assert_rel

torch.set_num_threads(1)
U_WALL, NU = 180 / ttools.Re_wall_to_cl(180), 1 / ttools.Re_wall_to_cl(180)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0)


# ---------------------------------------------------------------------------
# numpy pieces, to 1e-12
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("Re_wall_to_cl", (180.0,)), ("Re_wall_to_cl", (330.0,)),
    ("Re_wall_to_cl", (550.0,)), ("t_star", (3e-4, 0.06)),
    ("t_star", (1.0 / ttools.Re_wall_to_cl(550), 0.05)),
])
def test_wall_unit_tools(name, args):
    _close(getattr(ttools, name)(*args), getattr(jtools, name)(*args))


@pytest.mark.parametrize("N,ny_half", [(1, 32), (2, 8), (2, 4), (1, 16)])
def test_y_weights(N, ny_half):
    _close(tgrid._make_y_weights(N, ny_half), jgrid._make_y_weights(N, ny_half))


@pytest.mark.parametrize("x,y,z,yN,dims", [(16, 17, 16, 2, 3), (8, 9, 8, 2, 3),
                                           (64, 65, 64, 1, 3), (16, 16, 1, 2, 2)])
def test_vertex_grid_centers_and_wall_distances(x, y, z, yN, dims):
    kw = dict(H=2.0, L=np.pi, D=np.pi / 2, x=x, y_half=y // 2, yN=yN, z=z,
              dims=dims)
    tg, jg = tgrid._make_grid(**kw), jgrid._make_grid(**kw)
    _close(tg, jg)
    info = tgrid.channel_info(H=2.0, L=np.pi, D=np.pi / 2, x=x, y=y, z=z,
                              refinement_strength=yN, n_dims=dims)
    centers = jgeo.cell_centers(jg)
    yc = centers[1, 0, :, 0] if dims == 3 else centers[1, :, 0]
    _close(info["y_centers"], yc)
    _close(info["d_y"], (1 + yc[0], 1 - yc[-1]))


def test_reichardt_and_van_driest_profiles():
    yc = np.linspace(-0.99, 0.99, 33)
    for u_wall, nu in ((U_WALL, NU), (0.05, 1.5e-4)):
        _close(tgrid.reichardt_profile(yc, u_wall, nu),
               jgrid.reichardt_profile(yc, u_wall, nu))
        _close(tgrid.van_driest_sqr_from_centers(yc, u_wall, nu),
               jgrid.van_driest_sqr_from_centers(yc, u_wall, nu))


@pytest.mark.parametrize("shape,n_modes", [((16, 9, 8), 24), ((8, 16, 12), 5)])
def test_curl_noise_bit_for_bit(shape, n_modes):
    scale = tuple(2 / s for s in shape)
    t = t_curl_noise(shape, scale, np.random.default_rng(7), n_modes)
    j = j_curl_noise(shape, scale, np.random.default_rng(7), n_modes)
    assert t.shape == (3, shape[2], shape[1], shape[0])
    assert np.array_equal(t, j)


# ---------------------------------------------------------------------------
# hooks and SGS, to 1e-6
# ---------------------------------------------------------------------------

def _channel(dtype_pair, x=16, y=17, z=16, seed=5):
    """The channel domain at a tiny size from both packages' builders (the
    same curl noise), with a random non-zero bottom-plate velocity."""
    jdt, tdt = dtype_pair
    kw = dict(H=2.0, L=np.pi, D=np.pi / 2, x=x, y=y, z=z, refinement_strength=2,
              n_dims=3, u_wall=U_WALL, viscosity=NU)
    jdom, jinfo = jgrid.make_channel_flow_domain(
        **kw, rng=np.random.default_rng(seed), dtype=jdt)
    tdom, tinfo = tgrid.make_channel_flow_domain(
        **kw, rng=np.random.default_rng(seed), dtype=tdt, device="cpu")
    plate = np.random.default_rng(seed + 1).normal(
        0, 0.01, (3,) + tuple(jdom._blocks[0].face_data[2].velocity.shape[1:]))
    for dom in (jdom, tdom):
        dom._blocks[0].face_data[2].velocity = plate.copy()
    return jdom.build(), tdom.build(), jinfo, tinfo


DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("dt", list(DTYPES))
def test_forcing_hook(dt):
    with jax.enable_x64(dt == "float64"):
        (jt, jg, js), (tt, tg, ts), jinfo, tinfo = _channel(DTYPES[dt])
        assert tinfo["d_y"] == jinfo["d_y"]
        _close(tinfo["y_centers"], jinfo["y_centers"])
        assert_rel(ts.blocks[0].velocity.numpy(), np.asarray(js.blocks[0].velocity),
                   1e-7 if dt == "float32" else 1e-15, "generated velocity")
        jout = jgrid.make_dynamic_forcing_hook(jg, jt, jinfo["d_y"])(js)
        tout = tgrid.make_dynamic_forcing_hook(tg, tt, tinfo["d_y"])(ts)
        src = tout.blocks[0].velocity_source
        assert_rel(src.numpy(), np.asarray(jout.blocks[0].velocity_source), 1e-6,
                   "forcing")
        assert float(src[0].min()) == float(src[0].max()) > 0
        assert not bool(src[1:].any())


@pytest.mark.parametrize("dt", list(DTYPES))
def test_velocity_gradients_and_smagorinsky_on_the_channel(dt):
    with jax.enable_x64(dt == "float64"):
        (jt, jg, js), (tt, tg, ts), _, _ = _channel(DTYPES[dt])
        for a, b in zip(tsgs.velocity_gradients(ts, tg, tt),
                        jsgs.velocity_gradients(js, jg, jt)):
            assert a.shape == (3, 3, 16, 16, 16)
            assert_rel(a.numpy(), np.asarray(b), 1e-6, "G")
        for a, b in zip(tsgs.smagorinsky_viscosity(ts, tg, tt, 0.1),
                        jsgs.smagorinsky_viscosity(js, jg, jt, 0.1)):
            assert_rel(a.numpy(), np.asarray(b), 1e-6, "nu_t")


@pytest.mark.parametrize("van_driest", [False, True])
def test_smagorinsky_hook(van_driest):
    with jax.enable_x64(True):
        (jt, jg, js), (tt, tg, ts), jinfo, _ = _channel(DTYPES["float64"])
        vd_t = vd_j = None
        if van_driest:
            vd = np.broadcast_to(jgrid.van_driest_sqr_from_centers(
                jinfo["y_centers"], U_WALL, NU)[None, :, None], (16, 16, 16))
            vd_t, vd_j = (torch.from_numpy(vd.copy()),), (jnp.asarray(vd),)
        tv = tsgs.make_smagorinsky_hook(tg, tt, 0.17, vd_t)(ts).blocks[0].viscosity
        jv = jsgs.make_smagorinsky_hook(jg, jt, 0.17, vd_j)(js).blocks[0].viscosity
        assert tv.shape == (16, 16, 16) and float(tv.min()) >= NU
        assert_rel(tv.numpy(), np.asarray(jv), 1e-6, "viscosity")


def test_velocity_gradients_on_a_curvilinear_block():
    """The ``minv`` branch: a skewed 2D block, periodic in x, walls in y."""
    corners = [(0.0, 0.0), (1.0, 0.2), (0.3, 1.0), (1.4, 1.1)]
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 9, 12))
    wall = rng.normal(size=(2, 1, 12))
    states = []
    with jax.enable_x64(True):
        for geo, Builder, kw in ((jgeo, JDomainBuilder, dict(dtype=jnp.float64)),
                                 (tgeo, TDomainBuilder, dict(dtype=torch.float64))):
            grid = geo.generate_grid_vertices_2d(
                (10, 13), corners, None, x_weights=np.linspace(0, 1, 10) ** 1.3)
            dom = Builder(ndims=2, viscosity=0.01, **kw)
            blk = dom.create_block(grid)
            blk.close_boundary("-y", velocity=wall)
            blk.set_velocity(u)
            assert not blk.orthogonal
            states.append(dom.build())
        (jt, jg, js), (tt, tg, ts) = states
        a = tsgs.velocity_gradients(ts, tg, tt)[0]
        b = jsgs.velocity_gradients(js, jg, jt)[0]
    assert a.shape == (2, 2, 9, 12)
    assert_rel(a.numpy(), np.asarray(b), 1e-6, "G curvilinear")


# ---------------------------------------------------------------------------
# the per-agent-mean windows (twin of tests/test_obs_extraction.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nax,naz,w,Wx,Wz,px,pz", [
    (4, 3, 2, 3, 3, 0, 0),
    (3, 3, 2, 2, 2, 1, 1),
    (8, 8, 2, 1, 1, 0, 0),    # TCFSmall's default window of 1
    (4, 4, 4, 3, 3, 3, 1),    # the MARL window of 3 (pad_x = w)
])
def test_moving_window_2d_x_z_bruteforce(nax, naz, w, Wx, Wz, px, pz):
    rng = np.random.default_rng(1)
    field = rng.normal(size=(naz * w, nax * w)).astype(np.float32)
    out = extract_moving_window_2d_x_z(torch.from_numpy(field), nax, naz, w,
                                       Wx, Wz, pad_x=px, pad_z=pz).numpy()
    assert out.shape == (nax * naz, Wz, Wx)
    means = np.zeros((naz, nax), np.float32)
    for iz in range(naz):
        for ix in range(nax):
            means[iz, ix] = field[iz * w:(iz + 1) * w, ix * w:(ix + 1) * w].mean()
    rolled = np.roll(means, (pz, px), axis=(0, 1))
    k = 0
    for ix in range(nax):          # x-major agent order
        for iz in range(naz):
            expect = np.empty((Wz, Wx), np.float32)
            for dz in range(Wz):
                for dx in range(Wx):
                    expect[dz, dx] = rolled[(iz + dz) % naz, (ix + dx) % nax]
            np.testing.assert_allclose(out[k], expect, rtol=0, atol=1e-6)
            k += 1


def test_moving_window_2d_x_z_refuses_bad_tilings():
    f = torch.zeros(8, 12)
    with pytest.raises(ValueError):
        extract_moving_window_2d_x_z(f, 4, 4, 2, 1, 1)
    with pytest.raises(ValueError):
        extract_moving_window_2d_x_z(f, 6, 4, 2, 1, 1, pad_x=2)
    with pytest.raises(ValueError):
        extract_moving_window_2d_x_z(f, 6, 4, 2, 3, 1, pad_z=2)
