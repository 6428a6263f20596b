"""The port imports and runs with only the packages the card's machine has.

That machine has PyTorch, numpy and the CUDA toolkit but no ``jax``,
``gymnasium``, ``pettingzoo``, ``stable_baselines3``, ``torchrl``,
``tensordict``, ``matplotlib``, ``pandas``, ``PIL`` or ``huggingface_hub``;
a development host with the JAX package's dependencies has most of them, so
a stray import would pass every other CPU test and die on the card.  A
subprocess installs a ``sys.meta_path`` finder that refuses those packages
(and the JAX package itself), then imports the port and ``chip_smoke`` and
drives ``make`` / ``reset`` / ``step`` on the CPU.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = textwrap.dedent("""
    import sys

    REFUSED = ("jax", "jaxlib", "fluidgym_tpu", "gymnasium", "pettingzoo",
               "stable_baselines3", "torchrl", "tensordict", "matplotlib",
               "pandas", "PIL", "huggingface_hub")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"{name} is not on the card's machine")
            return None

    sys.meta_path.insert(0, Refuse())
    assert not [m for m in sys.modules if m.split(".")[0] in REFUSED]
""")


def _run(body: str) -> subprocess.CompletedProcess:
    code = BLOCKER + textwrap.dedent(body)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_blocker_refuses():
    out = _run("""
        try:
            import gymnasium
        except ImportError as err:
            print("refused:", err)
    """)
    assert out.returncode == 0, out.stderr
    assert "refused" in out.stdout


def test_port_and_chip_smoke_import_and_step_without_card_packages():
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import fluidgym_tpu_torch
        import chip_smoke  # noqa: F401  (main() not run)
        from fluidgym_tpu_torch.ops import cg_cuda, cg_cuda_mb  # noqa: F401
        from fluidgym_tpu_torch.ops import stencil_cuda  # noqa: F401
        from fluidgym_tpu_torch.solver import coarse_strips  # noqa: F401
        env = fluidgym_tpu_torch.make(
            "RBC2D-easy-v0", device="cpu", resolution=4, n_heaters=4,
            load_initial_domain=False, load_domain_statistics=False,
            randomize_initial_state=False, episode_length=3, step_length=0.1,
            dt=0.05, local_obs_window=3)
        obs, _ = env.reset(seed=0)
        obs, reward, *_ , info = env.step(np.zeros((4, 1), np.float32))
        assert all(bool(torch.isfinite(v).all()) for v in obs.values())
        assert np.isfinite(float(info["nusselt"]))
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_cylinder_imports_and_steps_without_card_packages():
    """The second registered id: the multi-block cylinder (scipy's KD-tree
    for the sensor plan is on the card's machine and is imported inside the
    function that needs it)."""
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import fluidgym_tpu_torch
        env = fluidgym_tpu_torch.make(
            "CylinderJet2D-easy-v0", device="cpu", resolution=8,
            load_initial_domain=False, load_domain_statistics=False,
            randomize_initial_state=False, step_length=0.01, dt=0.01)
        obs, _ = env.reset(seed=0)
        obs, reward, *_ , info = env.step(np.full((1,), 0.5, np.float32))
        assert obs["velocity"].shape == (151, 2)
        assert all(bool(torch.isfinite(v).all()) for v in obs.values())
        assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_cylinder3d_imports_and_steps_without_card_packages():
    """CylinderJet3D (slice 10) at resolution 8: the 3D merged plan, the
    per-z-slice forces and the z-stacked sensor plan need none of the
    refused packages."""
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import fluidgym_tpu_torch
        env = fluidgym_tpu_torch.make(
            "CylinderJet3D-easy-v0", device="cpu", resolution=8, n_jets=4,
            load_initial_domain=False, load_domain_statistics=False,
            randomize_initial_state=False, step_length=0.01, dt=0.01)
        obs, _ = env.reset(seed=0)
        obs, reward, *_ , info = env.step(np.full((4, 1), 0.5, np.float32))
        assert obs["velocity"].shape == (4, 2, 3, 151)
        assert all(bool(torch.isfinite(v).all()) for v in obs.values())
        assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_airfoil_imports_and_steps_without_card_packages():
    """The third registered id: the airfoil C-grid, whose mask is the port's
    own point-in-polygon test (matplotlib is refused here), stepped from
    the bundled snapshot through the flip-seam plan's plain solvers."""
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import fluidgym_tpu_torch
        env = fluidgym_tpu_torch.make(
            "Airfoil2D-easy-v0", device="cpu", randomize_initial_state=False,
            step_length=0.05, dt=0.05)
        obs, _ = env.reset(seed=0)
        obs, reward, *_ , info = env.step(np.array([1.0, -0.5, -0.5], np.float32))
        assert obs["velocity"].shape == (209, 2)
        assert all(bool(torch.isfinite(v).all()) for v in obs.values())
        assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_airfoil3d_imports_and_steps_without_card_packages():
    """Airfoil3D-easy (slice 16): the 3D C-grid's flip-seam plan, its 2D
    warm start from the bundled ``airfoil_2D_Re1000/train_00`` (seed 23)
    and the per-slice forces, on a span of 2 cells, stepped once with
    nothing of the refused packages."""
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import fluidgym_tpu_torch
        from fluidgym_tpu_torch.envs.airfoil.airfoil_env_3d import AirfoilEnv3D
        AirfoilEnv3D._res_z = 2
        env = fluidgym_tpu_torch.make(
            "Airfoil3D-easy-v0", device="cpu", n_agents=1,
            load_initial_domain=False, load_domain_statistics=False,
            randomize_initial_state=False, step_length=0.002, dt=0.002)
        obs, _ = env.reset(seed=23)
        obs, reward, *_ , info = env.step(np.array([[1.0, -0.5, -0.5]], np.float32))
        assert obs["velocity"].shape == (1, 1, 3, 209)
        assert all(bool(torch.isfinite(v).all()) for v in obs.values())
        assert info["all_cds"].shape == (2,)
        assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_batched_env_imports_and_steps_without_card_packages():
    """Slice 5: ``parallel.BatchedFluidEnv`` (torch.func.vmap over the env's
    pieces, the lane-folding solves) needs none of the refused packages."""
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from fluidgym_tpu_torch.parallel import BatchedFluidEnv
        benv = BatchedFluidEnv(
            "RBC2D-easy-v0", 2, device="cpu", resolution=4, n_heaters=4,
            load_initial_domain=False, load_domain_statistics=False,
            randomize_initial_state=False, episode_length=3, step_length=0.1,
            dt=0.05, local_obs_window=3)
        obs, _ = benv.reset(seed=0)
        obs, rew, term, trunc, info = benv.step(np.zeros((2, 4, 1), np.float32))
        assert rew.shape == (2,) and bool(torch.isfinite(rew).all())
        assert all(bool(torch.isfinite(v).all()) for v in obs.values())
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_make_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; make() then runs on it")
    out = _run("""
        import fluidgym_tpu_torch
        try:
            fluidgym_tpu_torch.make("RBC2D-easy-v0", resolution=4, n_heaters=4,
                                    load_initial_domain=False,
                                    load_domain_statistics=False)
        except RuntimeError as err:
            print("raised:", err)
        else:
            print("ran on the CPU")
    """)
    assert out.returncode == 0, out.stderr
    assert "raised:" in out.stdout and 'device="cpu"' in out.stdout


def test_chip_smoke_refuses_without_card(tmp_path):
    """Without a card, or alone in a directory, chip_smoke exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _run("""
        import runpy
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_cylinder_rot2d_imports_and_steps_without_card_packages():
    """CylinderRot2D (slice 13) at Re 500 (the upwind blend) and resolution
    8 needs none of the refused packages."""
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import fluidgym_tpu_torch
        env = fluidgym_tpu_torch.make(
            "CylinderRot2D-hard-v0", device="cpu", resolution=8,
            load_initial_domain=False, load_domain_statistics=False,
            randomize_initial_state=False, step_length=0.01, dt=0.01)
        obs, _ = env.reset(seed=0)
        assert env._cfg.advection_upwind_blend == 0.3
        obs, reward, *_ , info = env.step(np.full((1,), 0.5, np.float32))
        assert obs["velocity"].shape == (151, 2)
        assert all(bool(torch.isfinite(v).all()) for v in obs.values())
        assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_airfoil_medium_imports_and_steps_without_card_packages():
    """Airfoil2D-medium (the blend and the aggregation coarse space, built
    at reset) needs none of the refused packages; a short sim step."""
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import fluidgym_tpu_torch
        env = fluidgym_tpu_torch.make(
            "Airfoil2D-medium-v0", device="cpu", randomize_initial_state=False,
            step_length=0.01, dt=0.01)
        obs, _ = env.reset(seed=0)
        assert env._cfg.pressure_agg.space.K == 1194
        obs, reward, *_ , info = env.step(np.array([1.0, -0.5, -0.5], np.float32))
        assert obs["velocity"].shape == (209, 2)
        assert all(bool(torch.isfinite(v).all()) for v in obs.values())
        assert np.isfinite(float(info["drag"])) and np.isfinite(float(reward))
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_tcf_imports_and_steps_without_card_packages():
    """TCFSmall3D-both (slice 15) at a tiny size: the channel grid, the curl
    noise, the forcing hook and the mean windows need none of the refused
    packages."""
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import fluidgym_tpu_torch
        env = fluidgym_tpu_torch.make(
            "TCFSmall3D-both-easy-v0", device="cpu", resolution_y=9,
            resolution_x_z=8, actor_size=2, load_initial_domain=False,
            load_domain_statistics=False, randomize_initial_state=False)
        obs, _ = env.reset(seed=0)
        obs, reward, *_ , info = env.step(np.full((32, 1), 0.5, np.float32))
        assert obs["velocity"].shape == (32, 1, 1, 2)
        assert all(bool(torch.isfinite(v).all()) for v in obs.values())
        assert np.isfinite(float(info["wall_stress"])) and reward.shape == (32,)
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_rl_surface_imports_and_steps_without_card_packages():
    """The wrappers, the adapters (on their ``object`` bases, with the
    port's own spaces), field output and logging import with every optional
    package refused; phase 54's stack (``VecFluidEnv(FlattenObservation(
    make(..., use_marl=True)))``) steps once, phase 55's
    (``GymFluidEnv(ActionNoise(SensorNoise(ObsExtraction(...))))``) resets
    and steps once, the render fields are computed, and the colormap step
    and the gates raise ``ImportError`` naming their package."""
    out = _run("""
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import fluidgym_tpu_torch
        from fluidgym_tpu_torch import spaces
        import fluidgym_tpu_torch.wrappers as W
        import fluidgym_tpu_torch.integration as I
        import fluidgym_tpu_torch.integration.sb3 as S
        from fluidgym_tpu_torch.integration import pettingzoo as P
        from fluidgym_tpu_torch.integration import torchrl as T
        from fluidgym_tpu_torch.utils import field_io, helpers, logging  # noqa: F401
        from fluidgym_tpu_torch.envs.util import visualization  # noqa: F401
        assert I.GymFluidEnv.__mro__[1] is object
        assert P.PettingZooFluidEnv.__mro__[1] is object
        assert S.VecFluidEnv.__mro__[1] is object
        kw = dict(device="cpu", resolution=4, n_heaters=4,
                  load_initial_domain=False, load_domain_statistics=False,
                  randomize_initial_state=False, episode_length=3,
                  step_length=0.1, dt=0.05, local_obs_window=3)
        venv = S.VecFluidEnv(W.FlattenObservation(
            fluidgym_tpu_torch.make("RBC2D-easy-v0", use_marl=True, **kw)))
        assert isinstance(venv.observation_space, spaces.Box)
        obs = venv.reset(seed=0)
        obs, rew, dones, infos = venv.step(np.zeros((4, 1), np.float32))
        assert isinstance(obs, np.ndarray) and obs.shape == (4, 288)
        assert np.isfinite(rew).all() and rew.shape == (4,)
        env = fluidgym_tpu_torch.make("RBC2D-easy-v0", **kw)
        g = I.GymFluidEnv(W.ActionNoise(W.SensorNoise(
            W.ObsExtraction(env, keys=["temperature"]), 0.05, 1), 0.1, 2))
        assert isinstance(g.action_space, spaces.Box)
        o, _ = g.reset(seed=0)
        o, r, te, tr, info = g.step(np.zeros((4, 1), np.float32))
        assert list(o) == ["temperature"] and isinstance(r, float)
        fields = env.render_fields()
        assert tuple(fields["temperature"].shape) == (25, 80)
        for call, name in ((env.render, "matplotlib"),
                           (lambda: T.TorchRLFluidEnv(env), "torchrl"),
                           (lambda: S.EvalCallback(venv, venv, 1, 1),
                            "stable-baselines3")):
            try:
                call()
            except ImportError as err:
                assert name in str(err), err
            else:
                raise AssertionError(f"no ImportError for {name}")
        bad = [m for m in sys.modules
               if m.split(".")[0] in REFUSED and m != "fluidgym_tpu_torch"
               and not m.startswith("fluidgym_tpu_torch.")]
        assert not bad, bad
        print("OK")
    """)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout
