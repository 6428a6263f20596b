"""Abstract base class of the port's environments (counterpart of
``fluidgym_tpu/envs/fluid_env.py``).

The env holds a ``DomainState`` of tensors on its ``device`` and advances it
with the PISO solver; one env step is ``_pure_step(carry, action) ->
(carry, obs, reward, info)`` over the carry of ``_pure_carry`` (a tuple led
by the ``DomainState``).  The step is composed of per-env pure pieces around
the simulation (``_compose_step``), which the single env runs directly and
``parallel.BatchedFluidEnv`` runs under ``torch.func.vmap``.  RNG: a numpy
``Generator`` for host-side decisions (the same draws as the JAX package
from the same seed) and a ``torch.Generator`` for ``sample_action``.

Environment surface: ``reset/step/seed/sample_action/get_state/set_state/
train/val/test``, Dict observation spaces, SARL/MARL dispatch, truncation at
``episode_length``, metric statistics.  Not ported yet: ``render``,
``save_gif``, ``init`` (dataset generation), ``plot_grid``, field image
dumps and the uncontrolled-episode DataFrame.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from dataclasses import dataclass, replace
from typing import Any, NamedTuple

import numpy as np
import torch

from fluidgym_tpu_torch import spaces
from fluidgym_tpu_torch.config import config as fluidgym_config
from fluidgym_tpu_torch.core.domain import (BlockGeom, DomainState, DomainTopo,
                                            domain_state_from_numpy,
                                            domain_state_to_numpy, map_state)
from fluidgym_tpu_torch.core.domain_io import load_domain
from fluidgym_tpu_torch.device import resolve_device
from fluidgym_tpu_torch.solver import piso
from fluidgym_tpu_torch.solver.piso import Hooks, SimConfig, single_step
from fluidgym_tpu_torch.types import EnvMode, FluidEnvLike
from fluidgym_tpu_torch.utils import data_utils

Tensor = torch.Tensor


class Stats(NamedTuple):
    """Statistical summary of a metric."""

    mean: float
    min: float
    max: float
    p5: float
    p25: float
    p50: float
    p75: float
    p95: float


@dataclass
class EnvState:
    """Snapshot of a FluidEnv for get_state/set_state."""

    class_name: str
    domain: DomainState
    n_steps: int
    mode: EnvMode
    additional_info: dict[str, Any]


class FluidEnv(ABC, FluidEnvLike):
    """Abstract base class for the port's environments."""

    _ndims: int
    _supports_marl: bool = False
    _metrics: list[str] = []

    def __init__(
        self,
        adaptive_cfl: float,
        dt: float,
        step_length: float,
        episode_length: int,
        ndims: int,
        use_marl: bool,
        dtype=None,
        load_initial_domain: bool = True,
        load_domain_statistics: bool = True,
        randomize_initial_state: bool = True,
        enable_actions: bool = True,
        differentiable: bool = False,
        device=None,
    ):
        super().__init__()
        if ndims not in (2, 3):
            raise ValueError("ndims must be 2 or 3.")
        if differentiable and not self._differentiable_ported():
            raise NotImplementedError(
                f"differentiable=True: the differentiable path is ported for "
                f"RBC2D-easy and CylinderJet2D-easy (at their registered size "
                f"or smaller) only, not {type(self).__name__} with these "
                f"settings yet (ROADMAP Queue 1 item 4)")
        self._device = resolve_device(device)
        self._ndims = ndims
        self._dt = float(dt)
        self._adaptive_cfl = float(adaptive_cfl)
        self._step_length = float(step_length)
        self._episode_length = int(episode_length)
        self._use_marl = bool(use_marl)
        if self._use_marl and not self._supports_marl:
            raise ValueError("This env does not support multi-agent mode.")
        self._dtype = dtype or fluidgym_config.dtype
        self._warn_solver_failure = True
        self._solver_warned = False
        self._load_domain_on_reset = bool(load_initial_domain)
        self._randomize_initial_state = bool(randomize_initial_state)
        self._enable_actions = bool(enable_actions)
        self._differentiable = bool(differentiable)

        self._seed_value: int | None = None
        self._torch_gen: torch.Generator | None = None
        self._np_rng: np.random.Generator | None = None
        self._reset_called = False
        self._n_episodes = 0
        self._n_steps = 0
        self._mode: EnvMode = EnvMode.TRAIN
        self._metrics_stats: dict[str, Stats] = {}
        self._uncontrolled_episode: list[dict] | None = None

        self._topo: DomainTopo | None = None
        self._geoms: tuple[BlockGeom, ...] | None = None
        self._state: DomainState | None = None
        self._cfg: SimConfig | None = None
        self._hooks: Hooks | None = None

        if load_initial_domain or load_domain_statistics:
            data_utils.prepare_initial_domains(self.initial_domain_id)
        if load_domain_statistics:
            self._load_domain_statistics()
        else:
            self._logger.warning(
                "Domain statistics not loaded; reward normalization uses "
                "defaults. Only use this for debugging or development.")

        self._action_space = self._get_action_space()
        self._observation_space = self._get_observation_space()
        if self._use_marl:
            action_shape = (self.n_agents, *self._action_space.shape)
        else:
            action_shape = self._action_space.shape
        self._zero_action = torch.zeros(action_shape, dtype=self._dtype,
                                        device=self._device)

    # ------------------------------------------------------------------
    # abstract hooks
    # ------------------------------------------------------------------
    @abstractmethod
    def _get_action_space(self) -> spaces.Box: ...

    @abstractmethod
    def _get_observation_space(self) -> spaces.Dict: ...

    @abstractmethod
    def _get_domain(self) -> tuple[DomainTopo, tuple[BlockGeom, ...], DomainState]: ...

    @abstractmethod
    def _get_prep_fn(self) -> Hooks: ...

    @abstractmethod
    def _get_simulation(self) -> SimConfig: ...

    def _additional_initialization(self) -> None:
        pass

    def _differentiable_ported(self) -> bool:
        """Whether this configuration takes ``differentiable=True``: one that
        was held in diff mode against the JAX package and run on the card
        (ROADMAP Queue 1 item 4 lists the rest)."""
        return False

    @abstractmethod
    def _apply_action(self, action: Tensor) -> None: ...

    @abstractmethod
    def _get_global_obs(self) -> dict[str, Tensor]: ...

    def _get_local_obs(self) -> dict[str, Tensor]:
        raise NotImplementedError

    @abstractmethod
    def _randomize_domain(self) -> None: ...

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def _logger(self) -> logging.Logger:
        return logging.getLogger(self.__class__.__name__)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def action_space(self) -> spaces.Box:
        return self._action_space

    @property
    def observation_space(self) -> spaces.Dict:
        return self._observation_space

    @property
    def use_marl(self) -> bool:
        return self._use_marl

    @property
    @abstractmethod
    def n_agents(self) -> int: ...

    @property
    def step_length(self) -> float:
        return self._step_length

    @property
    def episode_length(self) -> int:
        return self._episode_length

    @property
    def dt(self) -> float:
        return self._dt

    @property
    def ndims(self) -> int:
        return self._ndims

    @property
    def metrics(self) -> list[str]:
        return self._metrics

    @property
    def time_passed(self) -> float:
        return self._n_steps * self._step_length

    @property
    def _n_sim_steps(self) -> int:
        """Simulation steps per env step."""
        return max(1, int(self._step_length / self._dt))

    @property
    def n_sim_steps(self) -> int:
        return self._n_sim_steps

    @property
    def mode(self) -> EnvMode:
        return self._mode

    @mode.setter
    def mode(self, mode: EnvMode) -> None:
        if mode not in (EnvMode.TRAIN, EnvMode.VAL, EnvMode.TEST):
            raise ValueError("mode must be 'train', 'val', or 'test'.")
        self._mode = mode

    @property
    def differentiable(self) -> bool:
        return self._differentiable

    @property
    @abstractmethod
    def id(self) -> str: ...

    @property
    @abstractmethod
    def initial_domain_id(self) -> str: ...

    @property
    def unwrapped(self) -> "FluidEnv":
        return self

    def train(self) -> None:
        self.mode = EnvMode.TRAIN

    def val(self) -> None:
        self.mode = EnvMode.VAL

    def test(self) -> None:
        self.mode = EnvMode.TEST

    # ------------------------------------------------------------------
    # RNG
    # ------------------------------------------------------------------
    def seed(self, seed: int) -> None:
        """Seed the env RNGs."""
        if seed is None:
            raise ValueError("Seed cannot be None.")
        self._seed_value = int(seed)
        self._torch_gen = torch.Generator().manual_seed(int(seed))
        self._np_rng = np.random.default_rng(int(seed))

    def sample_action(self) -> Tensor:
        """Uniform random action from the action space."""
        if self._seed_value is None:
            raise RuntimeError("Environment must be seeded before sampling actions.")
        low = torch.as_tensor(self._action_space.low, dtype=self._dtype)
        high = torch.as_tensor(self._action_space.high, dtype=self._dtype)
        r = torch.rand(self._zero_action.shape, generator=self._torch_gen,
                       dtype=self._dtype)
        return (low + (high - low) * r).to(self._device)

    # ------------------------------------------------------------------
    # sim plumbing
    # ------------------------------------------------------------------
    def _run_single_step(self) -> None:
        self._state = single_step(self._state, self._geoms, self._topo,
                                  self._cfg, self._hooks)

    # ------------------------------------------------------------------
    # pure-step protocol (counterpart of the JAX package's ``_pure_step`` /
    # ``_pure_carry``): an env step is
    #   carry = _pure_begin(carry, action)
    #   n_sim_steps times: carry = _pure_pre_sim(carry, action);
    #                      advance carry[0] one sim step;
    #                      record = _pure_record(carry)
    #   obs, reward, info = _pure_end(carry, records)   (MARL: _pure_end_marl)
    # Each piece is per env and pure, so the batched env runs the same
    # pieces under torch.func.vmap; only the sim step differs.
    # ------------------------------------------------------------------
    def _pure_carry(self) -> tuple:
        """What the pure step threads through: ``(DomainState, *extra)``."""
        return (self._state,)

    def _set_pure_carry(self, carry: tuple) -> None:
        self._state = carry[0]

    def _pure_begin(self, carry: tuple, action: Tensor) -> tuple:
        return carry

    def _pure_pre_sim(self, carry: tuple, action: Tensor) -> tuple:
        return carry

    def _pure_record(self, carry: tuple) -> tuple:
        return ()

    def _pure_end(self, carry: tuple, records: list):
        """``(obs, reward, info)`` after the sim steps."""
        raise NotImplementedError

    def _pure_end_marl(self, carry: tuple, records: list):
        raise NotImplementedError

    def _compose_step(self, carry: tuple, action: Tensor, *, marl: bool = False,
                      lift=None, sim=None):
        """One env step from the pieces.  ``lift(piece)`` wraps each piece
        (identity for one env; a ``torch.func.vmap`` for a batch) and
        ``sim(state) -> (state, StepInfo)`` advances one sim step
        (``piso.single_step_info`` by default).  Returns ``(carry, obs,
        reward, info)``, with the solver entries merged into ``info``."""
        lift = lift or (lambda piece: piece)
        if sim is None:
            def sim(state):
                return piso.single_step_info(state, self._geoms, self._topo,
                                             self._cfg, self._hooks)
        carry = lift(self._pure_begin)(carry, action)
        records, infos = [], []
        for _ in range(self._n_sim_steps):
            carry = lift(self._pure_pre_sim)(carry, action)
            state, si = sim(carry[0])
            carry = (state,) + tuple(carry[1:])
            records.append(lift(self._pure_record)(carry))
            infos.append(si)
        end = self._pure_end_marl if marl else self._pure_end
        obs, reward, info = lift(end)(carry, records)
        info = dict(info)
        info.update(piso.solver_info_dict(piso.combine_infos(infos)))
        return carry, obs, reward, info

    def _pure_step(self, carry: tuple, action: Tensor):
        """Env step: ``(carry, action) -> (carry, obs, reward, info)``."""
        return self._compose_step(carry, action)

    def _pure_step_marl(self, carry: tuple, actions: Tensor):
        return self._compose_step(carry, actions, marl=True)

    def _step_impl(self, action: Tensor):
        carry, obs, reward, info = self._pure_step(self._pure_carry(), action)
        self._set_pure_carry(carry)
        return obs, reward, False, info

    def _step_marl_impl(self, actions: Tensor):
        carry, obs, rewards, info = self._pure_step_marl(self._pure_carry(),
                                                         actions)
        self._set_pure_carry(carry)
        return obs, rewards, False, info

    # ------------------------------------------------------------------
    # initial state
    # ------------------------------------------------------------------
    def _available_domain_indices(self, mode: EnvMode) -> list[int]:
        root = data_utils.initial_domain_dir(self.initial_domain_id)
        out = []
        for p in sorted(root.glob(f"{mode.value}_*.json")):
            stem = p.stem.rsplit("_", 1)[-1]
            if stem.isdigit() and p.with_suffix(".npz").exists():
                out.append(int(stem))
        return out

    def _load_initial_domain(self, mode: EnvMode, idx: int):
        path = (data_utils.initial_domain_dir(self.initial_domain_id)
                / f"{mode.value}_{idx:02d}")
        return load_domain(path, dtype=self._dtype, device=self._device)

    def load_initial_domain(self, mode: EnvMode, idx: int) -> None:
        """Load one bundled initial domain snapshot as the current state,
        with no randomization; the episode restarts."""
        self._topo, self._geoms, self._state = self._load_initial_domain(
            EnvMode(mode), idx)
        self._hooks = self._get_prep_fn()
        self._cfg = self._get_simulation()
        self._additional_initialization()
        self._ensure_agg_coarse()
        self._reset_called = True
        self._n_steps = 0

    def _set_initial_state(self, randomize: bool | None = None) -> None:
        """(Re)build topo/geoms/state (+ sim config) for a new episode."""
        if randomize is None:
            randomize = self._randomize_initial_state
        if self._load_domain_on_reset:
            try:
                avail = self._available_domain_indices(self.mode)
                if not avail:
                    raise FileNotFoundError(
                        f"no initial domains for {self.initial_domain_id}")
                idx = (int(avail[self._np_rng.integers(0, len(avail))])
                       if randomize else avail[0])
                self._topo, self._geoms, self._state = self._load_initial_domain(
                    self.mode, idx)
                try:
                    self._uncontrolled_episode = data_utils.load_uncontrolled_episode(
                        self.initial_domain_id, self.mode.value, idx)
                except FileNotFoundError:
                    self._uncontrolled_episode = None
            except FileNotFoundError as err:
                raise RuntimeError(
                    "Initial domain not found. Construct the env with "
                    "load_initial_domain=False.") from err
        else:
            self._topo, self._geoms, self._state = self._get_domain()
        self._hooks = self._get_prep_fn()
        self._cfg = self._get_simulation()
        self._additional_initialization()
        self._ensure_agg_coarse()
        if randomize:
            self._randomize_domain()

    def _ensure_agg_coarse(self) -> None:
        """The aggregation coarse space of the pressure solve, where the
        config asks for one (``pressure_coarse_tile``): built from the
        state (after ``_additional_initialization``, before any
        randomization, as the JAX package builds its cache entry), kept on
        the env and reused while the operator's key and viscosity hold
        (``piso.ensure_agg_coarse``), and handed to the solver on the
        config (``SimConfig.pressure_agg``).  Deliberate difference: the
        JAX package keeps it in a process-global FIFO cache and does not
        build it in ``load_initial_domain``."""
        self._agg_coarse = piso.ensure_agg_coarse(
            getattr(self, "_agg_coarse", None), self._state, self._geoms,
            self._topo, self._cfg)
        if self._agg_coarse is not None:
            self._cfg = replace(self._cfg, pressure_agg=self._agg_coarse)

    # ------------------------------------------------------------------
    # core loop
    # ------------------------------------------------------------------
    def reset(self, seed: int | None = None, randomize: bool | None = None):
        """Reset to an initial state."""
        if seed is None:
            if self._seed_value is None:
                raise ValueError(
                    "Seed must be provided either during reset or by calling seed().")
        else:
            self.seed(seed)
        self._set_initial_state(randomize=randomize)
        self._reset_called = True
        self._n_steps = 0
        self._n_episodes += 1
        self._solver_warned = False
        self._apply_action(self._zero_action)
        obs = self._get_local_obs() if self._use_marl else self._get_global_obs()
        return obs, {}

    def step(self, action):
        """One env step."""
        if not self._reset_called:
            raise RuntimeError(
                "Environment must be reset before stepping. Call 'reset()' "
                "before 'step()'.")
        action = torch.as_tensor(action, dtype=self._dtype, device=self._device)
        if action.shape != self._zero_action.shape:
            raise ValueError(
                f"Action shape {tuple(action.shape)} does not match expected "
                f"shape {tuple(self._zero_action.shape)}.")
        if self._n_steps >= self._episode_length:
            raise RuntimeError("Episode has already terminated. Call 'reset()' first.")
        if self._use_marl:
            obs, reward, terminated, info = self._step_marl_impl(action)
        else:
            obs, reward, terminated, info = self._step_impl(action)
        self._n_steps += 1
        truncated = self._n_steps >= self._episode_length
        info = {k: v.detach() if torch.is_tensor(v) else v
                for k, v in info.items()}
        self._check_solver_health(info)
        return obs, reward, terminated, truncated, info

    def _check_solver_health(self, info: dict) -> None:
        """Warn once per episode on a non-converged pressure solve; raise on
        a non-finite residual (the state has diverged)."""
        if not self._warn_solver_failure or "pressure_converged" not in info:
            return
        if not bool(info["pressure_converged"].all()):
            if not self._solver_warned:
                self._solver_warned = True
                self._logger.warning(
                    "Pressure solve did not converge at env step %d "
                    "(max residual %.3e over the step's solves); the "
                    "best-so-far iterate was used. See info['pressure_*'].",
                    self._n_steps, float(info["pressure_residual"].max()))
        if not bool(torch.isfinite(info["pressure_residual"]).all()):
            raise FloatingPointError(
                f"Pressure solve produced a non-finite residual at env step "
                f"{self._n_steps}: the simulation state has diverged. Reduce "
                f"dt / check boundary conditions, or reset the environment.")

    def detach(self) -> None:
        """Sever gradient flow between horizons (the JAX package's
        ``stop_gradient`` of the state): every tensor the step carries (the
        state and, where the env has one, its smoothed control) leaves the
        graph.  With ``differentiable=True`` a step's obs and reward carry
        the graph back to its action and to the state since the last
        ``detach`` (or reset); its ``info`` is detached."""
        self._set_pure_carry(tuple(
            map_state(c, torch.Tensor.detach) if isinstance(c, DomainState)
            else c.detach() for c in self._pure_carry()))

    # ------------------------------------------------------------------
    # state management
    # ------------------------------------------------------------------
    def get_state(self) -> EnvState:
        """Snapshot env state (the solver never writes into state tensors,
        so the snapshot shares them safely)."""
        return EnvState(class_name=self.__class__.__name__, domain=self._state,
                        n_steps=self._n_steps, mode=self._mode,
                        additional_info=self._get_additional_state_info())

    def set_state(self, state: EnvState) -> None:
        """Restore a snapshot; its tensors move to the env's device."""
        if state.class_name != self.__class__.__name__:
            raise ValueError(
                f"EnvState is for {state.class_name}, not {self.__class__.__name__}")
        if self._topo is None:
            if self._np_rng is None:
                self.seed(0)
            self._set_initial_state(randomize=False)
        self._state = _to_device(state.domain, self._device, self._dtype)
        self._n_steps = state.n_steps
        self._mode = state.mode
        self._set_additional_state_info(state.additional_info)
        self._reset_called = True

    def _get_additional_state_info(self) -> dict[str, Any]:
        """Env-specific state beyond the domain (e.g. a smoothed control)."""
        return {}

    def _set_additional_state_info(self, info: dict[str, Any]) -> None:
        pass

    # ------------------------------------------------------------------
    # statistics
    # ------------------------------------------------------------------
    def _load_domain_statistics(self) -> None:
        try:
            raw = data_utils.load_statistics(self.initial_domain_id)
            self._metrics_stats = {k: Stats(**v) for k, v in raw.items()}
        except FileNotFoundError:
            self._logger.warning(
                "Domain statistics not found for %s; metrics will use defaults.",
                self.initial_domain_id)
            self._metrics_stats = {}


def env_state_from_numpy(tree, device=None, dtype=None) -> EnvState:
    """Build a port ``EnvState`` from any object with the JAX ``EnvState``
    field names and array-like leaves (e.g. a JAX env's ``get_state()``):
    the domain through ``domain_state_from_numpy``, array entries of
    ``additional_info`` (such as ``last_control``) as tensors.  ``device``
    defaults to the CPU; ``set_state`` moves the state to the env's
    device."""
    device = torch.device("cpu" if device is None else device)
    dtype = dtype or fluidgym_config.dtype
    info = {k: (torch.as_tensor(np.array(v, copy=True), device=device).to(dtype)
                if hasattr(v, "shape") else v)
            for k, v in tree.additional_info.items()}
    return EnvState(class_name=tree.class_name,
                    domain=domain_state_from_numpy(tree.domain, device, dtype),
                    n_steps=int(tree.n_steps), mode=EnvMode(tree.mode.value),
                    additional_info=info)


def env_state_to_numpy(state: EnvState) -> EnvState:
    """The inverse of ``env_state_from_numpy``: the same structure with
    numpy leaves (host copies)."""
    info = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in state.additional_info.items()}
    return EnvState(class_name=state.class_name,
                    domain=domain_state_to_numpy(state.domain),
                    n_steps=state.n_steps, mode=state.mode, additional_info=info)


def _to_device(state: DomainState, device, dtype) -> DomainState:
    return map_state(state, lambda t: t.to(device=device, dtype=dtype))
