"""Batched environments: ``n_envs`` copies of one env config stepped as one
batch (counterpart of ``fluidgym_tpu/parallel/batched_env.py``).

The batch is a leading axis on every tensor of the env's pure-step carry.
One batched step runs the env's own pure pieces (``FluidEnv._compose_step``)
under ``torch.func.vmap`` and advances the simulation with
``piso.batched_step_info``, whose substep is vmapped too: every Krylov solve
folds the batch onto its kernel's lanes (``ops.cg_cuda.LaneFold``), so one
solve of the whole batch is one launch, its lockstep chunks side by side on
the card's SMs.  The physics is the single env's, line for line; a lane
solves as its env alone would (up to the rounding of batched products).

API of the JAX package's class: ``reset(seed | seeds)``, ``step(actions)``,
``seed``, ``train``/``val``/``test``, ``load_initial_domain``, ``close``;
observations are stacked over envs (SARL) or concatenated over agents
(MARL); the late-divergence guard, the divergence penalty and the
auto-reset splice.  ``step`` returns torch tensors on the env's device.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from fluidgym_tpu_torch.core.domain import (DomainState, state_from_leaves,
                                            state_leaves)
from fluidgym_tpu_torch.registry import make
from fluidgym_tpu_torch.solver import piso
from fluidgym_tpu_torch.types import EnvMode

Tensor = torch.Tensor

__all__ = ["BatchedFluidEnv"]

_STATE = "__domain_state__"


def _pack(tree):
    """``tree`` with every ``DomainState`` replaced by ``{_STATE: leaves}``
    (tuples, lists and dicts walked), so ``torch.func.vmap`` sees tensors
    only."""
    if isinstance(tree, DomainState):
        return {_STATE: state_leaves(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_pack(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    return tree


def _unpack(tree, like: DomainState):
    """The inverse of ``_pack``; states take ``like``'s structure."""
    if isinstance(tree, dict):
        if _STATE in tree:
            return state_from_leaves(like, tree[_STATE])
        return {k: _unpack(v, like) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unpack(t, like) for t in tree)
    return tree


def _tree_map(fn, *trees):
    """``fn`` over the tensors of packed trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _stack(items):
    return _tree_map(lambda *ts: torch.stack(ts), *[_pack(i) for i in items])


class BatchedFluidEnv:
    """``n_envs`` copies of one env config, stepped as one batch.

    Parameters
    ----------
    env_id : registered environment id.
    n_envs : number of batched environments.
    mesh : not ported (``NotImplementedError``); sharding a batch over
        several cards is ROADMAP Queue 1 item 11.
    auto_reset : reset finished envs in place (gymnasium vector semantics):
        a terminated (diverged) or truncated slot gets a fresh initial
        state, its step returns the new episode's first observation, and the
        finished episode's last one is in ``info["final_observation"]``.
    lockstep_chunk : envs per lockstep group, ``"auto"`` (default) or None.
        A lockstep round lasts as long as its slowest lane's substep, and the
        adaptive loop runs rounds until its slowest lane has finished its
        step; groups of ``c`` envs step one after another, each waiting only
        for its own slowest lane.  ``"auto"`` takes the largest divisor of
        ``n_envs`` that is <= 128 when ``n_envs > 128``, else one group.
        Must divide ``n_envs``; per-env physics is unchanged.
    divergence_reward : reward of a diverged (terminated) lane's last step,
        in place of the solver's NaN; clearly worse than any legitimate
        return (see the JAX package's class for why not 0).
    env_kwargs : forwarded to ``make`` (``device`` among them; the default
        is the CUDA card).
    """

    _AUTO_CHUNK = 128

    def __init__(self, env_id: str, n_envs: int, mesh: Any = None,
                 auto_reset: bool = True,
                 lockstep_chunk: int | str | None = "auto",
                 divergence_reward: float = -100.0, **env_kwargs: Any):
        if mesh is not None:
            raise NotImplementedError(
                "mesh sharding of the batch is not ported to "
                "fluidgym_tpu_torch yet (ROADMAP Queue 1 item 11)")
        self.divergence_reward = float(divergence_reward)
        self.env_id = env_id
        self.n_envs = int(n_envs)
        self.mesh = None
        self.auto_reset = bool(auto_reset)
        if lockstep_chunk == "auto":
            lockstep_chunk = None
            if self.n_envs > self._AUTO_CHUNK:
                c = self._AUTO_CHUNK
                while c > 1 and self.n_envs % c:
                    c -= 1
                lockstep_chunk = c if c > 1 else None
        self.lockstep_chunk = (None if lockstep_chunk is None
                               else int(lockstep_chunk))
        if self.lockstep_chunk is not None and (
                self.lockstep_chunk <= 0 or self.n_envs % self.lockstep_chunk):
            raise ValueError(f"lockstep_chunk={lockstep_chunk} must be a "
                             f"positive divisor of n_envs={n_envs}")
        # the prototype env supplies spaces, config, geometry and the pieces
        self.env = make(env_id, **env_kwargs)
        self._bcarry: tuple | None = None
        self._step_counts = np.zeros(self.n_envs, np.int64)

    # ------------------------------------------------------------------
    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def use_marl(self) -> bool:
        return self.env.use_marl

    @property
    def n_agents(self) -> int:
        return self.env.n_agents

    @property
    def device(self) -> torch.device:
        return self.env.device

    def train(self) -> None:
        self.env.train()

    def val(self) -> None:
        self.env.val()

    def test(self) -> None:
        self.env.test()

    def seed(self, seed: int) -> None:
        self._seed = int(seed)
        self.env.seed(seed)

    def close(self) -> None:
        self._bcarry = None

    # ------------------------------------------------------------------
    def reset(self, seed: int | Sequence[int] | None = None,
              randomize: bool | None = None):
        """Reset every env: a host loop over single-env resets (seeds
        ``seed + i``, or one per env), stacked into the batch."""
        if isinstance(seed, (int, np.integer)) or seed is None:
            base = getattr(self, "_seed", 0) if seed is None else int(seed)
            seeds = [base + i for i in range(self.n_envs)]
        else:
            seeds = [int(s) for s in seed]
            if len(seeds) != self.n_envs:
                raise ValueError("need one seed per env")
        carries, obs_list = [], []
        for s in seeds:
            obs, _ = self.env.reset(seed=s, randomize=randomize)
            carries.append(self.env._pure_carry())
            obs_list.append(obs)
        self._bcarry = _stack(carries)
        self._step_counts = np.zeros(self.n_envs, np.int64)
        return self._aggregate_obs(obs_list), {}

    def load_initial_domain(self, mode: EnvMode, idx: int) -> None:
        """Load one bundled initial domain into every batch slot."""
        self.env.load_initial_domain(mode, idx)
        self._bcarry = _stack([self.env._pure_carry()] * self.n_envs)
        self._step_counts = np.zeros(self.n_envs, np.int64)

    def _aggregate_obs(self, obs_list):
        """Stack over envs (SARL) / concatenate over agents (MARL)."""
        join = torch.cat if self.use_marl else torch.stack
        return {k: join([o[k] for o in obs_list]) for k in obs_list[0]}

    # ------------------------------------------------------------------
    def _group_step(self, bcarry, actions: Tensor):
        """The env's pure step over one lockstep group: its pieces under
        ``torch.func.vmap``, the sim steps by ``piso.batched_step_info``."""
        env = self.env
        like = state_from_leaves(env._state, bcarry[0][_STATE])

        def lift(piece):
            def inner(*args):
                return _pack(piece(*(_unpack(a, like) for a in args)))

            vpiece = torch.func.vmap(inner)

            def call(*args):
                with piso.strict_vmap():
                    return _unpack(vpiece(*(_pack(a) for a in args)), like)

            return call

        def sim(state):
            return piso.batched_step_info(state, env._geoms, env._topo,
                                          env._cfg, env._hooks)

        carry = _unpack(bcarry, like)
        carry, obs, reward, info = env._compose_step(
            carry, actions, marl=self.use_marl, lift=lift, sim=sim)
        return _pack(carry), obs, reward, info

    def step(self, actions):
        """Step all envs with stacked actions ``(n_envs, *action_shape)``
        (SARL) or ``(n_envs * n_agents, *action_shape)`` (MARL).  Returns
        ``(obs, rewards, terminated, truncated, info)`` as tensors on the
        env's device."""
        if self._bcarry is None:
            raise RuntimeError("BatchedFluidEnv must be reset before stepping.")
        env = self.env
        actions = torch.as_tensor(actions, dtype=env._dtype, device=env.device)
        shape = tuple(env.action_space.shape)
        if self.use_marl:
            actions = actions.reshape((self.n_envs, self.n_agents) + shape)
        if tuple(actions.shape[1:]) != tuple(env._zero_action.shape):
            raise ValueError(f"actions {tuple(actions.shape)} do not match "
                             f"{self.n_envs} x {tuple(env._zero_action.shape)}")
        c = self.lockstep_chunk or self.n_envs
        outs = []
        for g in range(0, self.n_envs, c):
            group = _tree_map(lambda t: t[g:g + c], self._bcarry)
            outs.append(self._group_step(group, actions[g:g + c]))
        if len(outs) == 1:
            self._bcarry, obs, rewards, info = outs[0]
        else:
            self._bcarry, obs, rewards, info = _tree_map(
                lambda *ts: torch.cat(ts), *outs)
        if self.use_marl:
            obs = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                   for k, v in obs.items()}
            rewards = rewards.reshape(-1)
        elif rewards.dim() == 2 and rewards.shape[1] == 1:
            rewards = rewards[:, 0]

        self._step_counts += 1
        truncated = self._step_counts >= env.episode_length
        terminated = self._per_env_terminated(info)
        # late-divergence guard: a blowing-up lane can emit non-finite
        # rewards or observations one step before its pressure residual
        # flags; any such lane terminates now
        na = self.n_agents if self.use_marl else 1
        bad = ~torch.isfinite(rewards.reshape(self.n_envs, -1)).all(dim=1)
        for v in obs.values():
            bad |= ~torch.isfinite(v.reshape(self.n_envs, na, -1)).all(dim=2).all(dim=1)
        terminated = terminated | bad.cpu().numpy()
        if terminated.any():
            # a terminated lane's reward is a strong penalty, never NaN or a
            # neutral 0; its non-finite observations become 0
            lane = torch.as_tensor(np.repeat(terminated, na), device=rewards.device)
            rewards = torch.where(
                lane, torch.full_like(rewards, self.divergence_reward), rewards)
            obs = {k: torch.where(torch.isfinite(v), v, torch.zeros_like(v))
                   for k, v in obs.items()}
        done = terminated | truncated
        if self.auto_reset and done.any():
            obs, info = self._auto_reset_done(obs, info, done)
        to_dev = lambda a: torch.as_tensor(a, device=env.device)
        return obs, rewards, to_dev(terminated), to_dev(truncated), info

    def _per_env_terminated(self, info) -> np.ndarray:
        """Diverged envs (a non-finite pressure residual) terminate; the
        single env raises instead, but a batch keeps its healthy lanes."""
        res = info.get("pressure_residual")
        if res is None:
            return np.zeros(self.n_envs, bool)
        res = res.reshape(self.n_envs, -1)
        return (~torch.isfinite(res).all(dim=1)).cpu().numpy()

    def _auto_reset_done(self, obs, info, done: np.ndarray):
        """Splice fresh initial states into finished slots; return the new
        episodes' first observations in their rows and the finished
        episodes' last observations under ``info["final_observation"]``."""
        idx = np.nonzero(done)[0]
        rows = torch.as_tensor(self._obs_rows(idx), device=self.device)
        info = dict(info)
        info["final_observation"] = {k: v[rows] for k, v in obs.items()}
        carries, obs_rows = [], []
        for _ in idx:
            o, _ = self.env.reset()
            carries.append(self.env._pure_carry())
            obs_rows.append(o)
        fresh = _stack(carries)
        slots = torch.as_tensor(idx, device=self.device)
        self._bcarry = _tree_map(lambda b, n: b.index_copy(0, slots, n),
                                 self._bcarry, fresh)
        new_obs = self._aggregate_obs(obs_rows)
        obs = {k: v.index_copy(0, rows, new_obs[k]) for k, v in obs.items()}
        self._step_counts[idx] = 0
        return obs, info

    def _obs_rows(self, env_idx: np.ndarray) -> np.ndarray:
        """Observation rows of envs: 1:1 (SARL) or n_agents each (MARL)."""
        if not self.use_marl:
            return env_idx
        na = self.n_agents
        return (env_idx[:, None] * na + np.arange(na)[None, :]).reshape(-1)
