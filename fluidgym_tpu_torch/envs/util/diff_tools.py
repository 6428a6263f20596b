"""Differentiating through the environment state (counterpart of
``fluidgym_tpu/envs/util/diff_tools.py``): extract the differentiable
sub-state, flatten it, rebuild a state from new arrays, and take VJPs of a
pure function of the state with ``torch.autograd.grad``.  The functions are
pure, as the JAX package's: nothing is marked in place."""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable

import torch

from fluidgym_tpu_torch.core.domain import DomainState, map_state, state_leaves

Tensor = torch.Tensor

__all__ = ["get_state_arrays", "get_flat_state", "replace_state_arrays",
           "state_vjp"]


def get_state_arrays(state: DomainState) -> list[Tensor]:
    """The differentiable state arrays of every block: velocity, plus the
    passive scalar if present."""
    arrays = []
    for blk in state.blocks:
        arrays.append(blk.velocity)
        if blk.scalar is not None:
            arrays.append(blk.scalar)
    return arrays


def get_flat_state(state_or_env) -> Tensor:
    """The differentiable state as one flat vector (of a ``DomainState``, or
    of an env's current state)."""
    state = getattr(state_or_env, "_state", state_or_env)
    return torch.cat([a.reshape(-1) for a in get_state_arrays(state)])


def replace_state_arrays(state: DomainState, arrays) -> DomainState:
    """Inverse of :func:`get_state_arrays`: ``state`` with the given
    velocity / scalar arrays."""
    it = iter(arrays)
    for b, blk in enumerate(state.blocks):
        vel = next(it)
        if blk.scalar is not None:
            state = state.replace_block(
                b, replace(blk, velocity=vel, scalar=next(it)))
        else:
            state = state.replace_block(b, replace(blk, velocity=vel))
    return state


def _leaves(tree) -> list[Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, DomainState):
        return state_leaves(tree)
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _detach(tree):
    if torch.is_tensor(tree):
        return tree.detach()
    if isinstance(tree, DomainState):
        return map_state(tree, torch.Tensor.detach)
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_detach(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detach(v) for v in tree)
    return tree


def state_vjp(step_fn: Callable[[DomainState], Any], state: DomainState,
              cotangent: Any = None):
    """VJP of ``step_fn`` with respect to the differentiable state arrays.

    ``step_fn(state) -> output`` is any pure function of a ``DomainState``
    (a ``piso_fixed_steps`` rollout, an env's ``_pure_step`` with the state
    in its carry).  Returns ``(output, grads)``: the output detached, and a
    list matching :func:`get_state_arrays`.  ``cotangent`` has the output's
    structure; by default all ones over the output's tensors."""
    arrays = [a.detach().requires_grad_(True)
              for a in get_state_arrays(state)]
    out = step_fn(replace_state_arrays(state, arrays))
    outs = _leaves(out)
    cots = (_leaves(cotangent) if cotangent is not None
            else [torch.ones_like(t) for t in outs])
    pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs], arrays,
                                grad_outputs=[c for _, c in pairs],
                                allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for g, a in zip(grads, arrays)]
    return _detach(out), grads
