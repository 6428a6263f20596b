"""Pure-step pieces of the envs whose control is smoothed toward the action
every sim step and whose step reports the mean drag and lift of its sim
steps (the cylinder and the airfoil; counterpart of their ``lax.scan``
bodies in the JAX package, whose carry is ``(DomainState, last_control)``).
"""

from __future__ import annotations

from typing import Any

import torch

Tensor = torch.Tensor


class SmoothedControlMixin:
    """Carry ``(state, last_control)``; per sim step ``c <- c + alpha (a -
    c)``, applied to the state, and ``(cd, cl)`` recorded after the sim
    step; the reward comes from ``_reward(cd, cl)`` of the step means."""

    _action_smoothing_alpha: float = 0.1

    def _reward(self, cd: Tensor, cl: Tensor) -> Tensor:
        raise NotImplementedError

    def _pure_carry(self) -> tuple:
        return (self._state, self._last_control)

    def _set_pure_carry(self, carry: tuple) -> None:
        self._state, self._last_control = carry

    def _pure_pre_sim(self, carry: tuple, action: Tensor) -> tuple:
        state, ctrl = carry
        ctrl = ctrl + self._action_smoothing_alpha * (action - ctrl)
        if self._enable_actions:
            state = self._pure_apply_action(state, ctrl)
        return (state, ctrl)

    def _pure_record(self, carry: tuple) -> tuple:
        return tuple(self._pure_drag_lift(carry[0]))

    def _pure_end(self, carry: tuple, records: list):
        cd = torch.mean(torch.stack([r[0] for r in records]))
        cl = torch.mean(torch.stack([r[1] for r in records]))
        return (self._pure_global_obs(carry[0]), self._reward(cd, cl),
                {"drag": cd, "lift": cl})

    def _get_additional_state_info(self) -> dict[str, Any]:
        return {"last_control": self._last_control}

    def _set_additional_state_info(self, info: dict[str, Any]) -> None:
        if "last_control" in info:
            self._last_control = torch.as_tensor(
                info["last_control"], device=self._device).to(self._dtype)
