"""Environment registry (counterpart of ``fluidgym_tpu/registry.py``):
``register(id, entry_point, defaults, **overrides)`` stores a constructor
plus a defaults dict; ``make(id, **kwargs)`` merges defaults <- per-id
overrides <- user kwargs and instantiates.  ``device`` is one of the user
kwargs: ``None`` (the default) means the CUDA card."""

from __future__ import annotations

from typing import Any, Callable


class EnvRegistry:
    """Maps env ids to (entry_point, merged default kwargs)."""

    def __init__(self) -> None:
        self._entries: dict[str, tuple[Callable[..., Any], dict[str, Any]]] = {}

    def register(
        self,
        id: str,
        entry_point: Callable[..., Any],
        defaults: dict[str, Any] | None = None,
        **overrides: Any,
    ) -> None:
        if id in self._entries:
            raise ValueError(f"Environment id {id!r} is already registered.")
        merged = dict(defaults or {})
        merged.update(overrides)
        self._entries[id] = (entry_point, merged)

    def make(self, id: str, **kwargs: Any):
        if id not in self._entries:
            raise KeyError(
                f"Unknown environment id {id!r}. Registered: {sorted(self._entries)}"
            )
        entry_point, defaults = self._entries[id]
        cfg = dict(defaults)
        cfg.update(kwargs)
        return entry_point(**cfg)

    def ids(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, id: str) -> bool:
        return id in self._entries


registry = EnvRegistry()


def register(id: str, entry_point, defaults=None, **overrides) -> None:
    """Register an environment id (module-level convenience)."""
    registry.register(id, entry_point, defaults, **overrides)


def make(id: str, **kwargs):
    """Instantiate a registered environment with merged config.  Pass
    ``device="cpu"`` to run on the host; the default is the CUDA card."""
    return registry.make(id, **kwargs)
