"""Implementation registry (twin of ``repro.ops.registry``): ``(op, mode)``
-> callable, filled by ``repro_torch.ops.impls`` (the inference modes) and
``repro_torch.ops.grad`` (the ``+grad`` modes) on first lookup.

Unlike the reference there is no graceful-degradation guard around the
fused entries: a fused mode either runs its kernel or raises. A mode still
to port has no entry, and looking it up raises ``NotImplementedError``
(for a ``+grad`` mode, naming the ROADMAP item that ports it).
"""
from __future__ import annotations

from typing import Callable, Optional

_REGISTRY: dict[tuple[str, str], Callable] = {}
_LOADED = False


def register(op: str, mode: str) -> Callable[[Callable], Callable]:
    """Decorator: ``@register("matmul", "fused")`` binds an implementation."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(op, mode)] = fn
        return fn

    return deco


def _ensure_loaded() -> None:
    global _LOADED
    if not _LOADED:
        _LOADED = True
        from . import grad, impls  # noqa: F401  (register the families)


def lookup(op: str, mode: str) -> Callable:
    _ensure_loaded()
    try:
        return _REGISTRY[(op, mode)]
    except KeyError:
        pass
    have = sorted(m for o, m in _REGISTRY if o == op)
    if mode.endswith("+grad"):
        hint = (" — its differentiable form is still to port (ROADMAP "
                "queue 1 item 2 for the LM ops)")
    else:
        hint = ""
    raise NotImplementedError(
        f"op {op!r} has no {mode!r} implementation in repro_torch "
        f"(registered modes: {have}){hint}")


def implementations(op: Optional[str] = None) -> dict:
    """Introspection: the registered (op, mode) -> callable table."""
    _ensure_loaded()
    if op is None:
        return dict(_REGISTRY)
    return {k: v for k, v in _REGISTRY.items() if k[0] == op}
