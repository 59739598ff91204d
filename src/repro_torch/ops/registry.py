"""Implementation registry (twin of ``repro.ops.registry``): ``(op, mode)``
-> callable, filled by ``repro_torch.ops.impls`` on first lookup.

Unlike the reference there is no graceful-degradation guard around the
fused entries: a fused mode either runs its kernel or raises. A mode whose
kernel is still to port has no entry, and looking it up raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Callable, Optional

_REGISTRY: dict[tuple[str, str], Callable] = {}
_LOADED = False

# ops whose fused kernel is still to port -> its ROADMAP queue 2 item
_FUSED_TODO = {
    "qk_mask": "K8",
    "attention": "K9",
    "dense_lif": "K2 (dense-activation and head-blocked variants)",
}


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
        from . import impls  # noqa: F401  (registers the kernel families)


def lookup(op: str, mode: str) -> Callable:
    _ensure_loaded()
    try:
        return _REGISTRY[(op, mode)]
    except KeyError:
        pass
    have = sorted(m for o, m in _REGISTRY if o == op)
    if mode.endswith("+grad"):
        hint = (" — the differentiable modes come with the training slice "
                "(ROADMAP queue 1 item 4)")
    elif mode == "fused" and op in _FUSED_TODO:
        hint = (f" — its kernel is still to port (ROADMAP queue 2, "
                f"{_FUSED_TODO[op]})")
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
