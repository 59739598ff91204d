"""Implementation registry (twin of ``repro.ops.registry``): ``(op, mode)``
-> callable, filled by ``repro_torch.ops.impls`` (the inference modes) and
``repro_torch.ops.grad`` (the ``+grad`` modes) on first lookup.

Every mode containing ``"fused"`` (the ``+grad`` modes too) goes out
behind ``fallback.guarded``, as in the reference: a runtime failure of the
kernel demotes the (op, mode) cell to its reference mode instead of
crashing the caller. A mode with no entry raises ``NotImplementedError``
on lookup. ``record_dispatches`` records the ``(op, mode)`` pairs resolved
inside a block; ``node_hook`` hands every fused entry through a function
inside a block (``launch.hlo_analysis.OpRecorder`` makes each fused call
one node of its op record).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

from . import fallback

_REGISTRY: dict[tuple[str, str], Callable] = {}
_LOADED = False
_DISPATCH_LOG: Optional[list] = None
_NODE_HOOK: Optional[Callable] = None


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


@contextlib.contextmanager
def record_dispatches() -> Iterator[list[tuple[str, str]]]:
    """Record every ``(op, mode)`` this registry resolves inside the block,
    in dispatch order (an audit of the modes a policy really executes).
    PyTorch runs eagerly, so every call is recorded, a repeated one too."""
    global _DISPATCH_LOG
    prev, _DISPATCH_LOG = _DISPATCH_LOG, []
    try:
        yield _DISPATCH_LOG
    finally:
        _DISPATCH_LOG = prev


@contextlib.contextmanager
def node_hook(hook: Callable[[str, str, Callable], Callable]) -> Iterator:
    """Inside the block, ``lookup`` returns ``hook(op, mode, fn)`` for every
    fused entry ``fn`` (the guarded one)."""
    global _NODE_HOOK
    prev, _NODE_HOOK = _NODE_HOOK, hook
    try:
        yield
    finally:
        _NODE_HOOK = prev


def plain(op: str, mode: str) -> Callable:
    """``op``'s plain version for ``mode`` (its ``reference`` twin), as
    registered: not logged as a dispatch and not guarded. For pricing a
    call (``launch.hlo_analysis``), not for running one."""
    _ensure_loaded()
    return _REGISTRY[(op, mode.replace("fused", "reference"))]


def plain(op: str, mode: str) -> Callable:
    """``op``'s plain version for ``mode`` (its ``reference`` twin), as
    registered: not logged as a dispatch and not guarded. For pricing a
    call (``launch.hlo_analysis``), not for running one."""
    _ensure_loaded()
    return _REGISTRY[(op, mode.replace("fused", "reference"))]


def lookup(op: str, mode: str) -> Callable:
    _ensure_loaded()
    if _DISPATCH_LOG is not None:
        _DISPATCH_LOG.append((op, mode))
    fn = _REGISTRY.get((op, mode))
    if fn is not None:
        if "fused" not in mode:
            return fn
        # a fused entry goes out behind the degradation guard
        fn = fallback.guarded(op, mode, fn)
        return fn if _NODE_HOOK is None else _NODE_HOOK(op, mode, fn)
    have = sorted(m for o, m in _REGISTRY if o == op)
    if not have:
        raise NotImplementedError(f"unknown op {op!r}")
    raise NotImplementedError(
        f"op {op!r} has no {mode!r} implementation in repro_torch "
        f"(registered modes: {have})")


def implementations(op: Optional[str] = None) -> dict:
    """Introspection: the registered (op, mode) -> callable table."""
    _ensure_loaded()
    if op is None:
        return dict(_REGISTRY)
    return {k: v for k, v in _REGISTRY.items() if k[0] == op}
