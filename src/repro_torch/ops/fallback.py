"""Graceful kernel degradation: fused -> reference per (op, mode) (twin of
``repro.ops.fallback``).

``registry.lookup`` returns every mode containing ``"fused"`` (the
``+grad`` modes too) behind ``guarded``. A failure the guard accepts
DEMOTES the (op, mode) cell to its reference mode for the rest of the
process, and the call runs again there, with the same signature and the
same contract, so the caller sees the swap only in ``demotions()`` and in
the engine's ``stats()``.

A demotion is sticky per (op, mode): the failed kernel is not tried again,
a ``RuntimeWarning`` says so, and the autotuner is told
(``AutoTuner.demote``), so the "auto" policies stop planning it.

What demotes depends on where the arguments lie:

  * On the card (any tensor argument off the CPU) only an
    ``InjectedKernelFault`` demotes. Every other error propagates: an
    ``nvcc`` build failure, a launch the card rejects, a
    ``torch.OutOfMemoryError``, a shape mismatch torch raises as a
    ``RuntimeError``. A kernel that fails to build or launch must not
    quietly give way to its plain version on the card; the router's
    replica failover or the caller sees it.
  * On the CPU any ``RuntimeError`` demotes, as in the reference. There
    the fused wrapper runs its kernel's plain version anyway.

Contract violations (``ValueError``, ``TypeError``, ``AssertionError``
from a shape or block check) propagate everywhere: the reference would
reject them too, and a fallback would hide the caller's bug.

``arm_kernel_fault(op, at_call)`` makes the ``at_call``-th guarded fused
call of ``op`` raise ``InjectedKernelFault``, the deterministic entry for
the chaos tests (``serve.faults.FaultPlan.fail_kernel`` arms it).

Two differences from the reference, both from eager execution:

  * ``at_call`` counts guarded calls as they are *executed*: every tick
    calls the op again. The reference counts the calls made while a
    function is traced, once per compiled shape. The two agree for
    ``at_call=0``, which is what the canned chaos plan uses.
  * A kernel launch is asynchronous: a fault the card reports after the
    launch returned surfaces at the engine's next read of a result, outside
    this guard. There the router's replica failover handles it. The guard
    adds no ``torch.cuda.synchronize`` to a dispatch: that would stall the
    host on every launch of an LM tick, which is host-bound already.
"""
from __future__ import annotations

import warnings
from typing import Callable

import torch

from ..tree import tree_leaves

__all__ = [
    "InjectedKernelFault", "arm_kernel_fault", "armed_kernel_faults",
    "is_demoted", "demotions", "reset_demotions", "reset", "guarded",
]


class InjectedKernelFault(RuntimeError):
    """A deliberately injected fused-kernel failure (the fault harness)."""


FALLBACK_EXCEPTIONS = (RuntimeError,)

_DEMOTED: dict[tuple[str, str], str] = {}      # (op, mode) -> reason
_WRAPPED: dict[tuple[str, str], tuple] = {}    # (op, mode) -> (fn, wrapper)
_FAULTS: list[dict] = []                       # armed injections
_LOG: list[dict] = []                          # demotion log


def arm_kernel_fault(op: str = "*", at_call: int = 0) -> None:
    """Arm one injected failure: the ``at_call``-th guarded fused call of
    ``op`` ("*" = any op, counted across all ops) raises
    ``InjectedKernelFault`` inside the guard. Fires once."""
    _FAULTS.append({"op": op, "at_call": int(at_call), "n": 0,
                    "fired": False})


def armed_kernel_faults() -> list[dict]:
    return [dict(f) for f in _FAULTS]


def is_demoted(op: str, mode: str | None = None) -> bool:
    """True if ``op`` (in ``mode``, or in any mode) runs its reference."""
    if mode is not None:
        return (op, mode) in _DEMOTED
    return any(o == op for o, _ in _DEMOTED)


def demotions() -> list[dict]:
    """The demotion log: one entry per (op, mode) that fell back."""
    return [dict(e) for e in _LOG]


def reset_demotions() -> None:
    """Forget every demotion (tests, or a deploy that fixed the kernel),
    the autotuner's too."""
    from .autotune import get_tuner

    _DEMOTED.clear()
    _LOG.clear()
    get_tuner().clear_demotions()


def reset() -> None:
    """Full reset: demotions, armed faults and the wrapper cache."""
    reset_demotions()
    _FAULTS.clear()
    _WRAPPED.clear()


def _reference_mode(mode: str) -> str:
    return mode.replace("fused", "reference")


def _maybe_inject(op: str) -> None:
    for f in _FAULTS:
        if f["fired"] or f["op"] not in ("*", op):
            continue
        if f["n"] < f["at_call"]:
            f["n"] += 1
            continue
        f["fired"] = True
        raise InjectedKernelFault(
            f"injected fused-kernel fault: op={op!r} call #{f['n']}")


def _on_card(args: tuple, kwargs: dict) -> bool:
    """True if any tensor argument (a ``SpikeTensor``'s data too) lies off
    the CPU."""
    for a in tree_leaves([list(args), kwargs]):
        t = a if isinstance(a, torch.Tensor) else getattr(a, "data", None)
        if isinstance(t, torch.Tensor) and t.device.type != "cpu":
            return True
    return False


def _demote(op: str, mode: str, err: BaseException) -> None:
    from .autotune import get_tuner

    reason = f"{type(err).__name__}: {err}"
    _DEMOTED[(op, mode)] = reason
    _LOG.append({"op": op, "mode": mode, "fallback": _reference_mode(mode),
                 "reason": reason})
    warnings.warn(
        f"fused kernel {op!r} ({mode}) raised {reason!r}; demoted to "
        f"{_reference_mode(mode)!r} for the rest of the process "
        f"(repro_torch.ops.fallback.reset_demotions() to re-arm)",
        RuntimeWarning, stacklevel=3)
    get_tuner().demote(op)


def guarded(op: str, mode: str, fn: Callable) -> Callable:
    """The wrapper ``registry.lookup`` returns for a fused mode, one
    closure per (op, mode) and implementation."""
    cached = _WRAPPED.get((op, mode))
    if cached is not None and cached[0] is fn:
        return cached[1]

    def call(*args, **kwargs):
        from .registry import lookup

        if (op, mode) in _DEMOTED:
            return lookup(op, _reference_mode(mode))(*args, **kwargs)
        try:
            _maybe_inject(op)
            return fn(*args, **kwargs)
        except FALLBACK_EXCEPTIONS as err:
            if not isinstance(err, InjectedKernelFault) \
                    and _on_card(args, kwargs):
                raise
            try:
                ref = lookup(op, _reference_mode(mode))
            except NotImplementedError:
                raise err from None
            _demote(op, mode, err)
            return ref(*args, **kwargs)

    call.__name__ = f"guarded_{op}_{mode.replace('+', '_')}"
    _WRAPPED[(op, mode)] = (fn, call)
    return call
