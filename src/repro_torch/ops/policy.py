"""ExecutionPolicy: one knob for how the hybrid data-event flow executes
(twin of ``repro.ops.policy``, same preset strings and ``+grad`` suffix).

  * ``"reference"``    — plain PyTorch paths, no hand-written kernels.
  * ``"fused_dense"``  — the fused event-driven kernels with int8 spike maps
                         between layers.
  * ``"fused_packed"`` — the fused kernels with bit-packed spike maps (32
                         spikes per int32 word) between layers.
  * ``"auto"`` / ``"auto_packed"`` — the roofline autotuner
                         (``ops.autotune``) picks the kernel, skip strategy
                         and block shape of each matmul sweep.

The ``differentiable`` axis (``for_training()`` / ``"<preset>+grad"``)
selects the surrogate-gradient implementations of ``ops.grad``: the
forward runs the preset's kernels, the backward the pseudo-derivative.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

KERNEL_MODES = ("reference", "fused", "auto")
FORMATS = ("dense", "packed")
GRAD_SUFFIX = "+grad"


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    kernels: str = "reference"      # "reference" | "fused" | "auto"
    format: str = "dense"           # "dense" | "packed"
    differentiable: bool = False    # surrogate-gradient graph

    def __post_init__(self):
        if self.kernels not in KERNEL_MODES:
            raise ValueError(f"kernels={self.kernels!r} not in {KERNEL_MODES}")
        if self.format not in FORMATS:
            raise ValueError(f"format={self.format!r} not in {FORMATS}")

    @property
    def fused(self) -> bool:
        return self.kernels in ("fused", "auto")

    @property
    def auto(self) -> bool:
        return self.kernels == "auto"

    @property
    def packed(self) -> bool:
        return self.format == "packed"

    @property
    def mode(self) -> str:
        """The ``(op, mode)`` registry key: the kernel mode, suffixed
        ``+grad`` for the differentiable graph."""
        return self.kernels + (GRAD_SUFFIX if self.differentiable else "")

    def for_training(self) -> "ExecutionPolicy":
        return dataclasses.replace(self, differentiable=True)

    def for_inference(self) -> "ExecutionPolicy":
        return dataclasses.replace(self, differentiable=False)

    @property
    def name(self) -> str:
        if self.kernels == "reference":
            base = ("reference" if self.format == "dense"
                    else "reference_packed")
        elif self.kernels == "auto":
            base = "auto" if self.format == "dense" else "auto_packed"
        else:
            base = f"fused_{self.format}"
        return base + (GRAD_SUFFIX if self.differentiable else "")

    def __str__(self) -> str:
        return self.name


REFERENCE = ExecutionPolicy("reference", "dense")
FUSED_DENSE = ExecutionPolicy("fused", "dense")
FUSED_PACKED = ExecutionPolicy("fused", "packed")
AUTO = ExecutionPolicy("auto", "dense")
AUTO_PACKED = ExecutionPolicy("auto", "packed")

POLICIES = {
    "reference": REFERENCE,
    "fused_dense": FUSED_DENSE,
    "fused_packed": FUSED_PACKED,
    "reference_packed": ExecutionPolicy("reference", "packed"),
    "auto": AUTO,
    "auto_packed": AUTO_PACKED,
}

PolicyLike = Union[ExecutionPolicy, str, None]


def as_policy(policy: PolicyLike,
              default: Optional[ExecutionPolicy] = None) -> ExecutionPolicy:
    """Normalize a policy spec (preset name, optionally ``+grad``-suffixed,
    an ExecutionPolicy, or None)."""
    if policy is None:
        return default if default is not None else REFERENCE
    if isinstance(policy, ExecutionPolicy):
        return policy
    if isinstance(policy, str):
        base, grad = policy, False
        if policy.endswith(GRAD_SUFFIX):
            base, grad = policy[:-len(GRAD_SUFFIX)], True
        try:
            pol = POLICIES[base]
        except KeyError:
            raise ValueError(
                f"unknown execution policy {policy!r}; expected one of "
                f"{sorted(POLICIES)} (optionally suffixed "
                f"'{GRAD_SUFFIX}')") from None
        return pol.for_training() if grad else pol
    raise TypeError(f"policy must be an ExecutionPolicy, a preset name, or "
                    f"None — got {type(policy).__name__}")


def merge_engine_policy(model_policy: ExecutionPolicy,
                        engine_policy: PolicyLike) -> ExecutionPolicy:
    """Engine-over-model policy resolution: an engine's ``policy``
    replaces the model's wholesale; None keeps the model's."""
    if engine_policy is None:
        return model_policy
    return as_policy(engine_policy)


def with_policy(cfg, policy: PolicyLike):
    """Config copy with ``policy`` set (a preset name or an instance)."""
    return dataclasses.replace(cfg, policy=as_policy(policy))
