"""Surrogate-gradient spike functions (twin of ``repro.core.surrogate``).

The forward is the exact Heaviside step H(v - v_th); the backward puts a
smooth pseudo-derivative in its place, so single-timestep SNNs train with
plain backprop (the paper's KD framework, C1). The four pseudo-derivatives
are copied as the reference writes them, operation for operation (the
triangle's ``/ alpha * alpha`` included), because the backward kernel
``csrc/spike_matmul_dx.cu`` and these plain forms must agree.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

_SURROGATES: dict[str, Callable[[torch.Tensor, float], torch.Tensor]] = {}


def _register(name: str):
    def deco(fn):
        _SURROGATES[name] = fn
        return fn
    return deco


@_register("atan")
def _atan_grad(v: torch.Tensor, alpha: float) -> torch.Tensor:
    # SpikingJelly default: d/dv [ 1/pi * atan(pi/2 * alpha * v) + 1/2 ]
    # (``alpha / tensor`` would be torch's reciprocal-then-multiply, two
    # roundings; a tensor numerator keeps the reference's one division)
    return v.new_tensor(alpha) / (2.0 * (1.0 + (math.pi / 2.0 * alpha * v)
                                         ** 2))


@_register("sigmoid")
def _sigmoid_grad(v: torch.Tensor, alpha: float) -> torch.Tensor:
    s = torch.sigmoid(alpha * v)
    return alpha * s * (1.0 - s)


@_register("triangle")
def _triangle_grad(v: torch.Tensor, alpha: float) -> torch.Tensor:
    # Esser et al. piecewise-linear window; support |v| < 1/alpha
    return torch.clamp_min(alpha - alpha * alpha * v.abs(), 0.0) \
        / alpha * alpha


@_register("rect")
def _rect_grad(v: torch.Tensor, alpha: float) -> torch.Tensor:
    return (v.abs() < 0.5 / alpha).to(v.dtype) * alpha


class _Spike(torch.autograd.Function):
    """Heaviside forward, registered pseudo-derivative backward."""

    @staticmethod
    def forward(ctx, v: torch.Tensor, surrogate: str, alpha: float):
        ctx.save_for_backward(v)
        ctx.surrogate, ctx.alpha = surrogate, alpha
        return (v >= 0).to(v.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (v,) = ctx.saved_tensors
        grad = _SURROGATES[ctx.surrogate](v, ctx.alpha).to(g.dtype)
        return g * grad, None, None


def spike(v_minus_vth: torch.Tensor, surrogate: str = "atan",
          alpha: float = 2.0) -> torch.Tensor:
    """Heaviside spike with a surrogate gradient; {0,1} in v's dtype."""
    if surrogate not in _SURROGATES:
        raise ValueError(f"unknown surrogate {surrogate!r}; expected one of "
                         f"{available_surrogates()}")
    return _Spike.apply(v_minus_vth, surrogate, alpha)


def available_surrogates() -> tuple[str, ...]:
    return tuple(_SURROGATES)


def surrogate_grad(v: torch.Tensor, surrogate: str,
                   alpha: float) -> torch.Tensor:
    """The registered pseudo-derivative at membrane offset ``v``
    (= v_mem - v_th): the factor the backward kernel fuses into its
    ``g @ wᵀ`` sweep."""
    return _SURROGATES[surrogate](v, alpha)
