"""LIF neuron configuration (twin of ``repro.core.lif``).

    v[t] = tau * v[t-1] * (1 - s[t-1]) + I[t]      (hard reset)
    s[t] = H(v[t] - v_th)

With the deployed single timestep (T=1, v[0]=0) this is ``s = H(I - v_th)``.
The kernels and their plain versions fire on ``v >= v_th``; for finite
floats it equals the reference's ``(v - v_th) >= 0``, the form
``lif_forward`` keeps (in the activation's dtype, as the reference's LM
layers compute it). ``surrogate``/``alpha`` choose the pseudo-derivative
the training backward puts in place of the Heaviside (``core.surrogate``).
"""
from __future__ import annotations

import dataclasses

import torch

from .surrogate import spike


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    tau: float = 0.5            # decay (paper §V.A: tau = 0.5)
    v_th: float = 1.0           # firing threshold
    surrogate: str = "atan"
    alpha: float = 2.0
    soft_reset: bool = False    # paper uses hard reset; soft kept for ablation


def lif_forward(current: torch.Tensor,
                cfg: LIFConfig = LIFConfig()) -> torch.Tensor:
    """Single-timestep spiking activation (the deployed mode): s = H(I -
    v_th), {0,1} in the current's dtype, with the surrogate gradient."""
    return spike(current - cfg.v_th, cfg.surrogate, cfg.alpha)
