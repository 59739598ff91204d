"""LIF neuron configuration (twin of ``repro.core.lif``).

    v[t] = tau * v[t-1] * (1 - s[t-1]) + I[t]      (hard reset)
    s[t] = H(v[t] - v_th)

With the deployed single timestep (T=1, v[0]=0) this is ``s = H(I - v_th)``;
``lif_multistep`` is the multi-timestep baseline the paper compares it with.
The kernels and their plain versions fire on ``v >= v_th``; for finite
floats it equals the reference's ``(v - v_th) >= 0``, the form
``lif_forward`` keeps (in the activation's dtype, as the reference's LM
layers compute it). ``surrogate``/``alpha`` choose the pseudo-derivative
the training backward puts in place of the Heaviside (``core.surrogate``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


def lif_single_step(current: torch.Tensor, cfg: LIFConfig = LIFConfig(),
                    v_prev: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One LIF update over post-reset state: v = tau * v_prev + I (v = I
    without ``v_prev``), s = H(v - v_th) with the surrogate gradient, and
    the reset v * (1 - s) (``soft_reset``: v - v_th * s). Returns (spikes,
    v_next)."""
    v = current if v_prev is None else cfg.tau * v_prev + current
    s = spike(v - cfg.v_th, cfg.surrogate, cfg.alpha)
    v_next = v - cfg.v_th * s if cfg.soft_reset else v * (1.0 - s)
    return s, v_next


def lif_multistep(currents: torch.Tensor,
                  cfg: LIFConfig = LIFConfig()) -> torch.Tensor:
    """The LIF over a leading time axis ``currents[T, ...]`` from v[0] = 0:
    the multi-timestep baseline (T > 1). Returns the spikes [T, ...]."""
    v = torch.zeros_like(currents[0])
    spikes = []
    for i_t in currents:
        s, v = lif_single_step(i_t, cfg, v_prev=v)
        spikes.append(s)
    return torch.stack(spikes)


def spike_rate(spikes: torch.Tensor) -> torch.Tensor:
    """Fraction of active neurons (f32 scalar)."""
    return spikes.to(torch.float32).mean()


def total_spikes(spikes: torch.Tensor) -> torch.Tensor:
    """Total spikes (the paper's TS metric), int32."""
    return spikes.to(torch.float32).sum().to(torch.int32)
