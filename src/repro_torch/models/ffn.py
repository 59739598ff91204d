"""Feed-forward layers (twin of ``repro.models.ffn``): the dense SwiGLU.
In spiking mode the SiLU gate becomes a LIF spike, so the hidden
activation is a binary event map times the up projection. The products
are plain ``torch.matmul``s, as the reference leaves them to XLA. The
MoE layers come with the ``moe`` family (ROADMAP queue 1 item 4).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from .layers import dense_apply, dense_init, maybe_spike, note_spikes


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d: Optional[int] = None,
             d_ff: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "gate": dense_init(gen, d, f, dtype=cfg.param_dtype),
        "up": dense_init(gen, d, f, dtype=cfg.param_dtype),
        "down": dense_init(gen, f, d, dtype=cfg.param_dtype),
    }


def mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    g = dense_apply(p["gate"], x)
    u = dense_apply(p["up"], x)
    if cfg.spiking:
        s = maybe_spike(g, True, cfg.lif)     # LIF gate: binary event map
        note_spikes("mlp", s)
        h = s * u
    else:
        h = silu(g) * u
    return dense_apply(p["down"], h)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), each step in
    x's dtype: at bf16 that rounds where the reference's (XLA's logistic
    on the CPU) rounds, which ``torch.nn.functional.silu`` (one rounding)
    does not."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))
