"""Spiking QKFormer token mask (twin of ``repro.core.qk_attention``, the
part KD training calls).

    t_i = sum_d Q[i, d]            (row summation along the Q path)
    A_i = spike(t_i - theta)       (token activation mask, {0,1})

``mode="or"`` is NEURAL's hardware atten_reg (any spike in the row): the
same forward on integer spike counts at theta = 1, with no gradient into Q.
"""
from __future__ import annotations

import torch

from .surrogate import spike


def qk_token_mask(q_spikes: torch.Tensor, mode: str = "threshold",
                  threshold: float = 1.0, surrogate: str = "atan",
                  alpha: float = 2.0) -> torch.Tensor:
    """Per-token mask from Q spikes [..., N, D] -> [..., N, 1] {0,1}."""
    rowsum = q_spikes.sum(dim=-1, keepdim=True)
    if mode == "or":
        # hardware atten_reg: deliberately no gradient into Q
        return (rowsum > 0).to(q_spikes.dtype)
    if mode != "threshold":
        raise ValueError(f"unknown QK mask mode {mode!r}")
    return spike(rowsum - threshold, surrogate, alpha)
