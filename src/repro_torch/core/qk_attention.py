"""Spiking QKFormer token mask (twin of ``repro.core.qk_attention``: the
token mask KD training calls and the grouped token attention of the
spiking LM's reference path).

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


def qk_grouped_token_attention(q_spikes: torch.Tensor, k_spikes: torch.Tensor,
                               mode: str = "threshold",
                               threshold: float = 1.0,
                               surrogate: str = "atan",
                               alpha: float = 2.0) -> torch.Tensor:
    """Grouped-KV token attention: per-query-head token masks gate grouped
    KV heads. q_spikes [..., N, H, Dh], k_spikes [..., N, Hkv, Dh] with H a
    multiple of Hkv; query head qh reads kv head qh // (H // Hkv). Returns
    the masked, group-expanded K [..., N, H, Dh] (the expansion happens in
    the broadcast multiply)."""
    h, hkv = q_spikes.shape[-2], k_spikes.shape[-2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    g = h // hkv
    a = qk_token_mask(q_spikes, mode, threshold, surrogate, alpha)
    lead, n, dh = q_spikes.shape[:-3], q_spikes.shape[-3], q_spikes.shape[-1]
    a = a.reshape(*lead, n, hkv, g, 1)
    out = a * k_spikes[..., :, :, None, :]
    return out.reshape(*lead, n, h, dh)
