"""Spiking QKFormer attention (twin of ``repro.core.qk_attention``): the
token mask KD training calls, the grouped token attention of the spiking
LM's reference path, and the channel mask and Spikformer-style SSA.

    t_i = sum_d Q[i, d]            (row summation along the Q path)
    A_i = spike(t_i - theta)       (token activation mask, {0,1})

and the channel variant, c_d = sum_i Q[i, d]. ``mode="or"`` is NEURAL's
hardware atten_reg (any spike in the row): the same forward on integer
spike counts at theta = 1, with no gradient into Q.
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


def qk_channel_mask(q_spikes: torch.Tensor, mode: str = "threshold",
                    threshold: float = 1.0, surrogate: str = "atan",
                    alpha: float = 2.0) -> torch.Tensor:
    """Per-channel mask from Q spikes [..., N, D] -> [..., 1, D] {0,1}."""
    colsum = q_spikes.sum(dim=-2, keepdim=True)
    if mode == "or":
        # hardware atten_reg: deliberately no gradient into Q
        return (colsum > 0).to(q_spikes.dtype)
    if mode != "threshold":
        raise ValueError(f"unknown QK mask mode {mode!r}")
    return spike(colsum - threshold, surrogate, alpha)


def qk_token_attention(q_spikes: torch.Tensor, k_spikes: torch.Tensor,
                       mode: str = "threshold", threshold: float = 1.0,
                       surrogate: str = "atan",
                       alpha: float = 2.0) -> torch.Tensor:
    """QKTA: K's rows masked by Q's token mask, [..., N, D] -> [..., N, D].
    Row i's mask depends on row i of Q alone."""
    return qk_token_mask(q_spikes, mode, threshold, surrogate,
                         alpha) * k_spikes


def qk_channel_attention(q_spikes: torch.Tensor, k_spikes: torch.Tensor,
                         mode: str = "threshold", threshold: float = 1.0,
                         surrogate: str = "atan",
                         alpha: float = 2.0) -> torch.Tensor:
    """QKCA: K's channels masked by Q's channel mask."""
    return qk_channel_mask(q_spikes, mode, threshold, surrogate,
                           alpha) * k_spikes


def spiking_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float = 0.125,
                           causal: bool = False) -> torch.Tensor:
    """Spikformer-style SSA on binary Q, K, V without softmax: (Q K^T) V *
    scale, associated as Q (K^T V). Causal: chunks of 128 tokens, the
    masked scores within a chunk plus the exclusive prefix sum of the
    earlier chunks' K^T V."""
    if not causal:
        kv = torch.einsum("...nd,...ne->...de", k, v)
        return torch.einsum("...nd,...de->...ne", q, kv) * scale
    n = q.shape[-2]
    chunk = min(128, n)
    pad = (-n) % chunk

    def chunks(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t
        return t.reshape(*t.shape[:-2], t.shape[-2] // chunk, chunk,
                         t.shape[-1])

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    scores = torch.einsum("...cnd,...cmd->...cnm", qc, kc)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=q.dtype,
                                 device=q.device))
    intra = torch.einsum("...cnm,...cme->...cne", scores * mask, vc)
    kv_chunks = torch.einsum("...cnd,...cne->...cde", kc, vc)
    kv_prefix = torch.cumsum(kv_chunks, dim=-3) - kv_chunks   # exclusive
    inter = torch.einsum("...cnd,...cde->...cne", qc, kv_prefix)
    out = intra + inter
    out = out.reshape(*out.shape[:-3], -1, out.shape[-1])[..., :n, :]
    return out * scale


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
