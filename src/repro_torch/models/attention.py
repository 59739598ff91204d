"""Attention layer (twin of ``repro.models.attention``): the paper's
spiking Q-K attention (C4, QKFormer token attention) as the drop-in for
softmax attention.

Q and K are LIF spike maps; a per-token, per-head mask spike(rowsum(Q_h) -
theta) gates K's head; the output is mask * K. There is no score matrix
and no softmax, and each token's mask depends on that token alone, so
decode keeps no KV cache: under a packed policy each slot keeps only the
last token's masked spike map, packed, as its state (the engine's
telemetry reads it). The softmax branches (full, chunked and decode
attention with RoPE and a KV cache, and K9's flash kernel) raise: they
are still to port (ROADMAP queue 1 item 6, queue 2 K9).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import ops
from ..configs.base import ModelConfig
from ..core.events import pack_words
from ..core.qk_attention import qk_grouped_token_attention
from .layers import (dense_apply, dense_init, maybe_spike, note_spikes,
                     rmsnorm_init)


def _softmax_unported() -> NotImplementedError:
    return NotImplementedError(
        "softmax attention (RoPE, the KV cache and the K9 flash kernel) is "
        "still to port (ROADMAP queue 1 item 6, queue 2 K9); the port runs "
        "attention_kind='qk_spiking'")


# ----------------------------------------------------------------------- init
def attn_init(gen: torch.Generator, cfg: ModelConfig,
              d_model: Optional[int] = None, n_heads: Optional[int] = None,
              n_kv: Optional[int] = None) -> dict:
    d = d_model or cfg.d_model
    h = n_heads or cfg.n_heads
    hkv = n_kv or (cfg.n_kv_heads or h)
    dh = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, h * dh, bias=cfg.qkv_bias,
                         dtype=cfg.param_dtype),
        "wk": dense_init(gen, d, hkv * dh, bias=cfg.qkv_bias,
                         dtype=cfg.param_dtype),
        "wv": dense_init(gen, d, hkv * dh, bias=cfg.qkv_bias,
                         dtype=cfg.param_dtype),
        "wo": dense_init(gen, h * dh, d, dtype=cfg.param_dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, cfg.param_dtype, gen.device)
        p["k_norm"] = rmsnorm_init(dh, cfg.param_dtype, gen.device)
    return p


def _heads(cfg: ModelConfig, n_heads: Optional[int], n_kv: Optional[int]):
    h = n_heads or cfg.n_heads
    return h, n_kv or (cfg.n_kv_heads or h)


# -------------------------------------------------------------------- public
def attn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True,
               n_heads: Optional[int] = None,
               n_kv: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention. Returns [B, S, D]."""
    if cfg.attention_kind != "qk_spiking":
        raise _softmax_unported()
    h, hkv = _heads(cfg, n_heads, n_kv)
    return _qk_spiking_apply(p, cfg, x, h, hkv)


def _stateful(p, cfg, x, h, hkv, cache_k, cache_v):
    """The token-local spiking step shared by prefill, append and decode:
    a packed policy refreshes the per-slot spike state with the last
    token's masked map; otherwise the (empty) cache passes through."""
    if cfg.exec_policy.packed:
        out, state = _qk_spiking_apply(p, cfg, x, h, hkv,
                                       return_spike_state=True)
        return out, (state, cache_v)
    return _qk_spiking_apply(p, cfg, x, h, hkv), (cache_k, cache_v)


def attn_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, n_heads: Optional[int] = None,
                 n_kv: Optional[int] = None):
    """Prefill: the attention output and this layer's cache entry."""
    if cfg.attention_kind != "qk_spiking":
        raise _softmax_unported()
    h, hkv = _heads(cfg, n_heads, n_kv)
    b = x.shape[0]
    empty = torch.zeros((b, 0, hkv, cfg.resolved_head_dim), dtype=x.dtype,
                        device=x.device)
    return _stateful(p, cfg, x, h, hkv, empty, empty)


def attn_append(p: dict, cfg: ModelConfig, x: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                cache_len: torch.Tensor, *, n_heads: Optional[int] = None,
                n_kv: Optional[int] = None):
    """Chunked prefill: C new tokens against a cache entry. The spiking
    path is token-local, so the chunk is self-contained."""
    if cfg.attention_kind != "qk_spiking":
        raise _softmax_unported()
    h, hkv = _heads(cfg, n_heads, n_kv)
    return _stateful(p, cfg, x, h, hkv, cache_k, cache_v)


def attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                pos: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, cache_len: torch.Tensor, *,
                n_heads: Optional[int] = None, n_kv: Optional[int] = None):
    """One-token decode. x: [B, 1, D]."""
    if cfg.attention_kind != "qk_spiking":
        raise _softmax_unported()
    h, hkv = _heads(cfg, n_heads, n_kv)
    return _stateful(p, cfg, x, h, hkv, cache_k, cache_v)


# ----------------------------------------------------- spiking QKTA (paper C4)
def qk_spike_state_width(cfg: ModelConfig) -> int:
    """int32 words per cached packed spike-state row: the masked attention
    map [H*Dh] padded to the 128 lane grid, 32 spikes a word."""
    d = cfg.n_heads * cfg.resolved_head_dim
    return (-(-d // 128) * 128) // 32


def _packed_token_state(out_last: torch.Tensor) -> torch.Tensor:
    """[B, D] binary spike map -> [B, 1, 1, ceil(D/128)*4] int32 words."""
    _, d = out_last.shape
    dp = -(-d // 128) * 128
    padded = F.pad(out_last.to(torch.int32), (0, dp - d))
    return pack_words(padded)[:, None, None, :]


def _token_state(st: ops.SpikeTensor, b: int, s: int) -> torch.Tensor:
    """The last token's masked spike map as packed [B, 1, 1, W] int32 (no
    unpacking when the map is already packed)."""
    if st.is_packed:
        dw = st.data.shape[-1]
        return st.data[:b * s].reshape(b, s, dw)[:, -1][:, None, None, :]
    return _packed_token_state(st.data.reshape(b, s, -1)[:, -1])


def _qk_spiking_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      h: int, hkv: int, *, return_spike_state: bool = False):
    """QKFormer token attention on LIF spikes (paper Fig 5, on-the-fly).

    Under a fused policy (the deployed serving path) the wq and wk
    projections with their LIF thresholds are single fused PE passes
    (``ops.dense_lif``), and the QK token mask is applied inside the K
    pass's write-back as a head-blocked mask (one row-sum threshold per
    head); grouped KV (hkv < h) repeats the wk weight's columns (once per
    weight) so the per-query-head mask gates in the kernel. The output
    projection takes the masked spikes through the event-skipped
    ``ops.matmul``. A packed policy ships the spike maps packed end to
    end. The reference policy computes the same function in plain
    PyTorch, in the activation's dtype. ``return_spike_state`` also
    returns the last token's masked map packed ([B, 1, 1, W] int32).
    """
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    pol = cfg.exec_policy
    if pol.fused:
        q_st = ops.dense_lif(p["wq"], x, cfg.lif, policy=pol)
        out_st = ops.dense_lif(p["wk"], x, cfg.lif, q=q_st,
                               qk_threshold=cfg.lif.v_th,
                               heads=(h, dh), kv_heads=hkv, policy=pol)
        note_spikes("q", q_st)
        note_spikes("attn", out_st)
        proj = ops.matmul(out_st, p["wo"]["w"], policy=pol).to(x.dtype)
        if "b" in p["wo"]:
            proj = proj + p["wo"]["b"].to(proj.dtype)
        proj = proj.reshape(b, s, -1)
        if return_spike_state:
            return proj, _token_state(out_st, b, s)
        return proj
    q_cur = dense_apply(p["wq"], x).reshape(b, s, h, dh)
    k_cur = dense_apply(p["wk"], x).reshape(b, s, hkv, dh)
    q = maybe_spike(q_cur, True, cfg.lif)
    k = maybe_spike(k_cur, True, cfg.lif)
    # [B,S,H,Dh]: grouped KV broadcasts the per-query-head mask over each
    # group instead of replicating K
    out = qk_grouped_token_attention(q, k, mode="threshold",
                                     threshold=cfg.lif.v_th,
                                     surrogate=cfg.lif.surrogate,
                                     alpha=cfg.lif.alpha)
    note_spikes("q", q)
    note_spikes("attn", out)
    proj = dense_apply(p["wo"], out.reshape(b, s, h * dh))
    if return_spike_state:
        return proj, _packed_token_state(out.reshape(b, s, h * dh)[:, -1])
    return proj
