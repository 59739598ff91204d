"""Attention layer (twin of ``repro.models.attention``): GQA softmax
attention (full, chunked and cached decode, with RoPE and a KV cache) and
the paper's spiking Q-K attention (C4, QKFormer token attention) as its
drop-in.

Softmax path. The products are plain PyTorch (``torch.matmul``), as the
reference leaves them to XLA; K9, the hand-written flash kernel, is
reached through ``ops.attention`` alone, as in the reference. Grouped KV
(Hkv < H) folds each group's query heads into the rows of one product
against their KV head (``_grouped_scores`` / ``_grouped_pv``) instead of
repeating K and V: the same sums. The accumulation rules are the
reference's, and at bf16 they are different functions:

  * ``_attn_full`` and ``attn_append`` take the score product in f32 (the
    reference's ``preferred_element_type``: bf16 products are exact in
    f32);
  * ``_attn_chunked`` and ``attn_decode`` round the score product to the
    activation dtype and then widen it to f32; ``_attn_chunked`` also
    rounds p to the activation dtype for PV and its result back;
  * every path casts the softmax weights to q's dtype before PV.

Every mask is additive or a ``where`` with -1e30, never -inf, so cache
rows past a slot's length and pad rows get finite weights. The decode and
append paths write the new K/V rows into the cache's tensors in place
(the engine's pool is one preallocated tensor) and return those tensors.

Spiking path. Q and K are LIF spike maps; a per-token, per-head mask
spike(rowsum(Q_h) - theta) gates K's head; the output is mask * K. There
is no score matrix and no softmax, and each token's mask depends on that
token alone, so decode keeps no KV cache: under a packed policy each slot
keeps only the last token's masked spike map, packed, as its state (the
engine's telemetry reads it).

Still to port, and raising: the cross-attention ``kv_override`` of the
encdec family (ROADMAP queue 1 item 4) and the context-parallel decode
over a sequence-sharded cache, ``decode_cp_axis`` (item 6).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import ops
from ..configs.base import ModelConfig
from ..core.events import pack_words
from ..core.qk_attention import qk_grouped_token_attention
from ..core.softmax import softmax
from .layers import (apply_rope, causal_mask, dense_apply, dense_init,
                     maybe_spike, note_spikes, rmsnorm_apply, rmsnorm_init)

NEG = -1e30


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


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, h: int, hkv: int):
    """q [B,S,H,Dh], k and v [B,S,Hkv,Dh]: QKV bias, q_norm and k_norm,
    then RoPE on q and k."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = dense_apply(p["wq"], x).reshape(b, s, h, dh)
    k = dense_apply(p["wk"], x).reshape(b, s, hkv, dh)
    v = dense_apply(p["wv"], x).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q, cfg.rms_eps)
        k = rmsnorm_apply(p["k_norm"], k, cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,C,H,Dh] . k [B,S,Hkv,Dh] -> [B,H,C,S] in the operands' dtype:
    each KV head's G = H/Hkv query heads are rows of one product, so K is
    never repeated; query head h reads KV head h // G, as the reference's
    ``_expand_kv`` lays them out."""
    b, c, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, c, hkv, g, dh).permute(0, 2, 3, 1, 4)
    s = qg.reshape(b, hkv, g * c, dh) @ k.permute(0, 2, 3, 1)
    return s.reshape(b, h, c, k.shape[1])


def _grouped_pv(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w [B,H,C,S] . v [B,S,Hkv,Dh] -> [B,H,C,Dh] in the operands' dtype."""
    b, h, c, s = w.shape
    hkv, dh = v.shape[2], v.shape[3]
    o = w.reshape(b, hkv, (h // hkv) * c, s) @ v.permute(0, 2, 1, 3)
    return o.reshape(b, h, c, dh)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """[B,H,C,Dh] -> [B,C,H*Dh]."""
    b, h, c, dh = o.shape
    return o.transpose(1, 2).reshape(b, c, h * dh)


# ---------------------------------------------------------------- full attn
def _attn_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, causal: bool, q_offset: int = 0
               ) -> torch.Tensor:
    """Softmax attention over the whole sequence -> [B,Sq,H,Dh]. k, v:
    [B,Sk,Hkv,Dh] with Hkv dividing H (the reference takes them expanded
    to H; the sums are the same). Scores in f32 from the widened operands
    (exact bf16 products summed in f32), weights cast to q's dtype for
    PV."""
    scores = _grouped_scores(q.float(), k.float()) * scale
    if causal:
        scores = scores + causal_mask(q.shape[1], k.shape[1], q_offset,
                                      device=q.device)
    w = softmax(scores).to(q.dtype)
    return _grouped_pv(w, v).transpose(1, 2)


# ----------------------------------------------------------- chunked (flash)
def _attn_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool, q_block: int,
                  kv_block: int) -> torch.Tensor:
    """Flash-style: stream KV blocks with a running (max, denominator,
    output), so live memory is O(q_block * kv_block). Each block's scores
    are rounded to the activation dtype and then widened, and p is
    rounded to it for PV, as the reference does."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    if sq % q_block or sk % kv_block:
        raise ValueError(f"chunked attention needs block-divisible lengths "
                         f"({sq}, {sk}, {q_block}, {kv_block})")
    dev = q.device
    outs = []
    for qi in range(sq // q_block):
        q_i = q[:, qi * q_block:(qi + 1) * q_block]
        m = torch.full((b, h, q_block), float("-inf"), device=dev)
        l = torch.zeros((b, h, q_block), device=dev)
        o = torch.zeros((b, h, q_block, dh), device=dev)
        for lo in range(0, sk, kv_block):
            k_j, v_j = k[:, lo:lo + kv_block], v[:, lo:lo + kv_block]
            s_ij = _grouped_scores(q_i, k_j).float() * scale
            if causal:
                s_ij = s_ij + causal_mask(q_block, kv_block,
                                          qi * q_block - lo, device=dev)
            m_new = torch.maximum(m, s_ij.amax(dim=-1))
            p_ij = torch.exp(s_ij - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_ij.sum(dim=-1)
            o = o * corr[..., None] + _grouped_pv(p_ij.to(q.dtype),
                                                  v_j).float()
            m = m_new
        out = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def _attend(cfg: ModelConfig, q, k, v, scale: float, causal: bool):
    """Full attention, or chunked above ``cfg.flash_threshold``."""
    s, sk = q.shape[1], k.shape[1]
    if s * sk > cfg.flash_threshold ** 2 and s > 1:
        return _attn_chunked(q, k, v, scale, causal, cfg.attn_q_block,
                             cfg.attn_kv_block)
    return _attn_full(q, k, v, scale, causal)


# ------------------------------------------------------------- cache writes
def _bytes(t: torch.Tensor) -> torch.Tensor:
    """An f8 tensor's bytes as uint8 (the same bits), so indexed writes
    never need an f8 kernel; other dtypes as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _write_rows(cache: torch.Tensor, new: torch.Tensor,
                cache_len: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Write new [B,C,Hkv,Dh] into cache [B,S,Hkv,Dh] in place, in the
    cache's dtype: per sequence at ``rows`` [B,C] for a [B] ``cache_len``;
    for a scalar one slice from cache_len, clamped into the cache as the
    reference's ``dynamic_update_slice`` clamps it."""
    b, c = new.shape[:2]
    dev = cache.device
    if cache_len.ndim == 0:
        start = cache_len.clamp(0, cache.shape[1] - c)
        rows = (start + torch.arange(c, device=dev)).expand(b, c)
    bi = torch.arange(b, device=dev)[:, None]
    _bytes(cache)[bi, rows] = _bytes(new.to(cache.dtype))
    return cache


def _lens(cache_len, b: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(cache_len as a tensor, its [B] broadcast)."""
    cl = torch.as_tensor(cache_len, device=dev)
    return cl, cl.expand(b) if cl.ndim == 0 else cl


# -------------------------------------------------------------------- public
def attn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True,
               n_heads: Optional[int] = None, n_kv: Optional[int] = None,
               kv_override: Optional[tuple] = None) -> torch.Tensor:
    """Full-sequence attention. Returns [B, S, D]. ``kv_override``
    (cross-attention K/V of the encdec family) is still to port."""
    h, hkv = _heads(cfg, n_heads, n_kv)
    if cfg.attention_kind == "qk_spiking":
        return _qk_spiking_apply(p, cfg, x, h, hkv)
    if kv_override is not None:
        raise NotImplementedError(
            "attention over external K/V (kv_override, the encdec "
            "family's cross-attention) is still to port (ROADMAP queue 1 "
            "item 4)")
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q, k, v = _project_qkv(p, cfg, x, positions, h, hkv)
    out = _attend(cfg, q, k, v, dh ** -0.5, causal)
    return dense_apply(p["wo"], out.reshape(b, s, h * dh))


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
    """Prefill: the attention output and this layer's cache entry, (k, v)
    [B,S,Hkv,Dh] after RoPE (empty under ``qk_spiking``)."""
    h, hkv = _heads(cfg, n_heads, n_kv)
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    if cfg.attention_kind == "qk_spiking":
        empty = torch.zeros((b, 0, hkv, dh), dtype=x.dtype, device=x.device)
        return _stateful(p, cfg, x, h, hkv, empty, empty)
    q, k, v = _project_qkv(p, cfg, x, positions, h, hkv)
    out = _attend(cfg, q, k, v, dh ** -0.5, True)
    return dense_apply(p["wo"], out.reshape(b, s, h * dh)), (k, v)


def attn_append(p: dict, cfg: ModelConfig, x: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                cache_len, *, n_heads: Optional[int] = None,
                n_kv: Optional[int] = None):
    """Chunked prefill: C new tokens x [B,C,D] against a cache entry
    [B,S_max,Hkv,Dh] whose first ``cache_len`` rows (scalar or [B]) are
    valid. The chunk's K/V rows are written at cache_len..cache_len+C-1
    and query i attends the cached prefix plus chunk positions <= i, with
    f32 scores as the blocking prefill's ``_attn_full`` takes them, so a
    prompt fed in chunks gives the blocking prefill's result (when the
    cache holds the compute dtype and the blocking pass stayed below
    ``flash_threshold``). The spiking path is token-local, so there the
    chunk is self-contained."""
    h, hkv = _heads(cfg, n_heads, n_kv)
    if cfg.attention_kind == "qk_spiking":
        return _stateful(p, cfg, x, h, hkv, cache_k, cache_v)
    b, c, _ = x.shape
    dh = cfg.resolved_head_dim
    dev = x.device
    cl, lens = _lens(cache_len, b, dev)
    positions = lens[:, None] + torch.arange(c, device=dev)[None, :]
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, h, hkv)
    k = _write_rows(cache_k, k_new, cl, positions)
    v = _write_rows(cache_v, v_new, cl, positions)
    scores = _grouped_scores(q.float(), k.to(q.dtype).float()) * dh ** -0.5
    # query i (absolute position lens + i) sees key j iff j <= lens + i
    ki = torch.arange(k.shape[1], device=dev)[None, None, :]
    valid = ki <= positions[:, :, None]                      # [B,C,S]
    scores = torch.where(valid[:, None], scores, NEG)
    w = softmax(scores).to(q.dtype)
    out = _grouped_pv(w, v.to(q.dtype))
    return dense_apply(p["wo"], _merge_heads(out)), (k, v)


def attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                pos: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, cache_len, *,
                n_heads: Optional[int] = None, n_kv: Optional[int] = None):
    """One-token decode. x: [B, 1, D]; cache_[kv]: [B, S_max, Hkv, Dh];
    cache_len: a scalar or the [B] vector of per-sequence valid lengths
    (the engine's slot pool), the new token's row. Scores are rounded to
    the activation dtype and then widened, as the reference's are."""
    h, hkv = _heads(cfg, n_heads, n_kv)
    if cfg.attention_kind == "qk_spiking":
        return _stateful(p, cfg, x, h, hkv, cache_k, cache_v)
    if cfg.decode_cp_axis:
        raise NotImplementedError(
            "context-parallel decode over a sequence-sharded KV cache "
            f"(decode_cp_axis={cfg.decode_cp_axis!r}) is still to port "
            "(ROADMAP queue 1 item 6)")
    b = x.shape[0]
    dh = cfg.resolved_head_dim
    dev = x.device
    cl, lens = _lens(cache_len, b, dev)
    pos = torch.as_tensor(pos, device=dev)
    if pos.ndim == 0:
        positions = pos.expand(b)[:, None]
    elif pos.ndim == 1:
        positions = lens[:, None]
    else:
        positions = pos
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, h, hkv)
    k = _write_rows(cache_k, k_new, cl, lens[:, None])
    v = _write_rows(cache_v, v_new, cl, lens[:, None])
    scores = _grouped_scores(q, k.to(q.dtype)).float() * dh ** -0.5
    valid = torch.arange(k.shape[1], device=dev)[None, :] <= lens[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG)
    w = softmax(scores)
    out = _grouped_pv(w.to(q.dtype), v.to(q.dtype))
    return dense_apply(p["wo"], _merge_heads(out)), (k, v)


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
