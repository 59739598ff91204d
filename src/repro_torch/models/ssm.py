"""Mamba2 layer (twin of ``repro.models.ssm``): the SSD algorithm of
state-space duality (arXiv:2405.21060).

Chunked SSD: inside a chunk of ``cfg.ssm_chunk`` tokens the work is
attention-like (dense products), across chunks a short sequential
recurrence carries the [B, H, P, N] state; a Python loop over the chunks
takes the place of the reference's ``lax.scan``. A sequence whose length
is no multiple of the chunk ends in a shorter remainder chunk (exact, no
padding), as the reference runs it. Decode is O(1) a token: a per-layer
state {"ssm": [B, H, P, N] f32, "conv": [B, K-1, C] in the activation
dtype} replaces the KV cache.

Spiking mode (the paper's C3) replaces the SiLU of the conv branch by a
LIF spike, so xBC becomes a binary event stream.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import (dense_apply, dense_init, maybe_spike,
                     rmsnorm_gated_apply, rmsnorm_init, silu)


def ssm_dims(cfg: ModelConfig, d_model: Optional[int] = None):
    """(d, d_inner, heads, groups, state, conv channels)."""
    d = d_model or cfg.d_model
    d_inner = cfg.ssm_expand * d
    nheads = d_inner // cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = d_inner + 2 * g * n
    return d, d_inner, nheads, g, n, conv_dim


def mamba_init(gen: torch.Generator, cfg: ModelConfig,
               d_model: Optional[int] = None) -> dict:
    d, d_inner, h, g, n, conv_dim = ssm_dims(cfg, d_model)
    dev = gen.device
    d_in_proj = 2 * d_inner + 2 * g * n + h
    in_proj = dense_init(gen, d, d_in_proj, dtype=cfg.param_dtype)
    conv_w = (torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                          device=dev) * 0.02).to(cfg.param_dtype)
    u = torch.rand((h,), generator=gen, device=dev)
    lo, hi = torch.log(torch.tensor(0.001)), torch.log(torch.tensor(0.1))
    dt = torch.clamp(torch.exp(u * (hi - lo) + lo), min=1e-4)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.param_dtype,
                              device=dev),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),     # inverse softplus
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_inner, cfg.param_dtype, dev),
        "out_proj": dense_init(gen, d_inner, d, dtype=cfg.param_dtype),
    }


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, g: int, n: int):
    """The in-projection -> (z, xBC, dt)."""
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * g * n, zxbcdt.shape[-1]
                                - 2 * d_inner - 2 * g * n], dim=-1)


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return maybe_spike(x, True, cfg.lif) if cfg.spiking else silu(x)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cfg: ModelConfig,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time, then the activation. xbc [B,S,C],
    w [K,C]. ``tail`` [B, K-1, C] holds the previous chunk's last K-1
    pre-conv inputs (chunked prefill); None is a sequence start (zero
    history). K shifted adds, in xbc's dtype, in the reference's order."""
    k = w.shape[0]
    s = xbc.shape[1]
    if tail is None:
        pad = F.pad(xbc, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    wc = w.to(xbc.dtype)
    out = pad[:, 0:s, :] * wc[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s, :] * wc[i]
    return _act(cfg, out + b.to(out.dtype))


def _ssd_chunked(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor] = None):
    """Chunked SSD over S = n * chunk tokens, one chunk at a time carrying
    the [B,H,P,N] f32 state.

    xs [B,S,H,P]; dt [B,S,H] (after softplus); A [H] (negative); Bm, Cm
    [B,S,G,N]. Returns (y [B,S,H,P] f32, the final state)."""
    b, s, h, p = xs.shape
    g, n = Bm.shape[-2:]
    if s % chunk:
        raise ValueError(f"sequence {s} is no multiple of the chunk {chunk}")
    hg = h // g                                       # heads per B/C group
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xs.device))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xs.device)
             if init_state is None else init_state.to(torch.float32))
    ys = []
    for lo in range(0, s, chunk):
        x_i = xs[:, lo:lo + chunk].to(torch.float32)      # [b,q,h,p]
        dt_i = dt[:, lo:lo + chunk]                       # [b,q,h]
        B_i = Bm[:, lo:lo + chunk].to(torch.float32)      # [b,q,g,n]
        C_i = Cm[:, lo:lo + chunk].to(torch.float32)
        dA_cs = torch.cumsum(dt_i * A, dim=1)             # [b,q,h]
        # intra-chunk: L[i,j] = exp(dA_cs[i] - dA_cs[j]) for i >= j
        li = dA_cs[:, :, None, :] - dA_cs[:, None, :, :]  # [b,i,j,h]
        L = torch.exp(torch.where(mask[None, :, :, None], li,
                                  float("-inf")))
        scores = torch.einsum("bign,bjgn->bijg", C_i, B_i)
        dx = dt_i[..., None] * x_i                        # [b,q,h,p]
        Lg = L.reshape(b, chunk, chunk, g, hg)
        dxg = dx.reshape(b, chunk, g, hg, p)
        y_intra = torch.einsum("bijgr,bijg,bjgrp->bigrp", Lg, scores, dxg)
        # inter-chunk: the incoming state's contribution
        stg = state.reshape(b, g, hg, p, n)
        y_inter = torch.einsum("bqgn,bghpn->bqghp", C_i, stg)
        y_inter = y_inter * torch.exp(dA_cs).reshape(b, chunk, g, hg)[..., None]
        # state update
        seg_end = dA_cs[:, -1:, :]                        # [b,1,h]
        decay_to_end = torch.exp(seg_end - dA_cs)         # [b,q,h]
        wdx = (dx * decay_to_end[..., None]).reshape(b, chunk, g, hg, p)
        new_state = torch.einsum("bqgn,bqghp->bghpn", B_i, wdx).reshape(
            b, h, p, n)
        state = state * torch.exp(seg_end[:, 0, :])[..., None, None] \
            + new_state
        ys.append((y_intra + y_inter).reshape(b, chunk, h, p))
    return torch.cat(ys, dim=1), state


def mamba_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                d_model: Optional[int] = None,
                init_state: Optional[dict] = None,
                return_state: bool = False):
    """Whole-sequence forward. x [B,S,D] -> y [B,S,D], and with
    ``return_state`` the state after the last token ({"ssm" f32, "conv":
    the last K-1 pre-conv inputs in x's dtype}). ``init_state`` continues
    from an earlier chunk's state."""
    d, d_inner, h, g, n, conv_dim = ssm_dims(cfg, d_model)
    b, s, _ = x.shape
    z, xbc_raw, dt_raw = _split_proj(dense_apply(p["in_proj"], x),
                                     d_inner, g, n)
    conv_tail = None if init_state is None else init_state["conv"]
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"], cfg,
                       tail=conv_tail)
    xs, Bm, Cm = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(b, s, h, cfg.ssm_headdim)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    chunk = min(cfg.ssm_chunk, s)
    s0 = (s // chunk) * chunk
    st = None if init_state is None else init_state["ssm"]
    parts = []
    if s0:
        y0, st = _ssd_chunked(xs[:, :s0], dt[:, :s0], A, Bm[:, :s0],
                              Cm[:, :s0], chunk, st)
        parts.append(y0)
    if s0 < s:                      # remainder chunk (exact, no padding)
        y1, st = _ssd_chunked(xs[:, s0:], dt[:, s0:], A, Bm[:, s0:],
                              Cm[:, s0:], s - s0, st)
        parts.append(y1)
    y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    y = y + p["D"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rmsnorm_gated_apply(p["norm"], y, z, cfg.rms_eps)
    out = dense_apply(p["out_proj"], y)
    if not return_state:
        return out
    # conv state = the last K-1 pre-conv inputs; the history (the incoming
    # tail, or zeros at a sequence start) covers chunks shorter than K-1
    k1 = cfg.ssm_conv - 1
    hist = (torch.zeros((b, k1, xbc_raw.shape[-1]), dtype=x.dtype,
                        device=x.device)
            if conv_tail is None else conv_tail.to(x.dtype))
    tail = torch.cat([hist, xbc_raw], dim=1)[:, -k1:, :]
    return out, {"ssm": st.to(torch.float32), "conv": tail}


def mamba_init_state(cfg: ModelConfig, batch: int,
                     d_model: Optional[int] = None,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> dict:
    """Zero state: "ssm" [B,H,P,N] f32 and "conv" [B,K-1,C] in ``dtype``."""
    d, d_inner, h, g, n, conv_dim = ssm_dims(cfg, d_model)
    return {
        "ssm": torch.zeros((batch, h, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def mamba_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      state: dict, d_model: Optional[int] = None):
    """One token. x [B,1,D]; state {"ssm": [B,H,P,N], "conv": [B,K-1,C]}
    -> (y [B,1,D], the new state)."""
    d, d_inner, h, g, n, conv_dim = ssm_dims(cfg, d_model)
    b = x.shape[0]
    z, xbc_new, dt_raw = _split_proj(dense_apply(p["in_proj"], x[:, 0, :]),
                                     d_inner, g, n)
    # the conv window: the state's K-1 inputs, then this token's
    window = torch.cat([state["conv"].to(x.dtype), xbc_new[:, None, :]],
                       dim=1)                                   # [B,K,C]
    wc = p["conv_w"].to(x.dtype)
    conv_out = torch.einsum("bkc,kc->bc", window, wc)
    xbc = _act(cfg, conv_out + p["conv_b"].to(conv_out.dtype))
    new_conv = window[:, 1:, :]

    xs, Bm, Cm = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(b, h, cfg.ssm_headdim).to(torch.float32)
    Bm = Bm.reshape(b, g, n).to(torch.float32)
    Cm = Cm.reshape(b, g, n).to(torch.float32)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])   # [B,H]
    A = -torch.exp(p["A_log"])
    hg = h // g
    decay = torch.exp(dt * A)[..., None, None]                 # [B,H,1,1]
    Bh = torch.repeat_interleave(Bm, hg, dim=-2)               # [B,H,N]
    Ch = torch.repeat_interleave(Cm, hg, dim=-2)
    upd = (dt[..., None] * xs)[..., :, None] * Bh[:, :, None, :]
    new_ssm = state["ssm"] * decay + upd                       # [B,H,P,N]
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, Ch)
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rmsnorm_gated_apply(p["norm"], y, z, cfg.rms_eps)
    out = dense_apply(p["out_proj"], y)[:, None, :]
    return out, {"ssm": new_ssm, "conv": new_conv}
