"""Plain softmax attention (twin of the reference's ``ref.py``): the naive
masked softmax in f32, which is also the flash kernel's plain version."""
from __future__ import annotations

import torch

from ...core.softmax import softmax


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: float = 1.0) -> torch.Tensor:
    """q, k, v [BH, S, D] -> [BH, S, D] in q's dtype: scores, weights and
    the weighted sum in f32; masked scores -1e30."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        n = q.shape[1]
        mask = torch.tril(torch.ones((n, k.shape[1]), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, -1e30)
    w = softmax(s)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q [B,S,H,D], k and v [B,S,Hkv,D] (Hkv divides H) -> [B,S,H,D]:
    K and V repeated to H heads, then ``flash_attention_ref`` at scale
    D**-0.5, as the reference's ``("attention", "reference")`` runs it."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)

    def heads_first(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], d)

    out = flash_attention_ref(heads_first(q), heads_first(k), heads_first(v),
                              causal=causal, scale=d ** -0.5)
    return out.reshape(b, h, s, d).transpose(1, 2)


def flash_tile_twin(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, rows: int = 128,
                    keys: int = 64) -> torch.Tensor:
    """The scalar route's blocking order in plain torch on q [B,S,H,D], k
    and v [B,S,Hkv,D] (f32 or bf16, widened): q times D**-0.5 in f32 first;
    per q tile of ``rows`` rows (``ops.flash_plan``), key tiles of ``keys``
    in order (causal: up to the tile's last row), masked scores -1e30,
    m_new = max(m, the tile's row max), p = exp(s - m_new), l = l * corr +
    the tile's sum of p, acc = acc * corr + p v; out = acc / max(l, 1e-30).
    Returns the f32 output [B,S,H,D] (the kernel's before its rounding to
    q's dtype; its sums within a tile run in another order)."""
    b, s_len, h, d = q.shape
    g = h // k.shape[2]

    def heads(t, rep):
        t = t.float().repeat_interleave(rep, dim=2)
        return t.transpose(1, 2).reshape(b * h, s_len, d)

    qh = heads(q, 1) * torch.tensor(d ** -0.5, dtype=torch.float32)
    kh, vh = heads(k, g), heads(v, g)
    out = torch.empty((b * h, s_len, d), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, s_len, rows):
        r = torch.arange(q0, min(s_len, q0 + rows), device=q.device)
        m = torch.full((b * h, len(r)), -1e30, device=q.device)
        l = torch.zeros((b * h, len(r)), device=q.device)
        acc = torch.zeros((b * h, len(r), d), device=q.device)
        stop = min(s_len, q0 + rows) if causal else s_len
        for k0 in range(0, stop, keys):
            kk = torch.arange(k0, min(s_len, k0 + keys), device=q.device)
            sc = torch.einsum("bqd,bkd->bqk", qh[:, r], kh[:, kk])
            if causal:
                sc = torch.where(kk[None, None] > r[None, :, None],
                                 torch.tensor(-1e30, device=q.device), sc)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bqk,bkd->bqd", p,
                                                       vh[:, kk])
            m = m_new
        out[:, r] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, s_len, d).transpose(1, 2)


def split_bf16x3(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """f32 p as three bf16 terms, each rounded to nearest from what the
    terms before it leave (the differences are exact in f32): the split the
    wgmma route makes of its weights before PV. p1 + p2 + p3 == p wherever
    the pieces stay in bf16's normal range (p >= 2**-100 or so)."""
    p1 = p.to(torch.bfloat16)
    r = p - p1.float()
    p2 = r.to(torch.bfloat16)
    p3 = (r - p2.float()).to(torch.bfloat16)
    return p1, p2, p3
