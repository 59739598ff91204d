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
