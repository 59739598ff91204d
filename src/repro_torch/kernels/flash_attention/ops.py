"""Wrapper for the flash attention kernel (``csrc/flash_attention.cu``),
the twin of the reference's ``flash_attention``: causal or full softmax
attention over [B, S, H, D] q with grouped K and V [B, S, Hkv, D]. The
kernel on CUDA tensors, the plain version (``attention_ref``) on CPU
tensors.

The contract is the reference wrapper's: scale D**-0.5, the output in q's
dtype, and a sequence that does not divide into the blocks padded only
when causal (the pad keys lie after every real query); a non-causal call
with such a sequence raises ``ValueError``. ``q_block`` and ``kv_block``
are taken for the reference's signature and decide that check only: the
kernel's tile is its own (64 query rows by 64 keys), it masks a ragged
sequence itself, which for the real rows is the reference's padding, and
it reads each query head's KV head in place instead of repeating K and V.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import attention_ref

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,S,H,D] and k, v [B,S,Hkv,D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{k.shape[2]} kv heads do not divide {h} heads")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA tensors of one dtype (f32 or
    bf16): q [B,S,H,D], k and v [B,S,Hkv,D], D <= 128. Does not count."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes f32 or bf16, got {q.dtype}")
    _check(q, k, v)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}: the kernel keeps "
                         f"a row of up to {MAX_HEAD_DIM} columns a tile")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} > 65535 (the grid's y extent)")
    align = q.element_size()
    _build.require(q, "q", q.dtype, (b, s, h, d), dev, align=align)
    _build.require(k, "k", q.dtype, (b, s, hkv, d), dev, align=align)
    _build.require(v, "v", q.dtype, (b, s, hkv, d), dev, align=align)
    out = torch.empty_like(q)
    err = _build.library().repro_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), b, s,
        h, hkv, d, float(d ** -0.5), int(causal), _DTYPES[q.dtype],
        _build.stream(q))
    _build.check(err, "repro_flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_block: int = 512, kv_block: int = 512,
                    causal: bool = True) -> torch.Tensor:
    """q [B,S,H,D]; k, v [B,S,Hkv,D] (GQA: Hkv divides H) -> [B,S,H,D] in
    q's dtype."""
    _check(q, k, v)
    s = q.shape[1]
    pad = (-s) % max(min(q_block, s), min(kv_block, s))
    if pad and not causal:
        raise ValueError(f"non-causal flash attention needs a sequence that "
                         f"divides into its blocks ({s}, q_block {q_block}, "
                         f"kv_block {kv_block})")
    dev = q.device
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    args = (q.contiguous(), k.contiguous(), v.contiguous(), causal)
    _build.count_launch("flash_attention", args, (q, k, v))
    return flash_attention_cuda(*args)
