"""Wrapper for the flash attention kernels, the twin of the reference's
``flash_attention``: causal or full softmax attention over [B, S, H, D] q
with grouped K and V [B, S, Hkv, D]. The kernels on CUDA tensors, the
plain version (``attention_ref``) on CPU tensors.

Two routes (``pick_route``): ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``)
for bf16 at D 32, 64 or 128, QK^T and an exact three-term PV on the tensor
cores fed by TMA; ``"scalar"`` (``csrc/flash_attention.cu``) for f32 and
for bf16 at any other D, IEEE f32 FMAs. Both compute the reference's
function (f32 scores, f32 weights p, f32 sums).

The contract is the reference wrapper's: scale D**-0.5, the output in q's
dtype, and a sequence that does not divide into the blocks padded only
when causal (the pad keys lie after every real query); a non-causal call
with such a sequence raises ``ValueError``. ``q_block`` and ``kv_block``
are taken for the reference's signature and decide that check only: the
kernels' tiles are their own, they mask a ragged sequence themselves,
which for the real rows is the reference's padding, and they read each
query head's KV head in place instead of repeating K and V.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .ref import attention_ref

MAX_HEAD_DIM = 128
WGMMA_HEAD_DIMS = (32, 64, 128)
ROUTES = ("wgmma", "scalar")
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


def pick_route(q: torch.Tensor) -> str:
    """``"wgmma"`` for bf16 q at a head dim of 32, 64 or 128, else
    ``"scalar"``."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "scalar"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, *,
                         route: Optional[str] = None) -> torch.Tensor:
    """Launch a kernel on contiguous CUDA tensors of one dtype (f32 or
    bf16): q [B,S,H,D], k and v [B,S,Hkv,D], D <= 128. ``route`` defaults
    to ``pick_route(q)``; ``"wgmma"`` takes bf16 at D 32, 64 or 128 only.
    Does not count."""
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
    route = pick_route(q) if route is None else route
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    if route == "wgmma" and pick_route(q) != "wgmma":
        raise ValueError(f"the wgmma route takes bf16 at D in "
                         f"{WGMMA_HEAD_DIMS}, got {q.dtype} at D {d}")
    if route == "scalar" and b * h > 65535:
        raise ValueError(f"B * H = {b * h} > 65535 (the grid's y extent)")
    align = 16 if route == "wgmma" else q.element_size()
    _build.require(q, "q", q.dtype, (b, s, h, d), dev, align=align)
    _build.require(k, "k", q.dtype, (b, s, hkv, d), dev, align=align)
    _build.require(v, "v", q.dtype, (b, s, hkv, d), dev, align=align)
    out = torch.empty_like(q)
    lib = _build.library()
    if route == "wgmma":
        err = lib.repro_flash_attention_wgmma(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), b,
            s, h, hkv, d, float(d ** -0.5), int(causal), _build.stream(q))
        _build.check(err, "repro_flash_attention_wgmma")
        return out
    err = lib.repro_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), b, s,
        h, hkv, d, float(d ** -0.5), int(causal), _DTYPES[q.dtype],
        _build.stream(q))
    _build.check(err, "repro_flash_attention")
    return out


def wgmma_tile_cuda(a: torch.Tensor, b: torch.Tensor,
                    p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One tile's product through the wgmma route's own shared-memory
    layouts and descriptors, for testing them: with ``p`` None, a [64, D]
    times b [64, D] transposed (QK^T's wgmmas) -> [64, 64] f32; else p
    [64, 64] f32, split in three bf16 terms, times b [64, D] (PV's) ->
    [64, D] f32. a and b bf16, D 32, 64 or 128, on the card."""
    d = b.shape[1]
    dev = b.device
    if dev.type != "cuda":
        raise ValueError(f"wgmma_tile_cuda needs CUDA tensors, got {dev}")
    if d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"D {d} is not one of {WGMMA_HEAD_DIMS}")
    for t, name in ((a, "a"), (b, "b")):
        _build.require(t, name, torch.bfloat16, (64, d), dev)
    if p is not None:
        _build.require(p, "p", torch.float32, (64, 64), dev)
    out = torch.empty((64, 64 if p is None else d), dtype=torch.float32,
                      device=dev)
    err = _build.library().repro_wgmma_probe(
        _build.ptr(a), _build.ptr(b), _build.ptr(p), _build.ptr(out), d,
        0 if p is None else 1, _build.stream(b))
    _build.check(err, "repro_wgmma_probe")
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
    route = pick_route(q)
    _build.count_launch("flash_attention", args, (q, k, v), route=route)
    return flash_attention_cuda(*args, route=route)
