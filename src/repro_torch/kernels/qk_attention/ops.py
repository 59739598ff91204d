"""Wrapper for the QKFormer token-attention kernel (``csrc/qk_attention.cu``),
the twin of the reference's ``qk_attention_fused``: per token row of
[..., N, D] spikes, keep K's row where Q's row sum reaches the threshold.
The kernel on CUDA tensors, the plain version on CPU tensors."""
from __future__ import annotations

import torch

from .. import _build
from ..contract import KernelContract, declare
from .ref import qk_attention_ref

CONTRACT = declare(KernelContract(
    family="qk_attention", ops=("qk_mask",), grad=True, emits_spikes=True,
    # one row a warp: csrc/qk_attention.cu declares no shared memory
    smem_bytes=lambda bm, bn, bk, packed: 0))

_DTYPES = {torch.float32: 0, torch.int8: 1}


def qk_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                      threshold: float = 1.0) -> torch.Tensor:
    """Launch the kernel on contiguous [rows, D] CUDA tensors of one dtype
    (f32 or int8). Returns the masked k. Does not count."""
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"qk_attention_cuda needs CUDA tensors, got {dev}")
    if k.dtype not in _DTYPES:
        raise TypeError(f"qk_attention takes f32 or int8 spikes, got {k.dtype}")
    rows, d = k.shape
    align = k.element_size()
    _build.require(q, "q", k.dtype, (rows, d), dev, align=align)
    _build.require(k, "k", k.dtype, (rows, d), dev, align=align)
    out = torch.empty_like(k)
    err = _build.library().repro_qk_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(out), rows, d,
        float(threshold), _DTYPES[k.dtype], _build.stream(k))
    _build.check(err, "repro_qk_attention")
    return out


def qk_attention_fused(q: torch.Tensor, k: torch.Tensor, *,
                       threshold: float = 1.0) -> torch.Tensor:
    """q, k [..., N, D] spikes -> masked k [..., N, D] in k's dtype. q is
    cast to k's dtype (exact on spike counts)."""
    if q.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ")
    dev = k.device
    if dev.type == "cpu":
        return qk_attention_ref(q, k, threshold=threshold)
    if dev.type != "cuda":
        raise ValueError(f"qk_attention runs on cuda or cpu, not {dev}")
    d = k.shape[-1]
    args = (q.to(k.dtype).reshape(-1, d).contiguous(),
            k.reshape(-1, d).contiguous(), threshold)
    _build.count_launch("qk_attention", args, (q, k))
    return qk_attention_cuda(*args).reshape(k.shape)
