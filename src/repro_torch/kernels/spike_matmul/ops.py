"""Wrapper for the event-driven spike matmul kernel (``csrc/spike_matmul.cu``):
padding, the ``vld_cnt`` map, checks, and the device split."""
from __future__ import annotations

from typing import Optional

import torch

from ...core.events import pad_to_blocks, vld_or_compute
from .. import _build
from .ref import spike_matmul_block_ref

TILE = 128          # the kernel's CTA tile == the metadata block


def spike_matmul_cuda(xp: torch.Tensor, wp: torch.Tensor,
                      vld: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on block-aligned CUDA operands (see
    ``spike_matmul_block_ref`` for the contract). Does not count."""
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul_cuda needs CUDA tensors, got {dev}")
    mp, kp = xp.shape
    np_ = wp.shape[1]
    if mp % TILE or kp % TILE or np_ % TILE:
        raise ValueError(f"operands must be {TILE}-aligned: x {tuple(xp.shape)}"
                         f", w {tuple(wp.shape)}")
    _build.require(xp, "x", torch.int8, (mp, kp), dev)
    _build.require(wp, "w", torch.float32, (kp, np_), dev)
    _build.require(vld, "vld_cnt", torch.int32, (mp // TILE, kp // TILE), dev,
                   align=4)
    out = torch.empty((mp, np_), dtype=torch.float32, device=dev)
    err = _build.library().repro_spike_matmul(
        _build.ptr(xp), _build.ptr(wp), _build.ptr(vld), _build.ptr(out),
        mp, kp, np_, _build.stream(xp))
    _build.check(err, "repro_spike_matmul")
    return out


def spike_matmul_operands(x: torch.Tensor, w: torch.Tensor,
                          vld_cnt: Optional[torch.Tensor] = None) -> tuple:
    """The block-aligned operands of one launch (x int8, w f32, vld), in
    the order ``spike_matmul_cuda`` and ``spike_matmul_block_ref`` take
    them. x is cast to int8, as the reference wrapper casts it."""
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    xp = pad_to_blocks(x.to(torch.int8), TILE, TILE).contiguous()
    wp = pad_to_blocks(w.to(torch.float32), TILE, TILE).contiguous()
    vld = vld_or_compute(xp, vld_cnt, TILE, TILE).contiguous()
    return xp, wp, vld


def spike_matmul(x: torch.Tensor, w: torch.Tensor, *,
                 vld_cnt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Event-driven spike matmul: x [M, K] spikes @ w [K, N] -> f32
    [M, N], tiled on 128x128 blocks. ``vld_cnt`` is the [Mp/128, Kp/128]
    count map of x (a fused layer's ``vld_next``); it is computed here when
    not given. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    args = spike_matmul_operands(x, w, vld_cnt)
    dev = x.device
    if dev.type == "cpu":
        out = spike_matmul_block_ref(*args)
    elif dev.type == "cuda":
        _build.count_launch("spike_matmul", args, (x, w))
        out = spike_matmul_cuda(*args)
    else:
        raise ValueError(f"spike_matmul runs on cuda or cpu, not {dev}")
    return out[:x.shape[0], :w.shape[1]]
