"""Wrapper for the event-driven spike matmul kernel (``csrc/spike_matmul.cu``):
padding, the ``vld_cnt`` map, checks, and the device split. x is an int8
spike map or a ``PackedSpikes`` (the kernel's packed_in variant)."""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ...core.events import (LANE_BITS, PackedSpikes, pad_to_blocks,
                            vld_or_compute)
from .. import _build
from .ref import spike_matmul_block_ref

TILE = 128          # the kernel's CTA tile == the metadata block


def check_block_contract(ps: PackedSpikes, block_m: int, block_k: int,
                         what: str = "packed operand") -> None:
    """A PackedSpikes pins its tile grid when it is packed; the kernel
    must tile the same way, or its vld_cnt and occ maps route nothing."""
    if (ps.block_m, ps.block_k) != (block_m, block_k):
        raise ValueError(
            f"{what} was packed on (block_m={ps.block_m}, "
            f"block_k={ps.block_k}) but the kernel tiles on "
            f"(block_m={block_m}, block_k={block_k}); re-pack it")


def packed_operand(ps: PackedSpikes, vld_cnt: Optional[torch.Tensor],
                   what: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The words and vld map of a 2-D packed x, checked against the grid."""
    check_block_contract(ps, TILE, TILE, what)
    if len(ps.shape) != 2:
        raise ValueError(f"{what} must be a 2-D packed operand, got logical "
                         f"shape {tuple(ps.shape)}")
    words = ps.words.contiguous()
    vld = ps.vld_cnt if vld_cnt is None else vld_cnt
    expect = (words.shape[0] // TILE, words.shape[1] * LANE_BITS // TILE)
    if tuple(vld.shape) != expect:
        raise ValueError(f"{what}: vld_cnt grid {tuple(vld.shape)} does not "
                         f"match its words' {expect}")
    return words, vld.to(torch.int32).contiguous()


def weight_operand(w: torch.Tensor, kp: int) -> torch.Tensor:
    """w [K, N] -> f32 [Kp, Np], zero rows up to the operand's padded K."""
    wp = pad_to_blocks(w.to(torch.float32), TILE, TILE)
    if wp.shape[0] < kp:
        wp = F.pad(wp, (0, 0, 0, kp - wp.shape[0]))
    return wp.contiguous()


def spike_matmul_cuda(xp: torch.Tensor, wp: torch.Tensor,
                      vld: torch.Tensor, packed_x: bool = False
                      ) -> torch.Tensor:
    """Launch the kernel on block-aligned CUDA operands (see
    ``spike_matmul_block_ref`` for the contract). Does not count."""
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul_cuda needs CUDA tensors, got {dev}")
    mp, kp = xp.shape[0], wp.shape[0]
    np_ = wp.shape[1]
    if mp % TILE or kp % TILE or np_ % TILE:
        raise ValueError(f"operands must be {TILE}-aligned: x {tuple(xp.shape)}"
                         f", w {tuple(wp.shape)}")
    if packed_x:
        _build.require(xp, "x", torch.int32, (mp, kp // LANE_BITS), dev)
    else:
        _build.require(xp, "x", torch.int8, (mp, kp), dev)
    _build.require(wp, "w", torch.float32, (kp, np_), dev)
    _build.require(vld, "vld_cnt", torch.int32, (mp // TILE, kp // TILE), dev,
                   align=4)
    out = torch.empty((mp, np_), dtype=torch.float32, device=dev)
    err = _build.library().repro_spike_matmul(
        _build.ptr(xp), _build.ptr(wp), _build.ptr(vld), _build.ptr(out),
        mp, kp, np_, int(packed_x), _build.stream(xp))
    _build.check(err, "repro_spike_matmul")
    return out


def spike_matmul_operands(x: Union[torch.Tensor, PackedSpikes],
                          w: torch.Tensor,
                          vld_cnt: Optional[torch.Tensor] = None) -> tuple:
    """The block-aligned operands of one launch (x, w f32, vld, packed_x),
    in the order ``spike_matmul_cuda`` and ``spike_matmul_block_ref`` take
    them. A dense x is cast to int8, as the reference wrapper casts it; a
    packed x brings its words and vld map, and w gets zero rows up to the
    words' padded K."""
    packed = isinstance(x, PackedSpikes)
    k0 = x.shape[-1]
    if w.shape[0] != k0:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    if packed:
        xp, vld = packed_operand(x, vld_cnt, "spike_matmul x")
        return xp, weight_operand(w, xp.shape[1] * LANE_BITS), vld, True
    xp = pad_to_blocks(x.to(torch.int8), TILE, TILE).contiguous()
    vld = vld_or_compute(xp, vld_cnt, TILE, TILE).contiguous()
    return xp, weight_operand(w, xp.shape[1]), vld, False


def spike_matmul(x: Union[torch.Tensor, PackedSpikes], w: torch.Tensor, *,
                 vld_cnt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Event-driven spike matmul: x [M, K] spikes (or a 2-D PackedSpikes)
    @ w [K, N] -> f32 [M, N], tiled on 128x128 blocks. ``vld_cnt`` is the
    [Mp/128, Kp/128] count map of x (a fused layer's ``vld_next``); a dense
    x without one gets it computed here, a packed x carries its own. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    args = spike_matmul_operands(x, w, vld_cnt)
    dev = args[0].device
    if dev.type == "cpu":
        out = spike_matmul_block_ref(*args)
    elif dev.type == "cuda":
        _build.count_launch("spike_matmul", args, (x, w))
        out = spike_matmul_cuda(*args)
    else:
        raise ValueError(f"spike_matmul runs on cuda or cpu, not {dev}")
    return out[:x.shape[-2], :w.shape[1]]
