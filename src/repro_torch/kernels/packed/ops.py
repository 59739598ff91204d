"""Wrappers for the pack and unpack kernels (``csrc/pack_spikes.cu``,
``csrc/unpack_spikes.cu``): leading dims, padding to the block grid,
checks, and the device split.

``pack_spikes``   — spikes [..., M, K] -> PackedSpikes (words, vld_cnt and
                    occ from one pass).
``unpack_spikes`` — PackedSpikes -> dense int8 at the logical shape.
"""
from __future__ import annotations

import torch

from ...core.events import LANE_BITS, PackedSpikes
from .. import _build
from ..spike_matmul.ops import TILE
from .ref import pack_spikes_ref, unpack_spikes_ref


def _padded(n: int) -> int:
    return -(-n // TILE) * TILE


def pack_spikes_cuda(x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the pack kernel on int8 CUDA spikes [nb, m, k] (unpadded).
    Returns (words [nb, mp, kp/32], vld_cnt and occ [nb, mp/128, kp/128])
    with mp, kp the 128-padded extents. Does not count."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"pack_spikes_cuda needs CUDA tensors, got {dev}")
    nb, m, k = x.shape
    _build.require(x, "x", torch.int8, (nb, m, k), dev, align=1)
    mp, kp = _padded(m), _padded(k)
    words = torch.empty((nb, mp, kp // LANE_BITS), dtype=torch.int32,
                        device=dev)
    vld = torch.empty((nb, mp // TILE, kp // TILE), dtype=torch.int32,
                      device=dev)
    occ = torch.empty_like(vld)
    err = _build.library().repro_pack_spikes(
        _build.ptr(x), _build.ptr(words), _build.ptr(vld), _build.ptr(occ),
        nb, m, k, mp, kp, _build.stream(x))
    _build.check(err, "repro_pack_spikes")
    return words, vld, occ


def pack_spikes(x: torch.Tensor, *, block_m: int = TILE,
                block_k: int = TILE) -> PackedSpikes:
    """Compress spikes [..., M, K] (nonzero == event) into the packed
    format: core dims padded to the block grid, 32 spikes per int32 word,
    and the block ``vld_cnt`` and ``occ`` maps, all from one pass. The
    kernel on CUDA tensors (128x128 blocks), the plain version on CPU
    tensors."""
    dev = x.device
    if dev.type == "cpu":
        return pack_spikes_ref(x, block_m=block_m, block_k=block_k,
                               with_occ=True)
    if dev.type != "cuda":
        raise ValueError(f"pack_spikes runs on cuda or cpu, not {dev}")
    if (block_m, block_k) != (TILE, TILE):
        raise ValueError(f"the pack kernel tiles on ({TILE}, {TILE}); got "
                         f"(block_m={block_m}, block_k={block_k})")
    *lead, m, k = x.shape
    x8 = x if x.dtype == torch.int8 else (x != 0).to(torch.int8)
    x3 = x8.reshape(-1, m, k).contiguous()
    _build.count_launch("pack_spikes", (x3,), (x,))
    words, vld, occ = pack_spikes_cuda(x3)
    return PackedSpikes(words.reshape(*lead, *words.shape[1:]),
                        vld.reshape(*lead, *vld.shape[1:]), tuple(x.shape),
                        TILE, TILE, occ.reshape(*lead, *occ.shape[1:]))


def unpack_spikes_cuda(words: torch.Tensor) -> torch.Tensor:
    """Launch the unpack kernel on int32 CUDA words [..., W]. Returns the
    int8 0/1 map [..., W*32]. Does not count."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"unpack_spikes_cuda needs CUDA tensors, got {dev}")
    _build.require(words, "words", torch.int32, tuple(words.shape), dev,
                   align=4)
    out = torch.empty((*words.shape[:-1], words.shape[-1] * LANE_BITS),
                      dtype=torch.int8, device=dev)
    err = _build.library().repro_unpack_spikes(
        _build.ptr(words), _build.ptr(out), words.numel(),
        _build.stream(words))
    _build.check(err, "repro_unpack_spikes")
    return out


def unpack_spikes(ps: PackedSpikes, *,
                  dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """The dense 0/1 spike map at the logical (unpadded) shape: bit-exact
    inverse of ``pack_spikes``. The kernel on CUDA tensors, the plain
    version on CPU tensors."""
    dev = ps.words.device
    if dev.type == "cpu":
        return unpack_spikes_ref(ps, dtype)
    if dev.type != "cuda":
        raise ValueError(f"unpack_spikes runs on cuda or cpu, not {dev}")
    words = ps.words.contiguous()
    _build.count_launch("unpack_spikes", (words,), (ps,))
    dense = unpack_spikes_cuda(words)[..., :ps.m, :ps.k]
    return dense if dtype == torch.int8 else dense.to(dtype)

