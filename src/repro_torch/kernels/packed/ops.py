"""Wrappers for the pack and unpack kernels (``csrc/pack_spikes.cu``,
``csrc/unpack_spikes.cu``): leading dims, padding to the block grid,
checks, and the device split.

``pack_spikes``   — spikes [..., M, K] -> PackedSpikes (words, vld_cnt and
                    occ from one pass).
``unpack_spikes`` — PackedSpikes -> dense 0/1 at the logical shape, in the
                    caller's dtype (int8, bf16 or f32) from one pass.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.events import LANE_BITS, PackedSpikes
from .. import _build
from ..contract import KernelContract, declare, pack_smem
from ..spike_matmul.ops import TILE
from .ref import pack_spikes_ref, unpack_spikes_ref

# pack / unpack, and the word-level patch extraction and OR pooling the
# registry binds beside them (im2col / pool differentiate, the conversions
# do not)
CONTRACT = declare(KernelContract(
    family="packed", ops=("pack", "unpack", "im2col", "pool"),
    grad_ops=("im2col", "pool"), emits_spikes=True, smem_bytes=pack_smem))


def _padded(n: int) -> int:
    return -(-n // TILE) * TILE


def pack_plan(k: int) -> int:
    """Segments of 16 columns a row of a 128-column block in the pack
    kernel's lane map: 2 for k <= 32, 4 for k <= 64 (a warp then covers 8
    rows and no lane falls on the padding), else 8. A unit of 16 / that
    row blocks is then 2048 segments: 8 loads for each of a CTA's 256
    threads."""
    return 2 if k <= 32 else 4 if k <= 64 else 8


def pack_spikes_cuda(x: torch.Tensor, *, out: Optional[tuple] = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the pack kernel on int8 CUDA spikes [nb, m, k] (unpadded;
    contiguous, at any alignment: 16-byte loads where k % 16 == 0 and x is
    16-byte aligned, a byte loop otherwise). Returns (words [nb, mp, kp/32],
    vld_cnt and occ [nb, mp/128, kp/128]) with mp, kp the 128-padded
    extents, into ``out`` when given (every entry is written). Does not
    count."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"pack_spikes_cuda needs CUDA tensors, got {dev}")
    nb, m, k = x.shape
    _build.require(x, "x", torch.int8, (nb, m, k), dev, align=1)
    mp, kp = _padded(m), _padded(k)
    shapes = ((nb, mp, kp // LANE_BITS), (nb, mp // TILE, kp // TILE),
              (nb, mp // TILE, kp // TILE))
    if out is None:
        out = tuple(torch.empty(s, dtype=torch.int32, device=dev)
                    for s in shapes)
    for t, name, s in zip(out, ("words", "vld", "occ"), shapes):
        _build.require(t, name, torch.int32, s, dev)
    words, vld, occ = out
    vector = k % 16 == 0 and x.data_ptr() % 16 == 0
    err = _build.library().repro_pack_spikes(
        _build.ptr(x), _build.ptr(words), _build.ptr(vld), _build.ptr(occ),
        nb, m, k, mp, kp, pack_plan(k), int(vector), _build.stream(x))
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


# the unpack kernel's output dtypes, by the kind its C entry takes
UNPACK_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def unpack_plan(k: int) -> int:
    """Columns of a segment in the unpack kernel's lane map: 128, 64 or 32,
    the largest that divides k (a segment is one load of 4, 2 or 1 words,
    and the segments of a row follow one another in the output), or 0 for
    a ragged k, which takes the element-wise path. A warp's unit is 4096
    spikes: 32 x 128 / G segments."""
    return next((g for g in (128, 64, 32) if k % g == 0), 0)


def unpack_segment(k: int, wpr: int, words_ptr: int, out_ptr: int) -> int:
    """``unpack_plan(k)``, halved until the words' rows (``wpr`` words) and
    base address hold whole aligned segments, or 0 (the element-wise path)
    where the output is not 16-byte aligned."""
    g = unpack_plan(k) if out_ptr % 16 == 0 else 0
    while g and (wpr % (g // LANE_BITS) or words_ptr % (g // 8)):
        g = g // 2 if g > LANE_BITS else 0
    return g


def unpack_spikes_cuda(words: torch.Tensor, m: int, k: int,
                       dtype: torch.dtype = torch.int8, *,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the unpack kernel on int32 CUDA words [..., mp, W] (mp >= m
    rows, W * 32 >= k columns). Returns the 0/1 map [..., m, k] in
    ``dtype`` (int8, bf16 or f32), into ``out`` when given (contiguous, at
    any element alignment: 16-byte stores where it is 16-byte aligned, an
    element loop otherwise). Reads only the words of the extent and writes
    nothing past it. Does not count."""
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"unpack_spikes_cuda needs CUDA tensors, got {dev}")
    if dtype not in UNPACK_KINDS:
        raise TypeError(f"unpack_spikes writes int8, bf16 or f32, not {dtype}")
    *lead, mp, wpr = words.shape
    if m > mp or k > wpr * LANE_BITS:
        raise ValueError(f"[{m}, {k}] is past the words' extent "
                         f"[{mp}, {wpr * LANE_BITS}]")
    _build.require(words, "words", torch.int32, tuple(words.shape), dev,
                   align=4)
    shape = (*lead, m, k)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    _build.require(out, "out", dtype, shape, dev, align=out.element_size())
    g = unpack_segment(k, wpr, words.data_ptr(), out.data_ptr())
    err = _build.library().repro_unpack_spikes(
        _build.ptr(words), _build.ptr(out), math.prod(lead), m, k, mp, wpr, g,
        UNPACK_KINDS[dtype], _build.stream(words))
    _build.check(err, "repro_unpack_spikes")
    return out


def unpack_spikes(ps: PackedSpikes, *,
                  dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """The dense 0/1 spike map at the logical (unpadded) shape in ``dtype``:
    bit-exact inverse of ``pack_spikes``. The kernel on CUDA tensors (one
    launch writing int8, bf16 or f32 itself; another dtype is cast from
    its int8 map), the plain version on CPU tensors."""
    dev = ps.words.device
    if dev.type == "cpu":
        return unpack_spikes_ref(ps, dtype)
    if dev.type != "cuda":
        raise ValueError(f"unpack_spikes runs on cuda or cpu, not {dev}")
    kind = dtype if dtype in UNPACK_KINDS else torch.int8
    args = (ps.words.contiguous(), ps.m, ps.k, kind)
    _build.count_launch("unpack_spikes", args, (ps,))
    return unpack_spikes_cuda(*args).to(dtype)

