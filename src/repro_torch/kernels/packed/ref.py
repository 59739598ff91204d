"""Plain versions of the pack and unpack kernels: the PyTorch pack and
unpack of ``core.events`` (kept there so ``core`` needs no kernel).

``pack_spikes_ref(x, with_occ=True)`` is the pack kernel's function on the
same [..., M, K] input: padded words, ``vld_cnt`` and ``occ``.
``unpack_words(words)`` is the unpack kernel's: the padded dense map.

Twins of the pack kernel's own steps, in numpy, for the CPU tests:
``gather16_twin`` is its 16-byte-to-16-bit gather and ``pack_lanes_twin``
its whole lane map (units, segments, shuffles, the stores of each row's
four words of a block, the block counters), which also counts how often
each group of words is stored. ``unpack_lanes_twin`` is the unpack
kernel's lane map (segments, a warp's unit, its bit stream, each lane's
16-byte chunks, the element-wise path), counting each word's loads and
each element's stores.
"""
from __future__ import annotations

import numpy as np

from ...core.events import (PackedSpikes, pack_spikes_ref, unpack_spikes_ref,
                            unpack_words)

THREADS = 256          # the pack kernel's CTA
TILE = 128             # its row and column blocks


def gather16_twin(segments: np.ndarray) -> np.ndarray:
    """[..., 16] int8 bytes -> [...] int bits, bit b set iff byte b is
    nonzero, as the kernel forms them: per little-endian 32-bit word q,
    ``__vcmpne4(q, 0)`` (0xff a nonzero byte), ``& 0x01010101``, times
    ``0x01020408`` modulo 2**32, ``>> 24``; the four nibbles joined."""
    q = np.ascontiguousarray(segments, dtype=np.int8).view(np.uint32)
    ne = np.zeros(q.shape, np.uint32)
    for b in range(4):
        byte = (q >> np.uint32(8 * b)) & np.uint32(0xFF)
        ne |= np.where(byte != 0, np.uint32(0xFF << (8 * b)), np.uint32(0))
    nib = ((ne & np.uint32(0x01010101)) * np.uint32(0x01020408)
           >> np.uint32(24))
    return (nib[..., 0] | nib[..., 1] << np.uint32(4)
            | nib[..., 2] << np.uint32(8) | nib[..., 3] << np.uint32(12))


def _shfl_down(v: np.ndarray, d: int) -> np.ndarray:
    """``__shfl_down_sync`` over [..., 32] lanes: lane l reads lane l + d,
    its own value where l + d > 31."""
    out = v.copy()
    out[..., :32 - d] = v[..., d:]
    return out


def pack_lanes_twin(x: np.ndarray, vw: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The pack kernel's lane map on x [nb, m, k] (nonzero == event), with
    ``vw`` segments of 16 columns a row of a block (``ops.pack_plan``): a
    unit is 16 / vw row blocks by one column block; its thread t's load u
    is segment s = u * 256 + t: row s // vw, segment s % vw; a lane's bits
    come from its 16 bytes (none past k or m); a word joins its two lanes'
    halves, a row's first lane gathers its four words and stores them (rows
    below the padded extent only), and counts them in row block u // (vw //
    2) of the unit, which the twin checks against the row's own. Returns
    (words [nb, mp, kp/32] int32, vld_cnt and occ [nb, mp/128, kp/128]
    int32, stores [nb, mp, kp/128]: how often each row's group of four
    words of a block was stored)."""
    nb, m, k = x.shape
    mp, kp = -(-m // TILE) * TILE, -(-k // TILE) * TILE
    nbc, rbs = kp // TILE, mp // TILE
    g_rows = 16 // vw                                  # row blocks a unit
    rgs = -(-rbs // g_rows)
    xs = np.zeros((nb, rgs * g_rows * TILE, kp), np.int8)
    xs[:, :m, :k] = x
    s = np.arange(8 * THREADS)
    r, j = s // vw, s % vw
    block = r // TILE
    assert (block == (s // THREADS) // (vw // 2)).all()
    words = np.zeros((nb, mp, kp // 32), np.uint32)
    vld = np.zeros((nb, rbs, nbc), np.int64)
    occ = np.zeros((nb, rbs, nbc), np.int64)
    stores = np.zeros((nb, mp, nbc), np.int64)
    for item, rg, cq in np.ndindex(nb, rgs, nbc):
        rows = rg * g_rows * TILE + r
        seg = xs[item, rows[:, None],
                 cq * TILE + 16 * j[:, None] + np.arange(16)]
        h = gather16_twin(seg).reshape(-1, 32)          # warps
        w0 = h | _shfl_down(h, 1) << np.uint32(16)
        quad = [w0, _shfl_down(w0, 2), _shfl_down(w0, 4), _shfl_down(w0, 6)]
        for i in range(1, 4):
            if vw <= 2 * i:                            # padding
                quad[i] = np.zeros_like(w0)
        lead = (j == 0) & (rows < mp)
        quad = np.stack([q.reshape(-1) for q in quad], -1)[lead]
        rr, bb = rows[lead], rg * g_rows + block[lead]
        words[item, rr, 4 * cq:4 * cq + 4] = quad
        np.add.at(stores[item, :, cq], rr, 1)
        np.add.at(vld[item, :, cq], bb,
                  np.unpackbits(quad.view(np.uint8), axis=1).sum(1))
        flags = ((quad != 0) << np.arange(4)).sum(1)
        np.bitwise_or.at(occ[item, :, cq], bb, flags)
    return (words.view(np.int32), vld.astype(np.int32), occ.astype(np.int32),
            stores)


UNIT_WORDS = 128       # the unpack kernel's unit a warp: 4096 spikes


def unpack_lanes_twin(words: np.ndarray, m: int, k: int, g: int,
                      per_chunk: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The unpack kernel's lane map on words [nb, mp, wpr] int32 for the
    extent [nb, m, k], with ``g`` columns a segment (``ops.unpack_plan``;
    0: the element-wise path) and ``per_chunk`` elements a 16-byte store
    (16 int8, 8 bf16, 4 f32). Segment s is row s // (k / g), its (s % (k /
    g))-th group of g / 32 words; unit u of a warp holds segments u * 32 L
    + [0, 32 L), L = 128 / 32 / (g / 32) a lane, lane ``l``'s i-th load
    being segment 32 i + l of the unit, which lands at the same place of
    the unit's bit stream; lane l's q-th store is chunk 32 q + l of the
    unit, unless its first element lies past the extent. Returns (the
    output bits [nb, m, k] uint8, stores per element [nb, m, k], loads per
    word [nb, mp, wpr])."""
    nb, mp, wpr = words.shape
    w = words.view(np.uint32)
    n_out = nb * m * k
    out = np.zeros(n_out, np.uint8)
    stores = np.zeros(n_out, np.int64)
    loads = np.zeros(words.shape, np.int64)
    if g == 0:
        e = np.arange(n_out)
        row, col = e // k, e % k
        item, r = row // m, row % m
        np.add.at(loads, (item, r, col // 32), 1)
        out[:] = (w[item, r, col // 32] >> (col % 32).astype(np.uint32)) & 1
        stores += 1
        return out.reshape(nb, m, k), stores.reshape(nb, m, k), loads
    seg_words = g // 32
    n_loads = UNIT_WORDS // 32 // seg_words
    n_seg, seg_row = n_out // g, k // g
    lane = np.arange(32)
    for u in range(-(-n_seg // (32 * n_loads))):
        s0 = u * 32 * n_loads
        stream = np.zeros(UNIT_WORDS, np.uint32)
        for i in range(n_loads):
            seg = s0 + lane + 32 * i
            live = seg < n_seg
            row, j = seg[live] // seg_row, seg[live] % seg_row
            item, r = row // m, row % m
            cols = j[:, None] * seg_words + np.arange(seg_words)
            np.add.at(loads, (item[:, None], r[:, None], cols), 1)
            at = (lane[live] + 32 * i)[:, None] * seg_words + np.arange(
                seg_words)
            stream[at] = w[item[:, None], r[:, None], cols]
        e0 = s0 * g
        for q in range(32 * UNIT_WORDS // per_chunk // 32):
            bit = (32 * q + lane) * per_chunk
            b = bit[e0 + bit < n_out]
            at = e0 + b[:, None] + np.arange(per_chunk)
            shift = (b[:, None] % 32 + np.arange(per_chunk)).astype(np.uint32)
            out[at] = (stream[b // 32][:, None] >> shift) & 1
            np.add.at(stores, at, 1)
    return out.reshape(nb, m, k), stores.reshape(nb, m, k), loads


__all__ = ["PackedSpikes", "pack_spikes_ref", "unpack_spikes_ref",
           "unpack_words", "gather16_twin", "pack_lanes_twin",
           "unpack_lanes_twin"]
