"""Plain versions of the pack and unpack kernels: the PyTorch pack and
unpack of ``core.events`` (kept there so ``core`` needs no kernel).

``pack_spikes_ref(x, with_occ=True)`` is the pack kernel's function on the
same [..., M, K] input: padded words, ``vld_cnt`` and ``occ``.
``unpack_words(words)`` is the unpack kernel's: the padded dense map.

Twins of the pack kernel's own steps, in numpy, for the CPU tests:
``gather16_twin`` is its 16-byte-to-16-bit gather and ``pack_lanes_twin``
its whole lane map (units, segments, shuffles, the stores of each row's
four words of a block, the block counters), which also counts how often
each group of words is stored.
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


__all__ = ["PackedSpikes", "pack_spikes_ref", "unpack_spikes_ref",
           "unpack_words", "gather16_twin", "pack_lanes_twin"]
