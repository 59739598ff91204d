"""Event metadata for the hybrid data-event execution and the bit-packed
spike format (twin of ``repro.core.events``).

A spike map is cut into (block_m x block_k) tiles; ``vld_cnt`` holds the
nonzero count of each tile. The event-driven kernels skip every tile whose
count is zero, and a fused layer emits the count map of its own output so
the next layer never re-reads the spikes to build it.

Packed layout (shared with the pack/unpack kernels and the packed operand
paths of ``fused_pe`` and ``spike_matmul``): word j of a row covers columns
[32j, 32j + 32) of the padded map, bit b = column 32j + b, and bit 31 wraps
to the sign of the int32 word, as in the reference. Torch has no popcount
and no bitwise-OR reduction, so words are built in int64 and wrapped to
int32 explicitly, and ``popcount32`` is a SWAR bit count over the word
widened to int64 and masked to its 32 bits (an arithmetic ``>>`` on the
int32 word would smear the sign bit).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

LANE_BITS = 32                  # spikes per packed int32 word


class Blocks(NamedTuple):
    """The tile grid every event-metadata map and kernel agrees on."""
    m: int = 128
    n: int = 128
    k: int = 128


DEFAULT_BLOCKS = Blocks()


def block_count_map_2d(spikes: torch.Tensor, block_m: int,
                       block_k: int) -> torch.Tensor:
    """int32 [M//block_m, K//block_k] nonzero count per tile of a
    tile-aligned [M, K] map (pad first with ``pad_to_blocks``)."""
    m, k = spikes.shape
    if m % block_m or k % block_k:
        raise ValueError(f"[{m}, {k}] is not tiled by ({block_m}, {block_k}); "
                         f"pad it with pad_to_blocks first")
    x = (spikes != 0).reshape(m // block_m, block_m, k // block_k, block_k)
    return x.sum(dim=(1, 3), dtype=torch.int32)


def vld_or_compute(x: torch.Tensor, vld_cnt: Optional[torch.Tensor],
                   block_m: int, block_k: int) -> torch.Tensor:
    """Pass a producer's count map through (checked against the grid of the
    padded operand ``x``), or compute it with one pass over ``x``."""
    m, k = x.shape
    expect = (m // block_m, k // block_k)
    if vld_cnt is None:
        return block_count_map_2d(x, block_m, block_k)
    if tuple(vld_cnt.shape) != expect:
        raise ValueError(
            f"vld_cnt grid {tuple(vld_cnt.shape)} does not match the "
            f"[{m}, {k}] operand tiled on (block_m={block_m}, "
            f"block_k={block_k}) — expected {expect}. A chained vld map "
            f"must come from a producer using the SAME block sizes.")
    return vld_cnt.to(torch.int32)


def compact_kmap(vld_cnt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The routing of the gated kernels: for each row of blocks of an int32
    [Gm, Gk] count map, the non-silent k blocks compacted to the front.

    Returns ``nact`` int32 [Gm], the number of non-silent blocks of each
    row, and ``kmap`` int32 [Gm, Gk], their indices in ascending order
    followed by repeats of the last one (a fully silent row maps to block
    0). A gated kernel walks ``kmap[i, s]`` for ``s < nact[i]``. Stays on
    ``vld_cnt``'s device, so a kernel reads it without a host round trip."""
    gk = vld_cnt.shape[1]
    active = vld_cnt > 0
    nact = active.sum(dim=1, dtype=torch.int32)
    # a stable sort of (inactive last) keeps the active indices ascending
    kmap = torch.argsort((~active).to(torch.int8), dim=1, stable=True)
    last_s = (nact.to(torch.int64) - 1).clamp_min(0)[:, None]
    last = torch.gather(kmap, 1, last_s)
    s_idx = torch.arange(gk, device=vld_cnt.device)[None, :]
    kmap = torch.where(s_idx < nact[:, None], kmap, last)
    return nact, kmap.to(torch.int32).contiguous()


def pad_to_blocks(x: torch.Tensor, block_m: int,
                  block_k: int) -> torch.Tensor:
    """Zero-pad the last two dims up to multiples of the block sizes."""
    m, k = x.shape[-2], x.shape[-1]
    pm, pk = (-m) % block_m, (-k) % block_k
    if pm or pk:
        x = F.pad(x, (0, pk, 0, pm))
    return x


def block_occupancy(spikes: torch.Tensor, block_m: int = DEFAULT_BLOCKS.m,
                    block_k: int = DEFAULT_BLOCKS.k) -> torch.Tensor:
    """Fraction of non-silent blocks on the kernels' tile grid (the
    sparsity the block skip can use; the raw spike rate is what an FPGA
    uses). f32 scalar."""
    flat = pad_to_blocks(spikes.reshape(-1, spikes.shape[-1]), block_m,
                         block_k)
    cnt = block_count_map_2d(flat, block_m, block_k)
    # an occupancy metric, never differentiated  # neurallint: disable=NL-BARE-HEAVISIDE
    return (cnt > 0).to(torch.float32).mean()


def event_stats(spikes: torch.Tensor, block_m: int = DEFAULT_BLOCKS.m,
                block_k: int = DEFAULT_BLOCKS.k) -> dict:
    """Spike rate, total spikes and block occupancy of a spike tensor."""
    s = spikes.to(torch.float32)
    return {"spike_rate": s.mean(), "total_spikes": s.sum(),
            "block_occupancy": block_occupancy(spikes, block_m, block_k)}


def synaptic_ops(spikes: torch.Tensor, fanout: int) -> torch.Tensor:
    """Synaptic operations a spike tensor triggers: ``fanout``
    accumulations a spike (the SOPS numerator of the paper's GSOPS/W)."""
    return spikes.to(torch.float32).sum() * fanout


# ====================================================== bit-packed spike format
_MASK32 = 0xFFFFFFFF


def _word_shifts(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 words with those bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _or_bits(flags: torch.Tensor) -> torch.Tensor:
    """[..., n] 0/1 flags (n <= 32) -> int32 [...] with bit i = flags[i];
    the sum of distinct powers of two in int64 is exactly their OR."""
    shifts = _word_shifts(flags.shape[-1], flags.device)
    return _wrap_int32((flags.to(torch.int64) << shifts).sum(dim=-1))


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (bit 31 included), as int32."""
    v = words.to(torch.int64) & _MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & _MASK32) >> 24).to(torch.int32)


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[..., K] 0/nonzero spikes -> [..., K/32] int32 words (K % 32 == 0)."""
    *lead, k = bits.shape
    if k % LANE_BITS:
        raise ValueError(f"K = {k} is not a multiple of {LANE_BITS}")
    return _or_bits((bits != 0).reshape(*lead, k // LANE_BITS, LANE_BITS))


def unpack_words(words: torch.Tensor,
                 dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """[..., W] int32 words -> [..., W*32] 0/1 spikes (inverse of
    ``pack_words``; the arithmetic ``>>`` then ``& 1`` reads bit 31 too)."""
    *lead, w = words.shape
    shifts = torch.arange(LANE_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*lead, w * LANE_BITS).to(dtype)


def head_lane_masks(n_heads: int, head_dim: int,
                    total_cols: int) -> torch.Tensor:
    """Per-head word masks for head-blocked popcount row sums: int32
    [n_heads, total_cols // 32], bit b of word w in row h set iff packed
    column 32w + b belongs to head h (``column // head_dim == h``).
    Columns at or past ``n_heads * head_dim`` (lane padding) belong to no
    head. ANDing a packed spike row with row h and popcounting gives that
    head's row sum; the fused PE kernel forms the same masks from the
    column arithmetic."""
    if total_cols % LANE_BITS:
        raise ValueError(f"{total_cols} columns are not whole words")
    if n_heads * head_dim > total_cols:
        raise ValueError(f"{n_heads} heads of {head_dim} do not fit in "
                         f"{total_cols} columns")
    cols = torch.arange(total_cols, dtype=torch.int64)
    sel = cols[None, :] // head_dim == torch.arange(n_heads)[:, None]
    return pack_words(sel.to(torch.int32))


def _block_words(words: torch.Tensor, block_m: int, block_k: int
                 ) -> tuple[tuple, int, int, int, int]:
    *lead, m, w = words.shape
    wpb = block_k // LANE_BITS
    if block_k % LANE_BITS or m % block_m or w % wpb:
        raise ValueError(f"words {tuple(words.shape)} are not tiled by "
                         f"({block_m}, {block_k})")
    return tuple(lead), m, w, wpb, m // block_m


def popcount_block_map(words: torch.Tensor, block_m: int,
                       block_k: int) -> torch.Tensor:
    """vld_cnt per (block_m x block_k) tile straight from packed words."""
    lead, m, w, wpb, gm = _block_words(words, block_m, block_k)
    pc = popcount32(words).reshape(*lead, gm, block_m, w // wpb, wpb)
    return pc.sum(dim=(-3, -1), dtype=torch.int32)


def _occ_bits(col: torch.Tensor, wpb: int) -> torch.Tensor:
    if wpb > LANE_BITS:
        raise ValueError("the word bitmap needs block_k <= 1024")
    return _or_bits(col)


def word_occupancy_map(words: torch.Tensor, block_m: int,
                       block_k: int) -> torch.Tensor:
    """Per tile, bit c set iff word-column c of the tile (dense columns
    [32c, 32c + 32)) holds a nonzero word in any of the tile's rows.
    int32 [..., Mp/block_m, Kp/block_k]; bit 31 wraps to the sign."""
    lead, m, w, wpb, gm = _block_words(words, block_m, block_k)
    nz = (words != 0).reshape(*lead, gm, block_m, w // wpb, wpb)
    return _occ_bits(nz.any(dim=-3), wpb)


def word_occupancy_map_dense(x: torch.Tensor, block_m: int,
                             block_k: int) -> torch.Tensor:
    """``word_occupancy_map`` straight from a dense tile-aligned
    [..., Mp, Kp] operand: a 32-column stripe is occupied when any of its
    entries is nonzero."""
    *lead, m, k = x.shape
    wpb = block_k // LANE_BITS
    if m % block_m or k % block_k:
        raise ValueError(f"[{m}, {k}] is not tiled by ({block_m}, {block_k})")
    nz = (x != 0).reshape(*lead, m // block_m, block_m, k // block_k, wpb,
                          LANE_BITS)
    return _occ_bits(nz.any(dim=-1).any(dim=-3), wpb)


@dataclasses.dataclass(frozen=True)
class PackedSpikes:
    """Event-compressed spike tensor, the interchange format between the
    kernels.

    words   : int32 [..., Mp, Kp/32], both core dims padded to the
              (block_m, block_k) grid
    vld_cnt : int32 [..., Mp/block_m, Kp/block_k] per-block spike counts,
              derived by popcount when the words are made
    shape   : the logical (unpadded) shape; the last two dims are (m, k)
    occ     : optional int32 [..., Mp/block_m, Kp/block_k] word-occupancy
              bitmaps (``word_occupancy_map``), or None when not computed
    """
    words: torch.Tensor
    vld_cnt: torch.Tensor
    shape: tuple
    block_m: int = 128
    block_k: int = 128
    occ: Optional[torch.Tensor] = None

    def with_occ(self) -> "PackedSpikes":
        """Self with the word-occupancy bitmap filled in (self when the
        pack pass already emitted it)."""
        if self.occ is not None:
            return self
        occ = word_occupancy_map(self.words, self.block_m, self.block_k)
        return dataclasses.replace(self, occ=occ)

    @property
    def m(self) -> int:
        return self.shape[-2]

    @property
    def k(self) -> int:
        return self.shape[-1]

    @property
    def padded_shape(self) -> tuple:
        return (*self.shape[:-2], self.words.shape[-2],
                self.words.shape[-1] * LANE_BITS)

    @property
    def packed_bytes(self) -> int:
        """Device-memory bytes of the words and metadata maps."""
        n = 4 * (math.prod(self.words.shape) + math.prod(self.vld_cnt.shape))
        if self.occ is not None:
            n += 4 * math.prod(self.occ.shape)
        return n

    @property
    def dense_bytes(self) -> int:
        """Bytes of the padded int8 map it replaces."""
        return math.prod(self.padded_shape)

    def __getitem__(self, idx: int) -> "PackedSpikes":
        """Index ONE leading (batch/time) dim; the packed core is kept."""
        if not isinstance(idx, int):
            raise TypeError(f"PackedSpikes index must be an int, got {idx!r}")
        if len(self.shape) <= 2:
            raise IndexError("cannot index the packed core dims")
        return PackedSpikes(self.words[idx], self.vld_cnt[idx],
                            tuple(self.shape[1:]), self.block_m,
                            self.block_k,
                            None if self.occ is None else self.occ[idx])


# a pytree node, as the reference registers it with jax.tree_util
pytree.register_dataclass(PackedSpikes)


def packed_from_words(words: torch.Tensor, shape: tuple, *,
                      block_m: int = 128, block_k: int = 128,
                      vld_cnt: Optional[torch.Tensor] = None,
                      occ: Optional[torch.Tensor] = None,
                      with_occ: bool = False) -> PackedSpikes:
    """Wrap a word tensor (im2col patches of packed maps, a pooled map) as
    a kernel-ready PackedSpikes: rows padded to the block_m grid, vld_cnt
    by popcount over the words unless the producer emitted it."""
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32, got {words.dtype}")
    if block_k % LANE_BITS or (words.shape[-1] * LANE_BITS) % block_k:
        raise ValueError(f"{words.shape[-1]} words per row do not tile "
                         f"block_k = {block_k}")
    pm = (-words.shape[-2]) % block_m
    if pm:
        words = F.pad(words, (0, 0, 0, pm))
    if vld_cnt is None:
        vld_cnt = popcount_block_map(words, block_m, block_k)
    if occ is None and with_occ:
        occ = word_occupancy_map(words, block_m, block_k)
    return PackedSpikes(words, vld_cnt, tuple(shape), block_m, block_k, occ)


def pack_spikes_ref(x: torch.Tensor, *, block_m: int = 128,
                    block_k: int = 128,
                    with_occ: bool = False) -> PackedSpikes:
    """Plain pack: pad -> pack_words -> popcount vld (+ occ)."""
    if block_k % LANE_BITS:
        raise ValueError(f"block_k = {block_k} is not a multiple of "
                         f"{LANE_BITS}")
    words = pack_words(pad_to_blocks(x, block_m, block_k))
    occ = word_occupancy_map(words, block_m, block_k) if with_occ else None
    return PackedSpikes(words, popcount_block_map(words, block_m, block_k),
                        tuple(x.shape), block_m, block_k, occ)


def unpack_spikes_ref(ps: PackedSpikes,
                      dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Plain unpack back to the logical (unpadded) dense map."""
    return unpack_words(ps.words, dtype)[..., :ps.m, :ps.k]


# ====================================================== packed-word invariants
def pad_lane_mask(k: int, n_words: int) -> np.ndarray:
    """int32 mask per word with 1-bits at every pad-lane position (logical
    columns >= ``k``): a row is pad-clean iff ``words & mask == 0``."""
    nbits = np.clip(k - LANE_BITS * np.arange(n_words), 0, LANE_BITS)
    valid = (np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1)
    return (~valid & np.uint64(_MASK32)).astype(np.uint32).view(np.int32)


def check_packed_invariants(ps: PackedSpikes) -> dict:
    """Audit one PackedSpikes: ``ok`` and the violation counts

      pad_cols     words with nonzero bits in column pad lanes (>= k)
      pad_rows     nonzero words in pad rows (>= m)
      vld_mismatch blocks whose vld_cnt != the popcount of their words
      occ_mismatch blocks whose occ bitmap != the re-derived one (0 when
                   ``occ`` is None)

    Reads the tensors back to the host; a test and audit path."""
    words = ps.words.detach().cpu()
    flat = words.reshape(-1, words.shape[-2], words.shape[-1]).numpy()
    mask = pad_lane_mask(ps.k, words.shape[-1])
    pad_cols = int(((flat & mask) != 0).sum())
    pad_rows = int((flat[:, ps.m:, :] != 0).sum())
    vld_ref = popcount_block_map(words, ps.block_m, ps.block_k)
    vld_mismatch = int((vld_ref != ps.vld_cnt.detach().cpu()).sum())
    occ_mismatch = 0
    if ps.occ is not None:
        occ_ref = word_occupancy_map(words, ps.block_m, ps.block_k)
        occ_mismatch = int((occ_ref != ps.occ.detach().cpu()).sum())
    return {
        "ok": not (pad_cols or pad_rows or vld_mismatch or occ_mismatch),
        "pad_cols": pad_cols,
        "pad_rows": pad_rows,
        "vld_mismatch": vld_mismatch,
        "occ_mismatch": occ_mismatch,
    }
