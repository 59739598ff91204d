"""The in-kernel tile step of the event-gated kernels, stated as plain
PyTorch (twin of ``repro.kernels.gating``).

Both vld-gated kernels (``spike_matmul`` and ``fused_pe``) land on one
inner step: accumulate one (block_m x block_k) x tile against one (block_k
x block_n) w tile into an f32 accumulator, either the whole tile at once
or (the two-level route) stripe by stripe, where a stripe is one packed
int32 word column = 32 dense k columns, and silent stripes are skipped on
the ``occ`` bitmap of ``core.events.word_occupancy_map``.

On the card this logic lives inside the tiles: ``csrc/fused_pe.cuh`` and
``csrc/spike_matmul.cu`` walk the kept 32-deep steps (the stripes) of a
route and ``csrc/spike_matmul_dw.cu`` the transposed product. This module
is their statement for the contract checks and the tests; nothing on the
main path calls it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.events import LANE_BITS, unpack_words

Bits = Optional[Union[int, torch.Tensor]]


def _dense_tile(x: torch.Tensor, packed_in: bool) -> torch.Tensor:
    return unpack_words(x, torch.float32) if packed_in else \
        x.to(torch.float32)


def _stripes(x: torch.Tensor, packed_in: bool, occ_bits: Bits):
    """(c, the x stripe c as f32) for every occupied stripe of the tile."""
    if packed_in:
        wpb = x.shape[-1]
    else:
        if x.shape[-1] % LANE_BITS:
            raise ValueError(f"a dense x tile of {x.shape[-1]} columns is "
                             f"not whole stripes of {LANE_BITS}")
        wpb = x.shape[-1] // LANE_BITS
    if wpb > LANE_BITS:
        raise ValueError(f"{wpb} word columns: an occ bitmap covers at most "
                         f"{LANE_BITS}")
    bits = int(occ_bits)
    for c in range(wpb):
        # the arithmetic >> keeps bit 31 readable (& 1 masks the sign fill)
        if (bits >> c) & 1:
            xs = (unpack_words(x[:, c:c + 1], torch.float32) if packed_in
                  else x[:, c * LANE_BITS:(c + 1) * LANE_BITS]
                  .to(torch.float32))
            yield c, xs


def accum_tile(o: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
               packed_in: bool, occ_bits: Bits = None) -> None:
    """o += x_tile @ w_tile, in place.

    ``x``: (block_m, block_k) dense spikes, or (block_m, block_k / 32)
    int32 words when ``packed_in``. ``w``: (block_k, block_n). ``o``:
    (block_m, block_n) f32. ``occ_bits``: the tile's word-occupancy bitmap;
    when given, only occupied 32-column stripes are multiplied."""
    if occ_bits is None:
        o += _dense_tile(x, packed_in) @ w.to(torch.float32)
        return
    for c, xs in _stripes(x, packed_in, occ_bits):
        o += xs @ w[c * LANE_BITS:(c + 1) * LANE_BITS].to(torch.float32)


def accum_tile_t(o: torch.Tensor, x: torch.Tensor, g: torch.Tensor, *,
                 packed_in: bool, occ_bits: Bits = None) -> None:
    """o += x_tileᵀ @ g_tile, in place: the weight-gradient contraction.

    ``x`` as in ``accum_tile``; ``g``: (block_m, block_n) f32 cotangent;
    ``o``: (block_k, block_n). A silent stripe c of x adds nothing to
    output rows [32 c, 32 (c + 1)), so its product is skipped."""
    g = g.to(torch.float32)
    if occ_bits is None:
        o += _dense_tile(x, packed_in).T @ g
        return
    for c, xs in _stripes(x, packed_in, occ_bits):
        o[c * LANE_BITS:(c + 1) * LANE_BITS] += xs.T @ g
