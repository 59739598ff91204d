"""Event metadata for the hybrid data-event execution (twin of
``repro.core.events``, dense part).

A spike map is cut into (block_m x block_k) tiles; ``vld_cnt`` holds the
nonzero count of each tile. The event-driven kernels skip every tile whose
count is zero, and a fused layer emits the count map of its own output so
the next layer never re-reads the spikes to build it.

The packed (32 spikes per int32 word) helpers come with the packed slice
(ROADMAP queue 2, K1).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

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


def pad_to_blocks(x: torch.Tensor, block_m: int,
                  block_k: int) -> torch.Tensor:
    """Zero-pad the last two dims up to multiples of the block sizes."""
    m, k = x.shape[-2], x.shape[-1]
    pm, pk = (-m) % block_m, (-k) % block_k
    if pm or pk:
        x = F.pad(x, (0, pk, 0, pm))
    return x
