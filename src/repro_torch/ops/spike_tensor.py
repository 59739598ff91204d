"""SpikeTensor: the spike-map currency of ``repro_torch.ops`` (twin of
``repro.ops.spike_tensor``).

One logical binary spike map lives in one of two physical formats:

  * ``dense``  — int8 (or float) 0/1 entries at the logical shape;
  * ``packed`` — int32 words of 32 spikes each, core dims padded to the
    block grid, with the popcount-derived ``vld_cnt`` map always present.

Both carry the per-block ``vld_cnt`` map the next event-driven kernel skips
on, so chaining layer L's output into layer L+1 never recomputes the
routing metadata, whatever the format.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
from torch.utils import _pytree as pytree

from ..core.events import (DEFAULT_BLOCKS, LANE_BITS, PackedSpikes,
                           unpack_words)

FORMATS = ("dense", "packed")


@dataclasses.dataclass(frozen=True)
class SpikeTensor:
    """data    : ``dense`` — [..., M, K] spikes (any dtype; nonzero ==
                 event) at the logical (unpadded) shape; ``packed`` — int32
                 [..., Mp, Kp/32] words, core dims padded to the
                 (block_m, block_k) grid.
    vld_cnt : int32 [..., Mp/block_m, Kp/block_k] per-block event counts
              over the padded grid, or None when no kernel produced one
              (packed tensors always carry it).
    shape   : the logical shape; the last two dims are (m, k).
    occ     : optional int32 word-occupancy bitmaps on the same grid (the
              pack kernel emits them), or None.
    """
    data: torch.Tensor
    vld_cnt: Optional[torch.Tensor] = None
    fmt: str = "dense"
    shape: tuple = ()
    block_m: int = DEFAULT_BLOCKS.m
    block_k: int = DEFAULT_BLOCKS.k
    occ: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.fmt not in FORMATS:
            raise ValueError(f"fmt={self.fmt!r} not in {FORMATS}")
        if self.shape:
            object.__setattr__(self, "shape", tuple(self.shape))
        elif self.fmt == "packed":
            raise ValueError("a packed SpikeTensor needs its logical shape")
        else:
            object.__setattr__(self, "shape", tuple(self.data.shape))

    @classmethod
    def dense(cls, x: torch.Tensor, vld_cnt: Optional[torch.Tensor] = None,
              *, block_m: int = DEFAULT_BLOCKS.m,
              block_k: int = DEFAULT_BLOCKS.k) -> "SpikeTensor":
        return cls(x, vld_cnt, "dense", tuple(x.shape), block_m, block_k)

    @classmethod
    def from_packed(cls, ps: PackedSpikes) -> "SpikeTensor":
        return cls(ps.words, ps.vld_cnt, "packed", tuple(ps.shape),
                   ps.block_m, ps.block_k, ps.occ)

    @classmethod
    def wrap(cls, x: "Spikes") -> "SpikeTensor":
        """Coerce a spike operand (raw tensor, PackedSpikes or
        SpikeTensor)."""
        if isinstance(x, SpikeTensor):
            return x
        if isinstance(x, PackedSpikes):
            return cls.from_packed(x)
        return cls.dense(x)

    @property
    def is_packed(self) -> bool:
        return self.fmt == "packed"

    @property
    def m(self) -> int:
        return self.shape[-2]

    @property
    def k(self) -> int:
        return self.shape[-1]

    @property
    def padded_shape(self) -> tuple:
        if self.is_packed:
            return (*self.shape[:-2], self.data.shape[-2],
                    self.data.shape[-1] * LANE_BITS)
        mp = -(-self.m // self.block_m) * self.block_m
        kp = -(-self.k // self.block_k) * self.block_k
        return (*self.shape[:-2], mp, kp)

    @property
    def hbm_bytes(self) -> int:
        """Bytes this tensor ships over device memory in its format:
        payload (4 bytes a word when packed) plus the vld_cnt map."""
        vld = (4 * math.prod(self.vld_cnt.shape)
               if self.vld_cnt is not None else 0)
        if self.is_packed:
            return 4 * math.prod(self.data.shape) + vld
        return math.prod(self.shape) * self.data.element_size() + vld

    @property
    def dense_bytes(self) -> int:
        """Bytes of the padded int8 map (what the packed format replaces)."""
        return math.prod(self.padded_shape)

    def to_packed_spikes(self) -> PackedSpikes:
        """View a packed SpikeTensor as the kernel-level container."""
        if not self.is_packed:
            raise ValueError("a dense SpikeTensor has no packed view")
        return PackedSpikes(self.data, self.vld_cnt, self.shape,
                            self.block_m, self.block_k, self.occ)

    def to_dense(self, dtype: torch.dtype = torch.int8) -> torch.Tensor:
        """The dense map at the logical shape (plain PyTorch; ``ops.unpack``
        goes through the unpack kernel)."""
        if not self.is_packed:
            return self.data.to(dtype)
        return unpack_words(self.data, dtype)[..., :self.m, :self.k]

    def count(self) -> torch.Tensor:
        """Total event count (f32 scalar): from the metadata map when
        present, else a reduction over the payload."""
        if self.vld_cnt is not None:
            return self.vld_cnt.sum().to(torch.float32)
        return (self.data != 0).to(torch.float32).sum()

    def __getitem__(self, idx: int) -> "SpikeTensor":
        """Index ONE leading (batch/time) dim; the 2-D core is preserved."""
        if not isinstance(idx, int):
            raise TypeError(f"SpikeTensor index must be an int, got {idx!r}")
        if len(self.shape) <= 2:
            raise IndexError("cannot index the core dims")
        return SpikeTensor(self.data[idx],
                           None if self.vld_cnt is None else self.vld_cnt[idx],
                           self.fmt, self.shape[1:], self.block_m,
                           self.block_k,
                           None if self.occ is None else self.occ[idx])


# a pytree node, as the reference registers it with jax.tree_util
pytree.register_dataclass(SpikeTensor)

Spikes = Union[torch.Tensor, PackedSpikes, SpikeTensor]
