"""SpikeTensor: the spike-map currency of ``repro_torch.ops`` (twin of
``repro.ops.spike_tensor``, dense variant).

It carries the payload, its logical shape and — once a kernel has produced
one — the per-block ``vld_cnt`` map the next event-driven kernel skips on,
so chaining layer L's output into layer L+1 never recomputes the routing
metadata. The packed variant comes with the packed slice (ROADMAP queue 2,
K1); asking for it raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from ..core.events import DEFAULT_BLOCKS

FORMATS = ("dense", "packed")

_PACKED_TODO = ("packed spike tensors are not ported yet "
                "(ROADMAP queue 2, K1)")


@dataclasses.dataclass(frozen=True)
class SpikeTensor:
    """data    : [..., M, K] spikes (any dtype; nonzero == event) at the
                 logical (unpadded) shape.
    vld_cnt : int32 [..., Mp/block_m, Kp/block_k] per-block event counts
              over the padded grid, or None when no kernel produced one.
    """
    data: torch.Tensor
    vld_cnt: Optional[torch.Tensor] = None
    fmt: str = "dense"
    shape: tuple = ()
    block_m: int = DEFAULT_BLOCKS.m
    block_k: int = DEFAULT_BLOCKS.k

    def __post_init__(self):
        if self.fmt == "packed":
            raise NotImplementedError(_PACKED_TODO)
        if self.fmt != "dense":
            raise ValueError(f"fmt={self.fmt!r} not in {FORMATS}")
        object.__setattr__(self, "shape", tuple(self.data.shape))

    @classmethod
    def dense(cls, x: torch.Tensor, vld_cnt: Optional[torch.Tensor] = None,
              *, block_m: int = DEFAULT_BLOCKS.m,
              block_k: int = DEFAULT_BLOCKS.k) -> "SpikeTensor":
        return cls(x, vld_cnt, "dense", tuple(x.shape), block_m, block_k)

    @classmethod
    def from_packed(cls, ps) -> "SpikeTensor":
        raise NotImplementedError(_PACKED_TODO)

    @classmethod
    def wrap(cls, x: "Spikes") -> "SpikeTensor":
        """Coerce a spike operand (raw tensor or SpikeTensor)."""
        if isinstance(x, SpikeTensor):
            return x
        return cls.dense(x)

    @property
    def is_packed(self) -> bool:
        return False

    @property
    def m(self) -> int:
        return self.shape[-2]

    @property
    def k(self) -> int:
        return self.shape[-1]

    @property
    def padded_shape(self) -> tuple:
        mp = -(-self.m // self.block_m) * self.block_m
        kp = -(-self.k // self.block_k) * self.block_k
        return (*self.shape[:-2], mp, kp)

    @property
    def hbm_bytes(self) -> int:
        """Bytes this tensor ships over device memory: payload plus any
        metadata map."""
        vld = (4 * math.prod(self.vld_cnt.shape)
               if self.vld_cnt is not None else 0)
        return math.prod(self.shape) * self.data.element_size() + vld

    @property
    def dense_bytes(self) -> int:
        """Bytes of the padded int8 map."""
        return math.prod(self.padded_shape)

    def to_packed_spikes(self):
        raise NotImplementedError(_PACKED_TODO)

    def to_dense(self, dtype: torch.dtype = torch.int8) -> torch.Tensor:
        return self.data.to(dtype)

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
                           self.block_k)


Spikes = Union[torch.Tensor, SpikeTensor]
