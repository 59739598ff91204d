"""Plain versions of the event-driven spike matmul."""
from __future__ import annotations

import torch

from ...core.events import unpack_words


def spike_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense f32 product of spikes and weights (twin of the reference's
    ``ref.py``). The kernel's block skip is exact, so it must match this
    up to the order of the f32 sums."""
    return x.to(torch.float32) @ w.to(torch.float32)


def block_skip_mask(vld: torch.Tensor, shape: tuple) -> torch.Tensor:
    """[Mp, Kp] bool: True inside the blocks whose vld count is nonzero."""
    bm, bk = shape[0] // vld.shape[0], shape[1] // vld.shape[1]
    return (vld > 0).repeat_interleave(bm, 0).repeat_interleave(bk, 1)


def spike_matmul_block_ref(xp: torch.Tensor, wp: torch.Tensor,
                           vld: torch.Tensor, packed_x: bool = False
                           ) -> torch.Tensor:
    """The kernel's function on block-aligned operands: x [Mp, Kp] int8
    (or, with ``packed_x``, its [Mp, Kp/32] int32 words, unpacked here),
    w [Kp, Np] f32, vld [Mp/128, Kp/128]; blocks with a zero count
    contribute nothing. Returns out [Mp, Np] f32."""
    x = unpack_words(xp) if packed_x else xp
    return spike_matmul_ref(x * block_skip_mask(vld, x.shape), wp)
