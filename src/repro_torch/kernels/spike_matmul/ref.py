"""Plain versions of the event-driven spike matmul and of its backward
(the data- and weight-gradient kernels)."""
from __future__ import annotations

from typing import Optional

import torch

from ...core.events import unpack_words
from ...core.surrogate import surrogate_grad


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


def spike_matmul_dx_ref(g: torch.Tensor, w: torch.Tensor,
                        v: Optional[torch.Tensor] = None, *,
                        surrogate: str = "atan", alpha: float = 2.0,
                        v_th: float = 1.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward data-gradient: ``dv = g * surr'(v - v_th)`` (``dv = g``
    without ``v``) and ``dx = dv @ wᵀ``. g, v [M, N]; w [K, N]. Returns
    (dx [M, K], dv [M, N])."""
    g = g.to(torch.float32)
    dv = g if v is None else g * surrogate_grad(
        v.to(torch.float32) - v_th, surrogate, alpha).to(g.dtype)
    return dv @ w.to(torch.float32).T, dv


def spike_matmul_dw_ref(x: torch.Tensor, g: torch.Tensor,
                        vld: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward weight-gradient ``dw = xᵀ @ g`` over spikes x [M, K]
    and g [M, N]; with ``vld`` (x's count map on the 128x128 grid of its
    padded shape) the blocks whose count is zero contribute nothing, as in
    the kernel. Returns dw [K, N] f32."""
    xf = x.to(torch.float32)
    if vld is not None:
        m, k = x.shape
        mask = block_skip_mask(vld, (vld.shape[0] * 128, vld.shape[1] * 128))
        xf = xf * mask[:m, :k]
    return xf.T @ g.to(torch.float32)
