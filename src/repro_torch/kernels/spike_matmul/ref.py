"""Plain versions of the event-driven spike matmul and of its backward
(the data- and weight-gradient kernels)."""
from __future__ import annotations

from typing import Optional

import torch

from ...core.events import LANE_BITS, PackedSpikes, unpack_words
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


def gated_mask(nact: torch.Tensor, kmap: torch.Tensor,
               occ: Optional[torch.Tensor], shape: tuple) -> torch.Tensor:
    """[Mp, Kp] bool: True where a gated walk reads x. It walks ``kmap[i,
    s]`` for ``s < nact[i]`` (``core.events.compact_kmap``) and, with
    ``occ`` (``"two_level"``), only the occupied 32-column stripes of each
    block it visits."""
    gm, gk = kmap.shape
    bm, bk = shape[0] // gm, shape[1] // gk
    walk = (torch.arange(gk, device=kmap.device)[None, :]
            < nact.to(torch.int64)[:, None])
    rows, steps = walk.nonzero(as_tuple=True)
    on = torch.zeros((gm, gk), dtype=torch.bool, device=kmap.device)
    on[rows, kmap[rows, steps].to(torch.int64)] = True
    if occ is None:
        return on.repeat_interleave(bm, 0).repeat_interleave(bk, 1)
    wpb = bk // LANE_BITS
    shifts = torch.arange(wpb, dtype=torch.int32, device=occ.device)
    stripes = on[..., None] & (((occ[..., None] >> shifts) & 1) != 0)
    return (stripes.reshape(gm, gk * wpb).repeat_interleave(bm, 0)
            .repeat_interleave(LANE_BITS, 1))


def spike_matmul_block_ref(xp: torch.Tensor, wp: torch.Tensor,
                           vld: torch.Tensor, packed_x: bool = False
                           ) -> torch.Tensor:
    """The kernel's function on block-aligned operands: x [Mp, Kp] int8
    (or, with ``packed_x``, its [Mp, Kp/32] int32 words, unpacked here),
    w [Kp, Np] f32, vld [Mp/128, Kp/128]; blocks with a zero count
    contribute nothing. Returns out [Mp, Np] f32."""
    x = unpack_words(xp) if packed_x else xp
    return spike_matmul_ref(x * block_skip_mask(vld, x.shape), wp)


def spike_matmul_gated_block_ref(xp: torch.Tensor, wp: torch.Tensor, gate,
                                 packed_x: bool = False) -> torch.Tensor:
    """The gated kernel's function on block-aligned operands: as
    ``spike_matmul_block_ref``, with x read only where the ``gate``
    (nact, kmap and, for ``"two_level"``, occ) walk reads it."""
    x = unpack_words(xp) if packed_x else xp
    nact, kmap, occ = gate
    return spike_matmul_ref(x * gated_mask(nact, kmap, occ, x.shape), wp)


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


def _dense_x(x) -> torch.Tensor:
    """A packed operand unpacked to its logical [M, K] map."""
    if isinstance(x, PackedSpikes):
        return unpack_words(x.words)[:x.shape[0], :x.shape[1]]
    return x


def spike_matmul_dw_ref(x, g: torch.Tensor,
                        vld: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The backward weight-gradient ``dw = xᵀ @ g`` over spikes x [M, K]
    (or a 2-D ``PackedSpikes``, unpacked) and g [M, N]; with ``vld`` (x's
    count map on the 128x128 grid of its padded shape) the blocks whose
    count is zero contribute nothing, as in the kernel. Returns dw [K, N]
    f32."""
    x = _dense_x(x)
    xf = x.to(torch.float32)
    if vld is not None:
        m, k = x.shape
        mask = block_skip_mask(vld, (vld.shape[0] * 128, vld.shape[1] * 128))
        xf = xf * mask[:m, :k]
    return xf.T @ g.to(torch.float32)


def spike_matmul_dw_gated_ref(x, g: torch.Tensor, gate) -> torch.Tensor:
    """The gated dw kernel's function: ``dw = xᵀ @ g`` with x read only
    where the walk of ``gate`` reads it. ``gate`` routes the transposed
    vld map (nact_t [Gk], mmap [Gk, Gm]: for each k block its non-silent
    m blocks) and, for ``"two_level"``, carries x's occ [Gm, Gk] on the
    128x128 grid: a clear bit leaves out the 32 rows of dw the stripe
    feeds. A packed x is unpacked first."""
    x = _dense_x(x)
    m, k = x.shape
    nact_t, mmap, occ = gate
    gk, gm = mmap.shape
    mask = gated_mask(nact_t, mmap, None, (gk * 128, gm * 128)).T
    if occ is not None:
        mask = mask & gated_mask(torch.full((gm,), gk, dtype=torch.int32,
                                            device=occ.device),
                                 torch.arange(gk, dtype=torch.int32,
                                              device=occ.device)
                                 .expand(gm, gk), occ, (gm * 128, gk * 128))
    return (x.to(torch.float32) * mask[:m, :k]).T @ g.to(torch.float32)
