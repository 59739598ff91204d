"""Plain versions of the event-driven spike matmul and of its backward
(the data- and weight-gradient kernels), and the plain twin of the dw
kernel's arithmetic: g split into three bf16 terms, three products."""
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


def split_g_bf16x3(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """f32 g as three bf16 terms, the split the dw kernel makes of g before
    its tensor-core products: g1 is g with its low 16 bits cleared, g2 the
    same of r = g - g1, g3 = r - g2 rounded to nearest (each difference is
    exact in f32). The first two round toward zero, so no finite g, and no
    partial sum g1 + g2, overflows. g1 + g2 + g3 == g for every finite f32
    with |g| >= 2**-110, where every term's bits lie within bf16's range;
    below, the sum is within 2**-134 (half of bf16's least step) of g."""
    g = g.to(torch.float32)

    def high(t):
        return (t.view(torch.int32) & -65536).view(torch.float32)

    g1 = high(g)
    r = g - g1
    g2 = high(r)
    return (g1.to(torch.bfloat16), g2.to(torch.bfloat16),
            (r - g2).to(torch.bfloat16))


def spike_matmul_dw_split_ref(x, g: torch.Tensor,
                              vld: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """dw the way the kernel forms it: ``spike_matmul_dw_ref`` as the sum
    of three products, x^T g1 + x^T g2 + x^T g3 over ``split_g_bf16x3(g)``
    (each product of 0/1 and a bf16 is exact; the sums are f32)."""
    g1, g2, g3 = split_g_bf16x3(g)
    return ((spike_matmul_dw_ref(x, g1.float(), vld)
             + spike_matmul_dw_ref(x, g2.float(), vld))
            + spike_matmul_dw_ref(x, g3.float(), vld))
