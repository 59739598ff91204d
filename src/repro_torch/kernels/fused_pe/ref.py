"""Plain versions of the fused PE layer.

``fused_pe_ref`` is the twin of the reference's ``ref.py``: the composed
chain matmul -> (+bias, +residual) -> LIF -> QK mask -> block counts, on
unpadded operands. ``fused_pe_block_ref`` is the plain version of the CUDA
kernel itself, on the same block-aligned operands: it honours the input
``vld`` map (a silent block contributes nothing), the ``m_valid`` /
``n_valid`` margins and the LIF state (``LIFState``, at the valid extent)
exactly as the kernel does. Its packed variants unpack
their packed operands, run the dense plain version, and pack its spikes,
so the dense plain version is the one definition of the function.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...core.events import (block_count_map_2d, pack_words, pad_to_blocks,
                            unpack_words)
from ..lif_update.ref import lif_update_ref
from ..qk_attention.ref import qk_attention_ref
from ..spike_matmul.ref import block_skip_mask, gated_mask, spike_matmul_ref


def head_gate(q: torch.Tensor, heads: tuple[int, int],
              qk_threshold: float) -> torch.Tensor:
    """The head-blocked QK mask: int8 [M, h*dh], column c gated by the row
    sum of q over its head's slice ``q[:, (c // dh)*dh : (c // dh + 1)*dh]``
    (the reference's per-head ``rs >= qk_threshold``)."""
    h, dh = heads
    rs = q[..., :h * dh].to(torch.float32).reshape(
        *q.shape[:-1], h, dh).sum(dim=-1)
    mask = (rs >= qk_threshold).to(torch.int8)
    return mask.repeat_interleave(dh, dim=-1)


def fused_pe_ref(x: torch.Tensor, w: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 v_prev: Optional[torch.Tensor] = None,
                 s_prev: Optional[torch.Tensor] = None,
                 q: Optional[torch.Tensor] = None,
                 tau: float = 0.5, v_th: float = 1.0,
                 soft_reset: bool = False, qk_threshold: float = 1.0,
                 block_m: int = 128, block_n: int = 128,
                 heads: Optional[tuple[int, int]] = None
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Returns (spikes int8, v_next f32 | None, vld_next int32); v_next is
    None in the stateless (T=1) form. x is spikes or a dense f32 / bf16
    activation (taken in f32, as the reference takes it). The QK mask is
    whole-row (one row sum of q gates the whole output row) or, with
    ``heads=(h, dh)``, head-blocked: one row sum per head over q's head
    slice gates only that head's dh output columns (``h*dh`` must be the
    output width)."""
    cur = spike_matmul_ref(x, w)
    if bias is not None:
        cur = cur + bias.reshape(1, -1).to(torch.float32)
    if residual is not None:
        cur = cur + residual.to(torch.float32)
    stateless = v_prev is None
    vp = torch.zeros_like(cur) if stateless else v_prev
    sp = torch.zeros_like(cur) if s_prev is None else s_prev
    spk, v_next = lif_update_ref(cur, vp, sp, tau=tau, v_th=v_th,
                                 soft_reset=soft_reset)
    if q is not None and heads is not None:
        if spk.shape[-1] != heads[0] * heads[1]:
            raise ValueError(f"heads {heads} do not tile the output width "
                             f"{spk.shape[-1]}")
        spk = spk * head_gate(q, heads, qk_threshold)
    elif q is not None:
        spk = qk_attention_ref(q, spk, threshold=qk_threshold)
    vld_next = block_count_map_2d(pad_to_blocks(spk, block_m, block_n),
                                  block_m, block_n)
    return spk, (None if stateless else v_next), vld_next


class LIFState(NamedTuple):
    """The LIF state of one stateful launch (the reference's with_state),
    at the valid extent [m_valid, n_valid]: the membrane potential
    ``v_prev`` f32 and the previous step's pre-mask spikes ``s_prev`` int8
    in, decayed by ``tau``; the reset is ``v - v_th * s`` with
    ``soft_reset``, else ``v * (1 - s)``."""
    v_prev: torch.Tensor
    s_prev: torch.Tensor
    tau: float = 0.5
    soft_reset: bool = False


class Packing(NamedTuple):
    """The variant of one launch: which spike operands are int32 words of
    32 spikes (the reference's packed_in / packed_q / packed_residual /
    packed_out), and whether the f32 current leaves too (``current``, the
    reference's emit_current)."""
    x: bool = False
    q: bool = False
    residual: bool = False
    out: bool = False
    current: bool = False

    @property
    def flags(self) -> int:
        """The kernel's flags argument: one bit per operand, in order."""
        return (int(self.x) | int(self.q) << 1 | int(self.residual) << 2
                | int(self.out) << 3)


def fused_pe_block_ref(xp: torch.Tensor, wp: torch.Tensor, vld: torch.Tensor,
                       bp: Optional[torch.Tensor], rp: Optional[torch.Tensor],
                       qp: Optional[torch.Tensor], m_valid: int, n_valid: int,
                       v_th: float, qk_threshold: float,
                       packing: Packing = Packing(), block_n: int = 128,
                       gate=None, heads: Optional[tuple[int, int]] = None,
                       state: Optional[LIFState] = None) -> tuple:
    """The kernel's function on block-aligned operands: x [Mp, Kp] int8
    spikes or a dense f32 / bf16 activation, w [Kp, Np] f32, vld [Mp/128,
    Kp/bk] (bk the k width of x's metadata blocks), bias [Np], residual
    [Mp, Np] f32, q [Mp, Dq] int8; each spike operand that ``packing``
    marks comes as its int32 words instead. x is read where the dense skip
    of ``vld`` reads it or, with a ``gate`` (nact, kmap, occ), where that
    gated walk reads it. ``heads=(h, dh)`` (``h*dh == n_valid``) makes the
    q mask head-blocked. ``state`` makes the launch stateful: v = tau *
    v_prev * (1 - s_prev) + cur, and the reset of v_next comes from the
    pre-mask spike. Returns (spikes [Mp, Np] int8, or [Mp, Np/32] words
    with ``packing.out``, and vld_next [Mp/128, Np/block_n] int32), then
    with ``state`` v_next [m_valid, n_valid] f32, and with
    ``packing.current`` the f32 current [m_valid, n_valid] the spikes were
    thresholded from."""
    x = unpack_words(xp) if packing.x else xp
    r = unpack_words(rp, torch.float32) if packing.residual else rp
    q = unpack_words(qp) if packing.q else qp
    mask = (block_skip_mask(vld, x.shape) if gate is None
            else gated_mask(*gate, x.shape))
    # the sums in fused_pe_ref's order: product, bias, residual
    cur = spike_matmul_ref(x * mask, wp)
    if bp is not None:
        cur = cur + bp.reshape(1, -1).to(torch.float32)
    if r is not None:
        cur = cur + r.to(torch.float32)
    vp, sp = torch.zeros_like(cur), torch.zeros_like(cur)
    tau, soft_reset = 0.5, False
    if state is not None:     # zeros past the valid extent, where none fires
        vp[:m_valid, :n_valid] = state.v_prev
        sp[:m_valid, :n_valid] = state.s_prev.to(torch.float32)
        tau, soft_reset = state.tau, state.soft_reset
    spk, v_next = lif_update_ref(cur, vp, sp, tau=tau, v_th=v_th,
                                 soft_reset=soft_reset)
    if heads is not None and q is not None:
        hd = heads[0] * heads[1]
        spk[:, :hd] *= head_gate(q, heads, qk_threshold)
    elif q is not None:
        spk = qk_attention_ref(q, spk, threshold=qk_threshold)
    spk[m_valid:, :] = 0
    spk[:, n_valid:] = 0
    vld_next = block_count_map_2d(spk, 128, block_n)
    out = (pack_words(spk) if packing.out else spk), vld_next
    if state is not None:
        out = (*out, v_next[:m_valid, :n_valid].contiguous())
    if packing.current:
        out = (*out, cur[:m_valid, :n_valid].contiguous())
    return out
