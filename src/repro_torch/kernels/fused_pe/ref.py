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

``split_product`` is the plain twin of the kernel's product for a spike x
(``csrc/event_wgmma.cuh``): w split exactly into three bf16 terms, and the
32-deep k steps its route keeps (``k_steps``) each summed as three products
into a fresh tile that joins the running f32 sum; ``fused_pe_block_ref(...,
split=True)`` runs the layer on it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...core.events import (block_count_map_2d, pack_words, pad_to_blocks,
                            unpack_words)
from ..lif_update.ref import lif_update_ref
from ..qk_attention.ref import qk_attention_ref
from ..spike_matmul.ref import (block_skip_mask, gated_mask,
                                sequential_product, spike_matmul_ref,
                                split_g_bf16x3)

# the k depth of one step of the spike-x tile: one packed word a row, one
# occ bit
STEP = 32
# the spike-x tile decides the spikes whose membrane potential lies within
# this of v_th on the scalar tile's ascending f32 chain (the kernel's
# kRecheckBand, 2^-15)
RECHECK_BAND = 2.0 ** -15


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
    ``soft_reset``, else ``v * (1 - s)``. ``x_hist`` and ``r_hist`` are the
    earlier steps of a train whose state began at zeros, [steps, ...] in
    the launch's x and residual operand layouts (None for none): the
    kernel's near-threshold recheck replays them into the state it decides
    on, which a launch asked for it returns last (``state_out``); the
    plain version, which sums each step as one f32 product, reads none of
    them and returns ``v_prev`` there."""
    v_prev: torch.Tensor
    s_prev: torch.Tensor
    tau: float = 0.5
    soft_reset: bool = False
    x_hist: Optional[torch.Tensor] = None
    r_hist: Optional[torch.Tensor] = None


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


def split_weight(wp: torch.Tensor) -> torch.Tensor:
    """The spike-x tile's weight operand: f32 wp [Kp, Np] as its exact
    three-term bf16 split (``split_g_bf16x3``), one [3, Kp, Np] bf16
    tensor."""
    return torch.stack(split_g_bf16x3(wp)).contiguous()


def k_steps(vld: torch.Tensor, gate, bk: int, row_blk: int) -> list[int]:
    """The first k column of each 32-deep step the spike-x tile of row block
    ``row_blk`` runs, in its order (the kernel's ``StepWalk``): every step
    of each block whose vld count is nonzero (the dense skip) or, with a
    ``gate`` (nact, kmap, occ), of each block of the compacted list, and
    with occ only the steps whose bit is set."""
    per = bk // STEP
    if gate is None:
        blocks = (vld[row_blk] != 0).nonzero().flatten().tolist()
        bits = [-1] * len(blocks)
    else:
        nact, kmap, occ = gate
        blocks = kmap[row_blk, :int(nact[row_blk])].tolist()
        bits = ([-1] * len(blocks) if occ is None
                else [int(occ[row_blk, kb]) for kb in blocks])
    return [kb * bk + s * STEP for kb, b in zip(blocks, bits)
            for s in range(per) if (b >> s) & 1]


def split_product(x: torch.Tensor, wp: torch.Tensor, vld: torch.Tensor,
                  gate=None, ws: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The spike-x tile's product in its order: per 128-row block, over
    ``k_steps``, a fresh tile ``(x_s @ w1_s + x_s @ w2_s) + x_s @ w3_s`` of
    the step's 32 columns, each product exact (0/1 times a bf16 term),
    added to the running f32 sum. ``ws`` is the split (``split_weight(wp)``
    when None). Returns [Mp, Np] f32."""
    w1, w2, w3 = (t.to(torch.float32)
                  for t in (split_weight(wp) if ws is None else ws))
    bk = wp.shape[0] // vld.shape[1]
    out = torch.zeros((x.shape[0], wp.shape[1]), dtype=torch.float32,
                      device=x.device)
    for rb in range(x.shape[0] // 128):
        rows = slice(128 * rb, 128 * rb + 128)
        for k0 in k_steps(vld, gate, bk, rb):
            xs = x[rows, k0:k0 + STEP].to(torch.float32)
            ks = slice(k0, k0 + STEP)
            out[rows] += (xs @ w1[ks] + xs @ w2[ks]) + xs @ w3[ks]
    return out


def fused_pe_tile_operands(args: tuple) -> tuple:
    """A launch's operands (``fused_pe_operands``'s, either route's) padded
    to whole 128-row blocks, as the plain versions read them: a float x and
    its q, read at their own rows, zero-padded, and the all-ones vld map of
    a float x without one; a spike x's operands as they are. The float-x
    tile computes the same outputs on these as on the unpadded ones (it
    never reads x's rows past m_valid)."""
    xp, wp, vld, bp, rp, qp, *rest = args
    xp = pad_to_blocks(xp, 128, 1).contiguous()
    if vld is None:
        vld = torch.ones((xp.shape[0] // 128, wp.shape[0] // 128),
                         dtype=torch.int32, device=xp.device)
    if qp is not None:
        qp = pad_to_blocks(qp, 128, 1).contiguous()
    return (xp, wp, vld, bp, rp, qp, *rest)


def fused_pe_block_ref(xp: torch.Tensor, wp: torch.Tensor, vld: torch.Tensor,
                       bp: Optional[torch.Tensor], rp: Optional[torch.Tensor],
                       qp: Optional[torch.Tensor], m_valid: int, n_valid: int,
                       v_th: float, qk_threshold: float,
                       packing: Packing = Packing(), block_n: int = 128,
                       gate=None, heads: Optional[tuple[int, int]] = None,
                       state: Optional[LIFState] = None,
                       ws: Optional[torch.Tensor] = None, *,
                       split: bool = False, state_out: bool = False) -> tuple:
    """The kernel's function on block-aligned operands: x [Mp, Kp] int8
    spikes or a dense f32 / bf16 activation, w [Kp, Np] f32, vld [Mp/128,
    Kp/bk] (bk the k width of x's metadata blocks), bias [Np], residual
    [Mp, Np] f32, q [Mp, Dq] int8; each spike operand that ``packing``
    marks comes as its int32 words instead. x is read where the dense skip
    of ``vld`` reads it or, with a ``gate`` (nact, kmap, occ), where that
    gated walk reads it. ``heads=(h, dh)`` (``h*dh == n_valid``) makes the
    q mask head-blocked. ``state`` makes the launch stateful: v = tau *
    v_prev * (1 - s_prev) + cur, and the reset of v_next comes from the
    pre-mask spike. ``ws``, the kernel's split of w for a spike x, is read
    only with ``split=True``, which forms a spike x's product as the kernel
    does (``split_product``) instead of as one f32 product, and, as the
    kernel does, forms again as the scalar tile's chain
    (``sequential_product``) every valid output whose membrane potential
    lies within ``RECHECK_BAND`` of v_th. Returns
    (spikes [Mp, Np] int8, or [Mp, Np/32] words
    with ``packing.out``, and vld_next [Mp/128, Np/block_n] int32), then
    with ``state`` v_next [m_valid, n_valid] f32, and with
    ``packing.current`` the f32 current [m_valid, n_valid] the spikes were
    thresholded from, and with ``state_out`` and a ``state`` that carries
    its train's earlier steps the state the spikes were decided on
    (``v_prev`` here: the plain version replays nothing). A float x and its
    q may come at their own rows, and then without a vld map
    (``fused_pe_tile_operands``)."""
    xp, wp, vld, bp, rp, qp = fused_pe_tile_operands(
        (xp, wp, vld, bp, rp, qp))
    x = unpack_words(xp) if packing.x else xp
    r = unpack_words(rp, torch.float32) if packing.residual else rp
    q = unpack_words(qp) if packing.q else qp
    mask = (block_skip_mask(vld, x.shape) if gate is None
            else gated_mask(*gate, x.shape))
    vp = torch.zeros((x.shape[0], wp.shape[1]), dtype=torch.float32,
                     device=x.device)
    sp = torch.zeros_like(vp)
    tau, soft_reset = 0.5, False
    if state is not None:     # zeros past the valid extent, where none fires
        vp[:m_valid, :n_valid] = state.v_prev
        sp[:m_valid, :n_valid] = state.s_prev.to(torch.float32)
        tau, soft_reset = state.tau, state.soft_reset

    def current(prod):
        """The sums in fused_pe_ref's order: product, bias, residual."""
        if bp is not None:
            prod = prod + bp.reshape(1, -1).to(torch.float32)
        if r is not None:
            prod = prod + r.to(torch.float32)
        return prod

    if split and not x.is_floating_point():
        cur = current(split_product(x, wp, vld, gate, ws))
        v = cur if state is None else tau * vp * (1.0 - sp) + cur
        near = (v - v_th).abs() < RECHECK_BAND
        near[m_valid:] = False
        near[:, n_valid:] = False
        if bool(near.any()):
            cur = torch.where(near, current(sequential_product(x, wp, mask)),
                              cur)
    else:
        cur = current(spike_matmul_ref(x * mask, wp))
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
    if state_out and state is not None and state.x_hist is not None:
        out = (*out, state.v_prev.clone())
    return out
