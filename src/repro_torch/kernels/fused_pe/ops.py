"""Wrapper for the fused PE kernel (``csrc/fused_pe.cu``), dense stateless
variant: padding, metadata plumbing, checks, and the device split.

The variants still to port (ROADMAP queue 2, K2) — packed operands and
output, ``skip="gated"``/``"two_level"``, LIF state for T>1, head-blocked
QK masks and ``emit_current`` — are not accepted here; the ops layer
raises before it gets this far.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core.events import pad_to_blocks, vld_or_compute
from .. import _build
from ..spike_matmul.ops import TILE
from .ref import fused_pe_block_ref


def spike_operand(x: torch.Tensor) -> torch.Tensor:
    """The kernel takes int8 spikes (bool is cast). A float x is the
    dense-activation variant (``ops.dense_lif``), which is still to port,
    so other dtypes raise."""
    if x.dtype == torch.bool:
        return x.to(torch.int8)
    if x.dtype != torch.int8:
        raise TypeError(f"fused_pe x must hold int8 spikes, got {x.dtype}; "
                        f"the dense-activation variant is still to port "
                        f"(ROADMAP queue 2, K2)")
    return x


def fused_pe_cuda(xp: torch.Tensor, wp: torch.Tensor, vld: torch.Tensor,
                  bp: Optional[torch.Tensor], rp: Optional[torch.Tensor],
                  qp: Optional[torch.Tensor], m_valid: int, n_valid: int,
                  v_th: float, qk_threshold: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on block-aligned CUDA operands (see
    ``fused_pe_block_ref`` for the contract). Does not count."""
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"fused_pe_cuda needs CUDA tensors, got {dev}")
    mp, kp = xp.shape
    np_ = wp.shape[1]
    if mp % TILE or kp % TILE or np_ % TILE:
        raise ValueError(f"operands must be {TILE}-aligned: x {tuple(xp.shape)}"
                         f", w {tuple(wp.shape)}")
    if not (0 <= m_valid <= mp and 0 <= n_valid <= np_):
        raise ValueError(f"valid extent ({m_valid}, {n_valid}) outside the "
                         f"padded [{mp}, {np_}]")
    _build.require(xp, "x", torch.int8, (mp, kp), dev)
    _build.require(wp, "w", torch.float32, (kp, np_), dev)
    _build.require(vld, "vld_cnt", torch.int32, (mp // TILE, kp // TILE), dev,
                   align=4)
    if bp is not None:
        _build.require(bp, "bias", torch.float32, (np_,), dev)
    if rp is not None:
        _build.require(rp, "residual", torch.float32, (mp, np_), dev)
    dq = 0
    if qp is not None:
        dq = qp.shape[1]
        if dq % TILE:
            raise ValueError(f"q width {dq} must be padded to {TILE}")
        _build.require(qp, "q", torch.int8, (mp, dq), dev)
    spikes = torch.empty((mp, np_), dtype=torch.int8, device=dev)
    vld_next = torch.empty((mp // TILE, np_ // TILE), dtype=torch.int32,
                           device=dev)
    err = _build.library().repro_fused_pe(
        _build.ptr(xp), _build.ptr(wp), _build.ptr(vld), _build.ptr(bp),
        _build.ptr(rp), _build.ptr(qp), dq, _build.ptr(spikes),
        _build.ptr(vld_next), mp, kp, np_, m_valid, n_valid, v_th,
        qk_threshold, _build.stream(xp))
    _build.check(err, "repro_fused_pe")
    return spikes, vld_next


def fused_pe_operands(x: torch.Tensor, w: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      q: Optional[torch.Tensor] = None,
                      vld_cnt: Optional[torch.Tensor] = None,
                      v_th: float = 1.0, qk_threshold: float = 1.0
                      ) -> tuple:
    """The block-aligned operands of one launch, in the order
    ``fused_pe_cuda`` and ``fused_pe_block_ref`` take them: x, w and the
    vld map padded to 128x128 tiles, bias padded to Np, the residual cast
    to f32 (an int8 binary shortcut included, as the reference wrapper
    casts it), q cast to int8, then the valid extent and thresholds."""
    m0, k0 = x.shape
    n0 = w.shape[1]
    if w.shape[0] != k0:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    xp = pad_to_blocks(spike_operand(x), TILE, TILE).contiguous()
    wp = pad_to_blocks(w.to(torch.float32), TILE, TILE).contiguous()
    vld = vld_or_compute(xp, vld_cnt, TILE, TILE).contiguous()
    np_ = wp.shape[1]
    bp = rp = qp = None
    if bias is not None:
        bp = F.pad(bias.reshape(n0).to(torch.float32), (0, np_ - n0))
    if residual is not None:
        if tuple(residual.shape) != (m0, n0):
            raise ValueError(f"residual {tuple(residual.shape)} is not "
                             f"[{m0}, {n0}]")
        rp = pad_to_blocks(residual.to(torch.float32), TILE,
                           TILE).contiguous()
    if q is not None:
        if q.shape[0] != m0:
            raise ValueError(f"q has {q.shape[0]} rows, x has {m0}")
        # zero padding never changes a row sum
        qp = pad_to_blocks(q.to(torch.int8), TILE, TILE).contiguous()
    return (xp, wp, vld, bp, rp, qp, m0, n0, v_th, qk_threshold)


def fused_pe(x: torch.Tensor, w: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None,
             q: Optional[torch.Tensor] = None,
             vld_cnt: Optional[torch.Tensor] = None,
             v_th: float = 1.0, qk_threshold: float = 1.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One stateless fused PE layer (the deployed T=1 form), tiled on
    128x128 blocks.

    x [M, K] int8 spikes, w [K, N]; optional bias [N], residual [M, N]
    (f32 current, or an int8 binary shortcut), q [M, Dq] spikes for the
    whole-row QK write-back mask, and ``vld_cnt`` — x's [Mp/128, Kp/128]
    count map from the producing layer, computed here when not given.
    Returns (spikes [M, N] int8, vld_next [Mp/128, Np/128] int32). The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    args = fused_pe_operands(x, w, bias=bias, residual=residual, q=q,
                             vld_cnt=vld_cnt, v_th=v_th,
                             qk_threshold=qk_threshold)
    dev = x.device
    if dev.type == "cpu":
        spikes, vld_next = fused_pe_block_ref(*args)
    elif dev.type == "cuda":
        _build.count_launch("fused_pe", args, (x, w, bias, residual, q))
        spikes, vld_next = fused_pe_cuda(*args)
    else:
        raise ValueError(f"fused_pe runs on cuda or cpu, not {dev}")
    return spikes[:x.shape[0], :w.shape[1]], vld_next
