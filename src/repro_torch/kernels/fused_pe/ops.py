"""Wrapper for the fused PE kernel (``csrc/fused_pe.cu``), stateless
variant: padding, metadata plumbing, checks, and the device split.

Spike operands (x, q, residual) may be int8 maps or ``PackedSpikes``, and
``out_format="packed"`` makes the emitted map leave as a PackedSpikes whose
``vld_cnt`` is the kernel's ``vld_next``; each packed operand selects the
kernel's packed variant for it (``Packing``). x may also be a dense f32 or
bf16 activation (``ops.dense_lif``, the LM's projections of its residual
stream): it takes the dense route on an all-ones vld map, since a float
operand is not recounted for silent blocks. ``skip`` is the byte-skip
strategy of ``spike_matmul`` (``"dense"``, or the gated walks, launched
with a ``Gate``), and the blocks are the autotuner's: x's metadata grid
is 128 x ``block_k`` and the emitted ``vld_next`` tiles the output on 128 x
``block_n`` (each 128 or 256). ``heads=(h, dh)`` makes the QK mask
head-blocked: each head's row sum of q gates only its own dh output
columns. The variant still to port (ROADMAP queue 2, K2) — LIF state for
T>1 — is not accepted here; the ops layer raises before it gets this far.
``emit_current=True`` (the training forward) also returns the f32 current
the spikes were thresholded from.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ...core.events import (LANE_BITS, PackedSpikes, pad_to_blocks,
                            vld_or_compute)
from .. import _build
from ..spike_matmul.ops import (SKIP_IDS, TILE, Gate, check_block_contract,
                                check_width, make_gate, packed_operand,
                                weight_operand, x_occupancy)
from .ref import Packing, fused_pe_block_ref

Spikes = Union[torch.Tensor, PackedSpikes]


# a dense activation x: its dtype -> the kernel's flag for it
FLOAT_X_FLAGS = {torch.float32: 16, torch.bfloat16: 32}


def spike_operand(x: torch.Tensor) -> torch.Tensor:
    """The kernel takes int8 spikes (bool is cast) or a dense f32 / bf16
    activation; other dtypes raise."""
    if x.dtype == torch.bool:
        return x.to(torch.int8)
    if x.dtype != torch.int8 and x.dtype not in FLOAT_X_FLAGS:
        raise TypeError(f"fused_pe x must hold int8 spikes or an f32 / bf16 "
                        f"activation, got {x.dtype}")
    return x


def check_heads(heads: Optional[tuple[int, int]], n_valid: int,
                q_cols: Optional[int]) -> None:
    """The head-blocked mask's contract: q is given and covers the output,
    which is exactly the h head blocks of dh columns."""
    if heads is None:
        return
    h, dh = heads
    if q_cols is None:
        raise ValueError("heads=(h, dh) needs the q operand")
    if h < 1 or dh < 1 or h * dh != n_valid:
        raise ValueError(f"heads {heads} must tile the output width "
                         f"{n_valid} (h * dh == n)")
    if q_cols < h * dh:
        raise ValueError(f"q has {q_cols} columns, heads {heads} need "
                         f"{h * dh}")


def fused_pe_cuda(xp: torch.Tensor, wp: torch.Tensor, vld: torch.Tensor,
                  bp: Optional[torch.Tensor], rp: Optional[torch.Tensor],
                  qp: Optional[torch.Tensor], m_valid: int, n_valid: int,
                  v_th: float, qk_threshold: float,
                  packing: Packing = Packing(), block_n: int = TILE,
                  gate: Optional[Gate] = None,
                  heads: Optional[tuple[int, int]] = None) -> tuple:
    """Launch the kernel on block-aligned CUDA operands (see
    ``fused_pe_block_ref`` for the contract and the outputs): the dense
    skip on ``vld``, or the gated walk of ``gate`` (spike x only). Does
    not count."""
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"fused_pe_cuda needs CUDA tensors, got {dev}")
    mp = xp.shape[0]
    kp, np_ = wp.shape
    check_width("block_n", block_n)
    if mp % TILE or kp % TILE or np_ % block_n or kp % vld.shape[1]:
        raise ValueError(f"operands must be {TILE}-aligned: x {tuple(xp.shape)}"
                         f", w {tuple(wp.shape)}, block_n {block_n}")
    bk = kp // vld.shape[1]
    check_width("block_k", bk)
    if not (0 <= m_valid <= mp and 0 <= n_valid <= np_):
        raise ValueError(f"valid extent ({m_valid}, {n_valid}) outside the "
                         f"padded [{mp}, {np_}]")
    flags = packing.flags
    if packing.x:
        _build.require(xp, "x", torch.int32, (mp, kp // LANE_BITS), dev)
    elif xp.dtype in FLOAT_X_FLAGS:
        if gate is not None:
            raise ValueError("a dense activation x takes the dense skip "
                             "only")
        _build.require(xp, "x", xp.dtype, (mp, kp), dev)
        flags |= FLOAT_X_FLAGS[xp.dtype]
    else:
        _build.require(xp, "x", torch.int8, (mp, kp), dev)
    _build.require(wp, "w", torch.float32, (kp, np_), dev)
    grid = (mp // TILE, kp // bk)
    _build.require(vld, "vld_cnt", torch.int32, grid, dev, align=4)
    if gate is not None:
        _build.require(gate.nact, "nact", torch.int32, grid[:1], dev, align=4)
        _build.require(gate.kmap, "kmap", torch.int32, grid, dev, align=4)
        if gate.occ is not None:
            _build.require(gate.occ, "occ", torch.int32, grid, dev, align=4)
    if bp is not None:
        _build.require(bp, "bias", torch.float32, (np_,), dev)
    if rp is not None:
        if packing.residual:
            _build.require(rp, "residual", torch.int32,
                           (mp, np_ // LANE_BITS), dev, align=4)
        else:
            _build.require(rp, "residual", torch.float32, (mp, np_), dev)
    dq = 0
    if qp is not None:
        dq = qp.shape[1]                  # words per row when packed
        if packing.q:
            _build.require(qp, "q", torch.int32, (mp, dq), dev, align=4)
        else:
            if dq % TILE:
                raise ValueError(f"q width {dq} must be padded to {TILE}")
            _build.require(qp, "q", torch.int8, (mp, dq), dev)
    check_heads(heads, n_valid,
                None if qp is None else dq * (LANE_BITS if packing.q else 1))
    if packing.out:
        spikes = torch.empty((mp, np_ // LANE_BITS), dtype=torch.int32,
                             device=dev)
    else:
        spikes = torch.empty((mp, np_), dtype=torch.int8, device=dev)
    # a wide tile's count is the sum of its two CTAs' (integer atomics)
    vld_next = (torch.empty if block_n == TILE else torch.zeros)(
        (mp // TILE, np_ // block_n), dtype=torch.int32, device=dev)
    current = (torch.empty((m_valid, n_valid), dtype=torch.float32,
                           device=dev) if packing.current else None)
    nact, kmap, occ = gate if gate is not None else (None, None, None)
    err = _build.library().repro_fused_pe(
        _build.ptr(xp), _build.ptr(wp), _build.ptr(vld), _build.ptr(nact),
        _build.ptr(kmap), _build.ptr(occ), _build.ptr(bp), _build.ptr(rp),
        _build.ptr(qp), dq, _build.ptr(spikes), _build.ptr(vld_next),
        _build.ptr(current), mp, kp, np_, bk, block_n, m_valid, n_valid, v_th,
        qk_threshold, 0 if heads is None else heads[1], flags,
        SKIP_IDS["dense" if gate is None else gate.skip], _build.stream(xp))
    _build.check(err, "repro_fused_pe")
    if packing.current:
        return spikes, vld_next, current
    return spikes, vld_next


def fused_pe_operands(x: Spikes, w: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[Spikes] = None,
                      q: Optional[Spikes] = None,
                      vld_cnt: Optional[torch.Tensor] = None,
                      v_th: float = 1.0, qk_threshold: float = 1.0,
                      out_format: str = "dense",
                      emit_current: bool = False, block_n: int = TILE,
                      block_k: int = TILE, skip: str = "dense",
                      heads: Optional[tuple[int, int]] = None) -> tuple:
    """The block-aligned operands of one launch, in the order
    ``fused_pe_cuda`` and ``fused_pe_block_ref`` take them: x (int8, f32 or
    bf16, or a packed x's words), w padded to x's padded K and to
    ``block_n``, the vld map (all ones for a float x without one), bias
    padded to Np, the residual (f32, an int8 binary shortcut cast as the
    reference wrapper casts it, or a packed one's words), q (int8 padded to
    128 columns, or words), then the valid extent, the thresholds, the
    ``Packing``, ``block_n``, the ``Gate`` (None for the dense skip) and
    ``heads`` (None for the whole-row mask)."""
    if out_format not in ("dense", "packed"):
        raise ValueError(f"out_format={out_format!r} not in "
                         f"('dense', 'packed')")
    check_width("block_n", block_n)
    check_width("block_k", block_k)
    m0, k0 = x.shape
    n0 = w.shape[1]
    if w.shape[0] != k0:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    if isinstance(x, PackedSpikes):
        xp, vld = packed_operand(x, vld_cnt, "fused_pe x", block_k)
        kp = xp.shape[1] * LANE_BITS
    else:
        xp = pad_to_blocks(spike_operand(x), TILE, block_k).contiguous()
        if xp.dtype in FLOAT_X_FLAGS:
            if skip != "dense":
                raise ValueError(f"a dense activation x takes skip='dense', "
                                 f"not {skip!r}")
            if vld_cnt is None:   # no silent blocks to find: never recount
                vld_cnt = torch.ones((xp.shape[0] // TILE,
                                      xp.shape[1] // block_k),
                                     dtype=torch.int32, device=xp.device)
        vld = vld_or_compute(xp, vld_cnt, TILE, block_k).contiguous()
        kp = xp.shape[1]
    gate = make_gate(vld, skip, x_occupancy(x, xp, block_k)
                     if skip == "two_level" else None)
    wp = weight_operand(w, kp, block_k, block_n)
    np_ = wp.shape[1]
    bp = rp = qp = None
    if bias is not None:
        bp = F.pad(bias.reshape(n0).to(torch.float32), (0, np_ - n0))
    if isinstance(residual, PackedSpikes):
        check_block_contract(residual, TILE, block_n, "fused_pe residual")
        if tuple(residual.shape) != (m0, n0):
            raise ValueError(f"packed residual {tuple(residual.shape)} is not "
                             f"[{m0}, {n0}]")
        rp = residual.words.contiguous()
    elif residual is not None:
        if tuple(residual.shape) != (m0, n0):
            raise ValueError(f"residual {tuple(residual.shape)} is not "
                             f"[{m0}, {n0}]")
        rp = pad_to_blocks(residual.to(torch.float32), TILE,
                           block_n).contiguous()
    if isinstance(q, PackedSpikes):
        if q.block_m != TILE:
            raise ValueError(f"fused_pe q was packed on block_m={q.block_m} "
                             f"but the kernel tiles on block_m={TILE}; its "
                             f"row blocks must match the output tiling")
        if q.shape[-2] != m0:
            raise ValueError(f"q has {q.shape[-2]} rows, x has {m0}")
        qp = q.words.contiguous()
    elif q is not None:
        if q.shape[0] != m0:
            raise ValueError(f"q has {q.shape[0]} rows, x has {m0}")
        # zero padding never changes a row sum
        qp = pad_to_blocks(q.to(torch.int8), TILE, TILE).contiguous()
    packing = Packing(isinstance(x, PackedSpikes), isinstance(q, PackedSpikes),
                      isinstance(residual, PackedSpikes),
                      out_format == "packed", emit_current)
    if heads is not None:
        check_heads(heads, n0, None if q is None else q.shape[-1])
    return (xp, wp, vld, bp, rp, qp, m0, n0, v_th, qk_threshold, packing,
            block_n, gate, heads)


def fused_pe(x: Spikes, w: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             residual: Optional[Spikes] = None,
             q: Optional[Spikes] = None,
             vld_cnt: Optional[torch.Tensor] = None,
             v_th: float = 1.0, qk_threshold: float = 1.0,
             out_format: str = "dense", emit_current: bool = False,
             block_n: int = TILE, block_k: int = TILE,
             skip: str = "dense",
             heads: Optional[tuple[int, int]] = None) -> tuple:
    """One stateless fused PE layer (the deployed T=1 form).

    x [M, K] int8 spikes, a 2-D PackedSpikes or a dense f32 / bf16
    activation, w [K, N]; optional bias [N], residual [M, N] (f32 current,
    an int8 binary shortcut, or a PackedSpikes shortcut on the output's
    grid), q [M, Dq] spikes or PackedSpikes for the QK write-back mask
    (whole-row, or per head with ``heads=(h, dh)``, ``h*dh == N``), and
    ``vld_cnt`` — x's [Mp/128, Kp/block_k] count map from the producing
    layer (computed here for a dense spike x without one, all ones for an
    activation; a packed x carries its own). ``skip`` as in
    ``spike_matmul.SKIP_MODES`` (``"dense"`` for an activation). Returns (spikes, vld_next
    [Mp/128, Np/block_n] int32): spikes are int8 [M, N], or with
    ``out_format="packed"`` a PackedSpikes of the logical shape [M, N] on
    the (128, block_n) grid. With ``emit_current`` a third output is the
    f32 [M, N] current (post-bias, post-residual) the spikes were
    thresholded from. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    args = fused_pe_operands(x, w, bias=bias, residual=residual, q=q,
                             vld_cnt=vld_cnt, v_th=v_th,
                             qk_threshold=qk_threshold, out_format=out_format,
                             emit_current=emit_current, block_n=block_n,
                             block_k=block_k, skip=skip, heads=heads)
    dev = args[0].device
    if dev.type == "cpu":
        outs = fused_pe_block_ref(*args)
    elif dev.type == "cuda":
        _build.count_launch("fused_pe" if skip == "dense" else
                            "fused_pe_gated", args,
                            (x, w, bias, residual, q))
        outs = fused_pe_cuda(*args)
    else:
        raise ValueError(f"fused_pe runs on cuda or cpu, not {dev}")
    spikes, vld_next = outs[:2]
    m0, n0, packing = args[6], args[7], args[10]
    if packing.out:
        spikes = PackedSpikes(spikes, vld_next, (m0, n0), TILE, block_n)
    else:
        spikes = spikes[:m0, :n0]
    return (spikes, vld_next, *outs[2:])
