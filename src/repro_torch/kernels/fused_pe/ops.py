"""Wrapper for the fused PE kernel (``csrc/fused_pe.cuh``): padding,
metadata plumbing, checks, the device split, and the multi-timestep scan.

Spike operands (x, q, residual) may be int8 maps or ``PackedSpikes``, and
``out_format="packed"`` makes the emitted map leave as a PackedSpikes whose
``vld_cnt`` is the kernel's ``vld_next``; each packed operand selects the
kernel's packed variant for it (``Packing``). x may also be a dense f32 or
bf16 activation (``ops.dense_lif``, the LM's projections of its residual
stream): it takes the dense skip, read at its own rows with no vld map (a
float operand is not recounted for silent blocks), on the float-x tile
that ``float_tile_plan`` cuts. ``skip`` is the byte-skip
strategy of ``spike_matmul`` (``"dense"``, or the gated walks, launched
with a ``Gate``), and the blocks are the autotuner's: x's metadata grid
is 128 x ``block_k`` and the emitted ``vld_next`` tiles the output on 128 x
``block_n`` (each 128 or 256). ``heads=(h, dh)`` makes the QK mask
head-blocked: each head's row sum of q gates only its own dh output
columns. ``v_prev`` / ``s_prev`` make a launch stateful (T>1): the
membrane decays by ``tau``, resets hard or soft, and ``v_next`` leaves with
the spikes; a dense activation x takes no state. ``emit_current=True``
(the training forward) also returns the f32 current the spikes were
thresholded from. ``fused_pe_layer`` runs a [T, M, K] spike train: one
stateless launch at T=1, the stateful kernel scanned over time otherwise.

On the card a launch takes the route ``pick_route`` gives it: the tile
(a spike x's 128 x 128 tensor-core tile, or the float-x tile), or for a
dense activation x of at most 64 rows on the dense skip, without residual,
state or emitted current (the LM's projections at its decode ticks and
prefill chunks), the decode route, which gives the float-x tile's bits. A
float x's operands are the same on both routes: x and q at their own rows,
x without a vld map; ``fused_pe_tile_operands`` pads them to whole 128-row
blocks for the plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from ...core.events import (LANE_BITS, PackedSpikes, block_count_map_2d,
                            pad_to_blocks, popcount_block_map, vld_or_compute)
from ...tree import derived
from .. import _build
from ..contract import KernelContract, declare, fused_pe_smem
from ..packed.ops import pack_spikes, unpack_spikes
from ..spike_matmul.ops import (DECODE_ROWS, ROUTE_IDS, SKIP_IDS, SMS, TILE,
                                Gate, check_block_contract, check_route,
                                check_width, make_gate, packed_operand,
                                row_vld, weight_operand, x_occupancy)
from .ref import (LIFState, Packing, fused_pe_block_ref,
                  fused_pe_tile_operands, head_gate, split_weight)

CONTRACT = declare(KernelContract(
    family="fused_pe", ops=("fused_pe", "fused_pe_layer", "dense_lif"),
    skips=("dense", "gated", "two_level"), grad=True,
    grad_ops=("fused_pe", "fused_pe_layer", "dense_lif"), emits_spikes=True,
    head_blocked=True, smem_bytes=fused_pe_smem))

Spikes = Union[torch.Tensor, PackedSpikes]


# a dense activation x: its dtype -> the kernel's flag for it
FLOAT_X_FLAGS = {torch.float32: 16, torch.bfloat16: 32}
# the flag bit of a soft reset (a stateful launch)
SOFT_RESET_FLAG = 64
# the float-x tile (csrc/event_gemm.cuh): 64 rows by 256 columns, one CTA
# an SM (its ring takes 160 KB of shared memory)
FLOAT_TILE_M, FLOAT_TILE_N = 64, 256
FLOAT_TILE_RESIDENT = 1
# a tile of at most this many live rows takes the thin mapping
FLOAT_TILE_THIN = 16


@dataclasses.dataclass(frozen=True)
class FloatTilePlan:
    """The float-x tile's cut of an [M, K] @ [K, N] launch: ``mtiles`` x
    ``ntiles`` tiles of ``block_m`` x ``block_n``, n fastest; the first
    ``full`` cost two halves of a tile's time each, those of the last row
    ``tail`` each (1 where that row has at most 16 live rows: the kernel's
    thin mapping spreads them over every warp); ``ctas`` persistent CTAs,
    each a run of tiles of about one full tile's cost
    (``float_tile_runs``)."""
    block_m: int
    block_n: int
    mtiles: int
    ntiles: int
    full: int
    tail: int
    ctas: int

    def cost(self, t: int) -> int:
        """Halves of a tile's time of tiles [0, t)."""
        return (2 * t if t <= self.full
                else 2 * self.full + self.tail * (t - self.full))

    def first(self, c: int) -> int:
        """The first tile whose cumulative cost reaches ``c`` halves."""
        if c <= 2 * self.full:
            return (c + 1) // 2
        return self.full + -(-(c - 2 * self.full) // self.tail)


def float_tile_plan(m: int, n: int, k: int) -> FloatTilePlan:
    """The float-x tile's plan for an [M, K] @ [K, N] launch (N the padded
    output's columns; K, common to every tile, shapes nothing): 64 x 256
    tiles, and ceil(cost / 2) persistent CTAs, at most the ``SMS`` x
    ``FLOAT_TILE_RESIDENT`` the card holds at once, so a launch of at most
    that many tiles' cost runs one balanced wave. The C twin is
    ``float_grid`` and the launch in ``csrc/fused_pe_float.cu``. At the LM
    step's 1032 rows by 2048: 128 full tiles and 8 thin tiles of 8 live
    rows, 132 CTAs."""
    mtiles = max(1, -(-m // FLOAT_TILE_M))
    ntiles = -(-n // FLOAT_TILE_N)
    full = (mtiles - 1) * ntiles
    tail = 2 if m - (mtiles - 1) * FLOAT_TILE_M > FLOAT_TILE_THIN else 1
    total = 2 * full + tail * ntiles
    ctas = max(1, min(SMS * FLOAT_TILE_RESIDENT, -(-total // 2)))
    return FloatTilePlan(FLOAT_TILE_M, FLOAT_TILE_N, mtiles, ntiles, full, tail,
                         ctas)


def float_tile_runs(plan: FloatTilePlan) -> list[range]:
    """Each CTA's run of tiles (``t // ntiles`` the row, ``t % ntiles`` the
    column of tile t): CTA c takes the tiles whose cumulative cost starts
    in [C c / G, C (c + 1) / G), C the launch's cost and G its CTAs (the
    kernel's own split)."""
    total = plan.cost(plan.full + plan.ntiles)
    return [range(plan.first(total * c // plan.ctas),
                  plan.first(total * (c + 1) // plan.ctas))
            for c in range(plan.ctas)]


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


def pick_route(x: Spikes, skip: str, *, residual=None, v_prev=None,
               emit_current: bool = False) -> str:
    """The route of a launch: ``"decode"`` for a dense f32 or bf16
    activation x of at most ``DECODE_ROWS`` rows on the dense skip without
    a residual, LIF state or emitted current (the LM's projections), else
    ``"tile"``. The two give the same bits, so this is a choice of speed
    alone."""
    float_x = not isinstance(x, PackedSpikes) and x.dtype in FLOAT_X_FLAGS
    return ("decode" if float_x and skip == "dense"
            and x.shape[0] <= DECODE_ROWS and residual is None
            and v_prev is None and not emit_current else "tile")


# the decode route's count scratch, one a (device, stream): an int32 a
# count tile, into which its CTAs add their counts and arrivals
_COUNTS: dict = {}


def count_scratch(device, stream: int, tiles: int) -> torch.Tensor:
    """The zeroed count scratch of the decode route's launches on ``stream``
    for ``tiles`` (128, block_n) count tiles. Each CTA adds its spike count
    and its arrival into its tile's slot with one integer atomic (exact in
    any order), and the last CTA of a tile writes the sum to vld_next and
    zeroes the slot again, so one buffer serves every launch of a stream
    (they run in order) and vld_next needs neither zeroing nor a kernel of
    its own."""
    key = (str(device), stream)
    buf = _COUNTS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = _COUNTS[key] = torch.zeros(max(tiles, 128), dtype=torch.int32,
                                         device=device)
    return buf


def launch_outputs(mp: int, np_: int, m_valid: int, n_valid: int,
                   packing: Packing, block_n: int, stateful: bool,
                   route: str, device, *, float_x: bool = False) -> tuple:
    """The outputs one launch writes, allocated: spikes [mp, np_] int8 or
    [mp, np_/32] words, vld_next [mp/128, np_/block_n] int32, and v_next
    and the current at the valid extent (None where the launch has none).
    The kernel writes every spike position, padded rows included. On the
    tile route, a spike x's 256-wide count tiles and every tile of a float
    x (``float_x``) add their counts into a zeroed vld_next (integer
    atomics, exact in any order); the decode route writes vld_next whole
    (``count_scratch``), and so does a spike x's 128-wide count tile."""
    added = route == "tile" and (block_n != TILE or float_x)
    if packing.out:
        spikes = torch.empty((mp, np_ // LANE_BITS), dtype=torch.int32,
                             device=device)
    else:
        spikes = torch.empty((mp, np_), dtype=torch.int8, device=device)
    vld_next = (torch.zeros if added else torch.empty)(
        (mp // TILE, np_ // block_n), dtype=torch.int32, device=device)
    v_next = (torch.empty((m_valid, n_valid), dtype=torch.float32,
                          device=device) if stateful else None)
    current = (torch.empty((m_valid, n_valid), dtype=torch.float32,
                           device=device) if packing.current else None)
    return spikes, vld_next, v_next, current


def fused_pe_cuda(xp: torch.Tensor, wp: torch.Tensor,
                  vld: Optional[torch.Tensor],
                  bp: Optional[torch.Tensor], rp: Optional[torch.Tensor],
                  qp: Optional[torch.Tensor], m_valid: int, n_valid: int,
                  v_th: float, qk_threshold: float,
                  packing: Packing = Packing(), block_n: int = TILE,
                  gate: Optional[Gate] = None,
                  heads: Optional[tuple[int, int]] = None,
                  state: Optional[LIFState] = None,
                  ws: Optional[torch.Tensor] = None, *,
                  route: str = "tile", state_out: bool = False) -> tuple:
    """Launch the kernel on block-aligned CUDA operands (see
    ``fused_pe_block_ref`` for the contract and the outputs): the dense
    skip on ``vld``, or the gated walk of ``gate`` (spike x only), with the
    LIF ``state`` (spike x only) or without. A spike x's tile multiplies on
    the tensor cores by ``ws``, w's exact split into three bf16 terms
    ([3, Kp, Np], ``split_weight``), which it needs. With ``state_out``
    and a state that carries its train's earlier steps (``state.x_hist``)
    the launch also returns, last, the state the spikes were decided on:
    v_prev, but where the near-threshold recheck replayed those steps. No
    operand is written. A dense activation x (the float-x tile, or with
    ``route="decode"`` the decode route: at most 64 rows on the dense skip,
    without residual, state or emitted current) needs x and q only at
    their first m_valid rows, ``vld`` may be None (every block kept), and
    the outputs have x's rows padded to 128. Does not count."""
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"fused_pe_cuda needs CUDA tensors, got {dev}")
    check_route(route, "dense" if gate is None else gate.skip)
    decode = route == "decode"
    float_x = not packing.x and xp.dtype in FLOAT_X_FLAGS
    rows = xp.shape[0]
    mp = -(-rows // TILE) * TILE if float_x else rows
    kp, np_ = wp.shape
    check_width("block_n", block_n)
    gk = None if vld is None else vld.shape[1]
    if mp % TILE or kp % TILE or np_ % block_n or (gk and kp % gk):
        raise ValueError(f"operands must be {TILE}-aligned: x {tuple(xp.shape)}"
                         f", w {tuple(wp.shape)}, block_n {block_n}")
    if gk is None and not float_x:
        raise ValueError("a spike x's tile reads a vld map")
    bk = kp // gk if gk else TILE
    check_width("block_k", bk)
    if not (0 <= m_valid <= mp and 0 <= n_valid <= np_) or (
            float_x and m_valid > rows):
        raise ValueError(f"valid extent ({m_valid}, {n_valid}) outside the "
                         f"padded [{mp}, {np_}]")
    if decode and (xp.dtype not in FLOAT_X_FLAGS or rp is not None
                   or state is not None or packing.current
                   or not m_valid <= min(rows, DECODE_ROWS)):
        raise ValueError(f"the decode route takes a dense activation x of at "
                         f"most {DECODE_ROWS} live rows without residual, "
                         f"state or emitted current: x {xp.dtype} of "
                         f"{m_valid} live rows")

    flags = packing.flags
    if packing.x:
        _build.require(xp, "x", torch.int32, (rows, kp // LANE_BITS), dev)
    elif xp.dtype in FLOAT_X_FLAGS:
        if gate is not None:
            raise ValueError("a dense activation x takes the dense skip "
                             "only")
        _build.require(xp, "x", xp.dtype, (rows, kp), dev)
        flags |= FLOAT_X_FLAGS[xp.dtype]
    else:
        _build.require(xp, "x", torch.int8, (rows, kp), dev)
    _build.require(wp, "w", torch.float32, (kp, np_), dev)
    if xp.dtype not in FLOAT_X_FLAGS:
        if ws is None:
            raise ValueError("a spike x's tile needs ws, w's bf16 split")
        _build.require(ws, "ws", torch.bfloat16, (3, kp, np_), dev)
    grid = (mp // TILE, kp // bk)
    if vld is not None:
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
        # a float x's routes read q's first m_valid rows
        q_rows = qp.shape[0] if float_x and qp.shape[0] >= m_valid else mp
        if packing.q:
            _build.require(qp, "q", torch.int32, (q_rows, dq), dev, align=4)
        else:
            if dq % TILE:
                raise ValueError(f"q width {dq} must be padded to {TILE}")
            _build.require(qp, "q", torch.int8, (q_rows, dq), dev)
    check_heads(heads, n_valid,
                None if qp is None else dq * (LANE_BITS if packing.q else 1))
    if state is not None:
        if xp.dtype in FLOAT_X_FLAGS:
            raise ValueError("a dense activation x takes no LIF state")
        _build.require(state.v_prev, "v_prev", torch.float32,
                       (m_valid, n_valid), dev, align=4)
        _build.require(state.s_prev, "s_prev", torch.int8,
                       (m_valid, n_valid), dev, align=1)
        if state.soft_reset:
            flags |= SOFT_RESET_FLAG
    spikes, vld_next, v_next, current = launch_outputs(
        mp, np_, m_valid, n_valid, packing, block_n, state is not None,
        route, dev, float_x=float_x)
    nact, kmap, occ = gate if gate is not None else (None, None, None)
    x_hist = r_hist = v_used = None
    if state is not None and state.x_hist is not None:
        if state_out:
            v_used = torch.empty_like(state.v_prev)
        x_hist, r_hist = state.x_hist, state.r_hist
        steps = x_hist.shape[0]
        _build.require(x_hist, "x_hist", xp.dtype, (steps, *xp.shape), dev,
                       align=4)
        if (rp is None) != (r_hist is None):
            raise ValueError("r_hist goes with a residual, and only with one")
        if rp is not None:
            _build.require(r_hist, "r_hist", rp.dtype, (steps, *rp.shape),
                           dev, align=4)
    stream = _build.stream(xp)
    counts = (count_scratch(dev, stream, np_ // block_n) if decode
              else None)
    err = _build.library().repro_fused_pe(
        _build.ptr(xp), _build.ptr(wp),
        _build.ptr(ws if xp.dtype not in FLOAT_X_FLAGS else None),
        _build.ptr(vld), _build.ptr(nact),
        _build.ptr(kmap), _build.ptr(occ), _build.ptr(bp), _build.ptr(rp),
        _build.ptr(qp), dq, _build.ptr(spikes), _build.ptr(vld_next),
        _build.ptr(current),
        None if state is None else _build.ptr(state.v_prev),
        None if state is None else _build.ptr(state.s_prev),
        _build.ptr(v_next), mp, kp, np_, bk, block_n, m_valid, n_valid, v_th,
        qk_threshold, 0.0 if state is None else state.tau,
        0 if heads is None else heads[1], flags,
        SKIP_IDS["dense" if gate is None else gate.skip], ROUTE_IDS[route],
        _build.ptr(counts), _build.ptr(x_hist), _build.ptr(r_hist),
        0 if x_hist is None else x_hist.stride(0) * x_hist.element_size(),
        0 if r_hist is None else r_hist.stride(0) * r_hist.element_size(),
        0 if x_hist is None else x_hist.shape[0], _build.ptr(v_used), stream)
    _build.check(err, "repro_fused_pe")
    out = (spikes, vld_next)
    if state is not None:
        out = (*out, v_next)
    if packing.current:
        out = (*out, current)
    if v_used is not None:
        out = (*out, v_used)
    return out


def fused_pe_operands(x: Spikes, w: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      residual: Optional[Spikes] = None,
                      q: Optional[Spikes] = None,
                      vld_cnt: Optional[torch.Tensor] = None,
                      v_th: float = 1.0, qk_threshold: float = 1.0,
                      out_format: str = "dense",
                      emit_current: bool = False, block_n: int = TILE,
                      block_k: int = TILE, skip: str = "dense",
                      heads: Optional[tuple[int, int]] = None,
                      v_prev: Optional[torch.Tensor] = None,
                      s_prev: Optional[torch.Tensor] = None,
                      tau: float = 0.5, soft_reset: bool = False,
                      route: str = "tile",
                      train: Optional[tuple] = None) -> tuple:
    """The block-aligned operands of one launch, in the order
    ``fused_pe_cuda`` and ``fused_pe_block_ref`` take them: x (int8, f32 or
    bf16, or a packed x's words), w padded to x's padded K and to
    ``block_n``, the vld map (None for a float x without one), bias
    padded to Np, the residual (f32, an int8 binary shortcut cast as the
    reference wrapper casts it, or a packed one's words), q (int8 padded to
    128 columns, or words), then the valid extent, the thresholds, the
    ``Packing``, ``block_n``, the ``Gate`` (None for the dense skip),
    ``heads`` (None for the whole-row mask), the ``LIFState`` (None
    without ``v_prev``: v_prev as f32 and s_prev as int8, as the reference
    wrapper casts them, zeros for a missing s_prev, all unpadded) and, for
    a spike x, ws: the padded w's exact split into three bf16 terms
    ([3, Kp, Np], ``split_weight``), which the spike-x tile multiplies by,
    made once per weight (``weight_split``; None for a float x).

    ``train=(xh, rh, t)``, with the state, makes this launch step t of a
    train whose state began at zeros, laid out once by ``train_operands``:
    x's operand is the view ``xh[t]`` and an f32 residual's ``rh[t]``
    (nothing is padded again), and the steps before it, ``xh[:t]`` and
    ``rh[:t]``, ride in the ``LIFState`` for the kernel's near-threshold
    recheck (none at t = 0).

    A dense activation x's operands are the same on both routes (the
    float-x tile, and ``route="decode"``, which takes one without residual,
    state or emitted current): x and q at their own rows (only their
    columns padded; packed words come padded; x copied only where its K is
    not a whole number of blocks or it is not 16-byte aligned), and no vld
    map without one (the routes then keep every block).
    ``fused_pe_tile_operands`` pads them to whole 128-row blocks."""
    if out_format not in ("dense", "packed"):
        raise ValueError(f"out_format={out_format!r} not in "
                         f"('dense', 'packed')")
    check_width("block_n", block_n)
    check_width("block_k", block_k)
    check_route(route, skip)
    decode = route == "decode"
    float_x = not isinstance(x, PackedSpikes) and x.dtype in FLOAT_X_FLAGS
    bm = 1 if float_x else TILE         # the row padding of dense operands
    m0, k0 = x.shape
    n0 = w.shape[1]
    if w.shape[0] != k0:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    if decode and pick_route(x, skip, residual=residual, v_prev=v_prev,
                             emit_current=emit_current) != "decode":
        raise ValueError(f"the decode route takes a dense activation x of at "
                         f"most {DECODE_ROWS} rows without residual, state or "
                         f"emitted current")
    if isinstance(x, PackedSpikes):
        xp, vld = packed_operand(x, vld_cnt, "fused_pe x", block_k)
        kp = xp.shape[1] * LANE_BITS
    else:
        xp = (train_step(train, 0, (m0, k0), block_k) if train is not None
              else pad_to_blocks(spike_operand(x), bm, block_k).contiguous())
        if float_x:
            if skip != "dense":
                raise ValueError(f"a dense activation x takes skip='dense', "
                                 f"not {skip!r}")
            if xp.data_ptr() % 16:      # the routes load 16 bytes at a time
                xp = xp.clone()
            # no silent blocks to find: every block kept, never recounted
            vld = None if vld_cnt is None else row_vld(xp, vld_cnt, block_k)
        else:
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
        rp = (train_step(train, 1, (m0, n0), block_n)
              if train is not None and train[1] is not None
              else pad_to_blocks(residual.to(torch.float32), TILE,
                                 block_n).contiguous())
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
        qp = pad_to_blocks(q.to(torch.int8), bm, TILE).contiguous()
    packing = Packing(isinstance(x, PackedSpikes), isinstance(q, PackedSpikes),
                      isinstance(residual, PackedSpikes),
                      out_format == "packed", emit_current)
    if heads is not None:
        check_heads(heads, n0, None if q is None else q.shape[-1])
    state = None
    if s_prev is not None and v_prev is None:
        raise ValueError("s_prev needs v_prev")
    if v_prev is not None:
        if xp.dtype in FLOAT_X_FLAGS:
            raise ValueError("a dense activation x takes no LIF state")
        for name, t in (("v_prev", v_prev), ("s_prev", s_prev)):
            if t is not None and tuple(t.shape) != (m0, n0):
                raise ValueError(f"{name} {tuple(t.shape)} is not "
                                 f"[{m0}, {n0}]")
        sp = (torch.zeros((m0, n0), dtype=torch.int8, device=xp.device)
              if s_prev is None else s_prev.to(torch.int8))
        hist = ()
        if train is not None and train[2] > 0:
            xh, rh, t = train
            hist = (xh[:t], None if rh is None else rh[:t])
        state = LIFState(v_prev.to(torch.float32).contiguous(),
                         sp.contiguous(), float(tau), bool(soft_reset), *hist)
    elif train is not None:
        raise ValueError("a train's step goes with the LIF state")
    ws = (None if xp.dtype in FLOAT_X_FLAGS
          else weight_split(w, wp, block_k, block_n))
    return (xp, wp, vld, bp, rp, qp, m0, n0, v_th, qk_threshold, packing,
            block_n, gate, heads, state, ws)


def weight_split(w: torch.Tensor, wp: torch.Tensor, block_k: int,
                 block_n: int) -> torch.Tensor:
    """``split_weight(wp)`` of ``wp``, the padded operand of the caller's
    ``w``, made once while the tensor w views lives unmodified
    (``tree.derived`` on that tensor, the caller's parameter where w is a
    reshape of it, and its ``_version``, with the view and the padding):
    a parameter is split once, and an in-place update makes a new split.
    Keyed on the parameter, not on wp or a view of it, which are new
    tensors each call."""
    root = w
    while root._base is not None:
        root = root._base
    view = (tuple(w.shape), w.stride(), w.storage_offset())
    with torch.no_grad():
        return derived(root, ("fused_pe bf16x3", view, tuple(wp.shape),
                              block_k, block_n),
                       lambda: split_weight(wp.detach()))


def fused_pe(x: Spikes, w: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             residual: Optional[Spikes] = None,
             q: Optional[Spikes] = None,
             vld_cnt: Optional[torch.Tensor] = None,
             v_th: float = 1.0, qk_threshold: float = 1.0,
             out_format: str = "dense", emit_current: bool = False,
             block_n: int = TILE, block_k: int = TILE,
             skip: str = "dense",
             heads: Optional[tuple[int, int]] = None,
             v_prev: Optional[torch.Tensor] = None,
             s_prev: Optional[torch.Tensor] = None,
             tau: float = 0.5, soft_reset: bool = False,
             train: Optional[tuple] = None) -> tuple:
    """One fused PE layer: stateless (the deployed T=1 form), or one step
    of a T>1 train with the LIF state ``v_prev`` / ``s_prev`` [M, N] (and,
    where the state began at zeros, ``train``: the train's operands and
    this step's index, as ``fused_pe_operands`` takes them).

    x [M, K] int8 spikes, a 2-D PackedSpikes or a dense f32 / bf16
    activation, w [K, N]; optional bias [N], residual [M, N] (f32 current,
    an int8 binary shortcut, or a PackedSpikes shortcut on the output's
    grid), q [M, Dq] spikes or PackedSpikes for the QK write-back mask
    (whole-row, or per head with ``heads=(h, dh)``, ``h*dh == N``), and
    ``vld_cnt`` — x's [Mp/128, Kp/block_k] count map from the producing
    layer (computed here for a dense spike x without one, all ones for an
    activation; a packed x carries its own). ``skip`` as in
    ``spike_matmul.SKIP_MODES`` (``"dense"`` for an activation). With the
    state, v = tau * v_prev * (1 - s_prev) + current fires on v >= v_th,
    and v_next is reset (``soft_reset``: v - v_th * spike, else v * (1 -
    spike)) by the layer's own spike, before the QK mask. Returns (spikes,
    vld_next [Mp/128, Np/block_n] int32): spikes are int8 [M, N], or with
    ``out_format="packed"`` a PackedSpikes of the logical shape [M, N] on
    the (128, block_n) grid; then, with the state, v_next f32 [M, N], and
    with ``emit_current`` the f32 [M, N] current (post-bias,
    post-residual) the spikes were thresholded from. The kernel on CUDA
    tensors, on the route ``pick_route`` gives; the plain version on CPU
    tensors."""
    dev = (x.words if isinstance(x, PackedSpikes) else x).device
    route = (pick_route(x, skip, residual=residual, v_prev=v_prev,
                        emit_current=emit_current)
             if dev.type == "cuda" else "tile")
    args = fused_pe_operands(x, w, bias=bias, residual=residual, q=q,
                             vld_cnt=vld_cnt, v_th=v_th,
                             qk_threshold=qk_threshold, out_format=out_format,
                             emit_current=emit_current, block_n=block_n,
                             block_k=block_k, skip=skip, heads=heads,
                             v_prev=v_prev, s_prev=s_prev, tau=tau,
                             soft_reset=soft_reset, route=route,
                             train=train)
    if dev.type == "cpu":
        outs = fused_pe_block_ref(*args)
    elif dev.type == "cuda":
        _build.count_launch("fused_pe" if skip == "dense" else
                            "fused_pe_gated", args,
                            (x, w, bias, residual, q), route)
        outs = fused_pe_cuda(*args, route=route)
    else:
        raise ValueError(f"fused_pe runs on cuda or cpu, not {dev}")
    spikes, vld_next = outs[:2]
    m0, n0, packing = args[6], args[7], args[10]
    if packing.out:
        spikes = PackedSpikes(spikes, vld_next, (m0, n0), TILE, block_n)
    else:
        spikes = spikes[:m0, :n0]
    return (spikes, vld_next, *outs[2:])


def train_operands(x: Spikes, residual: Optional[Spikes], block_k: int,
                   block_n: int) -> tuple:
    """A [T, M, K] spike train x (int8 / bool / 0-1 float, or a 3-D
    PackedSpikes) and its [T, M, N] residual (or None) in the layouts of
    one step's launch operands, padded once for the whole train: (int8
    [T, Mp, Kp] or words, f32 [T, Mp, Np] or words, or None). Step t's
    launch takes ``(xh, rh, t)`` as its ``train``: its operands are views
    of these, and so are the steps before it that its recheck replays."""
    if isinstance(x, PackedSpikes):
        xh = x.words.contiguous()
    else:
        xh = pad_to_blocks(x.to(torch.int8), TILE, block_k).contiguous()
    if residual is None:
        return xh, None
    if isinstance(residual, PackedSpikes):
        return xh, residual.words.contiguous()
    return xh, pad_to_blocks(residual.to(torch.float32), TILE,
                             block_n).contiguous()


def train_step(train: tuple, which: int, shape: tuple,
               block: int) -> torch.Tensor:
    """Step ``train[2]`` of the train's x (``which`` 0) or residual (1)
    operand, checked to be the padded layout of a [M, K] (or [M, N])
    operand of ``shape`` on ``block``-wide column blocks."""
    op = train[which][train[2]]
    rows, cols = shape
    want = (-(-rows // TILE) * TILE, -(-cols // block) * block)
    if tuple(op.shape) != want:
        raise ValueError(f"the train's step {tuple(op.shape)} is not the "
                         f"padded {want}")
    return op


def _at(t, i: int):
    """Step ``i`` of an optional [T, ...] operand (tensor or PackedSpikes)."""
    return None if t is None else t[i]


def _stack_packed(ps: PackedSpikes) -> PackedSpikes:
    """A 2-D packed output as the [1, M, N] of a one-step train."""
    return PackedSpikes(ps.words[None], ps.vld_cnt[None], (1, *ps.shape),
                        ps.block_m, ps.block_k,
                        None if ps.occ is None else ps.occ[None])


def pack_steps(spikes: torch.Tensor, block_n: int) -> PackedSpikes:
    """[T, M, N] int8 spikes -> a PackedSpikes on the (128, block_n) grid,
    every step in one pack launch. The pack kernel tiles on 128 x 128: for
    a 256-wide grid the map is padded to it first and the counts are summed
    from the words."""
    if block_n == TILE or spikes.device.type == "cpu":
        return pack_spikes(spikes, block_m=TILE, block_k=block_n)
    ps = pack_spikes(pad_to_blocks(spikes, TILE, block_n))
    return PackedSpikes(ps.words, popcount_block_map(ps.words, TILE, block_n),
                        tuple(spikes.shape), TILE, block_n)


def fused_pe_layer(x: Spikes, w: torch.Tensor, *,
                   bias: Optional[torch.Tensor] = None,
                   residual: Optional[Spikes] = None,
                   q: Optional[Spikes] = None,
                   vld_cnt: Optional[torch.Tensor] = None,
                   tau: float = 0.5, v_th: float = 1.0,
                   soft_reset: bool = False, qk_threshold: float = 1.0,
                   out_format: str = "dense", block_n: int = TILE,
                   block_k: int = TILE, skip: str = "dense",
                   heads: Optional[tuple[int, int]] = None) -> tuple:
    """The fused PE layer over a [T, M, K] spike train (int8 or a 3-D
    PackedSpikes), the twin of the reference's kernel-layer scan:
    ``residual``, ``q`` and ``vld_cnt`` are per step ([T, ...]) or None.

    T=1 is one stateless launch (the deployed form). T>1 scans the
    stateful launch over time, carrying (v, s) from zeros, as
    ``core.lif.lif_multistep`` does: ``s`` is the kernel's pre-mask int8
    spike map; the train is laid out once (``train_operands``), each
    step's launch reads its own step and the steps before it, which its
    near-threshold recheck replays, as views of that one copy.
    With q the kernel runs unmasked and the whole-row (or,
    with ``heads``, per-head) mask gates its spikes outside, a packed q
    unpacked for it, and the step's vld map is recounted on the masked
    map. A packed output is packed after the scan, every step in one pack
    launch. Returns (spikes [T, M, N] int8 or a PackedSpikes on the (128,
    block_n) grid, vld_next [T, Mp/128, Np/block_n] int32)."""
    t = x.shape[0]
    kw = dict(bias=bias, v_th=v_th, block_n=block_n, block_k=block_k,
              skip=skip)
    if t == 1:
        spikes, vld = fused_pe(
            x[0], w, residual=_at(residual, 0), q=_at(q, 0),
            vld_cnt=_at(vld_cnt, 0), qk_threshold=qk_threshold,
            out_format=out_format, heads=heads, **kw)
        if out_format == "packed":
            return _stack_packed(spikes), vld[None]
        return spikes[None], vld[None]
    m, n = x.shape[1], w.shape[1]
    dev = (x.words if isinstance(x, PackedSpikes) else x).device
    v = torch.zeros((m, n), dtype=torch.float32, device=dev)
    s = torch.zeros((m, n), dtype=torch.int8, device=dev)
    xh, rh = train_operands(x, residual, block_k, block_n)
    spikes_ts, vld_ts = [], []
    for ti in range(t):
        spk, vld, v = fused_pe(
            x[ti], w, residual=_at(residual, ti), vld_cnt=_at(vld_cnt, ti),
            v_prev=v, s_prev=s, tau=tau, soft_reset=soft_reset,
            train=(xh, rh, ti), **kw)
        s = spk                                   # the pre-mask carry
        q_t = _at(q, ti)
        if q_t is not None:
            if isinstance(q_t, PackedSpikes):
                q_t = unpack_spikes(q_t)
            if heads is not None:
                gate = head_gate(q_t, heads, qk_threshold)
            else:
                gate = (q_t.to(torch.float32).sum(dim=-1, keepdim=True)
                        >= qk_threshold).to(torch.int8)
            spk = spk * gate
            vld = block_count_map_2d(pad_to_blocks(spk, TILE, block_n), TILE,
                                     block_n)
        spikes_ts.append(spk)
        vld_ts.append(vld)
    spk3, vld3 = torch.stack(spikes_ts), torch.stack(vld_ts)
    if out_format == "packed":
        return pack_steps(spk3, block_n), vld3
    return spk3, vld3
