"""Wrapper for the event-driven spike matmul kernel (``csrc/spike_matmul.cu``):
the operands, the ``vld_cnt`` map, the gated routing, the tile plan,
checks, and the device split. x is an int8 spike map or a ``PackedSpikes``
(the kernel's packed_in variant).

``skip`` is the byte-skip strategy of the reference (``SKIP_MODES``):
``"dense"`` walks every k block and skips the silent ones on ``vld_cnt``;
``"gated"`` walks only the compacted list of non-silent blocks
(``core.events.compact_kmap``, built on the device); ``"two_level"`` also
skips the silent 32-column stripes inside a block on the word-occupancy
bitmap ``occ``. The three give the same sums; the autotuner picks one per
layer from its cost model.

The kernel has two routes (``ROUTES``), picked from the shapes alone
(``pick_route``): the tile, which reads x and w at their own K and N (an
int8 x at its own rows, its columns rounded up to 16; w in place) and
writes out at x's rows, in tiles 128 rows by ``tile_plan``'s width; and the
decode route (``csrc/decode_gemm.cuh``) for a launch of at most
``DECODE_ROWS`` live rows on the dense skip (the LM's ``wo`` at a decode
tick or a prefill chunk), which reads x at its own rows with K padded to
the block, w padded to whole blocks, and gives the tile's bits.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from ...core.events import (LANE_BITS, PackedSpikes, compact_kmap,
                            pad_to_blocks, vld_or_compute,
                            word_occupancy_map, word_occupancy_map_dense)
from .. import _build
from ..contract import KernelContract, declare, matmul_smem
from .ref import (block_width, spike_matmul_block_ref,
                  spike_matmul_gated_block_ref)

CONTRACT = declare(KernelContract(
    family="spike_matmul", ops=("matmul",),
    skips=("dense", "gated", "two_level"), grad=True, grad_ops=("matmul",),
    smem_bytes=matmul_smem))

TILE = 128          # the kernel's CTA tile == the metadata block's rows
# the byte-skip strategies shared by spike_matmul, fused_pe and the dw
SKIP_MODES = ("dense", "gated", "two_level")
SKIP_IDS = {skip: i for i, skip in enumerate(SKIP_MODES)}
# the k (or n) widths of a metadata block the kernels take: the autotuner
# may tile a layer's output twice as wide, and the next layer's k inherits
# that grid
BLOCK_WIDTHS = (TILE, 2 * TILE)
# the kernels' routes: the 128-row tile, and the decode route for a launch
# of at most DECODE_ROWS live rows on the dense skip
ROUTES = ("tile", "decode")
ROUTE_IDS = {route: i for i, route in enumerate(ROUTES)}
DECODE_ROWS = 64
# an int8 x's row length on the tile route is a multiple of this (TMA
# reads rows that are whole 16-byte units apart)
X_ROW_ALIGN = 16
# the H100's SMs: the plans (this tile's, and backward.py's dx and dw)
# assume them, a constant, so that a plan, and with it the order of dw's
# f32 sums, depends on the shape alone
SMS = 132
# the tile route: a tile is 128 rows by block_n columns; per width, the
# warps of a CTA (8 x 8 outputs a thread at 64 and 128, 8 x 12 at 192), the
# CTAs one SM holds at once (their shared memory and registers), and the
# per-step cost, in columns, of what a tile does whatever its width (the
# x it stages and widens, the barrier)
TILE_BLOCK_N = (192, 128, 64)
TILE_WARPS = {64: 4, 128: 8, 192: 8}
TILE_RESIDENT = {64: 2, 128: 2, 192: 1}
TILE_STEP_COST = 16


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The tile route's cut: tiles of 128 rows by ``block_n`` columns,
    ``mtiles`` of them down M and ``ntiles`` across N."""
    block_n: int
    mtiles: int
    ntiles: int


def tile_plan(m: int, n: int, k: int) -> TilePlan:
    """The tile width for an [M, K] @ [K, N] launch: the least estimated
    time over 64, 128 and 192 (ties to the wider), where a width's time is
    its tiles an SM (the grid is persistent) times a tile's work a step,
    ``block_n + TILE_STEP_COST``, over how well that many CTAs keep an SM's
    FMA pipes busy (8 warps fully, 4 warps, one a scheduler, to three
    quarters). K is common to every width. N = 64 takes 64-wide tiles;
    the shortcuts' N = 128..512 take 128, a grid too short to fill the card
    64."""
    mtiles = max(1, -(-m // TILE))
    best = None
    for bn in TILE_BLOCK_N:
        ntiles = max(1, -(-n // bn))
        per_sm = -(-mtiles * ntiles // SMS)
        warps = min(per_sm, TILE_RESIDENT[bn]) * TILE_WARPS[bn]
        cost = per_sm * (bn + TILE_STEP_COST) / min(1.0, 0.5 + warps / 16)
        if best is None or cost < best[0]:
            best = (cost, TilePlan(bn, mtiles, ntiles))
    return best[1]


class Gate(NamedTuple):
    """The routing of a gated launch: ``compact_kmap`` of the vld map
    (nact [Gm], kmap [Gm, Gk] int32) and, for ``"two_level"``, the
    word-occupancy bitmap occ [Gm, Gk] int32 (None for ``"gated"``)."""
    nact: torch.Tensor
    kmap: torch.Tensor
    occ: Optional[torch.Tensor] = None

    @property
    def skip(self) -> str:
        return "gated" if self.occ is None else "two_level"


def check_skip(skip: str) -> None:
    if skip not in SKIP_MODES:
        raise ValueError(f"skip={skip!r} not in {SKIP_MODES}")


def pick_route(m: int, skip: str) -> str:
    """The route of a launch of ``m`` live rows on ``skip``: ``"decode"``
    for at most ``DECODE_ROWS`` rows on the dense skip, else ``"tile"``.
    The two give the same bits, so this is a choice of speed alone."""
    check_skip(skip)
    return "decode" if skip == "dense" and m <= DECODE_ROWS else "tile"


def check_route(route: str, skip: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"route={route!r} not in {ROUTES}")
    if route == "decode" and skip != "dense":
        raise ValueError(f"the decode route takes skip='dense', not {skip!r}")


def rows_padded(t: torch.Tensor) -> torch.Tensor:
    """An operand's rows zero-padded to whole 128-row blocks (words of a
    packed operand come so already)."""
    return pad_to_blocks(t, TILE, 1).contiguous()


def row_vld(xp: torch.Tensor, vld_cnt: Optional[torch.Tensor],
            block_k: int) -> torch.Tensor:
    """The count map of an int8 x read at its own rows and columns, on the
    (128, block_k) grid of its shape padded to whole blocks: the
    producer's, checked, or one pass over the padded operand."""
    if vld_cnt is None:
        return vld_or_compute(pad_to_blocks(xp, TILE, block_k), None, TILE,
                              block_k).contiguous()
    expect = (-(-xp.shape[0] // TILE), -(-xp.shape[1] // block_k))
    if tuple(vld_cnt.shape) != expect:
        raise ValueError(f"vld_cnt grid {tuple(vld_cnt.shape)} does not "
                         f"match the [{xp.shape[0]}, {xp.shape[1]}] operand's "
                         f"{expect} on (128, block_k={block_k})")
    return vld_cnt.to(torch.int32).contiguous()


def check_width(name: str, width: int) -> None:
    if width not in BLOCK_WIDTHS:
        raise ValueError(f"{name}={width} is not one of the kernels' block "
                         f"widths {BLOCK_WIDTHS}")


def check_block_contract(ps: PackedSpikes, block_m: int, block_k: int,
                         what: str = "packed operand") -> None:
    """A PackedSpikes pins its tile grid when it is packed; the kernel
    must tile the same way, or its vld_cnt and occ maps route nothing."""
    if (ps.block_m, ps.block_k) != (block_m, block_k):
        raise ValueError(
            f"{what} was packed on (block_m={ps.block_m}, "
            f"block_k={ps.block_k}) but the kernel tiles on "
            f"(block_m={block_m}, block_k={block_k}); re-pack it")


def make_gate(vld: torch.Tensor, skip: str,
              occ: Optional[torch.Tensor] = None) -> Optional[Gate]:
    """None for ``"dense"``; else the compacted routing of ``vld`` (and
    ``occ``, required for ``"two_level"``)."""
    check_skip(skip)
    if skip == "dense":
        return None
    nact, kmap = compact_kmap(vld)
    if skip == "gated":
        return Gate(nact, kmap)
    if occ is None or tuple(occ.shape) != tuple(vld.shape):
        raise ValueError("two_level gating needs the occ bitmap on the vld "
                         "map's grid")
    return Gate(nact, kmap, occ.to(torch.int32).contiguous())


def packed_operand(ps: PackedSpikes, vld_cnt: Optional[torch.Tensor],
                   what: str, block_k: int = TILE
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The words and vld map of a 2-D packed x, checked against the grid."""
    check_block_contract(ps, TILE, block_k, what)
    if len(ps.shape) != 2:
        raise ValueError(f"{what} must be a 2-D packed operand, got logical "
                         f"shape {tuple(ps.shape)}")
    words = ps.words.contiguous()
    vld = ps.vld_cnt if vld_cnt is None else vld_cnt
    expect = (words.shape[0] // TILE, words.shape[1] * LANE_BITS // block_k)
    if tuple(vld.shape) != expect:
        raise ValueError(f"{what}: vld_cnt grid {tuple(vld.shape)} does not "
                         f"match its words' {expect}")
    return words, vld.to(torch.int32).contiguous()


def x_occupancy(x: Union[torch.Tensor, PackedSpikes], xp: torch.Tensor,
                block_k: int) -> torch.Tensor:
    """The occ bitmap of the operand on its (128, block_k) grid: a packed
    x's own (derived from its words when the producer emitted none), a
    dense one's from its padded int8 map."""
    if isinstance(x, PackedSpikes):
        return (x.occ if x.occ is not None
                else word_occupancy_map(xp, TILE, block_k))
    return word_occupancy_map_dense(pad_to_blocks(xp, TILE, block_k), TILE,
                                    block_k)


def x_operand(x: torch.Tensor) -> torch.Tensor:
    """A dense x as the tile route reads it: int8 at its own [M, K], its
    rows zero-padded to a multiple of ``X_ROW_ALIGN`` columns (a copy only
    where K is not one), contiguous and 16-byte aligned."""
    x8 = pad_to_blocks(x.to(torch.int8), 1, X_ROW_ALIGN).contiguous()
    return x8 if x8.data_ptr() % 16 == 0 else x8.clone()


def weight_operand(w: torch.Tensor, kp: int, block_k: int = TILE,
                   block_n: int = TILE) -> torch.Tensor:
    """w [K, N] -> f32 [Kp, Np], zero rows up to the operand's padded K."""
    wp = pad_to_blocks(w.to(torch.float32), block_k, block_n)
    if wp.shape[0] < kp:
        wp = F.pad(wp, (0, 0, 0, kp - wp.shape[0]))
    return wp.contiguous()


def _require_maps(vld, gate, grid: tuple, dev) -> None:
    if gate is None:
        _build.require(vld, "vld_cnt", torch.int32, grid, dev, align=4)
        return
    _build.require(gate.nact, "nact", torch.int32, grid[:1], dev, align=4)
    _build.require(gate.kmap, "kmap", torch.int32, grid, dev, align=4)
    if gate.occ is not None:
        _build.require(gate.occ, "occ", torch.int32, grid, dev, align=4)


def _out(out: Optional[torch.Tensor], shape: tuple, dev) -> torch.Tensor:
    """The output buffer: a new one, or the caller's, checked."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    _build.require(out, "out", torch.float32, shape, dev)
    return out


def tma_rows(w: torch.Tensor) -> torch.Tensor:
    """w as the tile's TMA reads it: itself where its rows are a multiple
    of 16 bytes long and it is 16-byte aligned (N % 4 == 0: every layer of
    the models), else a copy whose rows are padded to 4 floats (read only
    up to N)."""
    k, n = w.shape
    if n % 4 == 0 and w.data_ptr() % 16 == 0:
        return w
    wq = w.new_zeros((k, -(-n // 4) * 4))
    wq[:, :n] = w
    return wq


def _launch_tile(xp: torch.Tensor, w: torch.Tensor,
                 vld: Optional[torch.Tensor], gate: Optional[Gate],
                 packed_x: bool, out: Optional[torch.Tensor]) -> torch.Tensor:
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul needs CUDA tensors, got {dev}")
    skip = "dense" if gate is None else gate.skip
    rows, ldx = xp.shape
    k, n = w.shape
    if (ldx * LANE_BITS if packed_x else ldx) < k or (
            not packed_x and ldx % X_ROW_ALIGN):
        raise ValueError(f"x {tuple(xp.shape)} does not hold w "
                         f"{tuple(w.shape)}'s K (an int8 x's rows are a "
                         f"multiple of {X_ROW_ALIGN} long)")
    grid = tuple((vld if gate is None else gate.kmap).shape)
    bk = block_width(k, grid[1])
    if grid[0] != -(-rows // TILE):
        raise ValueError(f"the map's grid {grid} does not cover x's {rows} "
                         f"rows in 128-row blocks")
    _build.require(xp, "x", torch.int32 if packed_x else torch.int8,
                   (rows, ldx), dev)
    _build.require(w, "w", torch.float32, (k, n), dev, align=4)
    _require_maps(vld, gate, grid, dev)
    out = _out(out, (rows, n), dev)
    nact, kmap, occ = gate if gate is not None else (None, None, None)
    wt = tma_rows(w)
    err = _build.library().repro_spike_matmul(
        _build.ptr(xp), _build.ptr(wt), _build.ptr(vld), _build.ptr(nact),
        _build.ptr(kmap), _build.ptr(occ), _build.ptr(out), rows, k, n, ldx,
        wt.shape[1], bk, tile_plan(rows, n, k).block_n, int(packed_x),
        SKIP_IDS[skip], _build.stream(xp))
    _build.check(err, "repro_spike_matmul")
    return out


def _launch_decode(xp: torch.Tensor, wp: torch.Tensor, vld: torch.Tensor,
                   packed_x: bool, out: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul needs CUDA tensors, got {dev}")
    rows, (kp, np_) = xp.shape[0], wp.shape
    # the decode route reads x's rows (the live ones) and writes whole
    # 128-row blocks
    mp = -(-rows // TILE) * TILE
    gk = vld.shape[1]
    if kp % TILE or np_ % TILE or not gk or kp % gk:
        raise ValueError(f"operands must be {TILE}-aligned: x "
                         f"{tuple(xp.shape)}, w {tuple(wp.shape)}")
    if rows > DECODE_ROWS:
        raise ValueError(f"the decode route takes at most {DECODE_ROWS} "
                         f"rows of x, got {rows}")
    bk = kp // gk
    check_width("block_k", bk)
    _build.require(xp, "x", torch.int32 if packed_x else torch.int8,
                   (rows, kp // LANE_BITS if packed_x else kp), dev)
    _build.require(wp, "w", torch.float32, (kp, np_), dev)
    _require_maps(vld, None, (mp // TILE, gk), dev)
    out = _out(out, (mp, np_), dev)
    err = _build.library().repro_spike_matmul_decode(
        _build.ptr(xp), _build.ptr(wp), _build.ptr(vld), _build.ptr(out), mp,
        kp, np_, bk, int(packed_x), rows, _build.stream(xp))
    _build.check(err, "repro_spike_matmul_decode")
    return out


def spike_matmul_cuda(xp: torch.Tensor, wp: torch.Tensor,
                      vld: torch.Tensor, packed_x: bool = False, *,
                      route: str = "tile",
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the dense skip on CUDA operands (see
    ``spike_matmul_block_ref`` for the contract): the tile, out [rows of x,
    N]; or with ``route="decode"`` the decode route over x's rows, at most
    ``DECODE_ROWS`` of them and not padded to 128 (the output's rows are).
    ``out``, where given, is the buffer written (every element of it).
    Does not count."""
    check_route(route, "dense")
    if route == "decode":
        return _launch_decode(xp, wp, vld, packed_x, out)
    return _launch_tile(xp, wp, vld, None, packed_x, out)


def spike_matmul_gated_cuda(xp: torch.Tensor, wp: torch.Tensor,
                            gate: Gate, packed_x: bool = False, *,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Launch the gated (or, with ``gate.occ``, two-level) walk on CUDA
    operands (see ``spike_matmul_gated_block_ref``). Does not count."""
    return _launch_tile(xp, wp, None, gate, packed_x, out)


def spike_matmul_operands(x: Union[torch.Tensor, PackedSpikes],
                          w: torch.Tensor,
                          vld_cnt: Optional[torch.Tensor] = None, *,
                          block_n: int = TILE, block_k: int = TILE,
                          skip: str = "dense", route: str = "tile") -> tuple:
    """The operands of one launch, in the order the launchers and plain
    versions take them: (x, w f32, vld, packed_x) for ``skip="dense"``, (x,
    w f32, Gate, packed_x) for the gated routes. On the tile route a dense
    x is cast to int8, as the reference wrapper casts it, at its own rows
    and K (``x_operand``); a packed x brings its words, vld map (and occ);
    w is read as it is, f32 [K, N] (no copy when it is f32 and
    contiguous). The maps are on x's (128, ``block_k``) grid;
    ``block_n`` is the metadata width of the output, which the tile does
    not need.

    ``route="decode"`` gives the decode route's operands, in the same
    order: x at its own M rows (a dense x's K padded to ``block_k``; a
    packed x's first M rows of words), its vld map on the grid of its rows
    padded to 128, and w with zero rows up to the padded K and zero columns
    up to a multiple of ``block_n``. ``spike_matmul_tile_operands`` pads
    x's rows to 128 for the tile, which then computes the same outputs."""
    check_skip(skip)
    check_route(route, skip)
    check_width("block_n", block_n)
    check_width("block_k", block_k)
    packed = isinstance(x, PackedSpikes)
    k0 = x.shape[-1]
    if w.shape[0] != k0:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    if route == "decode":
        if packed:
            xp, vld = packed_operand(x, vld_cnt, "spike_matmul x", block_k)
            kp = xp.shape[1] * LANE_BITS
            xp = xp[:x.shape[-2]]
        else:
            xp = pad_to_blocks(x.to(torch.int8), 1, block_k).contiguous()
            vld = row_vld(xp, vld_cnt, block_k)
            kp = xp.shape[1]
        return xp, weight_operand(w, kp, block_k, block_n), vld, packed
    if packed:
        xp, vld = packed_operand(x, vld_cnt, "spike_matmul x", block_k)
    else:
        xp = x_operand(x)
        vld = row_vld(xp, vld_cnt, block_k)
    wf = w.to(torch.float32).contiguous()
    if skip == "dense":
        return xp, wf, vld, packed
    occ = x_occupancy(x, xp, block_k) if skip == "two_level" else None
    return xp, wf, make_gate(vld, skip, occ), packed


def spike_matmul_tile_operands(args: tuple) -> tuple:
    """The tile's operands of a launch's operands (either route's): x's
    rows zero-padded to whole 128-row blocks, on which the tile computes
    the decode route's outputs, padded rows included."""
    xp, *rest = args
    return (rows_padded(xp), *rest)


def spike_matmul(x: Union[torch.Tensor, PackedSpikes], w: torch.Tensor, *,
                 vld_cnt: Optional[torch.Tensor] = None,
                 block_n: int = TILE, block_k: int = TILE,
                 skip: str = "dense") -> torch.Tensor:
    """Event-driven spike matmul: x [M, K] spikes (or a 2-D PackedSpikes)
    @ w [K, N] -> f32 [M, N], on 128 x ``block_k`` metadata blocks.
    ``vld_cnt`` is the [ceil(M/128), ceil(K/block_k)] count map of x (a
    fused layer's ``vld_next``); a dense x without one gets it computed
    here, a packed x carries its own. ``skip`` as in
    ``SKIP_MODES``. The kernel on CUDA tensors, on the route
    ``pick_route`` gives M and ``skip``; the plain version on CPU
    tensors."""
    dev = (x.words if isinstance(x, PackedSpikes) else x).device
    gated = skip != "dense"
    kw = dict(block_n=block_n, block_k=block_k, skip=skip)
    if dev.type == "cpu":
        args = spike_matmul_operands(x, w, vld_cnt, **kw)
        out = (spike_matmul_gated_block_ref if gated
               else spike_matmul_block_ref)(*args)
    elif dev.type == "cuda":
        route = pick_route(x.shape[-2], skip)
        args = spike_matmul_operands(x, w, vld_cnt, **kw, route=route)
        _build.count_launch("spike_matmul_gated" if gated else "spike_matmul",
                            args, (x, w), route)
        out = (spike_matmul_gated_cuda(*args) if gated
               else spike_matmul_cuda(*args, route=route))
    else:
        raise ValueError(f"spike_matmul runs on cuda or cpu, not {dev}")
    return out[:x.shape[-2], :w.shape[1]]
