"""Wrapper for the event-driven spike matmul kernel (``csrc/spike_matmul.cu``):
padding, the ``vld_cnt`` map, the gated routing, checks, and the device
split. x is an int8 spike map or a ``PackedSpikes`` (the kernel's packed_in
variant).

``skip`` is the byte-skip strategy of the reference (``SKIP_MODES``):
``"dense"`` walks every k block and skips the silent ones on ``vld_cnt``;
``"gated"`` walks only the compacted list of non-silent blocks
(``core.events.compact_kmap``, built on the device); ``"two_level"`` also
skips the silent 32-column stripes inside a block on the word-occupancy
bitmap ``occ``. The three give the same sums; the autotuner picks one per
layer from its cost model.

The kernel has two routes (``ROUTES``), picked from the shapes alone
(``pick_route``): the 128-row tile, and the decode route
(``csrc/decode_gemm.cuh``) for a launch of at most ``DECODE_ROWS`` live
rows on the dense skip (the LM's ``wo`` at a decode tick or a prefill
chunk), which reads x at its own rows, unpadded, and gives the tile's bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from ...core.events import (LANE_BITS, PackedSpikes, compact_kmap,
                            pad_to_blocks, vld_or_compute,
                            word_occupancy_map, word_occupancy_map_dense)
from .. import _build
from .ref import spike_matmul_block_ref, spike_matmul_gated_block_ref

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
    """The count map of an int8 x read at its own rows, on the (128,
    block_k) grid of its rows padded to 128: the producer's, checked, or
    one pass over the padded rows."""
    if vld_cnt is None:
        return vld_or_compute(rows_padded(xp), None, TILE, block_k)
    expect = (-(-xp.shape[0] // TILE), xp.shape[1] // block_k)
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
    return word_occupancy_map_dense(xp, TILE, block_k)


def weight_operand(w: torch.Tensor, kp: int, block_k: int = TILE,
                   block_n: int = TILE) -> torch.Tensor:
    """w [K, N] -> f32 [Kp, Np], zero rows up to the operand's padded K."""
    wp = pad_to_blocks(w.to(torch.float32), block_k, block_n)
    if wp.shape[0] < kp:
        wp = F.pad(wp, (0, 0, 0, kp - wp.shape[0]))
    return wp.contiguous()


def _launch(xp: torch.Tensor, wp: torch.Tensor, vld: Optional[torch.Tensor],
            gate: Optional[Gate], gk: int, packed_x: bool,
            route: str = "tile") -> torch.Tensor:
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul needs CUDA tensors, got {dev}")
    skip = "dense" if gate is None else gate.skip
    check_route(route, skip)
    rows, (kp, np_) = xp.shape[0], wp.shape
    # the output's rows: the tile route's are x's; the decode route reads
    # x's rows (the live ones) and writes whole 128-row blocks
    mp = rows if route == "tile" else -(-rows // TILE) * TILE
    if mp % TILE or kp % TILE or np_ % TILE or not gk or kp % gk:
        raise ValueError(f"operands must be {TILE}-aligned: x "
                         f"{tuple(xp.shape)}, w {tuple(wp.shape)}")
    if route == "decode" and rows > DECODE_ROWS:
        raise ValueError(f"the decode route takes at most {DECODE_ROWS} "
                         f"rows of x, got {rows}")
    bk = kp // gk
    check_width("block_k", bk)
    if packed_x:
        _build.require(xp, "x", torch.int32, (rows, kp // LANE_BITS), dev)
    else:
        _build.require(xp, "x", torch.int8, (rows, kp), dev)
    _build.require(wp, "w", torch.float32, (kp, np_), dev)
    grid = (mp // TILE, gk)
    if gate is None:
        _build.require(vld, "vld_cnt", torch.int32, grid, dev, align=4)
    else:
        _build.require(gate.nact, "nact", torch.int32, grid[:1], dev, align=4)
        _build.require(gate.kmap, "kmap", torch.int32, grid, dev, align=4)
        if gate.occ is not None:
            _build.require(gate.occ, "occ", torch.int32, grid, dev, align=4)
    out = torch.empty((mp, np_), dtype=torch.float32, device=dev)
    nact, kmap, occ = gate if gate is not None else (None, None, None)
    err = _build.library().repro_spike_matmul(
        _build.ptr(xp), _build.ptr(wp), _build.ptr(vld), _build.ptr(nact),
        _build.ptr(kmap), _build.ptr(occ), _build.ptr(out), mp, kp, np_, bk,
        int(packed_x), SKIP_IDS[skip], ROUTE_IDS[route], rows,
        _build.stream(xp))
    _build.check(err, "repro_spike_matmul")
    return out


def spike_matmul_cuda(xp: torch.Tensor, wp: torch.Tensor,
                      vld: torch.Tensor, packed_x: bool = False, *,
                      route: str = "tile") -> torch.Tensor:
    """Launch the dense-skip route on block-aligned CUDA operands (see
    ``spike_matmul_block_ref`` for the contract): the 128-row tile, or with
    ``route="decode"`` the decode route over x's rows, at most
    ``DECODE_ROWS`` of them and not padded to 128 (the output's rows are).
    Does not count."""
    return _launch(xp, wp, vld, None, vld.shape[1], packed_x, route)


def spike_matmul_gated_cuda(xp: torch.Tensor, wp: torch.Tensor,
                            gate: Gate, packed_x: bool = False
                            ) -> torch.Tensor:
    """Launch the gated (or, with ``gate.occ``, two-level) route on
    block-aligned CUDA operands (see ``spike_matmul_gated_block_ref``).
    Does not count."""
    return _launch(xp, wp, None, gate, gate.kmap.shape[1], packed_x)


def spike_matmul_operands(x: Union[torch.Tensor, PackedSpikes],
                          w: torch.Tensor,
                          vld_cnt: Optional[torch.Tensor] = None, *,
                          block_n: int = TILE, block_k: int = TILE,
                          skip: str = "dense", route: str = "tile") -> tuple:
    """The block-aligned operands of one launch, in the order the launchers
    and plain versions take them: (x, w f32, vld, packed_x) for
    ``skip="dense"``, (x, w f32, Gate, packed_x) for the gated routes. A
    dense x is cast to int8, as the reference wrapper casts it; a packed x
    brings its words, vld map (and occ), and w gets zero rows up to the
    words' padded K and zero columns up to a multiple of ``block_n``.

    ``route="decode"`` gives the decode route's operands, in the same
    order: x at its own M rows (a dense x's K padded, no row padding; a
    packed x's first M rows of words), its vld map on the grid of its rows
    padded to 128. ``spike_matmul_tile_operands`` pads them back to the
    tile's."""
    check_skip(skip)
    check_route(route, skip)
    check_width("block_n", block_n)
    check_width("block_k", block_k)
    packed = isinstance(x, PackedSpikes)
    k0 = x.shape[-1]
    if w.shape[0] != k0:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"chain")
    if packed:
        xp, vld = packed_operand(x, vld_cnt, "spike_matmul x", block_k)
        kp = xp.shape[1] * LANE_BITS
        if route == "decode":
            xp = xp[:x.shape[-2]]
    elif route == "decode":
        xp = pad_to_blocks(x.to(torch.int8), 1, block_k).contiguous()
        vld = row_vld(xp, vld_cnt, block_k)
        kp = xp.shape[1]
    else:
        xp = pad_to_blocks(x.to(torch.int8), TILE, block_k).contiguous()
        vld = vld_or_compute(xp, vld_cnt, TILE, block_k).contiguous()
        kp = xp.shape[1]
    wp = weight_operand(w, kp, block_k, block_n)
    if skip == "dense":
        return xp, wp, vld, packed
    occ = x_occupancy(x, xp, block_k) if skip == "two_level" else None
    return xp, wp, make_gate(vld, skip, occ), packed


def spike_matmul_tile_operands(args: tuple) -> tuple:
    """The 128-row tile's operands of a launch's operands (either route's):
    x's rows zero-padded to whole 128-row blocks, on which the tile route
    computes the decode route's outputs."""
    xp, *rest = args
    return (rows_padded(xp), *rest)


def spike_matmul(x: Union[torch.Tensor, PackedSpikes], w: torch.Tensor, *,
                 vld_cnt: Optional[torch.Tensor] = None,
                 block_n: int = TILE, block_k: int = TILE,
                 skip: str = "dense") -> torch.Tensor:
    """Event-driven spike matmul: x [M, K] spikes (or a 2-D PackedSpikes)
    @ w [K, N] -> f32 [M, N], on 128 x ``block_k`` metadata blocks (N
    padded to ``block_n``). ``vld_cnt`` is the [Mp/128, Kp/block_k] count
    map of x (a fused layer's ``vld_next``); a dense x without one gets it
    computed here, a packed x carries its own. ``skip`` as in
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
