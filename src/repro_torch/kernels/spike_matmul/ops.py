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
            gate: Optional[Gate], gk: int, packed_x: bool) -> torch.Tensor:
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul needs CUDA tensors, got {dev}")
    mp, (kp, np_) = xp.shape[0], wp.shape
    if mp % TILE or kp % TILE or np_ % TILE or not gk or kp % gk:
        raise ValueError(f"operands must be {TILE}-aligned: x "
                         f"{tuple(xp.shape)}, w {tuple(wp.shape)}")
    bk = kp // gk
    check_width("block_k", bk)
    if packed_x:
        _build.require(xp, "x", torch.int32, (mp, kp // LANE_BITS), dev)
    else:
        _build.require(xp, "x", torch.int8, (mp, kp), dev)
    _build.require(wp, "w", torch.float32, (kp, np_), dev)
    grid = (mp // TILE, gk)
    if gate is None:
        _build.require(vld, "vld_cnt", torch.int32, grid, dev, align=4)
        skip = "dense"
    else:
        _build.require(gate.nact, "nact", torch.int32, grid[:1], dev, align=4)
        _build.require(gate.kmap, "kmap", torch.int32, grid, dev, align=4)
        if gate.occ is not None:
            _build.require(gate.occ, "occ", torch.int32, grid, dev, align=4)
        skip = gate.skip
    out = torch.empty((mp, np_), dtype=torch.float32, device=dev)
    nact, kmap, occ = gate if gate is not None else (None, None, None)
    err = _build.library().repro_spike_matmul(
        _build.ptr(xp), _build.ptr(wp), _build.ptr(vld), _build.ptr(nact),
        _build.ptr(kmap), _build.ptr(occ), _build.ptr(out), mp, kp, np_, bk,
        int(packed_x), SKIP_IDS[skip], _build.stream(xp))
    _build.check(err, "repro_spike_matmul")
    return out


def spike_matmul_cuda(xp: torch.Tensor, wp: torch.Tensor,
                      vld: torch.Tensor, packed_x: bool = False
                      ) -> torch.Tensor:
    """Launch the dense-skip route on block-aligned CUDA operands (see
    ``spike_matmul_block_ref`` for the contract). Does not count."""
    return _launch(xp, wp, vld, None, vld.shape[1], packed_x)


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
                          skip: str = "dense") -> tuple:
    """The block-aligned operands of one launch, in the order the launchers
    and plain versions take them: (x, w f32, vld, packed_x) for
    ``skip="dense"``, (x, w f32, Gate, packed_x) for the gated routes. A
    dense x is cast to int8, as the reference wrapper casts it; a packed x
    brings its words, vld map (and occ), and w gets zero rows up to the
    words' padded K and zero columns up to a multiple of ``block_n``."""
    check_skip(skip)
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
    else:
        xp = pad_to_blocks(x.to(torch.int8), TILE, block_k).contiguous()
        vld = vld_or_compute(xp, vld_cnt, TILE, block_k).contiguous()
        kp = xp.shape[1]
    wp = weight_operand(w, kp, block_k, block_n)
    if skip == "dense":
        return xp, wp, vld, packed
    occ = x_occupancy(x, xp, block_k) if skip == "two_level" else None
    return xp, wp, make_gate(vld, skip, occ), packed


def spike_matmul(x: Union[torch.Tensor, PackedSpikes], w: torch.Tensor, *,
                 vld_cnt: Optional[torch.Tensor] = None,
                 block_n: int = TILE, block_k: int = TILE,
                 skip: str = "dense") -> torch.Tensor:
    """Event-driven spike matmul: x [M, K] spikes (or a 2-D PackedSpikes)
    @ w [K, N] -> f32 [M, N], on 128 x ``block_k`` metadata blocks (N
    padded to ``block_n``). ``vld_cnt`` is the [Mp/128, Kp/block_k] count
    map of x (a fused layer's ``vld_next``); a dense x without one gets it
    computed here, a packed x carries its own. ``skip`` as in
    ``SKIP_MODES``. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    args = spike_matmul_operands(x, w, vld_cnt, block_n=block_n,
                                 block_k=block_k, skip=skip)
    dev = args[0].device
    gated = skip != "dense"
    if dev.type == "cpu":
        out = (spike_matmul_gated_block_ref if gated
               else spike_matmul_block_ref)(*args)
    elif dev.type == "cuda":
        _build.count_launch("spike_matmul_gated" if gated else "spike_matmul",
                            args, (x, w))
        out = (spike_matmul_gated_cuda if gated else spike_matmul_cuda)(*args)
    else:
        raise ValueError(f"spike_matmul runs on cuda or cpu, not {dev}")
    return out[:x.shape[-2], :w.shape[1]]
