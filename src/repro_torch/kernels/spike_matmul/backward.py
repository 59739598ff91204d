"""Wrappers for the backward kernels of the spike matmul family
(``csrc/spike_matmul_dx.cu`` and ``csrc/spike_matmul_dw.cu``), the twins of
the reference's ``kernels/spike_matmul/backward.py`` entry points:

  * ``spike_matmul_dx``: ``dv = g ⊙ surr'(v - v_th)`` and ``dx = dv @ wᵀ``
    in one pass, the surrogate factor formed in the kernel;
  * ``spike_matmul_dw``: ``dw = xᵀ @ g`` over the spike operand, int8 or
    bit-packed (the reference's packed_in: a ``PackedSpikes`` on the
    128x128 grid, whose words the kernel reads as they are), skipping
    every 128x128 block of x whose forward ``vld_cnt`` is zero, by the
    dense skip or, with ``skip="gated"``/``"two_level"``, by a walk of the
    compacted transposed vld map (and the occ stripe skip).

Both take unpadded operands (the kernels check their bounds; packed words
come padded to the grid). The kernels run on CUDA tensors, the plain
versions (``ref.py``) on CPU tensors. Each kernel's cut of the work is
planned here, from the shape alone: ``dx_plan`` picks the width of dx's
tiles, ``dw_plan`` the runs of M that dw's CTAs sum apart and the length
of the chain of f32 adds into one output that follows from them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from ...core.events import (LANE_BITS, PackedSpikes, block_count_map_2d,
                            compact_kmap, pad_to_blocks, word_occupancy_map,
                            word_occupancy_map_dense)
from ...core.surrogate import available_surrogates
from .. import _build
from .ops import SKIP_IDS, Gate, check_block_contract, check_skip
from .ref import (spike_matmul_dw_gated_ref, spike_matmul_dw_ref,
                  spike_matmul_dx_ref)

TILE = 128
# the surrogate argument of repro_spike_matmul_dx (0: dv = g)
SURROGATE_IDS = {"atan": 1, "sigmoid": 2, "triangle": 3, "rect": 4}
# the H100's SMs: the plans assume them (a constant, so a plan, and with
# it the order of dw's f32 sums, depends on the shape alone)
SMS = 132
# dx: a tile is 128 rows by block_k columns; per width, the warps of a
# CTA (8 x 8 outputs a thread at 64 and 128, 8 x 12 at 192), the CTAs one
# SM holds at once (their registers), and the per-element cost, in FMAs,
# of forming a step's dv tile (surrogate, transposed store) that every k
# tile of a row block pays
DX_BLOCK_K = (192, 128, 64)
DX_WARPS = {64: 4, 128: 8, 192: 8}
DX_RESIDENT = {64: 2, 128: 1, 192: 1}
DX_STEP_COST = 16
# dw: a CTA's tile is 128 rows (one vld column block) by 64 columns of dw;
# one CTA an SM (its shared memory); a warpgroup takes 64 rows of each
# visited 128-row block in 16-row slices, whose three products (g's three
# bf16 terms) the tensor cores chain before a correctly rounded add joins
# them to the run's sum
DW_TILE_K, DW_TILE_N = 128, 64
DW_TC_ADDS = 3
DW_SLICES = TILE // 2 // 16
# a CTA's fixed cost (pipeline fill, epilogue, partial) in blocks
DW_CTA_BLOCKS = 2


@dataclasses.dataclass(frozen=True)
class DxPlan:
    """dx's cut: tiles of 128 rows by ``block_k`` columns, ``ktiles`` of
    them across K and ``mtiles`` down M."""
    block_k: int
    mtiles: int
    ktiles: int


def dx_plan(m: int, n: int, k: int) -> DxPlan:
    """The dx tile width for an [M, N] @ [K, N]^T launch: the least
    estimated time over 64, 128 and 192 (ties to the wider), where a
    width's time is its tiles an SM (the grid is persistent) times a
    tile's work, ``block_k + DX_STEP_COST`` FMAs a (row, n), over how well
    that many CTAs fill an SM (8 warps do). K = 576 .. 4608 (multiples of
    192) take 192-wide tiles with no padded column."""
    mtiles = max(1, -(-m // TILE))
    best = None
    for bk in DX_BLOCK_K:
        ktiles = max(1, -(-k // bk))
        per_sm = -(-mtiles * ktiles // SMS)
        warps = min(per_sm, DX_RESIDENT[bk]) * DX_WARPS[bk]
        cost = per_sm * (bk + DX_STEP_COST) / min(1.0, warps / 8)
        if best is None or cost < best[0]:
            best = (cost, DxPlan(bk, mtiles, ktiles))
    return best[1]


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """dw's cut: M's 128-row blocks in ``splits`` runs of ``per`` blocks
    (the last may be shorter), each summed by its own CTAs into an f32
    partial; the partials are added in order. ``chain`` is the longest
    chain of f32 adds into one output: a slice's tensor-core
    accumulations (``DW_TC_ADDS``), the run's correctly rounded adds of
    its slices' sums (``DW_SLICES`` a block), the two warpgroups' sum,
    then the partials."""
    splits: int
    per: int
    chain: int


def dw_plan(m: int, k: int, n: int) -> DwPlan:
    """The dw kernel's cut of M for x [M, K] and g [M, N]: the run length
    that minimises the estimated time, the waves of CTAs (one an SM) times
    a CTA's blocks plus its fixed cost (ties to fewer runs)."""
    mblocks = max(1, -(-m // TILE))
    tiles = -(-k // DW_TILE_K) * -(-n // DW_TILE_N)
    best = None
    for per in range(1, mblocks + 1):
        splits = -(-mblocks // per)
        if splits * per - mblocks >= per:
            continue                   # the same cut as a shorter run
        waves = -(-max(tiles, 1) * splits // SMS)
        cost = waves * (per + DW_CTA_BLOCKS)
        if best is None or cost < best[0] or (cost == best[0]
                                               and splits < best[1]):
            best = (cost, splits, per)
    _, splits, per = best
    return DwPlan(splits, per, DW_TC_ADDS + DW_SLICES * per + 1 + splits)


def _check_dx_args(g, w, v, surrogate):
    if surrogate not in SURROGATE_IDS:
        raise ValueError(f"unknown surrogate {surrogate!r}; expected one of "
                         f"{available_surrogates()}")
    if g.ndim != 2 or w.ndim != 2 or w.shape[1] != g.shape[1]:
        raise ValueError(f"g {tuple(g.shape)} and w {tuple(w.shape)} do not "
                         f"chain: g is [M, N] and w is [K, N]")
    if v is not None and v.shape != g.shape:
        raise ValueError(f"v {tuple(v.shape)} is not g's {tuple(g.shape)}")


def spike_matmul_dx_cuda(g: torch.Tensor, w: torch.Tensor,
                         v: Optional[torch.Tensor], surrogate: str = "atan",
                         alpha: float = 2.0, v_th: float = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dx kernel on contiguous f32 CUDA tensors; returns
    (dx [M, K], dv [M, N]), dv being g itself without v. Does not count."""
    _check_dx_args(g, w, v, surrogate)
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul_dx_cuda needs CUDA tensors, got {dev}")
    m, n = g.shape
    k = w.shape[0]
    _build.require(g, "g", torch.float32, (m, n), dev, align=4)
    _build.require(w, "w", torch.float32, (k, n), dev, align=4)
    if v is not None:
        _build.require(v, "v", torch.float32, (m, n), dev, align=4)
    plan = dx_plan(m, n, k)
    dx = torch.empty((m, k), dtype=torch.float32, device=dev)
    dv = (torch.empty((m, n), dtype=torch.float32, device=dev)
          if v is not None else None)
    # the constants the reference forms in double; ctypes rounds each to
    # f32 once, as JAX rounds a Python float meeting an f32 array
    err = _build.library().repro_spike_matmul_dx(
        _build.ptr(g), _build.ptr(v), _build.ptr(w), _build.ptr(dx),
        _build.ptr(dv), m, n, k,
        SURROGATE_IDS[surrogate] if v is not None else 0, plan.block_k, alpha,
        math.pi / 2.0 * alpha, alpha * alpha, 0.5 / alpha, v_th,
        _build.stream(g))
    _build.check(err, "repro_spike_matmul_dx")
    return dx, (g if v is None else dv)


def spike_matmul_dx(g: torch.Tensor, w: torch.Tensor,
                    v: Optional[torch.Tensor] = None, *,
                    surrogate: str = "atan", alpha: float = 2.0,
                    v_th: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward data-gradient ``dx = (g ⊙ surr'(v - v_th)) @ wᵀ``.

    g [M, N] cotangent; w [K, N]; v optional [M, N] membrane current cached
    by the fused forward: with it the surrogate factor is formed in the
    kernel and ``dv`` (the operand the weight, bias and residual gradients
    share) comes out as a by-product; without it ``dv = g``. Returns
    (dx [M, K], dv [M, N])."""
    args = (g.to(torch.float32).contiguous(), w.to(torch.float32).contiguous(),
            None if v is None else v.to(torch.float32).contiguous())
    dev = g.device
    if dev.type == "cpu":
        _check_dx_args(*args, surrogate)
        return spike_matmul_dx_ref(*args, surrogate=surrogate, alpha=alpha,
                                   v_th=v_th)
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul_dx runs on cuda or cpu, not {dev}")
    args = args + (surrogate, alpha, v_th)
    _build.count_launch("spike_matmul_dx", args, (g, w, v))
    return spike_matmul_dx_cuda(*args)


def vld_map(x: torch.Tensor) -> torch.Tensor:
    """int32 [ceil(M/128), ceil(K/128)] spike count per 128x128 block of an
    unpadded [M, K] map."""
    return block_count_map_2d(pad_to_blocks(x, TILE, TILE), TILE, TILE)


SpikeX = Union[torch.Tensor, PackedSpikes]


def _x_occ(x: SpikeX) -> torch.Tensor:
    """x's occ bitmap on the 128x128 grid (a packed x's own, else derived
    from its words; a dense x's from its padded int8 map)."""
    if isinstance(x, PackedSpikes):
        occ = x.occ if x.occ is not None else word_occupancy_map(
            x.words, TILE, TILE)
        return occ.to(torch.int32).contiguous()
    return word_occupancy_map_dense(pad_to_blocks(x, TILE, TILE), TILE,
                                    TILE).contiguous()


def dw_gate(x: SpikeX, vld: torch.Tensor, skip: str) -> Optional[Gate]:
    """None for ``"dense"``; else the walk of the gated dw: ``compact_kmap``
    of the transposed vld map (for each k block, its non-silent m blocks)
    and, for ``"two_level"``, x's occ bitmap on the 128x128 grid."""
    check_skip(skip)
    if skip == "dense":
        return None
    nact_t, mmap = compact_kmap(vld.T.contiguous())
    return Gate(nact_t, mmap, _x_occ(x) if skip == "two_level" else None)


def _dw_launch(x: SpikeX, g: torch.Tensor, vld: Optional[torch.Tensor],
               gate: Optional[Gate]) -> torch.Tensor:
    packed = isinstance(x, PackedSpikes)
    xt = x.words if packed else x
    dev = xt.device
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul_dw needs CUDA tensors, got {dev}")
    m, k = x.shape
    n = g.shape[1]
    gm, gk = -(-m // TILE), -(-k // TILE)
    if packed:
        _build.require(xt, "x words", torch.int32,
                       (gm * TILE, gk * TILE // LANE_BITS), dev, align=16)
    else:
        _build.require(xt, "x", torch.int8, (m, k), dev, align=1)
    _build.require(g, "g", torch.float32, (m, n), dev, align=4)
    if gate is None:
        _build.require(vld, "vld_cnt", torch.int32, (gm, gk), dev, align=4)
        skip = "dense"
    else:
        # a two-level gate's occ is the plain version's: the kernel walks
        # it as the gated one (csrc/spike_matmul_dw.cu's note)
        _build.require(gate.nact, "nact_t", torch.int32, (gk,), dev, align=4)
        _build.require(gate.kmap, "mmap", torch.int32, (gk, gm), dev, align=4)
        skip = gate.skip
    plan = dw_plan(m, k, n)
    kp, np_ = gk * TILE, -(-n // DW_TILE_N) * DW_TILE_N
    partial = torch.empty((plan.splits, kp, np_), dtype=torch.float32,
                          device=dev)
    dw = torch.empty((k, n), dtype=torch.float32, device=dev)
    nact_t, mmap = (gate.nact, gate.kmap) if gate is not None else (None, None)
    err = _build.library().repro_spike_matmul_dw(
        _build.ptr(xt), _build.ptr(g), _build.ptr(vld), _build.ptr(nact_t),
        _build.ptr(mmap), _build.ptr(partial), _build.ptr(dw),
        m, k, n, plan.splits, plan.per, SKIP_IDS[skip], int(packed),
        _build.stream(g))
    _build.check(err, "repro_spike_matmul_dw")
    return dw


def spike_matmul_dw_cuda(x: SpikeX, g: torch.Tensor,
                         vld: torch.Tensor) -> torch.Tensor:
    """Launch the dense-skip dw kernel: x [M, K] int8 (or a 2-D
    PackedSpikes on the 128x128 grid, contiguous words), g [M, N] f32, vld
    [ceil(M/128), ceil(K/128)] int32, all contiguous on one CUDA device.
    Returns dw [K, N] f32. Does not count."""
    return _dw_launch(x, g, vld, None)


def spike_matmul_dw_gated_cuda(x: SpikeX, g: torch.Tensor,
                               gate: Gate) -> torch.Tensor:
    """Launch the gated dw kernel on the walk of ``dw_gate`` (a two-level
    gate's walk is the gated one's). Returns dw [K, N] f32. Does not
    count."""
    return _dw_launch(x, g, None, gate)


def _packed_dw_operand(x: PackedSpikes, vld_cnt: Optional[torch.Tensor]
                       ) -> tuple[PackedSpikes, torch.Tensor]:
    """A packed x with contiguous words, and its vld map, checked against
    the kernel's 128x128 grid."""
    check_block_contract(x, TILE, TILE, "spike_matmul_dw x")
    if len(x.shape) != 2:
        raise ValueError(f"spike_matmul_dw takes a 2-D packed operand, got "
                         f"logical shape {tuple(x.shape)}")
    vld = (x.vld_cnt if vld_cnt is None else vld_cnt).to(torch.int32)
    grid = (x.words.shape[0] // TILE, x.words.shape[1] * LANE_BITS // TILE)
    if tuple(vld.shape) != grid:
        raise ValueError(f"spike_matmul_dw x: vld_cnt grid "
                         f"{tuple(vld.shape)} does not match its words' "
                         f"{grid}")
    xc = PackedSpikes(x.words.contiguous(), vld.contiguous(), tuple(x.shape),
                      TILE, TILE, x.occ)
    return xc, xc.vld_cnt


def spike_matmul_dw(x: SpikeX, g: torch.Tensor, *,
                    vld_cnt: Optional[torch.Tensor] = None,
                    skip: str = "dense") -> torch.Tensor:
    """Backward weight-gradient ``dw = xᵀ @ g``, event-skipped on x.

    x [M, K] binary spikes (any dtype; cast to int8, exact) or a 2-D
    ``PackedSpikes`` packed on the 128x128 grid (its words go to the kernel
    as they are: packed_in), the forward's operand; g [M, N] cotangent;
    ``vld_cnt`` x's [ceil(M/128), ceil(K/128)] count map from the forward
    (computed here for a dense x without one; a packed x carries its own).
    Silent blocks were silent on the way forward and contribute nothing
    here; ``skip`` (``SKIP_MODES``) picks how they are left out, along the
    transposed axis. Returns dw [K, N] f32."""
    if len(x.shape) != 2 or g.ndim != 2 or g.shape[0] != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} do not "
                         f"chain: x is [M, K] and g is [M, N]")
    if isinstance(x, PackedSpikes):
        x8, vld = _packed_dw_operand(x, vld_cnt)
    else:
        x8 = x.to(torch.int8).contiguous()
        vld = (vld_map(x8) if vld_cnt is None
               else vld_cnt.to(torch.int32).contiguous())
    gf = g.to(torch.float32).contiguous()
    gate = dw_gate(x8, vld, skip)
    dev = g.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"spike_matmul_dw runs on cuda or cpu, not {dev}")
    if gate is None:
        args = (x8, gf, vld)
        if dev.type == "cpu":
            return spike_matmul_dw_ref(*args)
        _build.count_launch("spike_matmul_dw", args, (x, g))
        return spike_matmul_dw_cuda(*args)
    args = (x8, gf, gate)
    if dev.type == "cpu":
        return spike_matmul_dw_gated_ref(*args)
    _build.count_launch("spike_matmul_dw_gated", args, (x, g))
    return spike_matmul_dw_gated_cuda(*args)
