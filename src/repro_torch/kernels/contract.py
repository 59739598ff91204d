"""Kernel-contract declarations: what each kernel family promises the
registry (twin of ``repro.kernels.contract``).

The event machinery depends on metadata contracts (``vld_cnt`` block maps,
``occ`` word-occupancy bitmaps, packed pad lanes, head lane masks) holding
at every ``(op, mode)`` boundary. Each family's ``ops.py`` declares one
``KernelContract`` at import time: the registry ops it backs, the policy
axes those ops support, and a model of the shared memory one CTA of its
kernels takes. ``repro_torch.analysis.contracts`` checks the whole registry
against these declarations; ``kernel_contracts()`` is what it walks.

The shared-memory models are read off the ``csrc/`` tiles they price (each
one's ``__shared__`` arrays and the dynamic shared-memory size its launch
asks for), the port's counterpart of the reference's VMEM models over its
BlockSpecs. They are checked against one H100 block's limit,
``launch.roofline.SMEM_BYTES_PER_BLOCK``. The tiles are fixed-size, so
most models do not depend on the block arguments: a model gives the most
any launch of the family takes.

This module imports nothing from the ops or analysis layers, so that a
family's ``ops.py`` can declare without an import cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

#: spikes per packed int32 word (``core.events.LANE_BITS``, kept here so
#: that the declarations import nothing)
LANE_BITS = 32

#: the seven kernel families; ``kernel_contracts`` imports each family's
#: ``ops`` module, so a missing declaration is an error, not a gap
FAMILIES = ("spike_matmul", "lif_update", "fused_pe", "packed",
            "qk_attention", "flash_attention", "w2ttfs_pool")


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """One family's registry contract.

    family       : kernel-family package name under ``repro_torch.kernels``.
    ops          : registry op names the family backs.
    modes        : base kernel modes registered per op ("reference" /
                   "fused"; the "+grad" modes follow from ``grad``).
    formats      : spike-map formats the ops accept and emit.
    skips        : byte-skip strategies the matmul-sweep ops accept.
    grad         : True when every op takes part in the "+grad" axis.
    grad_ops     : the ops that do, where only some do (overrides
                   ``grad``; e.g. the packed family's im2col / pool
                   differentiate, pack / unpack are format conversions).
    emits_spikes : True when outputs are SpikeTensors (the metadata
                   contract applies to every packed output).
    head_blocked : True when the op takes ``heads=(h, dh)``.
    smem_bytes   : the family's shared-memory model: ``(block_m, block_n,
                   block_k, packed) -> bytes`` one CTA takes, at most;
                   None where it has none to declare.
    """
    family: str
    ops: tuple
    modes: tuple = ("reference", "fused")
    formats: tuple = ("dense", "packed")
    skips: tuple = ("dense",)
    grad: bool = False
    grad_ops: Optional[tuple] = None
    emits_spikes: bool = False
    head_blocked: bool = False
    smem_bytes: Optional[Callable[[int, int, int, bool], int]] = None

    def gradient_ops(self) -> tuple:
        """The ops that must resolve both ``+grad`` registry modes."""
        if self.grad_ops is not None:
            return self.grad_ops
        return self.ops if self.grad else ()


_CONTRACTS: dict[str, KernelContract] = {}


def declare(contract: KernelContract) -> KernelContract:
    """Register a family's contract (called at family-ops import time)."""
    _CONTRACTS[contract.family] = contract
    return contract


def kernel_contracts() -> dict[str, KernelContract]:
    """All declared contracts, every family's declaration imported first.

    An undeclared family raises instead of shrinking the sweep."""
    import importlib

    for fam in FAMILIES:
        importlib.import_module(f"repro_torch.kernels.{fam}.ops")
        if fam not in _CONTRACTS:
            raise RuntimeError(
                f"kernel family {fam!r} declares no KernelContract; every "
                f"family must declare() one in its ops module so that the "
                f"contract sweep covers it")
    return dict(_CONTRACTS)


# ------------------------------------------------- shared-memory models
def spike_matmul_tile_smem(block_m: int, block_n: int) -> int:
    """``csrc/spike_matmul.cu``'s ``Cfg::kSmem``: a ring of 4 TMA slots,
    each a 32-deep step's f32 w rows and its x (int8 rows, or the packed
    words), two widened f32 x tiles, and 12 bytes of mbarriers and words
    a slot."""
    stages, step = 4, 32
    stage = step * block_n * 4 + block_m * step
    return stages * stage + 2 * step * block_m * 4 + 12 * stages


def spike_matmul_dx_smem(n: int, k_tile: int) -> int:
    """``csrc/spike_matmul_dx.cu``'s launch: dvT buffers of 16 rows by the
    128-row tile (plus a 4-float pad), all of N's resident up to N = 256,
    else two, and two wT slices of 16 by the tile's columns (+4), f32."""
    steps = -(-n // 16) if n <= 256 else 2
    return (steps * 16 * (128 + 4) + 2 * 16 * (k_tile + 4)) * 4


def spike_matmul_dw_smem() -> int:
    """``csrc/spike_matmul_dw.cu``'s ``kSmem``: two bf16 x blocks of 128 x
    128, three g stages of 128 rows by 68 floats, three int8 x stages of
    128 x 128, and 1024 bytes to align them."""
    mb, kt, pitch, stages = 128, 128, 64 + 4, 3
    return 2 * mb * kt * 2 + stages * mb * pitch * 4 + stages * mb * kt + 1024


#: ``csrc/decode_gemm.cuh``'s ``kDecodeMaxSmem``: the decode route fits
#: its ring to this, below the block's limit by the static arrays
DECODE_MAX_SMEM = 232448 - 2048


def matmul_smem(block_m: int, block_n: int, block_k: int,
                packed: bool) -> int:
    """The spike-matmul family: the most of its forward tile at its widest
    (192 columns), the dx tile (N = 256 resident, 192 columns), the dw
    tile and the decode route's cap."""
    return max(spike_matmul_tile_smem(block_m, max(block_n, 192)),
               spike_matmul_dx_smem(256, 192), spike_matmul_dw_smem(),
               DECODE_MAX_SMEM)


def fused_pe_spike_tile_smem() -> int:
    """``csrc/fused_pe.cuh``'s ``kSpikeSmemBytes`` (the spike-x tile,
    ``csrc/event_wgmma.cuh``): the larger of the wgmma ring (6 stages of
    three bf16 w terms, 32 x 128, and a 128 x 48-byte x step) and the
    epilogue (the restaged currents 128 x 136 f32, v_prev f32 and s_prev
    int8 128 x 128, the near-threshold bits, the recheck's index and sums,
    8 warps' chain scratch of 2048 floats), plus 1024 bytes of alignment
    and the static ``warp_count`` of 8 ints."""
    tile, term, x_step = 128, 32 * 128 * 2, 128 * 48
    ring = 6 * (3 * term + x_step)
    epi = (tile * (tile + 8) * 4 + tile * tile * 4 + tile * tile
           + tile * tile // 8 + (tile * tile // 32 + 4) * 4 + 256 * 4
           + 8 * 2048 * 4)
    return max(ring, epi) + 1024 + 8 * 4


def fused_pe_float_tile_smem() -> int:
    """``csrc/event_gemm.cuh``'s ``kFloatSmem`` (the float-x tile): a ring
    of 4 TMA slots, each a 32-deep step's w (32 x 256 f32) and x (64 x 32
    f32), the (row, head) gate bytes 64 x 258, two mbarriers a slot and
    1024 bytes of alignment."""
    stages, stage = 4, 32 * 256 * 4 + 64 * 32 * 4
    gates = -(-64 * (256 + 2) // 8) * 8
    return stages * stage + gates + 16 * stages + 1024


def fused_pe_smem(block_m: int, block_n: int, block_k: int,
                  packed: bool) -> int:
    """The fused PE family: its spike-x and float-x tiles, the decode
    route's cap plus its static gates (64 rows x 18 heads) and
    ``warp_count``, and the dx / dw tiles its ``+grad`` backward runs."""
    decode = DECODE_MAX_SMEM + 64 * 18 + 8 * 4
    return max(fused_pe_spike_tile_smem(), fused_pe_float_tile_smem(),
               decode, matmul_smem(block_m, block_n, block_k, packed))


def pack_smem(block_m: int, block_n: int, block_k: int, packed: bool) -> int:
    """Pack / unpack: ``csrc/pack_spikes.cu``'s block counts and occupancy
    words (``cnt_s``, ``occ_s``: at most 8 row blocks a unit) and
    ``csrc/unpack_spikes.cu``'s ``stream_s`` (2 warps x 128 words)."""
    return max(2 * 8 * 4, 2 * 128 * 4)


def flash_attention_smem(block_m: int, block_n: int, block_k: int,
                         packed: bool) -> int:
    """K9 at its widest instance, D = 128: the wgmma route
    (``csrc/flash_attention_wgmma.cu``'s ``Cfg::kSmem``: q 128 x 128 bf16,
    two stages of K and V tiles 128 x 128 bf16, 7 mbarriers, 1024 bytes of
    alignment) and the scalar route (``csrc/flash_attention.cu``'s
    ``Plan::kBytes`` at 128 rows: q, two K and two V tiles of 64 keys, and
    the 64 x 132 p tile, f32)."""
    d, rows, keys = 128, 128, 128
    wgmma = rows * d * 2 + 2 * 2 * keys * d * 2 + 8 * 7 + 1024
    scalar = 4 * (rows * d + 2 * 64 * d + 2 * 64 * d + 64 * (rows + 4))
    return max(wgmma, scalar)
