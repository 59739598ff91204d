"""``repro_torch.ops`` — the policy-dispatching execution layer (twin of
``repro.ops``).

  * ``SpikeTensor`` — the spike-map currency (dense or bit-packed),
    carrying its ``vld_cnt`` block metadata from one kernel to the next;
  * ``ExecutionPolicy`` — "reference" | "fused_dense" | "fused_packed" |
    "auto" | "auto_packed", each with its ``"+grad"`` training form; the
    auto policies defer the matmul sweeps to the roofline autotuner
    (``ops.autotune``), which reads the operands' measured sparsity;
  * entry points that look their implementation up in the ``(op, mode)``
    registry.
"""
from ..core.events import DEFAULT_BLOCKS, Blocks
from .autotune import AutoTuner, KernelPlan, get_tuner
from .dispatch import (FusedOut, attention, conv_matmul_weights, dense_lif,
                       fused_pe, fused_pe_layer, im2col, lif, matmul, pack,
                       pool, qk_mask, unpack, w2ttfs_head)
from .policy import (AUTO, AUTO_PACKED, FUSED_DENSE, FUSED_PACKED, POLICIES,
                     REFERENCE, ExecutionPolicy, as_policy,
                     merge_engine_policy, with_policy)
from .registry import implementations, lookup, register
from .spike_tensor import SpikeTensor, Spikes

__all__ = [
    "DEFAULT_BLOCKS", "Blocks", "SpikeTensor", "Spikes",
    "AutoTuner", "KernelPlan", "get_tuner",
    "ExecutionPolicy", "POLICIES", "REFERENCE", "FUSED_DENSE",
    "FUSED_PACKED", "AUTO", "AUTO_PACKED", "as_policy",
    "merge_engine_policy", "with_policy",
    "register", "lookup", "implementations",
    "FusedOut", "matmul", "lif", "fused_pe", "fused_pe_layer", "dense_lif",
    "pool",
    "im2col",
    "conv_matmul_weights", "qk_mask", "pack", "unpack", "w2ttfs_head",
    "attention",
]
