from .backward import (dw_splits, spike_matmul_dw, spike_matmul_dw_cuda,
                       spike_matmul_dx, spike_matmul_dx_cuda, vld_map)
from .ops import spike_matmul, spike_matmul_cuda, spike_matmul_operands
from .ref import (spike_matmul_block_ref, spike_matmul_dw_ref,
                  spike_matmul_dx_ref, spike_matmul_ref)

__all__ = ["spike_matmul", "spike_matmul_cuda", "spike_matmul_operands",
           "spike_matmul_block_ref", "spike_matmul_ref",
           "spike_matmul_dx", "spike_matmul_dx_cuda", "spike_matmul_dx_ref",
           "spike_matmul_dw", "spike_matmul_dw_cuda", "spike_matmul_dw_ref",
           "dw_splits", "vld_map"]
