from .ops import spike_matmul, spike_matmul_cuda, spike_matmul_operands
from .ref import spike_matmul_block_ref, spike_matmul_ref

__all__ = ["spike_matmul", "spike_matmul_cuda", "spike_matmul_operands",
           "spike_matmul_block_ref", "spike_matmul_ref"]
