from .ops import fused_pe, fused_pe_cuda, fused_pe_layer, fused_pe_operands
from .ref import LIFState, Packing, fused_pe_block_ref, fused_pe_ref, head_gate

__all__ = ["LIFState", "Packing", "fused_pe", "fused_pe_cuda",
           "fused_pe_layer", "fused_pe_operands", "fused_pe_block_ref",
           "fused_pe_ref", "head_gate"]
