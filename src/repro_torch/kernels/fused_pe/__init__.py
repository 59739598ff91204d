from .ops import (count_scratch, fused_pe, fused_pe_cuda, fused_pe_layer,
                  fused_pe_operands, fused_pe_tile_operands, launch_outputs,
                  pick_route)
from .ref import LIFState, Packing, fused_pe_block_ref, fused_pe_ref, head_gate

__all__ = ["LIFState", "Packing", "count_scratch", "fused_pe", "fused_pe_cuda",
           "fused_pe_layer", "fused_pe_operands", "fused_pe_tile_operands",
           "launch_outputs", "pick_route", "fused_pe_block_ref",
           "fused_pe_ref", "head_gate"]
