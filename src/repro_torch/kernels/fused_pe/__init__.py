from .ops import (FloatTilePlan, count_scratch, float_tile_plan,
                  float_tile_runs, fused_pe, fused_pe_cuda, fused_pe_layer,
                  fused_pe_operands, fused_pe_tile_operands, launch_outputs,
                  pick_route, train_operands, weight_split)
from .ref import (RECHECK_BAND, STEP, LIFState, Packing, fused_pe_block_ref,
                  fused_pe_ref, head_gate, k_steps, sequential_product,
                  split_product, split_weight)

__all__ = ["FloatTilePlan", "LIFState", "Packing", "RECHECK_BAND", "STEP",
           "count_scratch", "float_tile_plan", "float_tile_runs",
           "fused_pe", "fused_pe_cuda", "fused_pe_layer", "fused_pe_operands",
           "fused_pe_tile_operands", "launch_outputs", "pick_route",
           "train_operands", "fused_pe_block_ref", "fused_pe_ref", "head_gate",
           "k_steps", "sequential_product", "split_product", "split_weight",
           "weight_split"]
