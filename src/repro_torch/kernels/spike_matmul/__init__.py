from .backward import (DW_TILE_K, DW_TILE_N, TILE, DwPlan, DxPlan, dw_gate,
                       dw_plan, dx_plan, spike_matmul_dw,
                       spike_matmul_dw_cuda, spike_matmul_dw_gated_cuda,
                       spike_matmul_dx, spike_matmul_dx_cuda, vld_map)
from .ops import (DECODE_ROWS, ROUTES, SKIP_MODES, Gate, check_skip,
                  check_width, make_gate, pick_route, spike_matmul,
                  spike_matmul_cuda, spike_matmul_gated_cuda,
                  spike_matmul_operands, spike_matmul_tile_operands)
from .ref import (gated_mask, spike_matmul_block_ref,
                  spike_matmul_dw_gated_ref, spike_matmul_dw_ref,
                  spike_matmul_dw_split_ref, spike_matmul_dx_ref,
                  spike_matmul_gated_block_ref, spike_matmul_ref,
                  split_g_bf16x3)

__all__ = ["DECODE_ROWS", "ROUTES", "SKIP_MODES", "Gate", "check_skip",
           "check_width", "make_gate", "pick_route", "spike_matmul",
           "spike_matmul_cuda", "spike_matmul_gated_cuda",
           "spike_matmul_operands", "spike_matmul_tile_operands", "spike_matmul_block_ref",
           "spike_matmul_gated_block_ref", "spike_matmul_ref", "gated_mask",
           "spike_matmul_dx", "spike_matmul_dx_cuda", "spike_matmul_dx_ref",
           "spike_matmul_dw", "spike_matmul_dw_cuda",
           "spike_matmul_dw_gated_cuda", "spike_matmul_dw_ref",
           "spike_matmul_dw_gated_ref", "spike_matmul_dw_split_ref",
           "split_g_bf16x3", "dw_gate", "dw_plan", "DwPlan", "dx_plan",
           "DxPlan", "DW_TILE_K", "DW_TILE_N", "TILE", "vld_map"]
