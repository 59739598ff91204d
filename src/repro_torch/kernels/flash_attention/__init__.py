from .ops import (MAX_HEAD_DIM, WGMMA_HEAD_DIMS, FlashPlan, flash_attention,
                  flash_attention_cuda, flash_cta, flash_plan, pick_route,
                  wgmma_instance, wgmma_tile_cuda)
from .ref import (attention_ref, flash_attention_ref, flash_tile_twin,
                  split_bf16x3)

__all__ = ["MAX_HEAD_DIM", "WGMMA_HEAD_DIMS", "FlashPlan", "attention_ref",
           "flash_attention", "flash_attention_cuda", "flash_attention_ref",
           "flash_cta", "flash_plan", "flash_tile_twin", "pick_route",
           "split_bf16x3", "wgmma_instance", "wgmma_tile_cuda"]
