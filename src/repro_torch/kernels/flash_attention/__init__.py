from .ops import (MAX_HEAD_DIM, WGMMA_HEAD_DIMS, flash_attention,
                  flash_attention_cuda, pick_route, wgmma_tile_cuda)
from .ref import attention_ref, flash_attention_ref, split_bf16x3

__all__ = ["MAX_HEAD_DIM", "WGMMA_HEAD_DIMS", "attention_ref",
           "flash_attention", "flash_attention_cuda", "flash_attention_ref",
           "pick_route", "split_bf16x3", "wgmma_tile_cuda"]
