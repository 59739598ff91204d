from .ops import MAX_HEAD_DIM, flash_attention, flash_attention_cuda
from .ref import attention_ref, flash_attention_ref

__all__ = ["MAX_HEAD_DIM", "attention_ref", "flash_attention",
           "flash_attention_cuda", "flash_attention_ref"]
