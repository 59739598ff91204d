from .ops import qk_attention_cuda, qk_attention_fused
from .ref import qk_attention_ref

__all__ = ["qk_attention_cuda", "qk_attention_fused", "qk_attention_ref"]
