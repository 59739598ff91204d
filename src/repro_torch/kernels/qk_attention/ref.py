"""Plain QKFormer token attention (twin of the reference's ``ref.py``)."""
from __future__ import annotations

import torch


def qk_attention_ref(q: torch.Tensor, k: torch.Tensor,
                     threshold: float = 1.0) -> torch.Tensor:
    """Keep K's rows whose Q row sum reaches the threshold."""
    rowsum = q.to(torch.float32).sum(dim=-1, keepdim=True)
    return (rowsum >= threshold).to(k.dtype) * k
