"""Plain version of the fused W2TTFS head (twin of the reference's
``ref.py``)."""
from __future__ import annotations

import torch

from ...core.w2ttfs import w2ttfs_classifier


def w2ttfs_pool_fc_ref(spikes: torch.Tensor, fc_w: torch.Tensor,
                       fc_b: torch.Tensor, window: int) -> torch.Tensor:
    """spikes [B, H, W, C], fc_w [Ho*Wo*C, classes], fc_b [classes] ->
    logits [B, classes] f32."""
    return w2ttfs_classifier(spikes.to(torch.float32),
                             fc_w.to(torch.float32),
                             fc_b.to(torch.float32), window)
