"""Plain version of the LIF step (twin of the reference's ``ref.py``)."""
from __future__ import annotations

import torch


def lif_update_ref(current: torch.Tensor, v_prev: torch.Tensor,
                   s_prev: torch.Tensor, tau: float = 0.5, v_th: float = 1.0,
                   soft_reset: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (spikes int8, v_next f32), elementwise over any shape."""
    v = tau * v_prev.to(torch.float32) * (1.0 - s_prev.to(torch.float32)) \
        + current.to(torch.float32)
    spk = v >= v_th
    if soft_reset:
        v_next = v - v_th * spk.to(torch.float32)
    else:
        v_next = v * (1.0 - spk.to(torch.float32))
    return spk.to(torch.int8), v_next
