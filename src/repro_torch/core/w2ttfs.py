"""W2TTFS classifier head (twin of ``repro.core.w2ttfs``, the forms the
deployed models run).

The TTFS filter counts the spikes of each pooling window; NEURAL's WTFC
replaces the position-dependent ``t / window^2`` scale by the unit scale
``1 / window^2`` applied once per counted spike, so the head is
``logits = (counts @ fc_w) * (1 / window^2) + fc_b``. Layout: NHWC.
"""
from __future__ import annotations

import torch


def window_counts(spike_map: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H//window, W//window, C] spike counts."""
    b, h, w, c = spike_map.shape
    ho, wo = h // window, w // window
    return spike_map.reshape(b, ho, window, wo, window, c).sum(dim=(2, 4))


def w2ttfs_classifier(spike_map: torch.Tensor, fc_w: torch.Tensor,
                      fc_b: torch.Tensor, window: int) -> torch.Tensor:
    """The WTFC head: window counts times the unit-scale FC.
    ``fc_w``: [Ho*Wo*C, classes]."""
    cnt = window_counts(spike_map, window).to(fc_w.dtype)
    unit = 1.0 / float(window * window)
    return (cnt.reshape(cnt.shape[0], -1) @ fc_w) * unit + fc_b


def avgpool_classifier(x: torch.Tensor, fc_w: torch.Tensor,
                       fc_b: torch.Tensor, window: int) -> torch.Tensor:
    """The ANN head W2TTFS replaces: average pooling, then the FC."""
    b, h, w, c = x.shape
    ho, wo = h // window, w // window
    pooled = x.reshape(b, ho, window, wo, window, c).mean(dim=(2, 4))
    return pooled.reshape(b, -1).to(fc_w.dtype) @ fc_w + fc_b
