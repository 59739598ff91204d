"""Softmax over the last axis in the form of the reference's
``jax.nn.softmax``: exp of the max-shifted scores over their sum. The LM's
softmax attention and K9's plain version share it."""
from __future__ import annotations

import torch


def softmax(s: torch.Tensor) -> torch.Tensor:
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)
