"""Learning-rate schedules as functions of the step counter (twin of
``repro.optim.schedules``): each takes the int32 step tensor and returns
an f32 scalar tensor on its device."""
from __future__ import annotations

import math

import torch


def constant_lr(lr: float):
    def fn(step: torch.Tensor) -> torch.Tensor:
        return torch.tensor(lr, dtype=torch.float32, device=step.device)
    return fn


def cosine_lr(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)
    return fn


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cosine = cosine_lr(base_lr, max(total_steps - warmup_steps, 1),
                       final_frac)

    def fn(step: torch.Tensor) -> torch.Tensor:
        warm = base_lr * (step.to(torch.float32) + 1.0) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cosine(step - warmup_steps))
    return fn
