"""AdamW with decoupled weight decay (twin of ``repro.optim.adamw``): a
plain function over parameter trees, moments kept in f32."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten_like


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    m: Any
    v: Any


def adamw_init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: float | torch.Tensor = 1e-3, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 grad_scale: Optional[torch.Tensor] = None
                 ) -> tuple[Any, AdamWState]:
    """One AdamW step. ``grad_scale`` divides the gradients (loss scaling).
    Returns (new params, new state); nothing is updated in place."""
    step = state.step + 1
    b1t = 1.0 - b1 ** step.to(torch.float32)
    b2t = 1.0 - b2 ** step.to(torch.float32)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.to(torch.float32)
        if grad_scale is not None:
            g = g / grad_scale
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        delta = (m_new / b1t) / (torch.sqrt(v_new / b2t) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_m.append(m_new)
        new_v.append(v_new)
    return (tree_unflatten_like(params, new_p),
            AdamWState(step=step, m=tree_unflatten_like(params, new_m),
                       v=tree_unflatten_like(params, new_v)))
