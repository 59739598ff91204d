"""SGD with momentum (twin of ``repro.optim.sgd``): the optimizer the paper
trains its KD CNNs with (§V.A: momentum 0.9). A plain function over
parameter trees, in the reference's update order (weight decay added to the
gradient, then the momentum buffer, then the step); ``torch.optim.SGD``
orders its update differently."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten_like


class SGDState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    momentum: Any             # f32 buffers in the params' tree


def sgd_init(params: Any) -> SGDState:
    device = tree_leaves(params)[0].device
    return SGDState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        momentum=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params))


@torch.no_grad()
def sgd_update(grads: Any, state: SGDState, params: Any, *,
               lr: float | torch.Tensor = 0.1, momentum: float = 0.9,
               weight_decay: float = 0.0, nesterov: bool = False
               ) -> tuple[Any, SGDState]:
    """One step; returns (new params, new state). Nothing is updated in
    place."""
    new_p, new_b = [], []
    for p, g, buf in zip(tree_leaves(params), tree_leaves(grads),
                         tree_leaves(state.momentum)):
        g = g.to(torch.float32)
        if weight_decay:
            g = g + weight_decay * p.to(torch.float32)
        buf_new = momentum * buf + g
        step_dir = g + momentum * buf_new if nesterov else buf_new
        new_p.append((p.to(torch.float32) - lr * step_dir).to(p.dtype))
        new_b.append(buf_new)
    return (tree_unflatten_like(params, new_p),
            SGDState(step=state.step + 1,
                     momentum=tree_unflatten_like(params, new_b)))
