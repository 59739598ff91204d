"""Gradient clipping (twin of ``repro.optim.clip``): a plain function over
gradient trees, the norm taken in f32."""
from __future__ import annotations

from typing import Any

import torch

from ..tree import tree_leaves, tree_map


def global_norm(tree: Any) -> torch.Tensor:
    """The L2 norm of every leaf together, in f32: the leaves' sums of
    squares added in the tree's order, then the root."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """``grads`` scaled by ``min(1, max_norm / max(norm, 1e-12))``, each
    leaf kept in its dtype, and the norm before clipping. Nothing is
    updated in place."""
    norm = global_norm(grads)
    scale = torch.clamp(norm.new_tensor(max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm
