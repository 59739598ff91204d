"""Gradient compression for the data-parallel all-reduce (twin of
``repro.optim.compression``): symmetric per-tensor int8 with error
feedback, the quantisation residual carried into the next step's gradient
so the compression bias vanishes in expectation (1-bit-Adam / EF-SGD).

The port does what the reference's code does, not what its docstring
says: each rank quantises (g + carried error) to int8 and dequantises it
at once, and the all-reduce adds the dequantised **f32** values (the
reference's ``psum`` of ``deq_local``), then divides by the group's size.
No int8 or int32 payload crosses the wire. ``axis`` becomes a process
group (None: the default group).

The scale is per tensor of the reference's tree, whose layers are stacked
on a leading axis; the port keeps one tensor a layer (``convert.py``). So
the leaves at one place in each layer of a ``blocks`` list (and an
encoder-decoder's ``enc_blocks`` / ``dec_blocks``) share one scale, the
largest |value| over all of them, as the reference's stacked leaf has: the
int8 values and the residuals are then the reference's bit for bit.

Both divisions are true divisions by a tensor on the operand's device:
PyTorch's CUDA kernel multiplies by the reciprocal of a host scalar
divisor, which rounds otherwise than JAX's division.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..tree import (tree_leaves, tree_leaves_with_path, tree_map,
                    tree_unflatten_like)

# the reference's layer-stacked trees, which the port keeps as lists
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / amax.new_full((), 127.0)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale): scale =
    max(|x|max, 1e-12) / 127, q = clip(round(x / scale), -127, 127) with
    ties to even."""
    scale = _scale(torch.max(torch.abs(x)))
    return _quantize(x, scale), scale.to(torch.float32)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def error_feedback_init(params: Any) -> Any:
    """Zero f32 residuals in the parameters' tree, on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def _compress_group(gs: list, errs: list, group=None) -> list:
    """``_compress_one`` of the tensor the leaves ``gs`` form stacked:
    each (g + carried error) quantised at their common scale, the
    dequantised values all-reduced over ``group``; per leaf (their mean,
    the new local error)."""
    gs = [g.to(torch.float32) + e for g, e in zip(gs, errs)]
    scale = _scale(torch.stack([torch.max(torch.abs(g)) for g in gs]).max())
    out = []
    for g in gs:
        deq_local = decompress_int8(_quantize(g, scale), scale)
        new_err = g - deq_local                   # residual stays local
        dist.all_reduce(deq_local, op=dist.ReduceOp.SUM, group=group)
        n = deq_local.new_full((), float(dist.get_world_size(group)))
        out.append((deq_local.div_(n), new_err))
    return out


def _compress_one(g: torch.Tensor, err: torch.Tensor, group=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantise (g + carried error), all-reduce the dequantised values over
    ``group``; returns (their mean, the new local error)."""
    return _compress_group([g], [err], group)[0]


def _stacked_place(path: tuple) -> tuple:
    """The place a leaf at ``path`` stands for in the reference's tree: a
    layer's index under a ``STACKED`` list dropped."""
    return tuple("*" if j and path[j - 1] in STACKED and isinstance(k, int)
                 else k for j, k in enumerate(path))


def compressed_psum_grads(grads: Any, err: Any, group=None
                          ) -> tuple[Any, Any]:
    """int8 + error feedback on every leaf (a stacked list's leaves at one
    place together), reduced over ``group``. Returns (the mean gradients,
    the new errors), each in ``grads``'s tree; see
    ``train.trainer.make_compressed_train_step``."""
    pairs = tree_leaves_with_path(grads)
    g_leaves, e_leaves = [g for _, g in pairs], tree_leaves(err)
    members: dict = {}
    for i, (path, _) in enumerate(pairs):
        members.setdefault(_stacked_place(path), []).append(i)
    out = [None] * len(g_leaves)
    for idx in members.values():
        for i, o in zip(idx, _compress_group([g_leaves[i] for i in idx],
                                             [e_leaves[i] for i in idx],
                                             group)):
            out[i] = o
    return (tree_unflatten_like(grads, [o[0] for o in out]),
            tree_unflatten_like(grads, [o[1] for o in out]))
