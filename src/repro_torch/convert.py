"""Carry parameters across from the JAX package.

The two packages draw different random numbers from the same seed, so a
model is compared across them by moving the reference's variables over as
numpy arrays: ``variables_from_jax`` for the ``{"params", "state"}`` dict of
``repro.models.snn_cnn.init`` (or ``ann_cnn.init``), ``fused_from_jax`` for
the list of ``fuse_model``, ``optimizer_state_from_jax`` for the
reference's ``SGDState`` or ``AdamWState``, so that both packages can train
on from one state, ``lm_params_from_jax`` for the parameters of the
reference's ``LM`` (every family), ``encdec_params_from_jax`` for its
``EncDecLM``, and ``train_state_from_jax`` for the reference's LM
``TrainState`` (step, parameters, AdamW state). This module imports neither JAX nor the JAX package: the
caller converts leaves with ``np.asarray`` (``jax.tree_util.tree_map``).

Every leaf is copied (``np.array``) before it becomes a tensor.
``np.asarray`` of a JAX array is read-only, and ``torch.from_numpy`` on a
read-only array warns; the copy also keeps the tensors independent of the
caller's buffers.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import DeviceLike, resolve_device


def _to_torch(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, device) for v in tree)
    return torch.tensor(np.array(tree), device=device)


def optimizer_state_from_jax(opt: Any, device: DeviceLike = None):
    """The reference's ``SGDState(step, momentum)`` or ``AdamWState(step,
    m, v)`` with numpy leaves (told apart by their fields) -> the port's
    ``repro_torch.optim`` state of the same kind on ``device``."""
    from .optim import AdamWState, SGDState

    dev = resolve_device(device)
    fields = getattr(opt, "_fields", ())
    step = _to_torch(opt.step, dev).to(torch.int32)
    if fields == ("step", "momentum"):
        return SGDState(step, _to_torch(opt.momentum, dev))
    if fields == ("step", "m", "v"):
        return AdamWState(step, _to_torch(opt.m, dev), _to_torch(opt.v, dev))
    raise TypeError(f"not an SGDState or AdamWState: {type(opt).__name__} "
                    f"with fields {fields}")


def variables_from_jax(tree: dict, device: DeviceLike = None) -> dict:
    """``{"params": [...], "state": [...]}`` with numpy leaves -> the same
    structure of tensors on ``device`` (the card unless told otherwise)."""
    return _to_torch(tree, resolve_device(device))


def fused_from_jax(fused: list, device: DeviceLike = None) -> list:
    """The ``fuse_model`` list with numpy leaves -> tensors on ``device``."""
    return _to_torch(fused, resolve_device(device))


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack_lists(params: dict, stacked: tuple, dev) -> dict:
    """``params`` on ``dev``, each tree named in ``stacked`` (its leaves
    stacked on a leading layer axis) made a list of one tree per layer."""
    out = {k: _to_torch(v, dev) for k, v in params.items()
           if k not in stacked}
    for name in stacked:
        blocks = params[name]
        n_layers = len(next(iter(_leaves(blocks))))
        out[name] = [_to_torch(_unstack(blocks, i), dev)
                     for i in range(n_layers)]
    return out


def lm_params_from_jax(params: dict, device: DeviceLike = None) -> dict:
    """The reference ``LM.init`` tree with numpy leaves, its blocks stacked
    on a leading layer axis, -> the port's ``LM`` tree on ``device``: the
    same dicts, with ``blocks`` a list of one dict per layer. Every
    family's tree: a moe block's expert stacks ([E, D, F] a layer), a
    mamba block, the hybrid's ``shared_attn`` and the vlm's
    ``vision_proj`` (neither stacked) come across as they are."""
    return _unstack_lists(params, ("blocks",), resolve_device(device))


def encdec_params_from_jax(params: dict, device: DeviceLike = None) -> dict:
    """The reference ``EncDecLM.init`` tree with numpy leaves -> the
    port's ``EncDecLM`` tree on ``device``, ``enc_blocks`` and
    ``dec_blocks`` each a list of one dict per layer."""
    return _unstack_lists(params, ("enc_blocks", "dec_blocks"),
                          resolve_device(device))


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def train_state_from_jax(state: Any, device: DeviceLike = None):
    """The reference's LM ``TrainState(step, params, opt_state)`` with numpy
    leaves (its AdamW moments in the parameters' tree, the blocks stacked)
    -> the port's ``repro_torch.train.TrainState`` on ``device``, each of
    the three trees through ``lm_params_from_jax``."""
    from .optim import AdamWState
    from .train import TrainState

    dev = resolve_device(device)
    opt = state.opt_state
    return TrainState(
        step=_to_torch(state.step, dev).to(torch.int32),
        params=lm_params_from_jax(state.params, device=dev),
        opt_state=AdamWState(_to_torch(opt.step, dev).to(torch.int32),
                             lm_params_from_jax(opt.m, device=dev),
                             lm_params_from_jax(opt.v, device=dev)))
