"""Wrapper for the fused W2TTFS head kernel (``csrc/w2ttfs_pool.cu``)."""
from __future__ import annotations

import torch

from .. import _build
from .ref import w2ttfs_pool_fc_ref


def w2ttfs_pool_cuda(spikes: torch.Tensor, fc_w: torch.Tensor,
                     fc_b: torch.Tensor, window: int) -> torch.Tensor:
    """Launch the kernel on contiguous f32 CUDA tensors (see
    ``w2ttfs_pool_fc`` for the shapes). Does not count the launch."""
    dev = spikes.device
    if dev.type != "cuda":
        raise ValueError(f"w2ttfs_pool_cuda needs CUDA tensors, got {dev}")
    b, h, w, c = spikes.shape
    if window < 1 or h % window or w % window:
        raise ValueError(f"window {window} does not tile the {h}x{w} map")
    classes = fc_w.shape[1]
    features = (h // window) * (w // window) * c
    _build.require(spikes, "spikes", torch.float32, (b, h, w, c), dev,
                   align=4)
    _build.require(fc_w, "fc_w", torch.float32, (features, classes), dev,
                   align=4)
    _build.require(fc_b, "fc_b", torch.float32, (classes,), dev, align=4)
    out = torch.empty((b, classes), dtype=torch.float32, device=dev)
    unit = 1.0 / float(window * window)   # formed in double, as JAX does
    err = _build.library().repro_w2ttfs_pool(
        _build.ptr(spikes), _build.ptr(fc_w), _build.ptr(fc_b),
        _build.ptr(out), b, h, w, c, window, classes, unit,
        _build.stream(spikes))
    _build.check(err, "repro_w2ttfs_pool")
    return out


def w2ttfs_pool_fc(spikes: torch.Tensor, fc_w: torch.Tensor,
                   fc_b: torch.Tensor, *, window: int) -> torch.Tensor:
    """W2TTFS head: spikes [B, H, W, C] (binary, any dtype), fc_w
    [Ho*Wo*C, classes], fc_b [classes] -> logits [B, classes] f32. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    dev = spikes.device
    if dev.type == "cpu":
        return w2ttfs_pool_fc_ref(spikes, fc_w, fc_b, window)
    if dev.type != "cuda":
        raise ValueError(f"w2ttfs_pool_fc runs on cuda or cpu, not {dev}")
    args = (spikes.to(torch.float32).contiguous(),
            fc_w.to(torch.float32).contiguous(),
            fc_b.to(torch.float32).reshape(-1).contiguous(), window)
    _build.count_launch("w2ttfs_pool", args, (spikes, fc_w, fc_b))
    return w2ttfs_pool_cuda(*args)
