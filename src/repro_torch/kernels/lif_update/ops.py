"""Wrapper for the LIF update kernel (``csrc/lif_update.cu``)."""
from __future__ import annotations

import torch

from .. import _build
from .ref import lif_update_ref


def lif_update_cuda(current: torch.Tensor, v_prev: torch.Tensor,
                    s_prev: torch.Tensor, tau: float, v_th: float,
                    soft_reset: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on flat f32 CUDA tensors of one length.
    Returns (spikes int8, v_next f32); does not count the launch."""
    dev = current.device
    if dev.type != "cuda":
        raise ValueError(f"lif_update_cuda needs CUDA tensors, got {dev}")
    n = current.numel()
    for t, name in ((current, "current"), (v_prev, "v_prev"),
                    (s_prev, "s_prev")):
        _build.require(t, name, torch.float32, (n,), dev, align=4)
    spikes = torch.empty(n, dtype=torch.int8, device=dev)
    v_next = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.repro_lif_update(
        _build.ptr(current), _build.ptr(v_prev), _build.ptr(s_prev),
        _build.ptr(spikes), _build.ptr(v_next), n, tau, v_th,
        int(soft_reset), _build.stream(current))
    _build.check(err, "repro_lif_update")
    return spikes, v_next


def lif_update(current: torch.Tensor, v_prev: torch.Tensor,
               s_prev: torch.Tensor, *, tau: float = 0.5, v_th: float = 1.0,
               soft_reset: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused LIF step over any-shaped tensors: (spikes int8, v_next f32)
    with the input's shape. The kernel on CUDA tensors, the plain version
    on CPU tensors."""
    dev = current.device
    if dev.type == "cpu":
        return lif_update_ref(current, v_prev, s_prev, tau, v_th, soft_reset)
    if dev.type != "cuda":
        raise ValueError(f"lif_update runs on cuda or cpu, not {dev}")
    shape = current.shape
    args = tuple(t.to(torch.float32).reshape(-1).contiguous()
                 for t in (current, v_prev, s_prev)) + (tau, v_th, soft_reset)
    _build.count_launch("lif_update", args, (current, v_prev, s_prev))
    spikes, v_next = lif_update_cuda(*args)
    return spikes.reshape(shape), v_next.reshape(shape)
