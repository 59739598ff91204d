"""Wrapper for the fused W2TTFS head kernel (``csrc/w2ttfs_pool.cu``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...launch.roofline import SMEM_BYTES_PER_BLOCK
from .. import _build
from ..contract import KernelContract, declare
from .ref import w2ttfs_pool_fc_ref

# the spike dtypes the kernel reads as they are (its ``kind`` argument)
SPIKE_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
MAX_BLOCK_B = 8              # images a CTA, as the TPU kernel's block_b
SMEM_BYTES = SMEM_BYTES_PER_BLOCK    # shared memory a CTA can take
THREADS = 256                # the kernel's CTA


class HeadPlan(NamedTuple):
    block_b: int             # images a CTA
    rows_chunk: int          # fc_w rows a shared-memory chunk
    smem: int                # dynamic shared memory a CTA, bytes


def w2ttfs_plan(b: int, features: int, classes: int, *,
                sms: int = 132) -> HeadPlan:
    """Images a CTA: enough CTAs to cover the card's ``sms`` SMs (256
    images on an H100: 2 a CTA, 128 CTAs), at most ``MAX_BLOCK_B``, and at
    most what 64 KB of counts hold. fc_w's rows a
    chunk: as many as the shared memory left holds (the main path's 512 x
    10 and CIFAR-100's 512 x 100 are one chunk). The kernel's shared
    memory: the counts [block_b, features], the chunk [rows, classes], the
    slices' sums [256 // cw, block_b, cw] (cw = min(classes, 256)) and the
    running sums [block_b, classes], f32."""
    block_b = max(1, min(MAX_BLOCK_B, -(-b // sms),
                         (64 * 1024) // (4 * max(features, 1))))
    cw = min(classes, THREADS)
    fixed = 4 * (block_b * features + (THREADS // cw) * block_b * cw
                 + block_b * classes)
    rows_chunk = max(1, min(features, (SMEM_BYTES - fixed) // (4 * classes)))
    return HeadPlan(block_b, rows_chunk, fixed + 4 * rows_chunk * classes)


CONTRACT = declare(KernelContract(
    family="w2ttfs_pool", ops=("w2ttfs_head",), formats=("dense",),
    grad=True,
    # csrc/w2ttfs_pool.cu's dynamic shared memory, as its plan sizes it:
    # the main path's 256 images of 512 features into 10 classes, and
    # CIFAR-100's 100
    smem_bytes=lambda bm, bn, bk, packed: max(
        w2ttfs_plan(256, 512, classes).smem for classes in (10, 100))))


def w2ttfs_pool_cuda(spikes: torch.Tensor, fc_w: torch.Tensor,
                     fc_b: torch.Tensor, window: int) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA tensors: spikes int8, bf16 or
    f32 (read as they are), fc_w and fc_b f32 (see ``w2ttfs_pool_fc`` for
    the shapes). Does not count the launch."""
    dev = spikes.device
    if dev.type != "cuda":
        raise ValueError(f"w2ttfs_pool_cuda needs CUDA tensors, got {dev}")
    if spikes.dtype not in SPIKE_KINDS:
        raise TypeError(f"spikes must be one of {list(SPIKE_KINDS)}, got "
                        f"{spikes.dtype}")
    b, h, w, c = spikes.shape
    if window < 1 or h % window or w % window:
        raise ValueError(f"window {window} does not tile the {h}x{w} map")
    classes = fc_w.shape[1]
    features = (h // window) * (w // window) * c
    _build.require(spikes, "spikes", spikes.dtype, (b, h, w, c), dev,
                   align=spikes.element_size())
    _build.require(fc_w, "fc_w", torch.float32, (features, classes), dev,
                   align=4)
    _build.require(fc_b, "fc_b", torch.float32, (classes,), dev, align=4)
    plan = w2ttfs_plan(
        b, features, classes,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.smem > SMEM_BYTES:
        raise ValueError(f"a {features}-feature, {classes}-class head needs "
                         f"{plan.smem} bytes of shared memory a CTA")
    vector = (c * spikes.element_size()) % 16 == 0 and \
        spikes.data_ptr() % 16 == 0
    out = torch.empty((b, classes), dtype=torch.float32, device=dev)
    unit = 1.0 / float(window * window)   # formed in double, as JAX does
    err = _build.library().repro_w2ttfs_pool(
        _build.ptr(spikes), _build.ptr(fc_w), _build.ptr(fc_b),
        _build.ptr(out), SPIKE_KINDS[spikes.dtype], b, h, w, c, window,
        classes, unit, plan.block_b, plan.rows_chunk, int(vector),
        _build.stream(spikes))
    _build.check(err, "repro_w2ttfs_pool")
    return out


def w2ttfs_pool_fc(spikes: torch.Tensor, fc_w: torch.Tensor,
                   fc_b: torch.Tensor, *, window: int) -> torch.Tensor:
    """W2TTFS head: spikes [B, H, W, C] (binary, any dtype), fc_w
    [Ho*Wo*C, classes], fc_b [classes] -> logits [B, classes] f32. The
    kernel on CUDA tensors, reading an int8, bf16 or f32 map as it is (a
    bool map as int8, another dtype cast to f32), the plain version on CPU
    tensors."""
    dev = spikes.device
    if dev.type == "cpu":
        return w2ttfs_pool_fc_ref(spikes, fc_w, fc_b, window)
    if dev.type != "cuda":
        raise ValueError(f"w2ttfs_pool_fc runs on cuda or cpu, not {dev}")
    s = (spikes.view(torch.int8) if spikes.dtype == torch.bool
         else spikes if spikes.dtype in SPIKE_KINDS
         else spikes.to(torch.float32))
    args = (s.contiguous(), fc_w.to(torch.float32).contiguous(),
            fc_b.to(torch.float32).reshape(-1).contiguous(), window)
    _build.count_launch("w2ttfs_pool", args, (spikes, fc_w, fc_b))
    return w2ttfs_pool_cuda(*args)
