"""Minimal functional layer library (twin of ``repro.models.nn``): init
functions return dicts of tensors, apply functions are plain functions.
Images are NHWC and conv weights HWIO, as in the reference, so parameters
carry across unchanged.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- init utils
def kaiming(gen: torch.Generator, shape: tuple[int, ...], fan_in: int,
            dtype: torch.dtype = torch.float32,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """Normal(0, 2/fan_in), drawn on the generator's device, then moved."""
    std = math.sqrt(2.0 / fan_in)
    z = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return (z * std).to(device)


def xavier(gen: torch.Generator, shape: tuple[int, ...], fan_in: int,
           fan_out: int, dtype: torch.dtype = torch.float32,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """Uniform(-lim, lim), lim = sqrt(6 / (fan_in + fan_out)), drawn on the
    generator's device, then moved."""
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return (u * (2.0 * lim) - lim).to(device)


# -------------------------------------------------------------------- conv2d
def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              bias: bool = False, dtype: torch.dtype = torch.float32,
              device: Optional[torch.device] = None) -> dict:
    p = {"w": kaiming(gen, (kh, kw, cin, cout), kh * kw * cin, dtype, device)}
    if bias:
        p["b"] = torch.zeros((cout,), dtype=dtype, device=device)
    return p


def _same_pads(h: int, w: int, kh: int, kw: int, stride: int
               ) -> tuple[int, int, int, int, int, int]:
    """The reference's SAME padding: ``ph // 2`` before, the rest after
    (asymmetric at stride 2). Returns (ho, wo, top, bottom, left, right)."""
    ho = -(-h // stride)
    wo = -(-w // stride)
    ph = max((ho - 1) * stride + kh - h, 0)
    pw = max((wo - 1) * stride + kw - w, 0)
    return ho, wo, ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


def conv_apply(p: dict, x: torch.Tensor, stride: int = 1,
               padding: str = "SAME") -> torch.Tensor:
    """NHWC conv with an HWIO weight, then the bias (added after the conv,
    as the reference adds it). Padding is explicit: torch's
    ``padding="same"`` rejects stride 2."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[:2]
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"unknown padding {padding!r}")
    xc = x.permute(0, 3, 1, 2)
    if kh == kw == 1:
        # a 1x1 conv needs no padding at any stride: it is the stride-1
        # conv of the strided pixels, which also stays clear of a crash in
        # oneDNN's CPU conv backward at some 1x1 strided shapes
        xc, stride = xc[:, :, ::stride, ::stride], 1
    elif padding == "SAME":
        _, _, top, bottom, left, right = _same_pads(x.shape[1], x.shape[2],
                                                    kh, kw, stride)
        xc = F.pad(xc, (left, right, top, bottom))
    # IEEE f32: cuDNN would otherwise run an f32 conv in TF32, which keeps
    # about three decimal digits and flips spikes near v_th
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y.contiguous()


# ----------------------------------------------------- conv-as-matmul (im2col)
def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """Patch extraction: [B, H, W, C] -> [B, Ho, Wo, kh*kw*C] with features
    in (kh, kw, C) row-major order, so ``im2col(x) @ w.reshape(-1, Cout)``
    is the conv. Patches of a binary spike map are binary, so every conv
    becomes an event-skipped spike matmul."""
    b, h, w, c = x.shape
    if padding == "SAME":
        ho, wo, top, bottom, left, right = _same_pads(h, w, kh, kw, stride)
        x = F.pad(x, (0, 0, left, right, top, bottom))
    elif padding == "VALID":
        ho = (h - kh) // stride + 1
        wo = (w - kw) // stride + 1
    else:
        raise ValueError(f"unknown padding {padding!r}")
    cols = [x[:, i:i + (ho - 1) * stride + 1:stride,
              j:j + (wo - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


# ``im2col`` keeps each pixel's whole channel vector together per (i, j)
# tap, so with the channel axis padded to whole blocks and bit-packed
# (32 spikes per int32 word) patch extraction runs on the word tensor
# unchanged: the words of im2col(packed) ARE the packing of im2col(dense),
# and zero words are zero spikes, so SAME padding stays silent.
def im2col_packed(words: torch.Tensor, kh: int, kw: int, stride: int = 1,
                  padding: str = "SAME") -> torch.Tensor:
    """Patch extraction on channel-packed spike words: [B, H, W, Cp/32]
    int32 -> [B, Ho, Wo, kh*kw*Cp/32] int32, bit for bit the packed form of
    ``im2col`` on the dense map."""
    if words.dtype != torch.int32:
        raise TypeError(f"im2col_packed takes int32 words, got {words.dtype}")
    return im2col(words, kh, kw, stride, padding)


def conv_weights_as_matmul_packed(w: torch.Tensor,
                                  c_padded: int) -> torch.Tensor:
    """[kh, kw, Cin, Cout] -> [kh*kw*c_padded, Cout], with zero rows for the
    pad channels of each (i, j) tap (the packed format pads channels to
    whole words; for the dense format ``c_padded == Cin``)."""
    kh, kw, cin, cout = w.shape
    if c_padded < cin:
        raise ValueError(f"c_padded {c_padded} < Cin {cin}")
    if c_padded != cin:
        w = F.pad(w, (0, 0, 0, c_padded - cin))
    return w.reshape(kh * kw * c_padded, cout)


# ---------------------------------------------------------------- batch norm
def bn_init(c: int, dtype: torch.dtype = torch.float32,
            device: Optional[torch.device] = None) -> tuple[dict, dict]:
    params = {"scale": torch.ones((c,), dtype=dtype, device=device),
              "bias": torch.zeros((c,), dtype=dtype, device=device)}
    state = {"mean": torch.zeros((c,), dtype=dtype, device=device),
             "var": torch.ones((c,), dtype=dtype, device=device)}
    return params, state


def _rsqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) rounded once to ``x``'s dtype (taken in f64). Neither
    ``torch.rsqrt`` nor XLA's CPU rsqrt is correctly rounded; this one is
    the same on every device."""
    return torch.rsqrt(x.to(torch.float64)).to(x.dtype)


def bn_apply(p: dict, s: dict, x: torch.Tensor, train: bool,
             momentum: float = 0.9, eps: float = 1e-5
             ) -> tuple[torch.Tensor, dict]:
    """Batch norm over every axis but the last (channels). With ``train``
    it normalises by the batch statistics (biased variance) and returns
    the running statistics moved by the reference's rule
    ``momentum * old + (1 - momentum) * batch`` (``F.batch_norm`` would
    move the variance by the unbiased estimate instead); the new state is
    detached, as it is never differentiated. Without ``train`` it uses the
    running statistics and returns ``s`` unchanged."""
    if train:
        dims = tuple(range(x.ndim - 1))
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, correction=0)
        new_s = {"mean": (momentum * s["mean"]
                          + (1 - momentum) * mean).detach(),
                 "var": (momentum * s["var"]
                         + (1 - momentum) * var).detach()}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    inv = _rsqrt_rn(var + eps) * p["scale"]
    return (x - mean) * inv + p["bias"], new_s


# -------------------------------------------------------------------- linear
def linear_init(gen: torch.Generator, din: int, dout: int, bias: bool = True,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> dict:
    p = {"w": xavier(gen, (din, dout), din, dout, dtype, device)}
    if bias:
        p["b"] = torch.zeros((dout,), dtype=dtype, device=device)
    return p


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ------------------------------------------------------------------- pooling
def max_pool(x: torch.Tensor, window: int = 2,
             stride: Optional[int] = None) -> torch.Tensor:
    """NHWC max pool over ``window`` x ``window``, VALID padding."""
    stride = stride or window
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool(x: torch.Tensor, window: int = 2,
             stride: Optional[int] = None) -> torch.Tensor:
    """NHWC average pool over ``window`` x ``window``, VALID padding: the
    window sum divided by ``window * window``."""
    stride = stride or window
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def max_pool_packed(words: torch.Tensor, window: int = 2,
                    stride: Optional[int] = None) -> torch.Tensor:
    """Max-pool of binary spike maps is the OR over each window, which on
    packed words [B, H, W, Cp/32] is their bitwise OR (VALID padding): the
    pooled map never exists dense. Torch has no OR reduction, so the
    window's strided slices are OR-ed in turn."""
    if words.dtype != torch.int32:
        raise TypeError(f"max_pool_packed takes int32 words, got "
                        f"{words.dtype}")
    stride = stride or window
    ho = (words.shape[1] - window) // stride + 1
    wo = (words.shape[2] - window) // stride + 1
    out = None
    for i in range(window):
        for j in range(window):
            tap = words[:, i:i + (ho - 1) * stride + 1:stride,
                        j:j + (wo - 1) * stride + 1:stride, :]
            out = tap if out is None else out | tap
    return out.contiguous()
