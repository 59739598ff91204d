"""Transformer layer primitives of the LM zoo (twin of
``repro.models.layers``): parameters are plain dicts of tensors, LM
tensors are [batch, seq, d].

The paper's spiking mode plugs in here: ``maybe_spike`` turns a
pre-activation ("membrane current") into a binary spike map with a
surrogate gradient, the LM analogue of the LIF unit in NEURAL's PEs, and
``fused_dense_lif`` runs dense(x) -> LIF as one fused PE pass. RoPE and
``causal_mask`` serve the softmax attention path; ``soft_cap``, the
reference's logit cap, has no caller in either package.

``spike_log()`` collects, while it is open, the spike totals of every LIF
map the LM layers emit (``note_spikes``), as device tensors in call order:
per layer the Q map, the masked attention map and the MLP gate. Outside it
nothing is counted.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Iterator, Optional

import torch

from .. import ops
from ..core.lif import LIFConfig, lif_forward
from ..tree import derived

_SPIKE_LOG: Optional[list] = None


@contextlib.contextmanager
def spike_log() -> Iterator[list]:
    """Collect ``(kind, total)`` for every spike map noted in the block."""
    global _SPIKE_LOG
    prev, _SPIKE_LOG = _SPIKE_LOG, []
    try:
        yield _SPIKE_LOG
    finally:
        _SPIKE_LOG = prev


@contextlib.contextmanager
def spike_log_paused() -> Iterator[None]:
    """Note nothing inside the block (a checkpointed layer's recompute in
    the backward pass, whose maps its forward already noted)."""
    global _SPIKE_LOG
    prev, _SPIKE_LOG = _SPIKE_LOG, None
    try:
        yield
    finally:
        _SPIKE_LOG = prev


def note_spikes(kind: str, spikes) -> None:
    """Record a spike map's total (a SpikeTensor's from its metadata, a
    dense map's by a reduction) when a ``spike_log`` is open."""
    if _SPIKE_LOG is None:
        return
    if isinstance(spikes, ops.SpikeTensor):
        total = spikes.count().to(torch.int64)
    else:
        total = (spikes != 0).sum()
    _SPIKE_LOG.append((kind, total))


# ------------------------------------------------------------------- helpers
def truncated_normal(gen: torch.Generator, shape: tuple[int, ...], std: float,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, 1) cut at +-2, times ``std``, drawn on the generator's
    device."""
    z = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(z, a=-2.0, b=2.0, generator=gen)
    return z.to(dtype) * std


def dense_init(gen: torch.Generator, din: int, dout: int, *,
               bias: bool = False, std: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> dict:
    std = std if std is not None else 1.0 / math.sqrt(din)
    p = {"w": truncated_normal(gen, (din, dout), std, dtype)}
    if bias:
        p["b"] = torch.zeros((dout,), dtype=dtype, device=gen.device)
    return p


def cast_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.to(dtype)``, made once per weight (``tree.derived``): the
    reference casts the f32 parameters to the activation dtype inside each
    jitted call; eager PyTorch would redo the cast every call. A weight
    that autograd differentiates is cast anew, in the graph."""
    if w.dtype == dtype:
        return w
    if w.requires_grad and torch.is_grad_enabled():
        return w.to(dtype)
    return derived(w, ("cast", dtype), lambda: w.to(dtype))


def dense_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype (the weight cast to it, as the reference does)."""
    y = x @ cast_weight(p["w"], x.dtype)
    if "b" in p:
        y = y + cast_weight(p["b"], y.dtype)
    return y


# ------------------------------------------------------------------- rmsnorm
def rmsnorm_init(d: int, dtype: torch.dtype = torch.float32,
                 device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with its statistics in f32 whatever the activation dtype;
    the root is taken in f64 and rounded, so it is correctly rounded on
    every device."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt((var + eps).to(torch.float64)).to(torch.float32)
    return (xf * inv * p["scale"].to(torch.float32)).to(x.dtype)


def rmsnorm_gated_apply(p: dict, x: torch.Tensor, z: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's output norm: RMSNorm(x * silu(z)), in f32 (the root as
    ``rmsnorm_apply`` takes it), rounded to x's dtype."""
    g = x.to(torch.float32) * silu(z.to(torch.float32))
    var = torch.mean(g * g, dim=-1, keepdim=True)
    inv = torch.rsqrt((var + eps).to(torch.float64)).to(torch.float32)
    return (g * inv * p["scale"].to(torch.float32)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), each step in
    x's dtype: at bf16 that rounds where the reference's (XLA's logistic
    on the CPU) rounds, which ``torch.nn.functional.silu`` (one rounding)
    does not."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


# ---------------------------------------------------------------- embeddings
def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype = torch.float32) -> dict:
    # scaled init: keeps tied-readout logits O(1) at init
    return {"emb": truncated_normal(gen, (vocab, d), d ** -0.5, dtype)}


def embedding_lookup(p: dict, tokens: torch.Tensor,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    return p["emb"][tokens].to(compute_dtype)


def embedding_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied read-out: x @ emb^T -> [.., vocab] in f32."""
    return x.to(torch.float32) @ p["emb"].to(torch.float32).T


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float) -> torch.Tensor:
    """[head_dim / 2] f32 inverse frequencies, made on the CPU (a CUDA
    division by a Python scalar multiplies by its reciprocal, which would
    round differently)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    p = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    return p.new_tensor(1.0) / p


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """``rope_freqs`` moved to ``device`` once: a copy from host memory
    waits for the device's queue, which a copy every layer would drain."""
    return rope_freqs(head_dim, theta).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] (or [S]) int.

    Angles, cos and sin are computed in f32; the rotation runs in x's
    dtype, with cos and sin cast to it first, as the reference does."""
    dh = x.shape[-1]
    freqs = _rope_freqs_on(dh, theta, x.device)          # [Dh/2]
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :].to(x.dtype)    # [B,S,1,Dh/2]
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ------------------------------------------------------------- spiking hook
def maybe_spike(x: torch.Tensor, spiking: bool, lif: LIFConfig) -> torch.Tensor:
    """The paper's LIF activation as an LM drop-in: binary spikes with a
    surrogate gradient when ``spiking``; identity otherwise."""
    if not spiking:
        return x
    return lif_forward(x, lif)


def fused_dense_lif(p: dict, x: torch.Tensor, lif: LIFConfig, *, q=None,
                    qk_threshold: float = 1.0, policy=None) -> ops.SpikeTensor:
    """dense(x) -> LIF spikes as one fused PE pass (deployed inference),
    optionally gated by the QK token mask of ``q``'s row sums; a 2-D
    SpikeTensor over [tokens, Dout] in the policy's format (``"fused_dense"``
    unless told otherwise). Forward-equal to ``maybe_spike(dense_apply(p,
    x), True, lif)`` where the sums agree."""
    return ops.dense_lif(p, x, lif, q=q, qk_threshold=qk_threshold,
                         policy=ops.FUSED_DENSE if policy is None else policy)


# ------------------------------------------------------------- misc numerics
def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def causal_mask(sq: int, sk: int, q_offset: int = 0,
                dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """[sq, sk] additive mask: query i attends to keys <= i + q_offset;
    the others get -1e30 (finite, so a fully masked row stays finite)."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    return torch.where(ki <= qi, 0.0, -1e30).to(dtype)
