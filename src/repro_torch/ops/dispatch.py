"""Format-dispatching entry points (twin of ``repro.ops.dispatch``).

Every op takes spike operands as ``SpikeTensor`` (raw tensors and
``PackedSpikes`` are wrapped) plus an ``ExecutionPolicy`` — preset name,
instance, or None — and looks its implementation up in the ``(op, mode)``
registry. ``policy.format`` is the format of the emitted spike maps
(operands are converted as needed), so a chain of ``ops.*`` calls keeps its
format end to end. ``policy=None`` means the fused kernels, with the format
of the first spike operand. Under an ``"auto"`` policy the matmul-sweep
ops (``matmul``, ``fused_pe``, ``fused_pe_layer``) ask the roofline
autotuner (``ops.autotune``) for the kernel, the byte-skip strategy and
the block shape of each call from the operand's measured sparsity; the
other ops run ``"auto"`` as ``"fused"``, as the reference does.

A ``"+grad"`` policy (``policy.for_training()``) resolves the same registry
to the surrogate-gradient implementations of ``repro_torch.ops.grad``: the
forward still runs the policy's kernels, the backward puts the registered
pseudo-derivative in place of every Heaviside. Differentiable spike outputs
are dense f32 (autograd connectivity) and carry no metadata maps.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.events import DEFAULT_BLOCKS
from ..core.lif import LIFConfig
from ..tree import derived
from .policy import ExecutionPolicy, PolicyLike, as_policy
from .registry import lookup
from .spike_tensor import SpikeTensor, Spikes


def _policy_for(policy: PolicyLike, *sts: Optional[SpikeTensor]
                ) -> ExecutionPolicy:
    """None -> the fused kernels, the format inherited from the first
    packed spike operand (dense when there is none)."""
    if policy is not None:
        return as_policy(policy)
    packed = any(st is not None and st.is_packed for st in sts)
    return ExecutionPolicy("fused", "packed" if packed else "dense")


def _auto_matmul(op: str, pol: ExecutionPolicy, st: SpikeTensor, n: int,
                 block_m: int, block_n: int, block_k: int,
                 allow_wide_n: bool = True
                 ) -> tuple[ExecutionPolicy, str, int, int, int]:
    """Resolve an ``"auto"`` policy for a matmul-sweep op: the tuner's
    plan (kernel, skip strategy, block shape) for this operand's shape and
    measured sparsity. Returns the concrete policy and (skip, block_m,
    block_n, block_k). A demoted op plans to reference. Under ``+grad`` the
    plan prices the backward (the dw sweep's skip) and keeps the blocks."""
    from .autotune import get_tuner

    tuner = get_tuner()
    if tuner.is_demoted(op):
        return (dataclasses.replace(pol, kernels="reference"),
                "dense", block_m, block_n, block_k)
    if pol.differentiable:
        plan = tuner.plan_grad_for(st, n)
        return (dataclasses.replace(pol, kernels=plan.kernels),
                plan.skip, block_m, block_n, block_k)
    plan = tuner.plan_for(st, n, block_m=block_m, block_n=block_n,
                          block_k=block_k, allow_wide_n=allow_wide_n)
    pol = dataclasses.replace(pol, kernels=plan.kernels)
    return pol, plan.skip, plan.block_m, plan.block_n, plan.block_k


def _auto_fused_pe(op: str, pol: ExecutionPolicy, st: SpikeTensor,
                   res: Optional[SpikeTensor], qs: Optional[SpikeTensor],
                   n: int, block_m: int, block_n: int, block_k: int):
    """``_auto_matmul`` for a fused PE pass. A packed residual or q ties
    the output's tiling, so the tuner may not widen block_n; a packed
    residual's grid is the output's (the reference requests the default
    block_n and then rejects a residual emitted on a 256-wide grid)."""
    pinned = ((res is not None and res.is_packed)
              or (qs is not None and qs.is_packed))
    if res is not None and res.is_packed:
        block_n = res.block_k
    return _auto_matmul(op, pol, st, n, block_m, block_n, block_k,
                        allow_wide_n=not pinned)


def _non_tuned(policy: PolicyLike, *sts: Optional[SpikeTensor]
               ) -> ExecutionPolicy:
    """Ops without a tuner cost model run ``"auto"`` as ``"fused"``, as in
    the reference."""
    pol = _policy_for(policy, *sts)
    return dataclasses.replace(pol, kernels="fused") if pol.auto else pol


class FusedOut(NamedTuple):
    """``ops.fused_pe_layer`` result: the emitted spike map (metadata
    attached), optional membrane state, and the raw vld map."""
    spikes: SpikeTensor
    v_next: Optional[torch.Tensor]
    vld_next: Optional[torch.Tensor]


def matmul(x: Spikes, w: torch.Tensor, *, policy: PolicyLike = None,
           skip: str = "dense",
           block_m: int = DEFAULT_BLOCKS.m, block_n: int = DEFAULT_BLOCKS.n,
           block_k: int = DEFAULT_BLOCKS.k) -> torch.Tensor:
    """Event-driven spike matmul: [M, K] spikes @ [K, N] -> f32 current
    (the reference mode takes any leading dims). The fused mode skips
    silent blocks on the operand's ``vld_cnt`` (computed here when a dense
    SpikeTensor carries none) and takes a packed operand as it is.
    ``skip`` selects the byte-skip strategy ("dense" | "gated" |
    "two_level"); an ``"auto"`` policy overrides it and the blocks with
    the autotuner's plan."""
    st = SpikeTensor.wrap(x)
    pol = _policy_for(policy, st)
    if pol.auto:
        pol, skip, block_m, block_n, block_k = _auto_matmul(
            "matmul", pol, st, w.shape[1], block_m, block_n, block_k)
    return lookup("matmul", pol.mode)(st, w, block_m=block_m,
                                      block_n=block_n, block_k=block_k,
                                      skip=skip)


def lif(current: torch.Tensor, v_prev: torch.Tensor, s_prev: torch.Tensor,
        *, lif_cfg: LIFConfig = LIFConfig(),
        policy: PolicyLike = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One LIF membrane step over any-shaped current. Returns (spikes,
    v_next f32); spikes are int8, or f32 under a ``+grad`` policy."""
    pol = _non_tuned(policy)
    return lookup("lif", pol.mode)(current, v_prev, s_prev, lif_cfg)


def fused_pe(x: Spikes, w: torch.Tensor, *,
             bias: Optional[torch.Tensor] = None,
             residual: Optional[Spikes] = None,
             q: Optional[Spikes] = None,
             v_prev: Optional[torch.Tensor] = None,
             s_prev: Optional[torch.Tensor] = None,
             qk_threshold: float = 1.0,
             lif_cfg: LIFConfig = LIFConfig(),
             policy: PolicyLike = None,
             skip: str = "dense",
             heads: Optional[tuple[int, int]] = None,
             block_m: int = DEFAULT_BLOCKS.m,
             block_n: int = DEFAULT_BLOCKS.n,
             block_k: int = DEFAULT_BLOCKS.k) -> FusedOut:
    """One fused PE layer over a 2-D [M, K] spike operand: event-skipped
    matmul + bias / residual + LIF threshold + optional QK write-back mask
    (whole-row, or per head with ``heads=(h, dh)``), emitting the next
    layer's metadata on the fly. ``v_prev`` / ``s_prev`` carry the LIF
    state of a T>1 step (``v_next`` comes back in ``FusedOut.v_next``; the
    reset is the layer's own pre-mask spike). The ``+grad`` modes take the
    state too; a head-blocked mask under ``+grad`` raises (LM training)."""
    st = SpikeTensor.wrap(x)
    res = SpikeTensor.wrap(residual) if residual is not None else None
    qs = SpikeTensor.wrap(q) if q is not None else None
    pol = _policy_for(policy, st)
    if pol.auto:
        pol, skip, block_m, block_n, block_k = _auto_fused_pe(
            "fused_pe", pol, st, res, qs, w.shape[1], block_m, block_n,
            block_k)
    return lookup("fused_pe", pol.mode)(
        st, w, bias=bias, residual=res, q=qs, v_prev=v_prev, s_prev=s_prev,
        qk_threshold=qk_threshold, lif_cfg=lif_cfg, fmt=pol.format,
        block_m=block_m, block_n=block_n, block_k=block_k, skip=skip,
        heads=heads)


def fused_pe_layer(x: Spikes, w: torch.Tensor, *,
                   bias: Optional[torch.Tensor] = None,
                   residual: Optional[Spikes] = None,
                   q: Optional[Spikes] = None,
                   qk_threshold: float = 1.0,
                   lif_cfg: LIFConfig = LIFConfig(),
                   policy: PolicyLike = None,
                   skip: str = "dense",
                   heads: Optional[tuple[int, int]] = None,
                   block_m: int = DEFAULT_BLOCKS.m,
                   block_n: int = DEFAULT_BLOCKS.n,
                   block_k: int = DEFAULT_BLOCKS.k) -> FusedOut:
    """Fused layer over [T, M, K] spike trains: event-skipped matmul + bias
    / residual + LIF threshold + optional QK write-back mask, emitting the
    next layer's ``vld_cnt`` on the fly, in ``policy.format``.
    ``residual`` is a spike map (dense or packed) or an f32 membrane
    current. ``heads=(h, dh)`` makes the QK mask head-blocked: each head's
    row sum of q gates only its own dh output columns (inference modes;
    the ``+grad`` modes raise)."""
    st = SpikeTensor.wrap(x)
    res = SpikeTensor.wrap(residual) if residual is not None else None
    qs = SpikeTensor.wrap(q) if q is not None else None
    pol = _policy_for(policy, st)
    if pol.auto:
        pol, skip, block_m, block_n, block_k = _auto_fused_pe(
            "fused_pe_layer", pol, st, res, qs, w.shape[1], block_m, block_n,
            block_k)
    return lookup("fused_pe_layer", pol.mode)(
        st, w, bias=bias, residual=res, q=qs, qk_threshold=qk_threshold,
        lif_cfg=lif_cfg, fmt=pol.format, block_m=block_m, block_n=block_n,
        block_k=block_k, skip=skip, heads=heads)


def im2col(x: Spikes, spatial: tuple, kh: int, kw: int, stride: int, *,
           t: int = 1, policy: PolicyLike = None
           ) -> tuple[SpikeTensor, tuple[int, int]]:
    """Conv patch extraction on a token-layout spike map [t, B*H*W, C]
    (``spatial`` = (B, H, W, C)). Returns (patches [t, B*Ho*Wo, kh*kw*C],
    (Ho, Wo))."""
    st = SpikeTensor.wrap(x)
    pol = _non_tuned(policy, st)
    return lookup("im2col", pol.mode)(st, spatial, kh, kw, stride, t=t,
                                      fmt=pol.format)


def pool(x: Spikes, spatial: tuple, *, t: int = 1, window: int = 2,
         policy: PolicyLike = None) -> tuple[SpikeTensor, tuple[int, int]]:
    """Spatial max-pool of a binary spike map in token layout. Returns
    (pooled [t, B*H2*W2, C], (H2, W2))."""
    st = SpikeTensor.wrap(x)
    pol = _non_tuned(policy, st)
    return lookup("pool", pol.mode)(st, spatial, t=t, window=window,
                                    fmt=pol.format)


def conv_matmul_weights(w: torch.Tensor, patches: Spikes) -> torch.Tensor:
    """[kh, kw, Cin, Cout] conv weight -> the [K, Cout] matmul weight in
    ``ops.im2col``'s feature order."""
    from ..models import nn

    st = SpikeTensor.wrap(patches)
    kh, kw = w.shape[:2]
    c_padded = st.k // (kh * kw)
    if torch.is_grad_enabled() and w.requires_grad:
        return nn.conv_weights_as_matmul_packed(w, c_padded)
    # outside autograd, one matrix per parameter (and so one bf16 split of
    # it for the fused PE's spike-x tile, made once a weight)
    return derived(w, ("conv matmul", c_padded),
                   lambda: nn.conv_weights_as_matmul_packed(w, c_padded))


def qk_mask(q: Spikes, k: Spikes, *, threshold: float = 1.0,
            mode: str = "threshold", surrogate: str = "atan",
            alpha: float = 2.0, policy: PolicyLike = None) -> SpikeTensor:
    """QKFormer token attention: mask K's spike rows by Q's per-token
    row-sum threshold. Inputs [..., N, D]; the output keeps the policy's
    format. ``mode``/``surrogate``/``alpha`` shape the gradient under a
    ``+grad`` policy: ``"threshold"`` passes the surrogate pseudo-derivative
    of the row-sum Heaviside into Q; ``"or"`` (the hardware atten_reg, the
    same forward on integer spike counts at threshold 1) passes none.
    Inference policies ignore them."""
    qs = SpikeTensor.wrap(q)
    ks = SpikeTensor.wrap(k)
    pol = _non_tuned(policy, ks)
    if pol.differentiable:
        masked = lookup("qk_mask", pol.mode)(
            qs.to_dense(torch.float32) if qs.is_packed else qs.data,
            ks.to_dense(torch.float32) if ks.is_packed else ks.data,
            threshold, mode=mode, surrogate=surrogate, alpha=alpha)
        return SpikeTensor.dense(masked)
    masked = lookup("qk_mask", pol.kernels)(qs.to_dense(), ks.to_dense(),
                                            threshold)
    out = SpikeTensor.dense(masked)
    return pack(out, policy=pol) if pol.packed else out


def pack(x: Spikes, *, policy: PolicyLike = None,
         block_m: int = DEFAULT_BLOCKS.m,
         block_k: int = DEFAULT_BLOCKS.k) -> SpikeTensor:
    """Convert to the packed format (a packed operand is returned as it
    is): words, ``vld_cnt`` and ``occ`` from one pass."""
    st = SpikeTensor.wrap(x)
    if st.is_packed:
        return st
    pol = _non_tuned(as_policy(policy, ExecutionPolicy("fused", "packed")))
    return lookup("pack", pol.kernels)(st, block_m=block_m, block_k=block_k)


def unpack(x: Spikes, *, dtype: torch.dtype = torch.int8,
           policy: PolicyLike = None) -> torch.Tensor:
    """The dense spike map at the logical shape (a cast for a dense
    operand)."""
    st = SpikeTensor.wrap(x)
    if not st.is_packed:
        return st.data.to(dtype)
    pol = _non_tuned(as_policy(policy, ExecutionPolicy("fused", "packed")))
    return lookup("unpack", pol.kernels)(st, dtype)


def dense_lif(p: dict, x: torch.Tensor, lif_cfg: LIFConfig, *,
              q: Optional[Spikes] = None, qk_threshold: float = 1.0,
              heads: Optional[tuple[int, int]] = None,
              kv_heads: Optional[int] = None,
              policy: PolicyLike = None) -> SpikeTensor:
    """dense(x) + LIF threshold as one fused PE pass (the LM projections):
    ``x`` is the dense residual stream (f32 or bf16, any leading dims),
    ``p`` holds ``w`` [D, Dout] (and ``b``); the f32 pre-activation never
    reaches device memory, and the spikes leave in the policy's format as
    a 2-D SpikeTensor over [tokens, Dout]. ``q`` applies the QK write-back
    mask: whole-row, or with ``heads=(h, dh)`` one row-sum threshold per
    head over q's head slice, gating only that head's dh columns.
    ``kv_heads < h`` declares a grouped-KV projection (``w`` maps to
    ``kv_heads`` head blocks): the emitted map is the group-expanded
    [tokens, h*dh]; the fused mode repeats the weight's columns (once per
    weight, memoised), the reference broadcasts at the mask multiply.
    Under a ``"+grad"`` policy the spikes leave dense f32 with their
    surrogate gradient (``ops.grad``)."""
    flat = x.reshape(-1, x.shape[-1])
    qs = SpikeTensor.wrap(q) if q is not None else None
    pol = _non_tuned(policy)
    return lookup("dense_lif", pol.mode)(p, flat, lif_cfg, q=qs,
                                         qk_threshold=qk_threshold,
                                         fmt=pol.format, heads=heads,
                                         kv_heads=kv_heads)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_block: int = 512, kv_block: int = 512,
              policy: PolicyLike = None) -> torch.Tensor:
    """Streaming causal (or full) softmax attention over q [B, S, H, Dh]
    and grouped k, v [B, S, Hkv, Dh]: the non-spiking side of the hybrid
    flow, registered by the ``flash_attention`` kernel family."""
    pol = _non_tuned(_policy_for(policy))
    return lookup("attention", pol.kernels)(q, k, v, causal=causal,
                                            q_block=q_block,
                                            kv_block=kv_block)


def w2ttfs_head(spikes: torch.Tensor, fc_w: torch.Tensor,
                fc_b: torch.Tensor, *, window: int,
                policy: PolicyLike = None) -> torch.Tensor:
    """W2TTFS classifier head: window spike-count pooling + unit-scale FC
    over a dense [B, H, W, C] spike map."""
    pol = _non_tuned(policy)
    return lookup("w2ttfs_head", pol.mode)(spikes, fc_w, fc_b, window=window)
