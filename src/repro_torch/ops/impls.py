"""Kernel-family registrations for the ops dispatch layer (twin of
``repro.ops.impls``).

Each op binds a ``"reference"`` implementation (plain PyTorch) and, where
its kernel is ported, a ``"fused"`` one that goes through the kernel
wrapper: on CUDA tensors that launches the hand-written kernel, on CPU
tensors it runs the wrapper's plain version. Implementations take wrapped
``SpikeTensor`` operands, hand the kernels dense tensors or
``PackedSpikes``, and wrap spike outputs back in the format ``fmt`` asks
for, so neither the kernels nor the call sites fork on the format. A
packed operand goes to the kernel's packed variant; it is never unpacked
to run the dense kernel, and a fused variant never runs the reference
instead. The fused matmul-sweep registrations take the byte-skip strategy
(``skip``) and every block shape the autotuner can plan: block_m 128,
block_k on the operand's grid and block_n 128 or 256. The ``+grad`` modes
are registered by ``repro_torch.ops.grad``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..core.events import (DEFAULT_BLOCKS, LANE_BITS, PackedSpikes,
                           block_count_map_2d, pack_spikes_ref,
                           packed_from_words, pad_to_blocks,
                           unpack_spikes_ref)
from ..core.lif import LIFConfig, lif_forward
# the registry is where the kernel wrappers are bound, so it imports them
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.flash_attention import attention_ref, flash_attention
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.fused_pe import (fused_pe, fused_pe_layer, fused_pe_ref,
                                head_gate)
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.lif_update import lif_update, lif_update_ref
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.packed import pack_spikes, unpack_spikes
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.qk_attention import qk_attention_fused, qk_attention_ref
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.spike_matmul import check_width, spike_matmul, spike_matmul_ref
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.w2ttfs_pool import w2ttfs_pool_fc, w2ttfs_pool_fc_ref
from ..models import nn
from ..tree import derived
from .dispatch import FusedOut
from .registry import register
from .spike_tensor import SpikeTensor


def _check_blocks(block_m: int, block_n: int, block_k: int) -> None:
    """The CUDA kernels' CTA tile is 128x128; the metadata grid is 128
    rows by block_k (or, for an emitted map, block_n) columns, each 128
    or 256 (the widths the autotuner can plan)."""
    check_width("block_n", block_n)
    check_width("block_k", block_k)
    if block_m != DEFAULT_BLOCKS.m:
        raise ValueError(f"the CUDA kernels tile M on {DEFAULT_BLOCKS.m} rows;"
                         f" got block_m={block_m}")


def _operand(st: Optional[SpikeTensor]):
    """Kernel-level operand: PackedSpikes for packed, the raw payload (no
    cast: a dense residual current stays f32) for dense."""
    if st is None:
        return None
    return st.to_packed_spikes() if st.is_packed else st.data


def _q_operand(q: Optional[SpikeTensor]):
    """Q spikes for the write-back mask of the 2-D entry: packed stays
    packed (row sums are popcounts); dense flattens to the [tokens, Dq]
    core."""
    if q is None:
        return None
    if q.is_packed:
        return q.to_packed_spikes()
    return q.data.reshape(-1, q.data.shape[-1])


def _wrap_spikes(spikes, vld, fmt: str, block_m: int, block_n: int
                 ) -> SpikeTensor:
    """Kernel output -> SpikeTensor (the emitted map's metadata grid tiles
    on (block_m, block_n), so the output tensor's block_k IS block_n)."""
    if fmt == "packed":
        return SpikeTensor.from_packed(spikes)
    return SpikeTensor.dense(spikes, vld, block_m=block_m, block_k=block_n)


def _ref_wrap(spk: torch.Tensor, vld, fmt: str, block_m: int, block_n: int
              ) -> SpikeTensor:
    if fmt == "packed":
        return SpikeTensor.from_packed(
            pack_spikes_ref(spk, block_m=block_m, block_k=block_n))
    return SpikeTensor.dense(spk, vld, block_m=block_m, block_k=block_n)


# =============================================================== spike_matmul
@register("matmul", "fused")
def _matmul_fused(st: SpikeTensor, w: torch.Tensor, *, block_m, block_n,
                  block_k, skip="dense"):
    _check_blocks(block_m, block_n, block_k)
    if len(st.shape) != 2:
        raise ValueError(f"the fused matmul takes a 2-D [M, K] operand, got "
                         f"{tuple(st.shape)}")
    return spike_matmul(_operand(st), w,
                        vld_cnt=None if st.is_packed else st.vld_cnt,
                        block_n=block_n, block_k=block_k, skip=skip)


@register("matmul", "reference")
def _matmul_ref(st: SpikeTensor, w: torch.Tensor, *, block_m, block_n,
                block_k, skip="dense"):
    return spike_matmul_ref(st.to_dense() if st.is_packed else st.data, w)


# ================================================================= lif_update
@register("lif", "fused")
def _lif_fused(current, v_prev, s_prev, cfg: LIFConfig):
    return lif_update(current, v_prev, s_prev, tau=cfg.tau, v_th=cfg.v_th,
                      soft_reset=cfg.soft_reset)


@register("lif", "reference")
def _lif_ref(current, v_prev, s_prev, cfg: LIFConfig):
    return lif_update_ref(current, v_prev, s_prev, tau=cfg.tau,
                          v_th=cfg.v_th, soft_reset=cfg.soft_reset)


# =================================================================== fused_pe
@register("fused_pe", "fused")
def _fused_pe_fused(st: SpikeTensor, w: torch.Tensor, *, bias, residual, q,
                    v_prev, s_prev, qk_threshold, lif_cfg: LIFConfig, fmt,
                    block_m, block_n, block_k, skip="dense", heads=None):
    _check_blocks(block_m, block_n, block_k)
    if len(st.shape) != 2:
        raise ValueError(f"the fused PE pass takes a 2-D [M, K] operand, "
                         f"got {tuple(st.shape)}")
    out = fused_pe(
        _operand(st), w, bias=bias, residual=_operand(residual),
        q=_q_operand(q), vld_cnt=None if st.is_packed else st.vld_cnt,
        v_prev=v_prev, s_prev=s_prev, tau=lif_cfg.tau, v_th=lif_cfg.v_th,
        soft_reset=lif_cfg.soft_reset, qk_threshold=qk_threshold,
        out_format=fmt, block_n=block_n, block_k=block_k, skip=skip,
        heads=heads)
    spikes, vld = out[:2]
    v_next = out[2] if v_prev is not None else None
    return FusedOut(_wrap_spikes(spikes, vld, fmt, block_m, block_n), v_next,
                    vld)


@register("fused_pe", "reference")
def _fused_pe_reference(st: SpikeTensor, w: torch.Tensor, *, bias, residual,
                        q, v_prev, s_prev, qk_threshold, lif_cfg: LIFConfig,
                        fmt, block_m, block_n, block_k, skip="dense",
                        heads=None):
    res = residual.to_dense(torch.float32) if residual is not None else None
    qd = q.to_dense().reshape(-1, q.shape[-1]) if q is not None else None
    spk, v_next, vld = fused_pe_ref(
        st.to_dense() if st.is_packed else st.data, w, bias=bias,
        residual=res, v_prev=v_prev, s_prev=s_prev, q=qd, tau=lif_cfg.tau,
        v_th=lif_cfg.v_th, soft_reset=lif_cfg.soft_reset,
        qk_threshold=qk_threshold, block_m=block_m, block_n=block_n,
        heads=heads)
    return FusedOut(_ref_wrap(spk, vld, fmt, block_m, block_n), v_next, vld)


@register("fused_pe_layer", "fused")
def _fused_pe_layer_fused(st: SpikeTensor, w: torch.Tensor, *, bias,
                          residual, q, qk_threshold, lif_cfg: LIFConfig,
                          fmt, block_m, block_n, block_k, skip="dense",
                          heads=None):
    _check_blocks(block_m, block_n, block_k)
    spikes, vld = fused_pe_layer(
        _operand(st), w, bias=bias, residual=_operand(residual),
        q=_operand(q),
        vld_cnt=None if st.is_packed or st.vld_cnt is None else st.vld_cnt,
        tau=lif_cfg.tau, v_th=lif_cfg.v_th, soft_reset=lif_cfg.soft_reset,
        qk_threshold=qk_threshold, out_format=fmt, block_n=block_n,
        block_k=block_k, skip=skip, heads=heads)
    return FusedOut(_wrap_spikes(spikes, vld, fmt, block_m, block_n), None,
                    vld)


@register("fused_pe_layer", "reference")
def _fused_pe_layer_reference(st: SpikeTensor, w: torch.Tensor, *, bias,
                              residual, q, qk_threshold, lif_cfg: LIFConfig,
                              fmt, block_m, block_n, block_k, skip="dense",
                              heads=None):
    x = st.to_dense() if st.is_packed else st.data
    t, m, _ = x.shape
    n = w.shape[1]
    res = residual.to_dense(torch.float32) if residual is not None else None
    qd = q.to_dense() if q is not None else None
    spikes_ts, vld_ts = [], []
    v = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    s = torch.zeros((m, n), dtype=torch.int8, device=x.device)
    for ti in range(t):
        q_t = None if qd is None else qd[ti]
        if t == 1:
            spk, _, vld = fused_pe_ref(
                x[ti], w, bias=bias,
                residual=None if res is None else res[ti], q=q_t,
                tau=lif_cfg.tau, v_th=lif_cfg.v_th,
                soft_reset=lif_cfg.soft_reset, qk_threshold=qk_threshold,
                block_m=block_m, block_n=block_n, heads=heads)
        else:
            # stateful form: the LIF state carries the PRE-mask spikes and
            # the QK mask gates outside, as the reference's T>1 path does
            spk, v, vld = fused_pe_ref(
                x[ti], w, bias=bias,
                residual=None if res is None else res[ti], v_prev=v,
                s_prev=s, tau=lif_cfg.tau, v_th=lif_cfg.v_th,
                soft_reset=lif_cfg.soft_reset, block_m=block_m,
                block_n=block_n)
            s = spk
            if q_t is not None and heads is not None:
                spk = spk * head_gate(q_t, heads, qk_threshold)
                vld = block_count_map_2d(
                    pad_to_blocks(spk, block_m, block_n), block_m, block_n)
            elif q_t is not None:
                spk = qk_attention_ref(q_t, spk, threshold=qk_threshold)
                vld = block_count_map_2d(
                    pad_to_blocks(spk, block_m, block_n), block_m, block_n)
        spikes_ts.append(spk)
        vld_ts.append(vld)
    spk3 = torch.stack(spikes_ts)
    vld3 = torch.stack(vld_ts)
    return FusedOut(_ref_wrap(spk3, vld3, fmt, block_m, block_n), None, vld3)


# ============================================================ dense -> LIF map
def expand_group_weights(p: dict, heads: tuple[int, int],
                         kv_heads: int) -> dict:
    """Grouped-KV projection -> per-query-head projection, in weight space:
    ``p["w"]`` maps to ``kv_heads`` head blocks of dh columns, and each kv
    head's columns are repeated h // kv_heads times (query head qh reads kv
    head qh // g), so the fused kernel emits the group-expanded [tokens,
    h*dh] map directly. A stateless LIF of repeated columns is the repeated
    LIF spikes, so this equals masking grouped KV and broadcasting."""
    h, dh = heads
    g = h // kv_heads
    w = p["w"]
    d = w.shape[0]
    if w.shape[1] != kv_heads * dh:
        raise ValueError(f"w {tuple(w.shape)} is not {kv_heads} kv heads of "
                         f"{dh}")
    out = {"w": w.reshape(d, kv_heads, 1, dh).expand(d, kv_heads, g, dh)
           .reshape(d, h * dh).contiguous()}
    if "b" in p:
        out["b"] = (p["b"].reshape(kv_heads, 1, dh).expand(kv_heads, g, dh)
                    .reshape(h * dh).contiguous())
    return out


@register("dense_lif", "fused")
def _dense_lif_fused(p: dict, flat: torch.Tensor, lif_cfg: LIFConfig, *, q,
                     qk_threshold, fmt, heads=None, kv_heads=None):
    if heads is not None and kv_heads is not None and kv_heads != heads[0]:
        # once per weight: a serving model expands each layer's grouped wk
        # once, not once a token
        p = derived(p["w"], ("expand_group_weights", heads, kv_heads),
                    lambda: expand_group_weights(p, heads, kv_heads),
                    p.get("b"))
    if q is not None and not q.is_packed:   # the [tokens, Dq] core
        q = SpikeTensor.dense(q.data.reshape(-1, q.data.shape[-1]))
    spikes, vld = fused_pe(
        flat, p["w"], bias=p.get("b"), q=_operand(q),
        v_th=lif_cfg.v_th, qk_threshold=qk_threshold, out_format=fmt,
        # heads drives only the head-blocked mask: grouped KV without q is
        # the weight expansion alone
        heads=None if q is None else heads)
    return _wrap_spikes(spikes, vld, fmt, DEFAULT_BLOCKS.m, DEFAULT_BLOCKS.n)


@register("dense_lif", "reference")
def _dense_lif_ref(p: dict, flat: torch.Tensor, lif_cfg: LIFConfig, *, q,
                   qk_threshold, fmt, heads=None, kv_heads=None):
    cur = flat.to(torch.float32) @ p["w"].to(torch.float32)
    if "b" in p:
        cur = cur + p["b"].to(torch.float32)
    spk = lif_forward(cur, lif_cfg).to(torch.int8)
    m = flat.shape[0]
    if q is not None and heads is not None:
        # grouped KV (kv_heads < h) is masked by a broadcast over the group
        # axis: the expansion exists only as the multiply's output
        h, dh = heads
        hkv = h if kv_heads is None else kv_heads
        g = h // hkv
        rs = q.to_dense(torch.float32).reshape(m, -1)[:, :h * dh].reshape(
            m, h, dh).sum(dim=-1)
        mask = (rs >= qk_threshold).to(torch.int8)
        spk = (spk.reshape(m, hkv, 1, dh)
               * mask.reshape(m, hkv, g, 1)).reshape(m, h * dh)
    elif q is not None:
        rowsum = q.to_dense(torch.float32).reshape(m, -1).sum(
            dim=-1, keepdim=True)
        spk = spk * (rowsum >= qk_threshold).to(torch.int8)
    elif heads is not None and kv_heads is not None and kv_heads != heads[0]:
        h, dh = heads
        g = h // kv_heads
        spk = spk.reshape(m, kv_heads, 1, dh).expand(
            m, kv_heads, g, dh).reshape(m, h * dh)
    bm, bn = DEFAULT_BLOCKS.m, DEFAULT_BLOCKS.n
    if fmt == "packed":
        return SpikeTensor.from_packed(
            pack_spikes_ref(spk, block_m=bm, block_k=bn))
    vld = block_count_map_2d(pad_to_blocks(spk, bm, bn), bm, bn)
    return SpikeTensor.dense(spk, vld, block_m=bm, block_k=bn)


# ======================================================== packed (pack/unpack)
@register("pack", "fused")
def _pack_fused(st: SpikeTensor, *, block_m, block_k):
    return SpikeTensor.from_packed(
        pack_spikes(st.data, block_m=block_m, block_k=block_k))


@register("pack", "reference")
def _pack_ref(st: SpikeTensor, *, block_m, block_k):
    return SpikeTensor.from_packed(
        pack_spikes_ref(st.data, block_m=block_m, block_k=block_k))


@register("unpack", "fused")
def _unpack_fused(st: SpikeTensor, dtype):
    return unpack_spikes(st.to_packed_spikes(), dtype=dtype)


@register("unpack", "reference")
def _unpack_ref(st: SpikeTensor, dtype):
    return unpack_spikes_ref(st.to_packed_spikes(), dtype)


# =============================================================== qk_attention
# The deployed QKFormer masks inside the fused PE kernel; this op is the
# stand-alone QK token mask (the unfused training graph reaches it through
# its "+grad" form).
@register("qk_mask", "fused")
def _qk_mask_fused(q: torch.Tensor, k: torch.Tensor, threshold: float):
    return qk_attention_fused(q, k, threshold=threshold)


@register("qk_mask", "reference")
def _qk_mask_ref(q: torch.Tensor, k: torch.Tensor, threshold: float):
    return qk_attention_ref(q, k, threshold=threshold)


# ============================================================ flash_attention
@register("attention", "fused")
def _attention_fused(q, k, v, *, causal, q_block, kv_block):
    return flash_attention(q, k, v, q_block=q_block, kv_block=kv_block,
                           causal=causal)


@register("attention", "reference")
def _attention_ref(q, k, v, *, causal, q_block, kv_block):
    return attention_ref(q, k, v, causal=causal)


# ============================================================ spatial reshapes
# im2col / max-pool are data movement with no kernel of their own, but they
# are format-dispatched: the packed branches work on the word tensor and
# rebuild vld_cnt by popcount over the words. The two registrations differ
# only in how a format conversion runs: the pack/unpack kernels for
# "fused", their plain versions for "reference".
def _spatial_words(st: SpikeTensor, spatial: tuple, t: int) -> torch.Tensor:
    b, h, w_, _ = spatial
    return st.data[:, :b * h * w_].reshape(t * b, h, w_, st.data.shape[-1])


def _to_fmt(st: SpikeTensor, fmt: str, use_kernels: bool) -> SpikeTensor:
    if fmt == "packed" and not st.is_packed:
        pack = _pack_fused if use_kernels else _pack_ref
        return pack(st, block_m=st.block_m, block_k=st.block_k)
    if fmt == "dense" and st.is_packed:
        unpack = _unpack_fused if use_kernels else _unpack_ref
        return SpikeTensor.dense(unpack(st, torch.int8), block_m=st.block_m,
                                 block_k=st.block_k)
    return st


def _im2col_impl(st: SpikeTensor, spatial: tuple, kh, kw, stride, *, t, fmt,
                 use_kernels: bool = True):
    st = _to_fmt(st, fmt, use_kernels)
    b, h, w_, c = spatial
    if st.is_packed:
        pat = nn.im2col_packed(_spatial_words(st, spatial, t), kh, kw,
                               stride)
        _, ho, wo, kww = pat.shape
        ps = packed_from_words(pat.reshape(t, b * ho * wo, kww),
                               (t, b * ho * wo, kww * LANE_BITS),
                               block_m=st.block_m, block_k=st.block_k)
        return SpikeTensor.from_packed(ps), (ho, wo)
    dense = st.data.reshape(t * b, h, w_, c).to(torch.int8)
    pat = nn.im2col(dense, kh, kw, stride)
    _, ho, wo, kdim = pat.shape
    return (SpikeTensor.dense(pat.reshape(t, b * ho * wo, kdim),
                              block_m=st.block_m, block_k=st.block_k),
            (ho, wo))


def _pool_impl(st: SpikeTensor, spatial: tuple, *, t, window, fmt,
               use_kernels: bool = True):
    st = _to_fmt(st, fmt, use_kernels)
    b, h, w_, c = spatial
    if st.is_packed:
        pooled = nn.max_pool_packed(_spatial_words(st, spatial, t), window)
        h2, w2 = pooled.shape[1], pooled.shape[2]
        ps = packed_from_words(
            pooled.reshape(t, b * h2 * w2, pooled.shape[3]),
            (t, b * h2 * w2, c), block_m=st.block_m, block_k=st.block_k)
        return SpikeTensor.from_packed(ps), (h2, w2)
    x = st.data.reshape(t * b, h, w_, c).to(torch.float32)
    pooled = nn.max_pool(x, window)
    h2, w2 = pooled.shape[1], pooled.shape[2]
    return (SpikeTensor.dense(
        pooled.reshape(t, b * h2 * w2, c).to(torch.int8),
        block_m=st.block_m, block_k=st.block_k), (h2, w2))


register("im2col", "fused")(_im2col_impl)
register("im2col", "reference")(functools.partial(_im2col_impl,
                                                  use_kernels=False))
register("pool", "fused")(_pool_impl)
register("pool", "reference")(functools.partial(_pool_impl,
                                                use_kernels=False))


# =================================================================== w2ttfs
@register("w2ttfs_head", "fused")
def _w2ttfs_head_fused(spikes, fc_w, fc_b, *, window):
    return w2ttfs_pool_fc(spikes, fc_w, fc_b, window=window)


@register("w2ttfs_head", "reference")
def _w2ttfs_head_ref(spikes, fc_w, fc_b, *, window):
    return w2ttfs_pool_fc_ref(spikes, fc_w, fc_b, window)
