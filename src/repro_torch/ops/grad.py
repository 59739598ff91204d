"""The gradient axis of ``repro_torch.ops``: surrogate-gradient
implementations (twin of ``repro.ops.grad``).

The paper trains single-timestep SNNs with plain backprop by putting a
smooth pseudo-derivative in place of every Heaviside (C1). Here that is a
set of ``(op, mode)`` registry entries, so the same policy-driven forward
the deployment runs is what the KD training differentiates:

  * ``(op, "reference+grad")`` — plain PyTorch, differentiated by autograd
    through ``core.surrogate.spike`` (whose ``autograd.Function`` carries
    the pseudo-derivative). The baseline the fused mode is held against.
  * ``(op, "fused+grad")`` — a ``torch.autograd.Function`` whose forward
    runs the policy's kernels (int8 or packed spike output) and whose
    backward consumes residuals cached by that forward.

Residual policy (the matmul-bearing ops ``matmul``, ``fused_pe`` and
``fused_pe_layer``): the forward saves its spike operand (as int8, exact
on {0,1}) with the ``vld_cnt`` map it streamed, the weight and the
kernel-emitted membrane current (``emit_current``), and the backward
recomputes only the elementwise tail from that current. The two transposed
contractions are the backward kernels: ``dx = dv @ wᵀ`` with the surrogate
factor formed inside the dx kernel (the stateless pass), or as the plain
transposed product of the tail's ``dcur`` (a stateful T>1 step, whose
tail also carries the gradients into ``v_prev`` and ``s_prev``), and
``dw = xᵀ @ dv`` skipping the blocks that were silent on the way forward.
At T>1 the layer chains one residual-cached step per timestep; the carries
``(v, s)`` stay in the autograd graph (``s`` the pre-mask surrogate spike
in f32, handed to the kernel as an exact int8 copy), so BPTT flows through
both. The elementwise ops (``lif``,
``qk_mask``) and the small W2TTFS head keep the recompute-from-inputs vjp.

Executor: every fused entry calls the kernel wrappers, which launch the
hand-written kernels on CUDA tensors and run their plain versions on CPU
tensors. Spike operands arrive dense f32 (autograd connectivity) and spike
outputs leave dense f32; a packed-format forward packs and unpacks inside
the primal only. The head-blocked masks and ``dense_lif`` of LM training
(ROADMAP queue 1 item 2) are still to port and raise.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.events import DEFAULT_BLOCKS
from ..core.lif import LIFConfig
from ..core.qk_attention import qk_token_mask
from ..core.surrogate import spike
from ..core.w2ttfs import w2ttfs_classifier
# the registry is where the kernel wrappers are bound, so it imports them
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.fused_pe import fused_pe
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.lif_update import lif_update
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.packed import unpack_spikes
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.qk_attention import qk_attention_fused
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.spike_matmul import (spike_matmul, spike_matmul_dw,
                                    spike_matmul_dx, vld_map)
# neurallint: disable=NL-REGISTRY-BYPASS
from ..kernels.w2ttfs_pool import w2ttfs_pool_fc
from ..models import nn
from .dispatch import FusedOut
from .impls import _check_blocks
from .registry import register
from .spike_tensor import SpikeTensor

# --------------------------------------------------------------- machinery
def _f32(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.to(torch.float32)


def _dense_operand(st) -> torch.Tensor:
    """SpikeTensor (or tensor) -> dense f32 operand; a dense f32 payload
    passes through with its autograd history."""
    if isinstance(st, SpikeTensor):
        return st.to_dense(torch.float32) if st.is_packed \
            else st.data.to(torch.float32)
    return st.to(torch.float32)


class _RecomputeVJP(torch.autograd.Function):
    """Primal = ``kernel_fwd(*operands)`` (the policy's kernels); backward
    = the vjp of ``ref_fwd`` (the plain surrogate body), recomputed from
    the saved operands. Both return one tensor or a tuple of tensors of
    the same structure."""

    @staticmethod
    def forward(ctx, kernel_fwd: Callable, ref_fwd: Callable, *operands):
        ctx.ref_fwd = ref_fwd
        ctx.save_for_backward(*operands)
        return kernel_fwd(*operands)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(True)
                      for t in saved]
            outs = ctx.ref_fwd(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, gs) if o.requires_grad]
        wanted = [t for t, need in zip(inputs, ctx.needs_input_grad[2:])
                  if t is not None and need]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else ())
        out = [next(grads) if t is not None and need else None
               for t, need in zip(inputs, ctx.needs_input_grad[2:])]
        return (None, None, *out)


def _lif_step(cur: torch.Tensor, v_prev: Optional[torch.Tensor],
              s_prev: Optional[torch.Tensor], cfg: LIFConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The surrogate LIF body in the kernel's state convention (reset by
    ``s_prev`` on entry, by the emitted spike on exit)."""
    v = cur if v_prev is None else \
        cfg.tau * v_prev * (1.0 - (0.0 if s_prev is None else s_prev)) + cur
    s = spike(v - cfg.v_th, cfg.surrogate, cfg.alpha)
    v_next = v - cfg.v_th * s if cfg.soft_reset else v * (1.0 - s)
    return s, v_next


def _qk_rowmask(q: torch.Tensor, threshold: float, mode: str,
                surrogate: str, alpha: float) -> torch.Tensor:
    """Per-token write-back mask: ``core.qk_attention.qk_token_mask``, the
    one definition of the row-sum semantics."""
    return qk_token_mask(q, mode, threshold, surrogate, alpha)


def _pe_current(x, w, bias, residual) -> torch.Tensor:
    cur = x @ w
    if bias is not None:
        cur = cur + bias.reshape(1, -1)
    if residual is not None:
        cur = cur + residual
    return cur


def _row_masked(s: torch.Tensor, q: Optional[torch.Tensor],
                cfg: LIFConfig, qk_threshold: float) -> torch.Tensor:
    """Spikes gated by q's whole-row QK mask (as they are without q)."""
    if q is None:
        return s
    return s * _qk_rowmask(q.reshape(s.shape[0], -1), qk_threshold,
                           "threshold", cfg.surrogate, cfg.alpha)


def _pe_reference(x, w, bias, residual, q, cfg: LIFConfig,
                  qk_threshold: float, v_prev=None, s_prev=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused PE layer as plain autograd: current, the surrogate LIF
    step (stateless without ``v_prev``), whole-row QK mask. Returns
    (spikes, v_next)."""
    s, v_next = _lif_step(_pe_current(x, w, bias, residual), v_prev, s_prev,
                          cfg)
    return _row_masked(s, q, cfg, qk_threshold), v_next


def _forward_vld(vld: torch.Tensor, block_k: int) -> Optional[torch.Tensor]:
    """The forward kernel's vld map: the saved 128x128 one (the grid the
    backward kernels read) when x's blocks are 128 wide, else recounted by
    the wrapper on its own grid."""
    return vld if block_k == DEFAULT_BLOCKS.k else None


# ------------------------------------------------------------------- matmul
class _SpikeMatmul(torch.autograd.Function):
    """``x @ w`` on the spike matmul kernel; backward dx = g @ wᵀ (the dx
    kernel without a surrogate) and dw = xᵀ @ g (the dw kernel, skipping
    the blocks the forward skipped). ``skip`` is the byte-skip strategy of
    both directions. Takes leading batch dims."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, skip: str,
                blocks: tuple):
        x8 = x.reshape(-1, x.shape[-1]).to(torch.int8)     # exact on {0,1}
        vld = vld_map(x8)
        _, block_n, block_k = blocks
        out = spike_matmul(x8, w, vld_cnt=_forward_vld(vld, block_k),
                           block_n=block_n, block_k=block_k, skip=skip)
        ctx.save_for_backward(x8, vld, w)
        ctx.x_shape, ctx.skip = x.shape, skip
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x8, vld, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx, _ = spike_matmul_dx(g2, w)
            dx = dx.reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            dw = spike_matmul_dw(x8, g2, vld_cnt=vld,
                                 skip=ctx.skip).to(w.dtype)
        return dx, dw, None, None


def _matmul_impl(kernels: str):
    def impl(st, w, *, block_m, block_n, block_k, skip="dense"):
        x, w_ = _dense_operand(st), _f32(w)
        if kernels == "reference":
            return x @ w_
        _check_blocks(block_m, block_n, block_k)
        return _SpikeMatmul.apply(x, w_, skip, (block_m, block_n, block_k))
    return impl


# ---------------------------------------------------------------------- lif
def _lif_impl(kernels: str):
    def impl(current, v_prev, s_prev, cfg: LIFConfig):
        operands = (_f32(current), _f32(v_prev), _f32(s_prev))

        def ref_fwd(c, v, s):
            return _lif_step(c, v, s, cfg)

        if kernels == "reference":
            return ref_fwd(*operands)

        def kernel_fwd(c, v, s):
            v = torch.zeros_like(c) if v is None else v
            s = torch.zeros_like(c) if s is None else s
            spk, v_next = lif_update(c, v, s, tau=cfg.tau, v_th=cfg.v_th,
                                     soft_reset=cfg.soft_reset)
            return spk.to(torch.float32), v_next.to(torch.float32)

        return _RecomputeVJP.apply(kernel_fwd, ref_fwd, *operands)
    return impl


# ----------------------------------------------------------------- fused_pe
class _FusedPE(torch.autograd.Function):
    """The stateless fused PE layer on the kernels.

    Forward: one fused PE launch with ``emit_current`` (spikes and the f32
    current leave together; a packed output is unpacked by the unpack
    kernel). Backward, the reference's fully fused stateless form:
    ``dv = g_eff ⊙ surr'(cur - v_th)`` inside the dx kernel, where g_eff is
    the cotangent gated by the (constant) QK row mask; the gradient into q
    is the vjp of the mask on the spikes reconstructed as ``cur >= v_th``;
    ``dw`` on the dw kernel; the bias gradient is the column sum of dv and
    the residual's is dv. ``skip`` is the byte-skip strategy of the
    forward pass and of dw."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, q, cfg: LIFConfig,
                qk_threshold: float, fmt: str, skip: str, blocks: tuple):
        x8 = x.to(torch.int8)                               # exact on {0,1}
        vld = vld_map(x8)
        _, block_n, block_k = blocks
        spikes, _, cur = fused_pe(
            x8, w, bias=bias, residual=residual, q=q,
            vld_cnt=_forward_vld(vld, block_k), v_th=cfg.v_th,
            qk_threshold=qk_threshold, out_format=fmt, emit_current=True,
            block_n=block_n, block_k=block_k, skip=skip)
        if fmt == "packed":
            spikes = unpack_spikes(spikes)
        ctx.save_for_backward(x8, vld, w, q, cur)
        ctx.cfg, ctx.qk_threshold, ctx.skip = cfg, qk_threshold, skip
        ctx.has_bias, ctx.has_residual = bias is not None, residual is not None
        return spikes.to(torch.float32)

    @staticmethod
    def backward(ctx, gs: torch.Tensor):
        x8, vld, w, q, cur = ctx.saved_tensors
        cfg = ctx.cfg
        dq = None
        if q is not None:
            q2 = q.reshape(cur.shape[0], -1)

            def rowmask(q_):
                return _qk_rowmask(q_, ctx.qk_threshold, "threshold",
                                   cfg.surrogate, cfg.alpha)

            # the primal spikes, reconstructed: a constant wrt cur; the
            # surrogate factor flows through the dx kernel instead
            s_raw = (cur >= cfg.v_th).to(gs.dtype)
            with torch.enable_grad():
                q_ = q2.detach().requires_grad_(True)
                (dq,) = torch.autograd.grad(s_raw * rowmask(q_), q_, gs)
            dq = dq.reshape(q.shape)
            g_eff = gs * (torch.ones_like(gs) * rowmask(q2))
        else:
            g_eff = gs
        dx, dcur = spike_matmul_dx(g_eff, w, cur, surrogate=cfg.surrogate,
                                   alpha=cfg.alpha, v_th=cfg.v_th)
        dw = spike_matmul_dw(x8, dcur, vld_cnt=vld, skip=ctx.skip) \
            if ctx.needs_input_grad[1] else None
        dbias = dcur.sum(dim=0) if ctx.has_bias else None
        dres = dcur if ctx.has_residual else None
        return dx, dw, dbias, dres, dq, None, None, None, None, None


class _FusedPEState(torch.autograd.Function):
    """One stateful fused PE step (T>1) on the kernels.

    Forward: one fused PE launch with the LIF state and ``emit_current``
    (a packed output is unpacked by the unpack kernel); returns the spikes
    (QK-masked when q is given) and v_next, reset by the pre-mask spike.
    Backward: the elementwise tail (``_lif_step`` from the cached current,
    then the mask) differentiated by autograd gives ``dcur`` and the
    gradients into ``v_prev``, ``s_prev`` and q; then ``dx = dcur @ wᵀ``
    on the dx kernel without a surrogate (its plain transposed form) and
    ``dw = xᵀ @ dcur`` on the dw kernel; the bias gradient is the column
    sum of dcur and the residual's is dcur."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, q, v_prev, s_prev, cfg: LIFConfig,
                qk_threshold: float, fmt: str, skip: str, blocks: tuple):
        x8 = x.to(torch.int8)                               # exact on {0,1}
        vld = vld_map(x8)
        _, block_n, block_k = blocks
        spikes, _, v_next, cur = fused_pe(
            x8, w, bias=bias, residual=residual, q=q,
            vld_cnt=_forward_vld(vld, block_k), v_prev=v_prev,
            s_prev=s_prev, tau=cfg.tau, v_th=cfg.v_th,
            soft_reset=cfg.soft_reset, qk_threshold=qk_threshold,
            out_format=fmt, emit_current=True, block_n=block_n,
            block_k=block_k, skip=skip)
        if fmt == "packed":
            spikes = unpack_spikes(spikes)
        ctx.save_for_backward(x8, vld, w, q, v_prev, s_prev, cur)
        ctx.cfg, ctx.qk_threshold, ctx.skip = cfg, qk_threshold, skip
        ctx.has_bias, ctx.has_residual = bias is not None, residual is not None
        return spikes.to(torch.float32), v_next

    @staticmethod
    def backward(ctx, gs: torch.Tensor, gv: torch.Tensor):
        x8, vld, w, q, v_prev, s_prev, cur = ctx.saved_tensors
        cfg = ctx.cfg
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (cur, v_prev, s_prev)]
            q_ = None if q is None else q.detach().requires_grad_(True)
            spk, v_next = _lif_step(*leaves, cfg)
            spk = _row_masked(spk, q_, cfg, ctx.qk_threshold)
            wrt = leaves + ([] if q_ is None else [q_])
            grads = torch.autograd.grad((spk, v_next), wrt, (gs, gv),
                                        allow_unused=True)
        dcur, dv_prev, ds_prev = (torch.zeros_like(t) if g is None else g
                                  for g, t in zip(grads[:3], leaves))
        dq = None if q_ is None else grads[3]
        dx, _ = spike_matmul_dx(dcur, w)
        dw = spike_matmul_dw(x8, dcur, vld_cnt=vld, skip=ctx.skip) \
            if ctx.needs_input_grad[1] else None
        dbias = dcur.sum(dim=0) if ctx.has_bias else None
        dres = dcur if ctx.has_residual else None
        return (dx, dw, dbias, dres, dq, dv_prev, ds_prev, None, None, None,
                None, None)


def _pe_step(kernels: str, x, w, bias, residual, q, v_prev, s_prev,
             cfg: LIFConfig, qk_threshold: float, fmt: str, skip: str,
             blocks: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """One stateful step: (spikes, v_next), the spikes QK-masked when q is
    given; plain autograd under ``"reference"``, the kernels otherwise."""
    if kernels != "reference":
        _check_blocks(*blocks)
        return _FusedPEState.apply(x, w, bias, residual, q, v_prev, s_prev,
                                   cfg, qk_threshold, fmt, skip, blocks)
    return _pe_reference(x, w, bias, residual, q, cfg, qk_threshold, v_prev,
                         s_prev)


def _no_heads(heads) -> None:
    if heads is not None:
        raise NotImplementedError(
            "the differentiable head-blocked QK mask is still to port, "
            "with LM training (ROADMAP queue 1 item 2)")


def _fused_pe_impl(kernels: str):
    def impl(st, w, *, bias, residual, q, v_prev, s_prev, qk_threshold,
             lif_cfg, fmt, block_m, block_n, block_k, skip="dense",
             heads=None):
        _no_heads(heads)
        if s_prev is not None and v_prev is None:
            raise ValueError("s_prev needs v_prev")
        x, w_, b = _dense_operand(st), _f32(w), _f32(bias)
        res = None if residual is None else _dense_operand(residual)
        q_ = None if q is None else _dense_operand(q)
        blocks = (block_m, block_n, block_k)
        v_next = None
        if v_prev is not None:
            vp = _f32(v_prev)
            sp = torch.zeros_like(vp) if s_prev is None else _f32(s_prev)
            spk, v_next = _pe_step(kernels, x, w_, b, res, q_, vp, sp,
                                   lif_cfg, qk_threshold, fmt, skip, blocks)
        elif kernels == "reference":
            spk, _ = _pe_reference(x, w_, b, res, q_, lif_cfg, qk_threshold)
        else:
            _check_blocks(*blocks)
            spk = _FusedPE.apply(x, w_, b, res, q_, lif_cfg, qk_threshold,
                                 fmt, skip, blocks)
        return FusedOut(SpikeTensor.dense(spk, block_m=block_m,
                                          block_k=block_n), v_next, None)
    return impl


# ----------------------------------------------------------- fused_pe_layer
def _fused_pe_layer_impl(kernels: str):
    def impl(st, w, *, bias, residual, q, qk_threshold, lif_cfg, fmt,
             block_m, block_n, block_k, skip="dense", heads=None):
        t = st.shape[0]
        _no_heads(heads)
        if t != 1:
            return _stateful_layer(kernels, st, w, bias, residual, q,
                                   qk_threshold, lif_cfg, fmt,
                                   (block_m, block_n, block_k), skip)
        out = _fused_pe_impl(kernels)(
            st[0], w, bias=bias,
            residual=None if residual is None else residual[0],
            q=None if q is None else q[0], v_prev=None, s_prev=None,
            qk_threshold=qk_threshold, lif_cfg=lif_cfg, fmt=fmt,
            block_m=block_m, block_n=block_n, block_k=block_k, skip=skip,
            heads=heads)
        spk = out.spikes.data[None]
        return FusedOut(SpikeTensor.dense(spk, block_m=block_m,
                                          block_k=block_n), None, None)
    return impl


def _stateful_layer(kernels: str, st, w, bias, residual, q, qk_threshold,
                    cfg: LIFConfig, fmt: str, blocks: tuple, skip: str
                    ) -> FusedOut:
    """T>1: one stateful step per timestep, the carry (v, s) from zeros and
    in the autograd graph; ``s`` is the step's pre-mask surrogate spike,
    and the QK mask gates each step's spikes outside the carry."""
    x, w_, b = _dense_operand(st), _f32(w), _f32(bias)
    res = None if residual is None else _dense_operand(residual)
    q_ = None if q is None else _dense_operand(q)
    m, n = x.shape[1], w_.shape[1]
    v = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    s = torch.zeros_like(v)
    spikes = []
    for ti in range(x.shape[0]):
        spk, v = _pe_step(kernels, x[ti], w_, b,
                          None if res is None else res[ti], None, v, s, cfg,
                          qk_threshold, fmt, skip, blocks)
        s = spk
        spikes.append(_row_masked(spk, None if q_ is None else q_[ti], cfg,
                                  qk_threshold))
    return FusedOut(SpikeTensor.dense(torch.stack(spikes), block_m=blocks[0],
                                      block_k=blocks[1]), None, None)


# ------------------------------------------------------------------ qk_mask
def _qk_mask_impl(kernels: str):
    def impl(q, k, threshold, *, mode="threshold", surrogate="atan",
             alpha=2.0):
        def ref_fwd(q_, k_):
            return _qk_rowmask(q_, threshold, mode, surrogate, alpha) * k_

        operands = (_f32(q), _f32(k))
        if kernels == "reference":
            return ref_fwd(*operands)
        # "or" on non-negative integer spike counts == rowsum >= 1
        thr = 1.0 if mode == "or" else threshold

        def kernel_fwd(q_, k_):
            return qk_attention_fused(q_, k_, threshold=thr)

        return _RecomputeVJP.apply(kernel_fwd, ref_fwd, *operands)
    return impl


# -------------------------------------------------------------- w2ttfs_head
def _w2ttfs_impl(kernels: str):
    def impl(spikes, fc_w, fc_b, *, window):
        def ref_fwd(s, w, b):
            return w2ttfs_classifier(s, w, b, window)

        operands = (_f32(spikes), _f32(fc_w), _f32(fc_b))
        if kernels == "reference":
            return ref_fwd(*operands)

        def kernel_fwd(s, w, b):
            return w2ttfs_pool_fc(s, w, b, window=window).to(torch.float32)

        return _RecomputeVJP.apply(kernel_fwd, ref_fwd, *operands)
    return impl


# ------------------------------------------- differentiable data movement
# im2col / max-pool are data movement whose vjps autograd knows (slicing,
# cat, max-pool); the grad-mode registrations differ from the inference
# ones only by keeping the float dtype (the int8 casts of the inference
# forms are exact on {0,1} but cut the autograd graph).
def _im2col_diff(st, spatial, kh, kw, stride, *, t, fmt):
    b, h, w_, c = spatial
    x = _dense_operand(st)[:, :b * h * w_].reshape(t * b, h, w_, c)
    pat = nn.im2col(x, kh, kw, stride)
    _, ho, wo, kdim = pat.shape
    return (SpikeTensor.dense(pat.reshape(t, b * ho * wo, kdim),
                              block_m=st.block_m, block_k=st.block_k),
            (ho, wo))


def _pool_diff(st, spatial, *, t, window, fmt):
    b, h, w_, c = spatial
    x = _dense_operand(st)[:, :b * h * w_].reshape(t * b, h, w_, c)
    pooled = nn.max_pool(x, window)
    h2, w2 = pooled.shape[1], pooled.shape[2]
    return (SpikeTensor.dense(pooled.reshape(t, b * h2 * w2, c),
                              block_m=st.block_m, block_k=st.block_k),
            (h2, w2))


# ------------------------------------------------------------ registration
def _register_all() -> None:
    for kernels in ("reference", "fused"):
        mode = f"{kernels}+grad"
        register("matmul", mode)(_matmul_impl(kernels))
        register("lif", mode)(_lif_impl(kernels))
        register("fused_pe", mode)(_fused_pe_impl(kernels))
        register("fused_pe_layer", mode)(_fused_pe_layer_impl(kernels))
        register("qk_mask", mode)(_qk_mask_impl(kernels))
        register("w2ttfs_head", mode)(_w2ttfs_impl(kernels))
        register("im2col", mode)(_im2col_diff)
        register("pool", mode)(_pool_diff)


_register_all()
