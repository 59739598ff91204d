"""The LM training path's kernels as plain PyTorch that forms each kernel's
own sums, and a context that runs the path on them.

A library's f32 product sums in another order than the kernels, so a
spike can flip at v_th and the flip carries through the later layers: a
training step held to ``reference+grad`` differs in its gradients by more
than the kernels' own error. Inside ``chain_launchers()`` the same step
runs the same wrappers, operands and autograd on the card with no
hand-written kernel and the kernels' forward bits, which makes it the
witness a ``fused_dense+grad`` step's gradients are held to."""
from __future__ import annotations

import contextlib

import torch

from ..core.events import block_count_map_2d, pack_words, unpack_words
from . import _build
from .fused_pe import fused_pe_tile_operands, head_gate
from .fused_pe import ops as pe_ops
from .spike_matmul import (spike_matmul_chain_ref, spike_matmul_dw_ref,
                           spike_matmul_dx_ref, spike_matmul_tile_operands)
from .spike_matmul import backward as bwd_ops
from .spike_matmul import ops as mm_ops


def fma_chain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as the float-x tile (``csrc/event_gemm.cuh``) forms it: each
    output one chain of fused multiply-adds over k ascending, from +0.
    Each step is one ``torch.addcmul``, which a CUDA build fuses into one
    fmaf (a CPU build may round the product first). Returns [M, N] f32."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    xf = x.to(torch.float32)
    for k in range(x.shape[1]):
        acc = torch.addcmul(acc, xf[:, k:k + 1], w[k])
    return acc


def fused_pe_chain_ref(*args) -> tuple:
    """A fused PE launch of a dense float x (stateless, no residual) on
    ``fused_pe_cuda``'s operands, with the kernel's own sums: the current
    is ``fma_chain`` of the launch's operands, then the bias, the
    threshold, the QK mask and the block counts. Returns what the kernel
    returns."""
    (xp, wp, vld, bp, rp, qp, m0, n0, v_th, qk, packing, block_n, gate,
     heads, state, _) = fused_pe_tile_operands(args)
    if not xp.is_floating_point() or state is not None or rp is not None \
            or gate is not None:
        raise ValueError("fused_pe_chain_ref takes a dense float x only")
    cur = fma_chain(xp, wp)
    if bp is not None:
        cur = cur + bp.reshape(1, -1)
    spk = (cur >= v_th).to(torch.int8)
    if qp is not None:
        q = unpack_words(qp) if packing.q else qp
        spk[:, :heads[0] * heads[1]] *= head_gate(q, heads, qk)
    spk[m0:] = 0
    spk[:, n0:] = 0
    out = (pack_words(spk) if packing.out else spk,
           block_count_map_2d(spk, 128, block_n))
    if packing.current:
        out = (*out, cur[:m0, :n0].contiguous())
    return out


@contextlib.contextmanager
def chain_launchers():
    """Inside, the ``fused_dense+grad`` training path's launchers run plain
    PyTorch: K2 ``fused_pe_chain_ref``, K3 the ascending f32 chain
    (``spike_matmul_chain_ref``), and the backward's dx and dw their plain
    versions; the wrappers count no launch."""
    def dx(g, w, v, surrogate, alpha, v_th):
        return spike_matmul_dx_ref(g, w, v, surrogate=surrogate, alpha=alpha,
                                   v_th=v_th)

    swaps = [(pe_ops, "fused_pe_cuda",
              lambda *args, route="tile", **_: fused_pe_chain_ref(*args)),
             (mm_ops, "spike_matmul_cuda",
              lambda *args, route="tile": spike_matmul_chain_ref(
                  *spike_matmul_tile_operands(args))),
             (bwd_ops, "spike_matmul_dx_cuda", dx),
             (bwd_ops, "spike_matmul_dw_cuda", spike_matmul_dw_ref),
             (_build, "count_launch", lambda *args, **_: None)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
