"""Feed-forward layers (twin of ``repro.models.ffn``): the dense SwiGLU and
the dropping mixture of experts (MoE). In spiking mode the SiLU gate
becomes a LIF spike, so the hidden activation is a binary event map times
the up projection. The products are plain ``torch.matmul``s, as the
reference leaves them to XLA.

MoE. A softmax router in f32, top-k selection (a stable descending sort,
so ties go to the lower expert index as ``jax.lax.top_k`` gives them), the
top-k weights renormalised when k > 1. Each batch row is one dispatch
group of S tokens with ``moe_capacity(cfg, S)`` places per expert; the
S * k choices are ranked per expert in arrival order and those at or past
the capacity are dropped. The reference forms the [B, E, cap, D] expert
buffers and the combine with one-hot einsums (the GShard form, which
shards under GSPMD); here the buffers are filled by index from the ranks,
the experts run as one batched matmul over them, and each token gathers
its k rows back. ``moe_apply_dense_ref`` runs every expert on every token
(the tests' oracle: equal to ``moe_apply`` wherever nothing drops).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.softmax import softmax
from .layers import (cast_weight, dense_apply, dense_init, maybe_spike,
                     note_spikes, silu, truncated_normal)


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d: Optional[int] = None,
             d_ff: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "gate": dense_init(gen, d, f, dtype=cfg.param_dtype),
        "up": dense_init(gen, d, f, dtype=cfg.param_dtype),
        "down": dense_init(gen, f, d, dtype=cfg.param_dtype),
    }


def _gate(cfg: ModelConfig, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The SwiGLU hidden activation: silu(g) * u, or in spiking mode the
    LIF spikes of g (a binary event map, noted as the layer's "mlp" map)
    times u."""
    if cfg.spiking:
        s = maybe_spike(g, True, cfg.lif)
        note_spikes("mlp", s)
        return s * u
    return silu(g) * u


def mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    g = dense_apply(p["gate"], x)
    u = dense_apply(p["up"], x)
    return dense_apply(p["down"], _gate(cfg, g, u))


# --------------------------------------------------------------------- MoE
def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    std = 1.0 / (d ** 0.5)
    p = {
        "router": dense_init(gen, d, e, dtype=torch.float32),  # f32 router
        "w_gate": truncated_normal(gen, (e, d, f), std, cfg.param_dtype),
        "w_up": truncated_normal(gen, (e, d, f), std, cfg.param_dtype),
        "w_down": truncated_normal(gen, (e, f, d), 1.0 / f ** 0.5,
                                   cfg.param_dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d,
                               (cfg.d_ff or f) * cfg.n_shared_experts)
    return p


def moe_capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Places per expert in a dispatch group of ``group_tokens`` tokens: a
    multiple of 8, at least 8 and at most the group's length."""
    cap = int(group_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, min(group_tokens, -(-cap // 8) * 8))


def router_probs(p: dict, x: torch.Tensor):
    """[.., D] -> ([.., E] f32 softmax router probabilities, the logits)."""
    logits = x.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    return softmax(logits), logits


def top_k(probs: torch.Tensor, k: int):
    """The k largest probabilities and their experts, largest first; ties
    to the lower index (a stable sort, as ``jax.lax.top_k`` orders them)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Router probabilities and logits, and the (renormalised) top-k
    weights and experts of every token."""
    probs, logits = router_probs(p, x)
    topv, topi = top_k(probs, cfg.top_k)
    if cfg.top_k > 1:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, logits, topv, topi


def dispatch_ranks(topi: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[B, S, k] chosen experts -> [B, S, k] rank of each choice in its
    expert's buffer: the number of earlier choices of that expert in the
    row, counted over the flattened S * k choices in arrival order."""
    b, s, k = topi.shape
    onehot = F.one_hot(topi.reshape(b, s * k), n_experts).to(torch.int32)
    ranks = torch.cumsum(onehot, dim=1) - onehot
    return ranks.gather(-1, topi.reshape(b, s * k, 1)).reshape(b, s, k)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x: [B, S, D] -> (y, aux): the routed experts' sum, and the
    auxiliary terms {"load_balance", "router_z", "dropped_frac"} (f32
    scalars)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, s)
    probs, logits, topv, topi = _route(p, cfg, x)
    rank = dispatch_ranks(topi, e)
    keep = rank < cap                                     # capacity drop mask
    weight = topv * keep.to(topv.dtype)                   # [B,S,k]

    # the expert buffers, filled by index: choice (b, s, j) goes to place
    # rank of expert topi in row b (each kept place is taken once); a
    # dropped choice goes to a spare place past the buffers, cut off after
    place = topi * cap + torch.clamp(rank, max=cap - 1)   # [B,S,k]
    rows = torch.arange(b, device=x.device)[:, None, None].expand(b, s, k)
    spare = torch.where(keep, place, e * cap)
    xe = x.new_zeros((b, e * cap + 1, d)).index_put(
        (rows, spare), x[:, :, None, :].expand(b, s, k, d))[:, :e * cap]
    xe = xe.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    g = xe @ cast_weight(p["w_gate"], x.dtype)            # [E, B*cap, F]
    u = xe @ cast_weight(p["w_up"], x.dtype)
    ye = _gate(cfg, g, u) @ cast_weight(p["w_down"], x.dtype)
    ye = ye.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    # combine: each token's k rows, weighted (a dropped choice weighs 0),
    # summed in f32 and rounded once, as the reference's combine einsum
    picked = ye.gather(1, place.reshape(b, s * k, 1).expand(b, s * k, d))
    wt = weight.to(x.dtype).to(torch.float32)[..., None]
    y = (picked.reshape(b, s, k, d).to(torch.float32) * wt).sum(2)
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], cfg, x)

    # Switch aux loss: E * sum_e f_e * P_e (f = fraction routed, P = mean
    # probability)
    f_e = F.one_hot(topi, e).sum(2).to(torch.float32).mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    aux = {
        "load_balance": e * torch.sum(f_e * p_e),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        # the kept count times 1 / count in f32, as XLA's mean takes it
        "dropped_frac": 1.0 - keep.to(torch.float32).sum()
        * (1.0 / keep.numel()),
    }
    return y, aux


def moe_apply_dense_ref(p: dict, cfg: ModelConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert on every token, combined with the (dropless)
    top-k weights. O(E) work: tests only."""
    _, _, topv, topi = _route(p, cfg, x)
    probs_shape = (*x.shape[:2], cfg.n_experts)
    w_full = torch.zeros(probs_shape, dtype=topv.dtype,
                         device=x.device).scatter(-1, topi, topv)
    g = torch.einsum("bsd,edf->besf", x, cast_weight(p["w_gate"], x.dtype))
    u = torch.einsum("bsd,edf->besf", x, cast_weight(p["w_up"], x.dtype))
    h = (maybe_spike(g, True, cfg.lif) * u if cfg.spiking
         else silu(g) * u)
    ye = torch.einsum("besf,efd->besd", h, cast_weight(p["w_down"], x.dtype))
    y = torch.einsum("besd,bse->bsd", ye, w_full.to(x.dtype))
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], cfg, x)
    return y
