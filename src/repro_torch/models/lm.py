"""Decoder-only LM of the model zoo, the ``dense`` family (twin of
``repro.models.lm``): GQA attention (softmax attention with RoPE and a KV
cache, or the spiking QKFormer token attention,
``attention_kind="qk_spiking"``) and a SwiGLU MLP per block, RMSNorm, a
tied or separate read-out.

Execution modes: ``prefill`` (logits and the cache of a whole prompt),
``prefill_chunk`` (C more tokens against a cache: the serving engine's
chunked prefill, equal to a blocking prefill) and ``decode_step`` (one
token for every sequence of a slot pool). A Python loop over the layers
takes the place of the reference's ``lax.scan``; the parameters keep one
dict per block in ``params["blocks"]`` (``convert.lm_params_from_jax``
unstacks the reference's stacked blocks). The cache keeps the reference's
stacked layout, ``{"layers": (k [L, B, S, Hkv, Dh], v [...]), "len"}``.
Under softmax attention k and v hold the keys (after RoPE) and values in
``cfg.dtype``, or in ``torch.float8_e4m3fn`` when ``kv_dtype="f8_e4m3"``;
``decode_step`` and ``prefill_chunk`` write the new rows into the cache's
tensors in place and return the same tensors (the engine's slot pool is
one preallocated tensor, never copied a tick). Under ``qk_spiking`` both
are empty (S = 0), except that a packed policy keeps each slot's packed
spike state in k, [L, B, 1, 1, W] int32, made anew each call.

Training (``loss``): the causal next-token cross-entropy of a whole
sequence through ``block_apply`` layer by layer (``_stack_train``), each
layer checkpointed as ``cfg.remat`` asks: ``"full"`` recomputes the layer
in the backward pass (``torch.utils.checkpoint``), ``"dots"`` keeps its
matmul outputs and recomputes the rest. Under a ``"+grad"`` policy the
spiking projections run their kernels forward and their surrogate
gradients backward (``ops.grad``).

The other families (moe, ssm, hybrid, vlm, encdec) are still to port
(ROADMAP queue 1 item 4).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from .attention import (attn_append, attn_apply, attn_decode, attn_init,
                        attn_prefill, qk_spike_state_width)
from .ffn import mlp_apply, mlp_init
from .layers import (dense_apply, dense_init, embedding_init,
                     embedding_logits, embedding_lookup, rmsnorm_apply,
                     rmsnorm_init, spike_log_paused)


# ===================================================================== blocks
def block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, cfg.param_dtype, gen.device),
            "attn": attn_init(gen, cfg),
            "ln2": rmsnorm_init(cfg.d_model, cfg.param_dtype, gen.device),
            "mlp": mlp_init(gen, cfg)}


def _mlp_residual(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + mlp_apply(p["mlp"], cfg, rmsnorm_apply(p["ln2"], x,
                                                      cfg.rms_eps))


def _zero_aux(device) -> dict:
    """The MoE auxiliary terms of a block without experts: f32 zeros."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("load_balance", "router_z", "dropped_frac")}


def block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True
                ) -> tuple[torch.Tensor, dict]:
    """Full-sequence block forward (training): attention and the MLP, each
    on its RMSNorm and added to the residual stream. Returns (x, the MoE
    aux terms, zeros for the dense family)."""
    h = attn_apply(p["attn"], cfg, rmsnorm_apply(p["ln1"], x, cfg.rms_eps),
                   positions, causal=causal)
    return _mlp_residual(p, cfg, x + h), _zero_aux(x.device)


# the matmuls whose outputs a "dots" checkpoint keeps
_DOTS = frozenset(op.default for op in (torch.ops.aten.mm,
                                        torch.ops.aten.addmm,
                                        torch.ops.aten.bmm,
                                        torch.ops.aten.baddbmm))


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_contexts(remat: str) -> tuple:
    """The forward and recompute contexts of one checkpointed layer: the
    recompute notes no spikes (its forward did)."""
    if remat == "dots":
        fwd, rec = create_selective_checkpoint_contexts(_save_dots)
    else:
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    return fwd, _paused(rec)


@contextlib.contextmanager
def _paused(ctx):
    with ctx, spike_log_paused():
        yield


def block_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> tuple[torch.Tensor, Any]:
    """Block forward that also emits its cache entry."""
    h, kv = attn_prefill(p["attn"], cfg, rmsnorm_apply(p["ln1"], x,
                                                       cfg.rms_eps),
                         positions)
    return _mlp_residual(p, cfg, x + h), kv


def block_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache_l: Any,
                 cache_len: torch.Tensor) -> tuple[torch.Tensor, Any]:
    h, kv = attn_decode(p["attn"], cfg, rmsnorm_apply(p["ln1"], x,
                                                      cfg.rms_eps),
                        cache_len, cache_l[0], cache_l[1], cache_len)
    return _mlp_residual(p, cfg, x + h), kv


def block_append(p: dict, cfg: ModelConfig, x: torch.Tensor, cache_l: Any,
                 cache_len: torch.Tensor) -> tuple[torch.Tensor, Any]:
    """Chunked-prefill block forward: C tokens appended to a cache entry."""
    h, kv = attn_append(p["attn"], cfg, rmsnorm_apply(p["ln1"], x,
                                                      cfg.rms_eps),
                        cache_l[0], cache_l[1], cache_len)
    return _mlp_residual(p, cfg, x + h), kv


def _stack_layers(entries: list) -> tuple:
    """Per-layer (k, v) entries -> the stacked (k [L, ...], v [L, ...])."""
    return tuple(torch.stack([e[i] for e in entries]) for i in range(2))


def _pad_kv_layers(layers: tuple, max_len: int) -> tuple:
    """Pad float KV leaves (seq axis -3) to max_len; int32 leaves are
    packed spike states, one row per slot whatever the length, and empty
    leaves stay empty."""
    out = []
    for leaf in layers:
        s = leaf.shape[-3]
        if leaf.dtype == torch.int32 or s == 0 or s >= max_len:
            out.append(leaf)
            continue
        pad = torch.zeros((*leaf.shape[:-3], max_len - s, *leaf.shape[-2:]),
                          dtype=leaf.dtype, device=leaf.device)
        out.append(torch.cat([leaf, pad], dim=-3))
    return tuple(out)


# ================================================================== LM model
class LM:
    """Decoder-only LM over the dense-family blocks."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the {cfg.family!r} family is still to port (ROADMAP queue "
                f"1 item 4); the port's LM runs the dense family")
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device: DeviceLike = None) -> dict:
        """Random parameters drawn from ``gen`` on its device, then moved
        to ``device`` (the card unless told otherwise)."""
        cfg = self.cfg
        dev = resolve_device(device)
        params: dict = {
            "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                    cfg.param_dtype),
            "blocks": [block_init(gen, cfg) for _ in range(cfg.n_layers)],
            "final_norm": rmsnorm_init(cfg.d_model, cfg.param_dtype,
                                       gen.device),
        }
        if not cfg.tie_embeddings:
            params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                        dtype=cfg.param_dtype)
        return _to_device(params, dev)

    # ------------------------------------------------------------ embeddings
    def _embed(self, params: dict, batch: dict):
        """-> (x [B,S,D], positions [B,S])."""
        x = embedding_lookup(params["embed"], batch["tokens"], self.cfg.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x, positions

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return embedding_logits(params["embed"], x)
        return dense_apply(params["head"], x.to(torch.float32))

    def _final(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_apply(params["final_norm"], x, self.cfg.rms_eps)

    # ----------------------------------------------------------- stack (train)
    def _stack_train(self, params: dict, x: torch.Tensor,
                     positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Every block's ``block_apply`` in turn (checkpointed per
        ``cfg.remat``), then the final norm. Returns (x, the aux terms
        summed over the layers)."""
        cfg = self.cfg
        body = self._maybe_remat(
            lambda x_, p_l: block_apply(p_l, cfg, x_, positions))
        aux = _zero_aux(x.device)
        for p_l in params["blocks"]:
            x, a = body(x, p_l)
            aux = {k: aux[k] + a[k] for k in aux}
        return self._final(params, x), aux

    def _maybe_remat(self, fn: Callable) -> Callable:
        """``fn`` as it is (``remat="none"``), or checkpointed: ``"full"``
        saves only its inputs and recomputes it in the backward pass,
        ``"dots"`` also keeps its matmul outputs (non-reentrant
        ``torch.utils.checkpoint``)."""
        remat = self.cfg.remat
        if remat == "none":
            return fn
        if remat not in ("full", "dots"):
            raise ValueError(f"remat={remat!r} not in ('none', 'full', "
                             f"'dots')")
        contexts = functools.partial(_remat_contexts, remat)

        def run(*args):
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=contexts)
        return run

    # ------------------------------------------------------------------ loss
    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Causal next-token cross-entropy: the mean over every position t
        < S - 1 of -log p(token t+1), the logits in f32. ``batch["tokens"]``
        [B, S] int. Returns (loss, {"nll", "loss"})."""
        x, positions = self._embed(params, batch)
        x, _ = self._stack_train(params, x, positions)
        tokens = batch["tokens"]
        n_pred = tokens.shape[1] - 1
        logits = self._logits(params, x[:, -n_pred - 1:-1, :])
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        loss = nll.mean()
        return loss, {"nll": loss, "loss": loss}

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, params: dict, batch: dict,
                return_all_logits: bool = False,
                max_len: int = 0) -> tuple[torch.Tensor, dict]:
        """Full-context forward -> (last-position logits [B,V], or all of
        them [B,S,V] with ``return_all_logits``; the cache)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch)
        entries = []
        for p_l in params["blocks"]:
            x, c = block_prefill(p_l, cfg, x, positions)
            entries.append(c)
        layers = _stack_layers(entries)
        x = self._final(params, x)
        if return_all_logits:
            logits = self._logits(params, x)
        else:
            logits = self._logits(params, x[:, -1:, :])[:, 0, :]
        if max_len:
            layers = _pad_kv_layers(layers, max_len)
        cache = {"layers": layers,
                 "len": torch.tensor(positions.shape[1], dtype=torch.int32,
                                     device=x.device)}
        return logits, cache

    # ----------------------------------------------------------- decode step
    @torch.no_grad()
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        """One token for every sequence. tokens [B, 1] int; cache['len'] a
        scalar or a per-sequence [B] vector (slot pools)."""
        return self._append(params, tokens, cache, block_decode,
                            all_logits=False)

    # -------------------------------------------------------- chunked prefill
    @torch.no_grad()
    def prefill_chunk(self, params: dict, tokens: torch.Tensor, cache: dict
                      ) -> tuple[torch.Tensor, dict]:
        """Continued prefill: C tokens [B, C] appended to a cache whose
        ``len`` counts the positions already prefilled. Returns all-position
        logits [B, C, V] and the cache with len advanced by C; a prompt fed
        through this in chunks gives a blocking ``prefill``'s logits."""
        return self._append(params, tokens, cache, block_append,
                            all_logits=True)

    def _append(self, params, tokens, cache, block_fn, all_logits: bool):
        cfg = self.cfg
        cache_len = cache["len"]
        x = embedding_lookup(params["embed"], tokens, cfg.dtype)
        k_pool, v_pool = cache["layers"]
        entries = []
        for i, p_l in enumerate(params["blocks"]):
            x, nc = block_fn(p_l, cfg, x, (k_pool[i], v_pool[i]), cache_len)
            entries.append(nc)
        x = self._final(params, x)
        logits = self._logits(params, x)
        if not all_logits:
            logits = logits[:, 0, :]
        # softmax attention wrote its rows into the pool's own tensors
        layers = (_stack_layers(entries) if cfg.attention_kind == "qk_spiking"
                  else (k_pool, v_pool))
        return logits, {"layers": layers, "len": cache_len + tokens.shape[1]}

    # ------------------------------------------------------------ cache spec
    def init_cache(self, batch_size: int, max_len: int,
                   device: DeviceLike = None) -> dict:
        """Zero cache on ``device`` (the card unless told otherwise): under
        softmax attention k and v of [L, B, max_len, Hkv, Dh] in the KV
        dtype."""
        cfg = self.cfg
        dev = resolve_device(device)
        dh = cfg.resolved_head_dim
        hkv = cfg.n_kv_heads or cfg.n_heads
        lead = cfg.n_layers
        kv_dtype = (torch.float8_e4m3fn if cfg.kv_dtype == "f8_e4m3"
                    else cfg.dtype)
        if cfg.attention_kind != "qk_spiking":
            shp = (lead, batch_size, max_len, hkv, dh)
            return {"layers": (torch.zeros(shp, dtype=kv_dtype, device=dev),
                               torch.zeros(shp, dtype=kv_dtype, device=dev)),
                    "len": torch.tensor(max(max_len - 1, 0),
                                        dtype=torch.int32, device=dev)}
        empty = torch.zeros((lead, batch_size, 0, hkv, dh), dtype=kv_dtype,
                            device=dev)
        k = empty
        if cfg.exec_policy.packed:
            # per-slot spike state, bit-packed: one row of masked attention
            # spikes per layer, O(1) in sequence length
            k = torch.zeros((lead, batch_size, 1, 1,
                             qk_spike_state_width(cfg)), dtype=torch.int32,
                            device=dev)
        # len = max_len - 1: the cache is "full", as the reference has it:
        # the next token writes the last row
        return {"layers": (k, empty),
                "len": torch.tensor(max(max_len - 1, 0), dtype=torch.int32,
                                    device=dev)}


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def param_device(params: dict) -> torch.device:
    """The device a parameter tree lives on."""
    return params["embed"]["emb"].device


def spike_totals(log: list, n_layers: int) -> dict:
    """``layers.spike_log()`` entries of one LM pass -> per kind ("q",
    "attn", "mlp") the [n_layers] int64 totals, summed over the passes the
    log holds (each pass notes the kinds layer by layer)."""
    out: dict = {}
    for kind in ("q", "attn", "mlp"):
        vals = [t for k, t in log if k == kind]
        if not vals:
            continue
        if len(vals) % n_layers:
            raise ValueError(f"{len(vals)} {kind!r} totals for {n_layers} "
                             f"layers")
        out[kind] = torch.stack(vals).reshape(-1, n_layers).sum(dim=0)
    return out


__all__ = ["LM", "block_init", "block_apply", "block_prefill",
           "block_decode", "block_append", "param_device", "spike_totals"]
