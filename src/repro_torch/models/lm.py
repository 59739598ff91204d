"""Decoder-only LM of the model zoo (twin of ``repro.models.lm``): one
parameterised decoder stack for five families,

  dense   (qwen1.5-32b, qwen3-1.7b, qwen2.5-3b, yi-9b) -- GQA attention and
          a SwiGLU MLP a block;
  moe     (llama4-scout-17b-a16e, olmoe-1b-7b)         -- GQA attention and
          the dropping MoE FFN (``ffn.moe_apply``);
  ssm     (mamba2-130m)                                -- Mamba2 (SSD) blocks;
  hybrid  (zamba2-7b)                                  -- Mamba2 blocks and
          ONE shared attention + MLP block applied before each group of
          ``attn_every`` of them, with its own KV entry at each site;
  vlm     (phi-3-vision-4.2b)                          -- the dense decoder
          behind a prefix of precomputed patch embeddings (``img_embeds``),
          merged 2 x 2 (spike counts in spiking mode, the W2TTFS datapath;
          a mean otherwise) and projected by ``vision_proj``.

Attention is softmax attention with RoPE and a KV cache, or the spiking
QKFormer token attention (``attention_kind="qk_spiking"``). The encoder-
decoder family lives in ``models.encdec``.

Execution modes: ``prefill`` (logits and the cache of a whole prompt),
``prefill_chunk`` (C more tokens against a cache: the serving engine's
chunked prefill, equal to a blocking prefill on ``prefill_chunk_align``
bounds) and ``decode_step`` (one token for every sequence of a slot
pool). A Python loop over the layers takes the place of the reference's
``lax.scan``; the parameters keep one dict per block in
``params["blocks"]`` (``convert.lm_params_from_jax`` unstacks the
reference's stacked blocks). The cache keeps the reference's stacked
layout: ``{"layers": ..., "len"}`` with layers

  dense, moe, vlm: (k [L, B, S, Hkv, Dh], v [...]);
  ssm:             {"ssm": [L, B, H, P, N] f32, "conv": [L, B, K-1, C]};
  hybrid:          {"attn": (k [G, B, S, Hkv, Dh], v), "mamba": {"ssm":
                   [G, A, B, H, P, N], "conv": [G, A, B, K-1, C]}} for G
                   groups of A = ``attn_every`` mamba layers.

Under softmax attention k and v hold the keys (after RoPE) and values in
``cfg.dtype``, or in ``torch.float8_e4m3fn`` when ``kv_dtype="f8_e4m3"``;
under ``qk_spiking`` both are empty (S = 0), except that a packed policy
keeps each slot's packed spike state in k, [L, B, 1, 1, W] int32.
``decode_step`` and ``prefill_chunk`` write the new rows and states into
the cache's own tensors and return them (the engine's slot pool is one
preallocated tree, never copied a tick).

Training (``loss``): the causal next-token cross-entropy of a whole
sequence (its text positions, for the vlm family) through ``block_apply``
layer by layer (``_stack_train``), each layer checkpointed as
``cfg.remat`` asks: ``"full"`` recomputes the layer in the backward pass
(``torch.utils.checkpoint``), ``"dots"`` keeps its matmul outputs and
recomputes the rest. The moe family adds ``router_aux_weight`` times the
load-balance term and 1e-3 times the router-z term. Under a ``"+grad"``
policy the spiking projections run their kernels forward and their
surrogate gradients backward (``ops.grad``).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import DeviceLike, resolve_device
from ..configs.base import ModelConfig, ShapeSpec
from ..core.w2ttfs import window_counts
from ..tree import tree_map
from .attention import (attn_append, attn_apply, attn_decode, attn_init,
                        attn_prefill, qk_spike_state_width)
from .ffn import mlp_apply, mlp_init, moe_apply, moe_init
from .layers import (dense_apply, dense_init, embedding_init,
                     embedding_logits, embedding_lookup, maybe_spike,
                     rmsnorm_apply, rmsnorm_init, spike_log_paused)
from .ssm import (mamba_apply, mamba_decode_step, mamba_init,
                  mamba_init_state)

AUX_KEYS = ("load_balance", "router_z", "dropped_frac")


# ===================================================================== blocks
def _block_kind(cfg: ModelConfig) -> str:
    return {"dense": "attn_mlp", "vlm": "attn_mlp", "moe": "attn_moe",
            "ssm": "mamba", "hybrid": "mamba"}[cfg.family]


def block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    kind = _block_kind(cfg)
    if kind == "mamba":
        return {"ln1": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
                "mamba": mamba_init(gen, cfg)}
    p = {"ln1": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
         "attn": attn_init(gen, cfg),
         "ln2": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev)}
    if kind == "attn_moe":
        p["moe"] = moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg)
    return p


def shared_attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Zamba2's weight-shared attention block (one parameter set, many
    sites)."""
    dev = gen.device
    return {"ln1": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
            "attn": attn_init(gen, cfg),
            "ln2": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
            "mlp": mlp_init(gen, cfg, d_ff=cfg.d_ff)}


def _zero_aux(device) -> dict:
    """The MoE auxiliary terms of a block without experts: f32 zeros."""
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _ffn_residual(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x plus the block's MLP or MoE on its RMSNorm -> (x, the MoE aux
    terms, zeros for an MLP)."""
    y = rmsnorm_apply(p["ln2"], x, cfg.rms_eps)
    if "moe" in p:
        out, aux = moe_apply(p["moe"], cfg, y)
        return x + out, aux
    return x + mlp_apply(p["mlp"], cfg, y), _zero_aux(x.device)


def _norm1(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm_apply(p["ln1"], x, cfg.rms_eps)


def block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True
                ) -> tuple[torch.Tensor, dict]:
    """Full-sequence block forward (training). Returns (x, the MoE aux
    terms, zeros for blocks without experts)."""
    if "mamba" in p:
        return (x + mamba_apply(p["mamba"], cfg, _norm1(p, cfg, x)),
                _zero_aux(x.device))
    h = attn_apply(p["attn"], cfg, _norm1(p, cfg, x), positions,
                   causal=causal)
    return _ffn_residual(p, cfg, x + h)


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
    if "mamba" in p:
        out, st = mamba_apply(p["mamba"], cfg, _norm1(p, cfg, x),
                              return_state=True)
        return x + out, st
    h, kv = attn_prefill(p["attn"], cfg, _norm1(p, cfg, x), positions)
    return _ffn_residual(p, cfg, x + h)[0], kv


def block_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache_l: Any,
                 cache_len: torch.Tensor) -> tuple[torch.Tensor, Any]:
    if "mamba" in p:
        out, st = mamba_decode_step(p["mamba"], cfg, _norm1(p, cfg, x),
                                    cache_l)
        return x + out, st
    h, kv = attn_decode(p["attn"], cfg, _norm1(p, cfg, x), cache_len,
                        cache_l[0], cache_l[1], cache_len)
    return _ffn_residual(p, cfg, x + h)[0], kv


def block_append(p: dict, cfg: ModelConfig, x: torch.Tensor, cache_l: Any,
                 cache_len: torch.Tensor) -> tuple[torch.Tensor, Any]:
    """Chunked-prefill block forward: C tokens appended to a cache entry
    (a mamba block continues from its state)."""
    if "mamba" in p:
        out, st = mamba_apply(p["mamba"], cfg, _norm1(p, cfg, x),
                              init_state=cache_l, return_state=True)
        return x + out, st
    h, kv = attn_append(p["attn"], cfg, _norm1(p, cfg, x), cache_l[0],
                        cache_l[1], cache_len)
    return _ffn_residual(p, cfg, x + h)[0], kv


# the shared attention site's modes: (output, its new cache entry)
def _site_train(p, cfg, y, positions, entry, cache_len):
    return attn_apply(p, cfg, y, positions), None


def _site_prefill(p, cfg, y, positions, entry, cache_len):
    return attn_prefill(p, cfg, y, positions)


def _site_decode(p, cfg, y, positions, entry, cache_len):
    return attn_decode(p, cfg, y, cache_len, entry[0], entry[1], cache_len)


def _site_append(p, cfg, y, positions, entry, cache_len):
    return attn_append(p, cfg, y, entry[0], entry[1], cache_len)


def _shared_site(shared: dict, cfg: ModelConfig, x: torch.Tensor, attn_fn,
                 positions, entry, cache_len):
    """Zamba2's shared attention + MLP at one site -> (x, its KV entry)."""
    h, kv = attn_fn(shared["attn"], cfg, _norm1(shared, cfg, x), positions,
                    entry, cache_len)
    x = x + h
    return x + mlp_apply(shared["mlp"], cfg, rmsnorm_apply(
        shared["ln2"], x, cfg.rms_eps)), kv


# ------------------------------------------------------------- cache trees
def _index(tree: Any, i) -> Any:
    return tree_map(lambda a: a[i], tree)


def _stack(entries: list) -> Any:
    """Per-layer cache entries -> one tree of [L, ...] leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *entries)


def _put(pool: Any, new: Any) -> None:
    """Write a layer's new cache entry into its view of the pool (a
    softmax KV entry already is that view, written in place)."""
    def put(dst, src):
        if src.data_ptr() != dst.data_ptr() or src.shape != dst.shape:
            dst.copy_(src)
        return dst
    tree_map(put, pool, new)


def _pad_kv_layers(layers: Any, max_len: int) -> Any:
    """Pad float KV leaves (seq axis -3) to max_len; mamba states, int32
    leaves (packed spike states, one row per slot whatever the length) and
    empty leaves stay as they are."""
    if isinstance(layers, dict):
        return {k: v if k in ("mamba", "ssm", "conv")
                else _pad_kv_layers(v, max_len) for k, v in layers.items()}
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
    """Decoder-only LM over the block zoo (every family but encdec)."""

    def __init__(self, cfg: ModelConfig):
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
        if cfg.family == "hybrid":
            params["shared_attn"] = shared_attn_init(gen, cfg)
        if cfg.family == "vlm":
            params["vision_proj"] = dense_init(gen, cfg.d_vision, cfg.d_model,
                                               dtype=cfg.param_dtype)
        return _to_device(params, dev)

    # ------------------------------------------------------------ embeddings
    def _embed(self, params: dict, batch: dict):
        """-> (x [B,S,D], positions [B,S]); a vlm batch's ``img_embeds``
        [B, N, Dv] go first (merged and projected), the positions run over
        image and text."""
        cfg = self.cfg
        x = embedding_lookup(params["embed"], batch["tokens"], cfg.dtype)
        if cfg.family == "vlm" and "img_embeds" in batch:
            img = batch["img_embeds"].to(cfg.dtype)
            if cfg.vision_pool_window > 1:
                img = self._patch_merge(img)
            img = dense_apply(params["vision_proj"], img)
            x = torch.cat([img, x], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x, positions

    def _patch_merge(self, img: torch.Tensor) -> torch.Tensor:
        """The W2TTFS patch merge (paper C2 on the vision front end): in
        spiking mode each w x w window is its spike count times the unit
        scale 1 / w^2 (the WTFC datapath); otherwise its mean. img [B, N,
        Dv], N = g * g patches -> [B, (g/w)^2, Dv]."""
        cfg = self.cfg
        b, n, dv = img.shape
        w = cfg.vision_pool_window
        g = int(round(n ** 0.5))
        grid = img.reshape(b, g, g, dv)
        if cfg.spiking:
            cnt = window_counts(maybe_spike(grid, True, cfg.lif), w)
            pooled = cnt.to(img.dtype) / float(w * w)
        else:
            pooled = grid.reshape(b, g // w, w, g // w, w, dv).mean(dim=(2, 4))
        return pooled.reshape(b, (g // w) ** 2, dv)

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return embedding_logits(params["embed"], x)
        return dense_apply(params["head"], x.to(torch.float32))

    def _final(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_apply(params["final_norm"], x, self.cfg.rms_eps)

    def _groups(self, params: dict) -> list:
        """The hybrid stack's groups: each ``attn_every`` consecutive
        blocks."""
        a = self.cfg.attn_every
        blocks = params["blocks"]
        return [blocks[g:g + a] for g in range(0, len(blocks), a)]

    # ----------------------------------------------------------- stack (train)
    def _stack_train(self, params: dict, x: torch.Tensor,
                     positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Every block's ``block_apply`` in turn (checkpointed per
        ``cfg.remat``; a hybrid stack's shared attention site before each
        group), then the final norm. Returns (x, the aux terms summed over
        the layers)."""
        cfg = self.cfg
        body = self._maybe_remat(
            lambda x_, p_l: block_apply(p_l, cfg, x_, positions))
        aux = _zero_aux(x.device)
        groups = (self._groups(params) if cfg.family == "hybrid"
                  else [params["blocks"]])
        for group in groups:
            if cfg.family == "hybrid":
                x = _shared_site(params["shared_attn"], cfg, x, _site_train,
                                 positions, None, None)[0]
            for p_l in group:
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
        """Causal next-token cross-entropy: the mean over the text
        positions t < S - 1 of -log p(token t+1), the logits in f32, plus
        the moe family's aux terms. ``batch["tokens"]`` [B, S] int (and a
        vlm's ``img_embeds``). Returns (loss, {"nll", "loss"} and a moe's
        aux terms)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch)
        x, aux = self._stack_train(params, x, positions)
        tokens = batch["tokens"]
        n_pred = tokens.shape[1] - 1
        logits = self._logits(params, x[:, -n_pred - 1:-1, :])
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        loss = nll.mean()
        metrics = {"nll": loss}
        if cfg.family == "moe":
            loss = (loss + cfg.router_aux_weight * aux["load_balance"]
                    + 1e-3 * aux["router_z"])
            metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, params: dict, batch: dict,
                return_all_logits: bool = False,
                max_len: int = 0) -> tuple[torch.Tensor, dict]:
        """Full-context forward -> (last-position logits [B,V], or all of
        them [B,S,V] with ``return_all_logits``; the cache, its KV padded
        to ``max_len`` rows when that is longer)."""
        cfg = self.cfg
        x, positions = self._embed(params, batch)
        if cfg.family == "hybrid":
            attn, mamba = [], []
            for group in self._groups(params):
                x, kv = _shared_site(params["shared_attn"], cfg, x,
                                     _site_prefill, positions, None, None)
                attn.append(kv)
                states = []
                for p_l in group:
                    x, st = block_prefill(p_l, cfg, x, positions)
                    states.append(st)
                mamba.append(_stack(states))
            layers = {"attn": _stack(attn), "mamba": _stack(mamba)}
        else:
            entries = []
            for p_l in params["blocks"]:
                x, c = block_prefill(p_l, cfg, x, positions)
                entries.append(c)
            layers = _stack(entries)
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
                            _site_decode, all_logits=False)

    # -------------------------------------------------------- chunked prefill
    @torch.no_grad()
    def prefill_chunk(self, params: dict, tokens: torch.Tensor, cache: dict
                      ) -> tuple[torch.Tensor, dict]:
        """Continued prefill: C tokens [B, C] appended to a cache whose
        ``len`` counts the positions already prefilled. Returns all-position
        logits [B, C, V] and the cache with len advanced by C; a prompt fed
        through this in chunks gives a blocking ``prefill``'s logits (for
        ssm and hybrid, chunks on ``ssm_chunk`` bounds)."""
        return self._append(params, tokens, cache, block_append,
                            _site_append, all_logits=True)

    def _append(self, params, tokens, cache, block_fn, site_fn,
                all_logits: bool):
        cfg = self.cfg
        cache_len = cache["len"]
        layers = cache["layers"]
        x = embedding_lookup(params["embed"], tokens, cfg.dtype)
        if cfg.family == "hybrid":
            for g, group in enumerate(self._groups(params)):
                entry = _index(layers["attn"], g)
                x, kv = _shared_site(params["shared_attn"], cfg, x, site_fn,
                                     None, entry, cache_len)
                _put(entry, kv)
                for j, p_l in enumerate(group):
                    entry = _index(layers["mamba"], (g, j))
                    x, st = block_fn(p_l, cfg, x, entry, cache_len)
                    _put(entry, st)
        else:
            for i, p_l in enumerate(params["blocks"]):
                entry = _index(layers, i)
                x, new = block_fn(p_l, cfg, x, entry, cache_len)
                _put(entry, new)
        x = self._final(params, x)
        logits = self._logits(params, x)
        if not all_logits:
            logits = logits[:, 0, :]
        return logits, {"layers": layers, "len": cache_len + tokens.shape[1]}

    # ------------------------------------------------------------ cache spec
    def init_cache(self, batch_size: int, max_len: int,
                   device: DeviceLike = None) -> dict:
        """Zero cache on ``device`` (the card unless told otherwise) in the
        layout the module docstring gives; ``len`` = max_len - 1 (the
        cache is "full": the next token writes the last row)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dh = cfg.resolved_head_dim
        hkv = cfg.n_kv_heads or cfg.n_heads
        kv_dtype = (torch.float8_e4m3fn if cfg.kv_dtype == "f8_e4m3"
                    else cfg.dtype)

        def attn_entry(lead):
            if cfg.attention_kind != "qk_spiking":
                shp = (lead, batch_size, max_len, hkv, dh)
                return (torch.zeros(shp, dtype=kv_dtype, device=dev),
                        torch.zeros(shp, dtype=kv_dtype, device=dev))
            empty = torch.zeros((lead, batch_size, 0, hkv, dh),
                                dtype=kv_dtype, device=dev)
            if cfg.exec_policy.packed:
                # per-slot spike state, bit-packed: one row of masked
                # attention spikes per layer, O(1) in sequence length
                words = torch.zeros((lead, batch_size, 1, 1,
                                     qk_spike_state_width(cfg)),
                                    dtype=torch.int32, device=dev)
                return (words, empty)
            return (empty, empty)

        def mamba_entry(*lead):
            st = mamba_init_state(cfg, batch_size, dtype=cfg.dtype,
                                  device=dev)
            return tree_map(lambda a: a.expand(*lead, *a.shape).clone(), st)

        if cfg.family in ("dense", "moe", "vlm"):
            layers = attn_entry(cfg.n_layers)
        elif cfg.family == "ssm":
            layers = mamba_entry(cfg.n_layers)
        elif cfg.family == "hybrid":
            ng = cfg.n_layers // cfg.attn_every
            layers = {"attn": attn_entry(ng),
                      "mamba": mamba_entry(ng, cfg.attn_every)}
        else:
            raise ValueError(cfg.family)
        return {"layers": layers,
                "len": torch.tensor(max(max_len - 1, 0), dtype=torch.int32,
                                    device=dev)}

    # ------------------------------------------------------------ input spec
    def input_specs(self, shape: ShapeSpec) -> dict:
        """The step's inputs for a shape cell, as tensors on the meta
        device (shapes and dtypes, no storage): the reference gives
        ``jax.ShapeDtypeStruct`` stand-ins."""
        cfg = self.cfg
        b = shape.global_batch
        meta = torch.device("meta")
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": torch.empty(
                (b, self._text_len(shape.seq_len)), dtype=torch.int32,
                device=meta)}
            if cfg.family == "vlm":
                batch["img_embeds"] = torch.empty(
                    (b, cfg.n_img_tokens, cfg.d_vision),
                    dtype=torch.bfloat16, device=meta)
            return {"batch": batch}
        # decode: one new token against a seq_len cache
        return {"tokens": torch.empty((b, 1), dtype=torch.int32, device=meta),
                "cache": self.init_cache(b, shape.seq_len, device=meta)}

    def _text_len(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.family == "vlm":
            n_img = cfg.n_img_tokens
            if cfg.vision_pool_window > 1:
                n_img //= cfg.vision_pool_window ** 2
            return seq_len - n_img
        return seq_len


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
           "block_decode", "block_append", "shared_attn_init",
           "param_device", "spike_totals"]
