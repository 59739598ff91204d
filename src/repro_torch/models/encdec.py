"""Encoder-decoder backbone (twin of ``repro.models.encdec``; the
seamless-m4t-large-v2 cell).

The modality front end is a stub, as in the reference: the caller gives
precomputed audio-frame embeddings ``src_embeds`` [B, S_src, d_src]; the
model owns the frame pooling, ``src_proj`` into d_model, a bidirectional
encoder stack, and a causal decoder with cross-attention onto the encoder
output in every layer.

The front end pools windows of ``vision_pool_window`` frames: by spike
count times the unit scale in spiking mode (the paper's W2TTFS stage, C2),
by their mean otherwise. Decode keeps a self-attention KV cache and the
cross-attention K/V, projected once from the encoder output at prefill.
Under ``attention_kind="qk_spiking"`` the token attention reads no
external K/V, so the decoder does not see the encoder (the reference's
order; ROADMAP queue 3 records it as a property of the reference).

The cache: ``{"layers": {"self": (k, v), "cross": (ck, cv)}, "len"}``,
each [L, B, S, Hkv, Dh]. The serving engine does not serve this family
(its ``init_cache`` needs the source length and it has no
``prefill_chunk``): it is driven directly.
"""
from __future__ import annotations

from typing import Any

import torch

from .. import DeviceLike, resolve_device
from ..configs.base import ModelConfig, ShapeSpec
from .attention import attn_apply, attn_decode, attn_init, attn_prefill
from .ffn import mlp_apply, mlp_init
from .layers import (dense_apply, dense_init, embedding_init,
                     embedding_lookup, maybe_spike, rmsnorm_apply,
                     rmsnorm_init)
from .lm import _index, _pad_kv_layers, _put, _stack, _to_device


def enc_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {"ln1": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
            "attn": attn_init(gen, cfg),
            "ln2": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
            "mlp": mlp_init(gen, cfg)}


def dec_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {"ln1": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
            "attn": attn_init(gen, cfg),
            "ln_cross": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
            "cross": attn_init(gen, cfg),
            "ln2": rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
            "mlp": mlp_init(gen, cfg)}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device: DeviceLike = None) -> dict:
        """Random parameters drawn from ``gen`` on its device, then moved
        to ``device`` (the card unless told otherwise)."""
        cfg = self.cfg
        dev = resolve_device(device)
        n_enc = cfg.n_enc_layers or cfg.n_layers
        params = {
            "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                    cfg.param_dtype),
            "src_proj": dense_init(gen, cfg.d_src or cfg.d_model,
                                   cfg.d_model, dtype=cfg.param_dtype),
            "enc_blocks": [enc_block_init(gen, cfg) for _ in range(n_enc)],
            "enc_norm": rmsnorm_init(cfg.d_model, cfg.param_dtype,
                                     gen.device),
            "dec_blocks": [dec_block_init(gen, cfg)
                           for _ in range(cfg.n_layers)],
            "final_norm": rmsnorm_init(cfg.d_model, cfg.param_dtype,
                                       gen.device),
            "head": dense_init(gen, cfg.d_model, cfg.vocab_size,
                               dtype=cfg.param_dtype),
        }
        return _to_device(params, dev)

    def _norm(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_apply(p, x, self.cfg.rms_eps)

    # --------------------------------------------------------------- encoder
    def _frontend(self, params: dict, src: torch.Tensor) -> torch.Tensor:
        """Frame pooling (spike counts in spiking mode), then the
        projection into d_model."""
        cfg = self.cfg
        x = src.to(cfg.dtype)
        w = cfg.vision_pool_window          # reused as the frame-pool window
        if w > 1:
            b, s, d = x.shape
            if cfg.spiking:
                spikes = maybe_spike(x.reshape(b, s // w, w, d), True,
                                     cfg.lif)
                x = (spikes.sum(dim=2) / float(w)).to(x.dtype)
            else:
                x = x.reshape(b, s // w, w, d).mean(dim=2)
        return dense_apply(params["src_proj"], x)

    def encode(self, params: dict, src_embeds: torch.Tensor) -> torch.Tensor:
        """Source frames [B, S_src, d_src] -> encoder states [B, S, D]
        (non-causal self-attention)."""
        cfg = self.cfg
        x = self._frontend(params, src_embeds)
        positions = _positions(x.shape[0], x.shape[1], x.device)
        for p_l in params["enc_blocks"]:
            x = x + attn_apply(p_l["attn"], cfg, self._norm(p_l["ln1"], x),
                               positions, causal=False)
            x = x + mlp_apply(p_l["mlp"], cfg, self._norm(p_l["ln2"], x))
        return self._norm(params["enc_norm"], x)

    # --------------------------------------------------------------- decoder
    def _cross_kv(self, p_l: dict, enc_out: torch.Tensor) -> tuple:
        """The encoder states projected by a layer's cross wk and wv
        [B, Sk, Hkv, Dh] (no RoPE on them)."""
        cfg = self.cfg
        hkv = cfg.n_kv_heads or cfg.n_heads
        dh = cfg.resolved_head_dim
        b, sk, _ = enc_out.shape
        return (dense_apply(p_l["cross"]["wk"], enc_out).reshape(b, sk, hkv,
                                                                  dh),
                dense_apply(p_l["cross"]["wv"], enc_out).reshape(b, sk, hkv,
                                                                 dh))

    def _cross_mlp(self, p_l: dict, x: torch.Tensor, positions, ckv) -> Any:
        """Cross-attention onto ``ckv`` and the MLP, each added to x."""
        cfg = self.cfg
        x = x + attn_apply(p_l["cross"], cfg, self._norm(p_l["ln_cross"], x),
                           positions, causal=False, kv_override=ckv)
        return x + mlp_apply(p_l["mlp"], cfg, self._norm(p_l["ln2"], x))

    def _dec_block(self, p_l: dict, x: torch.Tensor, positions,
                   enc_out: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x + attn_apply(p_l["attn"], cfg, self._norm(p_l["ln1"], x),
                           positions, causal=True)
        return self._cross_mlp(p_l, x, positions,
                               self._cross_kv(p_l, enc_out))

    def decode_train(self, params: dict, tgt_tokens: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = embedding_lookup(params["embed"], tgt_tokens, cfg.dtype)
        positions = _positions(x.shape[0], x.shape[1], x.device)
        for p_l in params["dec_blocks"]:
            x = self._dec_block(p_l, x, positions, enc_out)
        return self._norm(params["final_norm"], x)

    # ------------------------------------------------------------------ loss
    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy of ``batch["tgt_tokens"]`` [B, S] given
        ``batch["src_embeds"]``. Returns (loss, {"loss", "nll"})."""
        enc_out = self.encode(params, batch["src_embeds"])
        tgt = batch["tgt_tokens"]
        x = self.decode_train(params, tgt[:, :-1], enc_out)
        logits = dense_apply(params["head"], x.to(torch.float32))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, tgt[:, 1:, None].long())[..., 0]
        loss = nll.mean()
        return loss, {"loss": loss, "nll": loss}

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params: dict, batch: dict,
                return_all_logits: bool = False,
                max_len: int = 0) -> tuple[torch.Tensor, dict]:
        """Encode the source and run the decoder over the target prefix ->
        (logits, a cache of self KV and cross K/V per decoder layer).
        ``max_len`` pads the self cache with decode headroom (the cross
        cache keeps the source length)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["src_embeds"])
        tgt = batch["tgt_tokens"]
        x = embedding_lookup(params["embed"], tgt, cfg.dtype)
        b, s, _ = x.shape
        positions = _positions(b, s, x.device)
        entries = []
        for p_l in params["dec_blocks"]:
            h, kv = attn_prefill(p_l["attn"], cfg,
                                 self._norm(p_l["ln1"], x), positions)
            ckv = self._cross_kv(p_l, enc_out)
            x = self._cross_mlp(p_l, x + h, positions, ckv)
            entries.append({"self": kv, "cross": ckv})
        layers = _stack(entries)
        x = self._norm(params["final_norm"], x)
        if return_all_logits:
            logits = dense_apply(params["head"], x.to(torch.float32))
        else:
            logits = dense_apply(params["head"],
                                 x[:, -1:, :].to(torch.float32))[:, 0, :]
        if max_len and max_len > s:
            layers["self"] = _pad_kv_layers(layers["self"], max_len)
        return logits, {"layers": layers,
                        "len": torch.tensor(s, dtype=torch.int32,
                                            device=x.device)}

    @torch.no_grad()
    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        """One target token [B, 1] against the cache (a scalar ``len``):
        the self KV row is written into the cache in place."""
        cfg = self.cfg
        cache_len = cache["len"]
        layers = cache["layers"]
        x = embedding_lookup(params["embed"], tokens, cfg.dtype)
        b = x.shape[0]
        positions = torch.as_tensor(cache_len, device=x.device).reshape(
            1, 1).expand(b, 1)
        for i, p_l in enumerate(params["dec_blocks"]):
            entry = _index(layers["self"], i)
            h, kv = attn_decode(p_l["attn"], cfg, self._norm(p_l["ln1"], x),
                                cache_len, entry[0], entry[1], cache_len)
            _put(entry, kv)
            x = self._cross_mlp(p_l, x + h, positions,
                                _index(layers["cross"], i))
        x = self._norm(params["final_norm"], x)
        logits = dense_apply(params["head"], x.to(torch.float32))[:, 0, :]
        return logits, {"layers": layers, "len": cache_len + 1}

    # ----------------------------------------------------------- cache/specs
    def init_cache(self, batch_size: int, max_len: int, src_len: int,
                   device: DeviceLike = None) -> dict:
        """Zero cache on ``device`` (the card unless told otherwise): self
        KV of ``max_len`` rows, cross K/V of ``src_len``."""
        cfg = self.cfg
        dev = resolve_device(device)
        hkv = cfg.n_kv_heads or cfg.n_heads
        dh = cfg.resolved_head_dim

        def kv(s):
            shp = (cfg.n_layers, batch_size, s, hkv, dh)
            return (torch.zeros(shp, dtype=cfg.dtype, device=dev),
                    torch.zeros(shp, dtype=cfg.dtype, device=dev))

        return {"layers": {"self": kv(max_len), "cross": kv(src_len)},
                "len": torch.tensor(max(max_len - 1, 0), dtype=torch.int32,
                                    device=dev)}

    def input_specs(self, shape: ShapeSpec) -> dict:
        """The step's inputs for a shape cell, as meta-device tensors (the
        reference gives ``jax.ShapeDtypeStruct`` stand-ins)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = torch.device("meta")
        d_src = cfg.d_src or cfg.d_model
        if shape.kind in ("train", "prefill"):
            return {"batch": {
                "src_embeds": torch.empty((b, s, d_src), dtype=torch.bfloat16,
                                          device=meta),
                "tgt_tokens": torch.empty((b, s), dtype=torch.int32,
                                          device=meta)}}
        w = cfg.vision_pool_window
        src_len = s // w if w > 1 else s
        return {"tokens": torch.empty((b, 1), dtype=torch.int32, device=meta),
                "cache": self.init_cache(b, s, src_len, device=meta)}
