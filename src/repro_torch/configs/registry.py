"""Architecture registry (twin of ``repro.configs.registry``):
``get_config(id)`` returns the published ModelConfig, ``reduced(cfg)`` the
family-preserving miniature the CPU tests use, ``build_model(cfg)`` the
model. The port builds the ``dense`` family's decoder-only ``LM``; the
other families raise, naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses

import torch

from . import (llama4_scout_17b_a16e, mamba2_130m, olmoe_1b_7b,
               phi3_vision_4_2b, qwen1_5_32b, qwen2_5_3b, qwen3_1_7b,
               seamless_m4t_large_v2, yi_9b, zamba2_7b)
from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        qwen1_5_32b.CONFIG,
        qwen3_1_7b.CONFIG,
        qwen2_5_3b.CONFIG,
        yi_9b.CONFIG,
        mamba2_130m.CONFIG,
        phi3_vision_4_2b.CONFIG,
        llama4_scout_17b_a16e.CONFIG,
        olmoe_1b_7b.CONFIG,
        zamba2_7b.CONFIG,
        seamless_m4t_large_v2.CONFIG,
    ]
}

PORTED_FAMILIES = ("dense",)


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def build_model(cfg: ModelConfig):
    """cfg -> the model (``init``, ``prefill``, ``prefill_chunk``,
    ``decode_step``, ``init_cache``)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is still to port "
            f"(ROADMAP queue 1 item 4); the port builds {PORTED_FAMILIES}")
    from ..models.lm import LM
    return LM(cfg)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving miniature for CPU tests (the reference's sizes)."""
    small = dict(
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        dtype=torch.float32,
        param_dtype=torch.float32,
        remat="none",
        attn_q_block=64,
        attn_kv_block=64,
    )
    if cfg.n_heads:
        ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))  # GQA kept
        small["n_heads"] = 4
        small["n_kv_heads"] = max(1, 4 // ratio)
    if cfg.family == "moe":
        small.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=64,
                     n_shared_experts=cfg.n_shared_experts)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16, ssm_conv=4)
    if cfg.family == "hybrid":
        small.update(attn_every=2)
    if cfg.family == "vlm":
        small.update(n_img_tokens=16, d_vision=32, vision_pool_window=2)
    if cfg.family == "encdec":
        small.update(n_enc_layers=2, d_src=32)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
