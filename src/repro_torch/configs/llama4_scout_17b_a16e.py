"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                  # shared-expert / dense width
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    moe_d_ff=8192,
    n_shared_experts=1,
    capacity_factor=1.25,
    rope_theta=5e5,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
    remat="dots",
)
