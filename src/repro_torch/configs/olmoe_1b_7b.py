"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (kv=16) d_ff=1024 (per expert)
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    n_shared_experts=0,
    capacity_factor=1.25,
    rope_theta=1e4,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    remat="none",
)
