"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-style GQA. [arXiv:2403.04652; hf]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=1e4,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
    remat="dots",
)
