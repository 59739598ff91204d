"""mamba2-130m [ssm] — 24L d_model=768 (attn-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,            # d_inner = 1536 -> 24 heads of 64
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=128,
    ssm_ngroups=1,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    remat="full",
)
