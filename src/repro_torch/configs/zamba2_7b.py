"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + weight-SHARED attention blocks.
[arXiv:2411.15242]

Adaptation note (DESIGN §Arch-applicability): real Zamba2 alternates two
shared blocks roughly every 6 mamba layers; we deploy ONE shared block every
``attn_every=9`` layers so the 81-layer stack divides into 9 homogeneous
scan groups (9 shared-attention sites) — same parameter-sharing idea, scan-
friendly structure.
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,                 # shared attention block's MLP width
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,               # d_inner = 7168 -> 112 heads of 64
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=128,
    ssm_ngroups=1,
    attn_every=9,
    rope_theta=1e4,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
    remat="full",
)
