"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend (STUB: precomputed patch
embeddings via input_specs). [hf:microsoft/Phi-3-vision-128k-instruct; hf]

The vision patch merge (2x2) is the paper-C2 hook: in spiking mode the patch
embeddings pool by spike-count (W2TTFS / WTFC datapath) instead of averaging.
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=1e4,
    tie_embeddings=False,
    n_img_tokens=1024,          # raw CLIP patches (32x32 grid)
    d_vision=1024,              # CLIP-L hidden size
    vision_pool_window=2,       # 2x2 merge -> 256 image tokens (C2 stage)
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    remat="dots",
)
