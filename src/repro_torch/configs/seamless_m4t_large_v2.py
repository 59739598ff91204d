"""seamless-m4t-large-v2 [audio] — 24L enc + 24L dec, d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206 — enc-dec, multimodal. [arXiv:2308.11596; hf]

Frontend STUB per the brief: input_specs supplies precomputed audio-frame
embeddings [B, S, d_src]. The window-2 frame downsampling stage is the
paper-C2 hook (spike-count pooling in spiking mode).
"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,                # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    d_src=1024,
    vision_pool_window=2,       # frame downsampling (C2 stage)
    rope_theta=1e4,
    tie_embeddings=False,
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    remat="dots",
)
