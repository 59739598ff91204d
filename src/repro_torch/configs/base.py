"""Config schema for the model zoo (twin of ``repro.configs.base``).

Every architecture is a ``ModelConfig``; the paper's SNN features (spiking
mode, QK attention, quantization) are flags on the same config, so any
arch can run as an ANN baseline or a spiking variant. ``policy`` says how
the ``qk_spiking`` path executes (``repro_torch.ops.ExecutionPolicy`` or a
preset name): ``"reference"`` (the None default) is plain PyTorch,
``"fused_dense"`` routes the LIF projections and the binary-activation
matmul through the fused PE and spike-matmul kernels, ``"fused_packed"``
also ships every spike map bit-packed and caches the per-slot spike state
packed. The deprecated flag pair of the reference (``use_event_kernels``,
``spike_format``) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core.lif import LIFConfig
from ..core.quant import QuantConfig
from ..ops.policy import REFERENCE, ExecutionPolicy, as_policy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0        # llama4-style always-on shared expert
    moe_group_size: int = 512        # GShard dispatch group (tokens)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # --- hybrid (zamba2) ---
    attn_every: int = 0              # shared attention applied every k layers
    # --- enc-dec (seamless-m4t) ---
    n_enc_layers: int = 0
    d_src: int = 0                   # precomputed frontend embedding dim
    # --- vlm (phi-3-vision) ---
    n_img_tokens: int = 0
    d_vision: int = 0
    vision_pool_window: int = 0      # >0: W2TTFS patch pooling (C2) applies
    # --- paper technique flags ---
    spiking: bool = False            # LIF activations (C3), KD-student mode
    attention_kind: str = "softmax"  # softmax | qk_spiking (C4)
    policy: Optional[Any] = None     # ExecutionPolicy | preset name | None
    lif: LIFConfig = LIFConfig()
    quant: QuantConfig = QuantConfig()
    # --- numerics ---
    dtype: Any = torch.bfloat16      # activation/compute dtype
    param_dtype: Any = torch.float32
    remat: str = "none"              # none | full | dots
    attn_q_block: int = 1024
    attn_kv_block: int = 1024
    flash_threshold: int = 8192      # chunked attention above this seq len
    kv_dtype: str = ""               # "" = activation dtype, or "f8_e4m3"
    # shard the decode KV cache's sequence axis over this mesh axis (the
    # reference's context-parallel decode); still to port: "" only
    decode_cp_axis: str = ""

    def __post_init__(self):
        if self.policy is not None:
            # presets normalised, so configs compare (and key caches) alike
            object.__setattr__(self, "policy", as_policy(self.policy))

    @property
    def exec_policy(self) -> ExecutionPolicy:
        """The resolved ExecutionPolicy (default ``"reference"``)."""
        return self.policy if self.policy is not None else REFERENCE

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def prefill_chunk_align(self) -> int:
        """Chunked-prefill granularity that keeps chunked prefill equal to
        a blocking one: any chunk for attention, ``ssm_chunk`` bounds for
        the SSD scan of ssm / hybrid families."""
        return self.ssm_chunk if self.family in ("ssm", "hybrid") else 1
