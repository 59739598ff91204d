"""Fixed-point and fp8 quantization and BN folding (twin of
``repro.core.quant``): the F&Q stage that builds the served artifact, and
the straight-through fake-quant the KD-QAT stage trains with.

The folds keep ``gamma / sqrt(var + eps)`` as the reference writes it (not
``rsqrt``), with the square root correctly rounded, so folded weights match
the JAX package bit for bit. ``torch.sqrt`` on f32 is not correctly rounded
on every build (torch 2.13's CPU kernel misses the last bit on about a fifth
of inputs in [0.5, 1.5]), while ``jnp.sqrt`` is; one ulp in ``inv_std`` can
tip a weight across a rounding tie of ``quantize_fixed``. The root is taken
in f64 and rounded to f32, which is exact: the f64 square root of an f32
value, rounded to f32, is the correctly rounded f32 square root.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    enabled: bool = False
    mode: str = "int"          # "int" | "fp8_e4m3" | "fp8_e5m2"
    bits: int = 8              # for "int" mode
    per_channel: bool = True   # per-output-channel scale on weights
    quantize_activations: bool = False
    act_bits: int = 8


def _ste(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward ``xq``, backward identity. The
    value is ``x + (xq - x)``, which can differ from ``xq`` in the last
    bit, exactly as the reference's form does."""
    return x + (xq - x).detach()


def quantize_fixed(x: torch.Tensor, bits: int = 8,
                   axis: Optional[int] = None) -> torch.Tensor:
    """Symmetric fixed-point fake-quant with a straight-through gradient.
    ``axis`` = per-channel scale axis."""
    qmax = 2.0 ** (bits - 1) - 1.0
    if axis is None:
        amax = x.abs().max()
    else:
        dims = tuple(i for i in range(x.ndim) if i != axis)
        amax = x.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return _ste(x, q * scale)


# fp8 variant -> the torch dtype a value is rounded through
FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
# e4m3fn has no infinity: the reference's cast gives NaN for a magnitude
# that rounds past the largest finite value, 448 (above 464, the tie, which
# rounds to even, 448), where torch's cast saturates to 448
E4M3_OVERFLOW = 464.0


def quantize_fp8(x: torch.Tensor, variant: str = "e4m3") -> torch.Tensor:
    """fp8 fake-quant with a straight-through gradient: x rounded to the
    nearest e4m3 (or e5m2) value and back; an e4m3 overflow is NaN, as in
    the reference."""
    if variant not in FP8_DTYPES:
        raise ValueError(f"unknown fp8 variant {variant!r}")
    xq = x.to(FP8_DTYPES[variant]).to(x.dtype)
    if variant == "e4m3":
        xq = torch.where(x.abs() > E4M3_OVERFLOW,
                         torch.full_like(xq, float("nan")), xq)
    return _ste(x, xq)


def fake_quant(x: torch.Tensor, cfg: QuantConfig, *,
               is_weight: bool = True) -> torch.Tensor:
    """The configured fake-quant (a no-op when disabled): symmetric fixed
    point for ``"int"``, a round trip through fp8 for ``"fp8_e4m3"`` and
    ``"fp8_e5m2"``."""
    if not cfg.enabled:
        return x
    if not is_weight and not cfg.quantize_activations:
        return x
    if cfg.mode == "int":
        bits = cfg.bits if is_weight else cfg.act_bits
        axis = 0 if (is_weight and cfg.per_channel and x.ndim >= 2) else None
        return quantize_fixed(x, bits, axis)
    if cfg.mode.startswith("fp8"):
        return quantize_fp8(x, cfg.mode.split("_")[1])
    raise ValueError(f"unknown quant mode {cfg.mode!r}")


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in ``x``'s dtype (via f64)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def fuse_bn_into_conv(w: torch.Tensor, b: Optional[torch.Tensor],
                      bn_gamma: torch.Tensor, bn_beta: torch.Tensor,
                      bn_mean: torch.Tensor, bn_var: torch.Tensor,
                      eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold BN statistics into an HWIO conv weight (output channels last)."""
    inv_std = bn_gamma / _sqrt_rn(bn_var + eps)
    w_fused = w * inv_std
    b0 = b if b is not None else torch.zeros_like(bn_mean)
    b_fused = (b0 - bn_mean) * inv_std + bn_beta
    return w_fused, b_fused


def fuse_bn_into_linear(w: torch.Tensor, b: Optional[torch.Tensor],
                        bn_gamma: torch.Tensor, bn_beta: torch.Tensor,
                        bn_mean: torch.Tensor, bn_var: torch.Tensor,
                        eps: float = 1e-5
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a BN that follows a linear layer: y = gamma*(xW+b-mean)/std +
    beta."""
    inv_std = bn_gamma / _sqrt_rn(bn_var + eps)
    w_fused = w * inv_std[None, :]
    b0 = b if b is not None else torch.zeros_like(bn_mean)
    b_fused = (b0 - bn_mean) * inv_std + bn_beta
    return w_fused, b_fused


def quantize_tree(params, cfg: QuantConfig):
    """Fake-quant every floating tensor of a nested dict / list of
    parameters (the QAT forward); other leaves pass through."""
    if not cfg.enabled:
        return params
    if isinstance(params, dict):
        return {k: quantize_tree(v, cfg) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_tree(v, cfg) for v in params)
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return fake_quant(params, cfg, is_weight=True)
    return params
