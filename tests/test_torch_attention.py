"""The port's softmax attention on the CPU against the JAX package: RoPE and
the causal mask, the attention layer's full, chunked, append and decode
paths (with qk_norm, QKV bias and grouped KV), and ``ops.attention``,
whose fused mode is the flash kernel's wrapper (on CPU tensors its plain
version) against JAX's Pallas kernel in interpret mode and its reference;
the bf16 wgmma route's arithmetic on the CPU: its exact three-term split
of the weights p (``split_bf16x3``), and a plain emulation of its order
(scores scaled after QK^T, 128-row by 128-key tiles, PV as three bf16
terms) against JAX's kernel in interpret mode.

Inputs are numpy arrays made from a seed, handed to both frameworks.
Tolerances: RoPE and the mask at rtol 1e-6, atol 1e-6 (f32 angles; the
frameworks' sin and cos may differ in the last bit); the attention paths
in f32 at rtol 1e-5, atol 1e-5 (f32 sums in another order); bf16 at 2e-2,
as JAX's own ``tests/test_flash_attention.py``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch import convert, ops
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build
from hypothesis import given
from hypothesis import strategies as st
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_ref,
                                                 pick_route, split_bf16x3)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

RTOL = ATOL = 1e-5


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ----------------------------------------------------------- RoPE and mask
@pytest.mark.parametrize("dh,theta", [(16, 1e6), (128, 1e6), (64, 1e4)])
def test_rope_freqs_match_jax(dh, theta):
    got = tlayers.rope_freqs(dh, theta)
    assert got.dtype == torch.float32 and got.shape == (dh // 2,)
    _close(got, jlayers.rope_freqs(dh, theta), 1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos_rank", [1, 2])
@pytest.mark.parametrize("dh,theta", [(16, 1e6), (128, 1e4)])
def test_apply_rope_matches_jax(dh, theta, pos_rank, dtype):
    rng = np.random.default_rng(dh + pos_rank)
    x = rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 9) if pos_rank == 2 else (9,))
    pos = pos.astype(np.int32)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    want = jlayers.apply_rope(jnp.asarray(x).astype(jd), jnp.asarray(pos),
                              theta)
    got = tlayers.apply_rope(torch.tensor(x).to(td), torch.tensor(pos), theta)
    assert got.dtype == td and got.shape == x.shape
    # the rotation runs in x's dtype: at bf16 an ulp of a bf16 value
    _close(got, want, 1e-6 if dtype == "f32" else 1e-2)


@pytest.mark.parametrize("sq,sk,off", [(5, 5, 0), (4, 9, 5), (7, 3, 0),
                                       (1, 16, 15)])
def test_causal_mask_matches_jax(sq, sk, off):
    got = tlayers.causal_mask(sq, sk, off)
    want = np.asarray(jlayers.causal_mask(sq, sk, off))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_soft_cap_matches_jax():
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32) * 40
    _close(tlayers.soft_cap(torch.tensor(x), 30.0),
           jlayers.soft_cap(jnp.asarray(x), 30.0), 1e-6)


# ------------------------------------------------ full and chunked helpers
def _qkv(seed, b, s, h, hkv, d, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or s
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,sq,sk,off", [(4, 4, 12, 12, 0),
                                             (4, 2, 12, 12, 0),
                                             (4, 1, 5, 13, 8)])
def test_attn_full_matches_jax(h, hkv, sq, sk, off, causal):
    q, k, v = _qkv(1, 2, sq, h, hkv, 16, sk)
    want = jattn._attn_full(jnp.asarray(q),
                            jattn._expand_kv(jnp.asarray(k), h),
                            jattn._expand_kv(jnp.asarray(v), h), 0.25,
                            causal, off)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    grouped = tattn._attn_full(tq, tk, tv, 0.25, causal, off)
    expanded = tattn._attn_full(tq, tk.repeat_interleave(h // hkv, dim=2),
                                tv.repeat_interleave(h // hkv, dim=2), 0.25,
                                causal, off)
    assert grouped.shape == (2, sq, h, 16)
    _close(grouped, want)
    _close(expanded, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,qb,kb", [(4, 2, 8, 16), (4, 4, 16, 8),
                                         (4, 1, 32, 32)])
def test_attn_chunked_matches_jax(h, hkv, qb, kb, causal):
    q, k, v = _qkv(2, 2, 32, h, hkv, 16)
    want = jattn._attn_chunked(jnp.asarray(q),
                               jattn._expand_kv(jnp.asarray(k), h),
                               jattn._expand_kv(jnp.asarray(v), h), 0.25,
                               causal, qb, kb)
    got = tattn._attn_chunked(*map(torch.tensor, (q, k, v)), 0.25, causal,
                              qb, kb)
    _close(got, want)


def test_attn_chunked_raises_on_ragged_blocks():
    q, k, v = map(torch.tensor, _qkv(3, 1, 20, 2, 2, 8))
    with pytest.raises(ValueError, match="block-divisible"):
        tattn._attn_chunked(q, k, v, 0.25, True, 8, 8)


# ------------------------------------------------------- the attention layer
ARCHS = ["qwen3-1.7b", "qwen2.5-3b"]      # qk_norm; QKV bias


def _layer(arch, **over):
    """(JAX cfg, JAX layer params, port cfg, port layer params): layer 0
    of the reduced softmax config's attention, JAX's init carried across
    (with a nonzero QKV bias, so the bias is exercised)."""
    jcfg = jreduced(jget(arch), **over)
    tcfg = reduced(get_config(arch), **over)
    jp = jattn.attn_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    for name in ("wq", "wk", "wv"):
        if "b" in jp[name]:
            jp[name]["b"] = (0.1 * rng.standard_normal(
                jp[name]["b"].shape)).astype(np.float32)
    tp = convert.variables_from_jax(jp, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("threshold", [8192, 4])
def test_attn_apply_and_prefill_match_jax(arch, threshold):
    """Full attention, and the chunked path with ``flash_threshold``
    lowered so that both packages take it (16 tokens, 8-row blocks)."""
    jcfg, jp, tcfg, tp = _layer(arch, flash_threshold=threshold,
                                attn_q_block=8, attn_kv_block=8)
    if arch == "qwen2.5-3b":
        assert "b" in tp["wq"] and "q_norm" not in tp
    else:
        assert "q_norm" in tp and "b" not in tp["wq"]
    x = np.random.default_rng(5).standard_normal((2, 16, 64)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    for causal in (True, False):
        want = jattn.attn_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                causal=causal)
        got = tattn.attn_apply(tp, tcfg, torch.tensor(x), torch.tensor(pos),
                               causal=causal)
        _close(got, want)
    want, (jk, jv) = jattn.attn_prefill(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(pos))
    got, (tk, tv) = tattn.attn_prefill(tp, tcfg, torch.tensor(x),
                                       torch.tensor(pos))
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)
    assert tk.shape == (2, 16, tcfg.n_kv_heads, 16)


def _cache(seed, b, s, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("vector", [False, True])
def test_attn_append_matches_jax(arch, vector):
    jcfg, jp, tcfg, tp = _layer(arch)
    hkv = tcfg.n_kv_heads
    ck, cv = _cache(6, 2, 16, hkv, 16)
    x = np.random.default_rng(7).standard_normal((2, 4, 64)).astype(
        np.float32)
    cl = np.array([3, 9], np.int32) if vector else np.array(5, np.int32)
    want, (jk, jv) = jattn.attn_append(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.asarray(cl))
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    got, (k2, v2) = tattn.attn_append(tp, tcfg, torch.tensor(x), tk, tv,
                                      torch.tensor(cl))
    _close(got, want)
    _close(k2, jk)
    _close(v2, jv)
    assert k2 is tk and v2 is tv              # written in place


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("vector", [False, True])
def test_attn_decode_matches_jax(arch, vector):
    jcfg, jp, tcfg, tp = _layer(arch)
    hkv = tcfg.n_kv_heads
    ck, cv = _cache(8, 3, 12, hkv, 16)
    x = np.random.default_rng(9).standard_normal((3, 1, 64)).astype(
        np.float32)
    cl = np.array([0, 5, 11], np.int32) if vector else np.array(7, np.int32)
    want, (jk, jv) = jattn.attn_decode(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(cl), jnp.asarray(ck),
                                       jnp.asarray(cv), jnp.asarray(cl))
    got, (tk, tv) = tattn.attn_decode(tp, tcfg, torch.tensor(x),
                                      torch.tensor(cl), torch.tensor(ck),
                                      torch.tensor(cv), torch.tensor(cl))
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)


def test_masked_cache_rows_give_finite_weights():
    """Rows past a slot's length hold garbage (here huge values) and get
    exactly zero weight: the output equals a decode over the valid prefix
    alone, and a slot of length 0 attends its own new row only."""
    _, _, tcfg, tp = _layer("qwen3-1.7b")
    ck, cv = map(torch.tensor, _cache(10, 2, 8, tcfg.n_kv_heads, 16))
    x = torch.tensor(np.random.default_rng(11).standard_normal(
        (2, 1, 64)).astype(np.float32))
    lens = torch.tensor([0, 3])
    junk_k, junk_v = ck.clone(), cv.clone()
    junk_k[:, 4:] = 1e20
    junk_v[:, 4:] = 1e20
    out, _ = tattn.attn_decode(tp, tcfg, x, lens, junk_k, junk_v, lens)
    clean, _ = tattn.attn_decode(tp, tcfg, x, lens, ck[:, :4].clone(),
                                 cv[:, :4].clone(), lens)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, clean, rtol=1e-6, atol=1e-6)


def test_f8_cache_writes_keep_the_bits():
    """An f8 cache takes the new rows rounded to f8 (through a uint8 view
    of its bytes), and attention reads them widened to the compute dtype."""
    _, _, tcfg, tp = _layer("qwen3-1.7b")
    hkv = tcfg.n_kv_heads
    f8 = torch.float8_e4m3fn
    ck = torch.zeros((1, 8, hkv, 16), dtype=f8)
    cv = torch.zeros((1, 8, hkv, 16), dtype=f8)
    x = torch.tensor(np.random.default_rng(12).standard_normal(
        (1, 3, 64)).astype(np.float32))
    _, (k, v) = tattn.attn_append(tp, tcfg, x, ck, cv, torch.tensor(2))
    _, (k32, _) = tattn.attn_append(tp, tcfg, x, torch.zeros(
        (1, 8, hkv, 16)), torch.zeros((1, 8, hkv, 16)), torch.tensor(2))
    assert k.dtype == f8 and k is ck and v is cv
    assert torch.equal(k.view(torch.uint8), k32.to(f8).view(torch.uint8))
    assert int(k[:, :2].view(torch.uint8).ne(0).sum()) == 0


def test_unported_options_raise():
    """The context-parallel decode still raises. Attention over external
    K/V (``kv_override``, the encdec family's cross-attention), which
    raised until the other families were ported, now runs and gives JAX's
    result: q projected, normed and rotated, k and v as given."""
    jcfg, jp, tcfg, tp = _layer("qwen3-1.7b")
    rng = np.random.default_rng(7)
    xa = rng.standard_normal((2, 3, 64)).astype(np.float32)
    kv = [rng.standard_normal((2, 5, tcfg.n_kv_heads, 16)).astype(np.float32)
          for _ in range(2)]
    pa = np.tile(np.arange(3, dtype=np.int32), (2, 1))
    got = tattn.attn_apply(tp, tcfg, torch.tensor(xa), torch.tensor(pa),
                           causal=False,
                           kv_override=tuple(torch.tensor(a) for a in kv))
    want = jattn.attn_apply(jp, jcfg, jnp.asarray(xa), jnp.asarray(pa),
                            causal=False,
                            kv_override=tuple(jnp.asarray(a) for a in kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    x = torch.zeros((1, 2, 64))
    cp = dataclasses.replace(tcfg, decode_cp_axis="data")
    c = torch.zeros((1, 4, tcfg.n_kv_heads, 16))
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tattn.attn_decode(tp, cp, x[:, :1], torch.tensor(1), c, c,
                          torch.tensor(1))


# ---------------------------------------------------------- ops.attention
# (s, h, hkv, d, block, causal): GQA 2:1 and 4:1, causal and full, a
# ragged causal S (300 with 128-blocks pads to 384 in the reference; a
# ragged full one raises, test_ops_attention_refuses_ragged_full), a
# sequence shorter than a block
OPS_CASES = [(64, 4, 4, 32, 32, True), (64, 4, 4, 32, 32, False),
             (96, 4, 2, 16, 32, True), (96, 4, 2, 16, 32, False),
             (300, 4, 1, 32, 128, True), (40, 2, 2, 64, 64, True),
             (40, 2, 2, 64, 64, False)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,h,hkv,d,blk,causal", OPS_CASES)
def test_ops_attention_matches_jax(s, h, hkv, d, blk, causal, dtype):
    q, k, v = _qkv(s + d, 1, s, h, hkv, d)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    tq, tk, tv = (torch.tensor(a).to(td) for a in (q, k, v))
    tol = 2e-2 if dtype == "bf16" else RTOL
    _build.reset_launches()
    fused = ops.attention(tq, tk, tv, causal=causal, q_block=blk,
                          kv_block=blk, policy="fused_dense")
    ref = ops.attention(tq, tk, tv, causal=causal, policy="reference")
    assert _build.LAUNCHES["flash_attention"] == 0     # CPU: plain version
    assert fused.dtype == td and fused.shape == (1, s, h, d)
    _close(fused, jax_flash(jq, jk, jv, q_block=blk, kv_block=blk,
                            causal=causal, interpret=True), tol)
    _close(ref, jops.attention(jq, jk, jv, causal=causal,
                               policy="reference"), tol)
    _close(fused, ref, tol)


def test_ops_attention_refuses_ragged_full():
    q, k, v = map(torch.tensor, _qkv(13, 1, 300, 2, 2, 16))
    with pytest.raises(ValueError, match="divides into its blocks"):
        ops.attention(q, k, v, causal=False, q_block=128, kv_block=128,
                      policy="fused_dense")
    out = ops.attention(q, k, v, causal=False, q_block=512, kv_block=512,
                        policy="fused_dense")        # one block: no pad
    assert out.shape == q.shape


def test_flash_attention_ref_matches_jax():
    rng = np.random.default_rng(14)
    q, k, v = (rng.standard_normal((3, 20, 8)).astype(np.float32)
               for _ in range(3))
    for causal in (True, False):
        _close(flash_attention_ref(*map(torch.tensor, (q, k, v)),
                                   causal=causal, scale=0.3),
               jax_flash_ref(*map(jnp.asarray, (q, k, v)), causal=causal,
                             scale=0.3))


def test_flash_attention_wrapper_checks_its_operands():
    q, k, v = map(torch.tensor, _qkv(15, 1, 8, 4, 3, 8))
    with pytest.raises(ValueError, match="do not divide"):
        flash_attention(q, k, v)
    q, k, v = map(torch.tensor, _qkv(15, 1, 8, 4, 2, 8))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    torch.testing.assert_close(flash_attention(q, k, v),
                               attention_ref(q, k, v))


# ----------------------------------------------- the wgmma route's arithmetic
def _split_sum(p: torch.Tensor) -> torch.Tensor:
    p1, p2, p3 = split_bf16x3(p)
    assert p1.dtype == p2.dtype == p3.dtype == torch.bfloat16
    # every partial sum is exact in f32: at most 24 significand bits
    return (p1.float() + p2.float()) + p3.float()


def test_split_bf16x3_is_exact_on_softmax_weights():
    """p1 + p2 + p3 == p bit for bit on 1.0, on f32 values spread over
    [2**-100, 1], and on exp over [-80, 0] (the weights a softmax step
    forms) wherever p >= 2**-110. Below that p3 falls under bf16's normal
    range (2**-126) and keeps its bits only down to 2**-133: there the sum
    is within half that step, 2**-134, of p, a weight f32 cannot resolve
    beside a row's sum l >= 1 (the row's max weighs exp(0) = 1)."""
    rng = np.random.default_rng(19)
    mant = rng.uniform(1.0, 2.0, 100_000).astype(np.float32)
    wide = np.ldexp(mant, rng.integers(-100, 0, 100_000)).astype(np.float32)
    for vals in (np.float32([1.0, 2.0 ** -100]), wide):
        p = torch.tensor(vals.copy())
        assert bool(((p >= 2.0 ** -100) & (p <= 1.0)).all())
        assert torch.equal(_split_sum(p), p)
    p = torch.tensor(np.exp(np.linspace(-80.0, 0.0, 200_001,
                                        dtype=np.float32)))
    got = _split_sum(p)
    normal = p >= 2.0 ** -110
    assert 0.9 < float(normal.float().mean()) < 1.0
    assert torch.equal(got[normal], p[normal])
    assert float((got - p).abs().max()) <= 2.0 ** -134


@given(st.integers(min_value=-100, max_value=-1),
       st.floats(min_value=1.0, max_value=2.0))
def test_split_bf16x3_is_exact_property(exponent, mantissa):
    """Any f32 p in [2**-100, 1]: the three bf16 terms sum back to p, and
    each is the rounding to nearest of what the terms before leave."""
    p = torch.tensor([min(1.0, math.ldexp(mantissa, exponent))],
                     dtype=torch.float32)
    p1, p2, p3 = split_bf16x3(p)
    assert torch.equal(_split_sum(p), p)
    assert torch.equal(p1, p.to(torch.bfloat16))
    assert torch.equal(p2, (p - p1.float()).to(torch.bfloat16))
    assert torch.equal(p3.float(), p - p1.float() - p2.float())


def test_pick_route():
    """bf16 at a head dim TMA can address (D % 8 == 0) takes the wgmma
    route, D 48 and 16 at a padded instance; bf16 at another D (44) and
    every f32 call the scalar route."""
    bf = {d: torch.zeros((1, 2, 2, d), dtype=torch.bfloat16)
          for d in (16, 32, 44, 48, 64, 128)}
    assert [pick_route(bf[d]) for d in (32, 64, 128)] == ["wgmma"] * 3
    assert pick_route(bf[48]) == pick_route(bf[16]) == "wgmma"
    assert pick_route(bf[44]) == "scalar"
    assert pick_route(torch.zeros((1, 2, 2, 64))) == "scalar"


def _wgmma_route_emulated(q, k, v, causal, block_q=128, block_k=128):
    """The wgmma route's order in plain torch on [B,S,H,D] bf16 operands:
    per 128-row q tile, 128-key tiles in order (causal: up to the q tile's
    last row), S = q k^T of the bf16 values in f32 and then s = scale * S,
    masked scores -1e30, the online softmax in f32 (l sums the f32 p), and
    PV as three products of p's bf16 terms; returns the f32 output."""
    b, s_len, h, d = q.shape
    g = h // k.shape[2]
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)

    def heads(t, rep):
        t = t.float().repeat_interleave(rep, dim=2)
        return t.transpose(1, 2).reshape(b * h, s_len, d)

    qh, kh, vh = heads(q, 1), heads(k, g), heads(v, g)
    out = torch.empty((b * h, s_len, d), dtype=torch.float32)
    for q0 in range(0, s_len, block_q):
        rows = torch.arange(q0, min(s_len, q0 + block_q))
        m = torch.full((b * h, len(rows)), -1e30)
        l = torch.zeros((b * h, len(rows)))
        acc = torch.zeros((b * h, len(rows), d))
        stop = min(s_len, q0 + block_q) if causal else s_len
        for k0 in range(0, stop, block_k):
            keys = torch.arange(k0, min(s_len, k0 + block_k))
            sc = torch.einsum("bqd,bkd->bqk", qh[:, rows], kh[:, keys]) * scale
            if causal:
                sc = torch.where(keys[None, None] > rows[None, :, None],
                                 torch.tensor(-1e30), sc)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None]
            for term in split_bf16x3(p):
                acc = acc + torch.einsum("bqk,bkd->bqd", term.float(),
                                         vh[:, keys])
            m = m_new
        out[:, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, s_len, d).transpose(1, 2)


# (s, h, hkv, d, causal, mul): ragged S (200 is no multiple of the 128-row
# or the 128-key tile), GQA, causal and full, and scores scaled by 8 so that
# the running max moves and its correction matters
EMULATED_CASES = [(200, 4, 2, 64, True, 1.0), (200, 4, 2, 64, False, 1.0),
                  (150, 2, 1, 32, True, 8.0), (96, 2, 2, 128, False, 8.0)]


@pytest.mark.parametrize("s,h,hkv,d,causal,mul", EMULATED_CASES)
def test_wgmma_route_order_matches_jax(s, h, hkv, d, causal, mul):
    """The emulated route against JAX's Pallas kernel in interpret mode on
    the same bf16 values widened to f32 (so the kernel returns its f32
    result): the f32 output within rtol = atol = 1e-5, and rounded to bf16
    within flash_gate's gate (half a bf16 ulp more, rtol 2**-8 + 1e-5)."""
    q, k, v = _qkv(s + d, 1, s, h, hkv, d)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    tq = (tq.float() * mul).to(torch.bfloat16)
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (tq, tk, tv))
    want = jax_flash(jq, jk, jv, q_block=512, kv_block=512, causal=causal,
                     interpret=True)
    got = _wgmma_route_emulated(tq, tk, tv, causal)
    _close(got, want)
    np.testing.assert_allclose(_np(got.to(torch.bfloat16)), _np(want),
                               rtol=2.0 ** -8 + 1e-5, atol=1e-5)
    _close(got, attention_ref(tq.float(), tk.float(), tv.float(),
                              causal=causal))


def _attention_f64(q, k, v, causal):
    """Softmax attention of [B,S,H,D] q, k and v (numpy, equal heads) in
    f64."""
    qh, kh, vh = (torch.tensor(a).double().transpose(1, 2) for a in (q, k, v))
    s = q.shape[1]
    sc = (qh @ kh.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones((s, s), dtype=torch.bool).tril(),
                            -1e300)
    return (torch.softmax(sc, dim=-1) @ vh).transpose(1, 2)


# (s, h, d, causal): f32 with q scaled by 8, at D 128 (the scale 2**-3.5
# rounds q * scale) and D 64 (the scale 2**-3 is exact)
SCALED_F32_CASES = [(256, 4, 128, True), (512, 4, 128, True),
                    (256, 4, 64, False)]


@pytest.mark.parametrize("s,h,d,causal", SCALED_F32_CASES)
def test_f32_scaled_scores_jax_kernel_against_f64(s, h, d, causal):
    """Where the f32 gate against the plain version stops holding, and why:
    with q scaled by 8 (scores up to about 40), JAX's own Pallas kernel in
    interpret mode, which scales q before the product as the scalar route
    does, and the plain version, which scales the product, are each held
    against the f64 result. The kernel's error stays within twice the plain
    version's (the GPU tests' ``_flash_witness``); where the scale is a
    power of two the two orders round s alike and the kernel meets the f32
    gate (rtol = atol = 1e-5) against the plain version too."""
    q, k, v = _qkv(s + d, 1, s, h, h, d)
    q = q * np.float32(8.0)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), q_block=128,
                     kv_block=128, causal=causal, interpret=True)
    plain = attention_ref(*(torch.tensor(a) for a in (q, k, v)),
                          causal=causal)
    exact = _attention_f64(q, k, v, causal)
    err = np.abs(np.asarray(want, np.float64) - exact.numpy()).max()
    err_plain = (plain.double() - exact).abs().max().item()
    assert err <= 2 * err_plain, (err, err_plain)
    if d == 64:
        _close(want, plain)
