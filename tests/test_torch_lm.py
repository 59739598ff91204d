"""The spiking QKFormer LM of the port on the CPU against the JAX package:
``head_lane_masks``, the head-blocked, dense-activation fused PE pass (the
port's plain version against JAX's Pallas kernel in interpret mode),
``ops.dense_lif`` with grouped KV, and the reduced qwen3-1.7b
(``spiking=True, attention_kind="qk_spiking"``) through ``LM.prefill``,
``prefill_chunk`` and ``decode_step`` under ``reference``, ``fused_dense``
and ``fused_packed``.

Inputs are numpy arrays made from a seed, handed to both frameworks; the
LM's parameters are JAX's, carried across by ``convert.lm_params_from_jax``.
A fused PE spike may differ only where the f64 membrane current lies
within 1e-4 of ``v_th`` (the frameworks sum the f32 products in another
order); flips there are counted and printed. ``vld_next`` is each side's
own spikes' block count, and equal where the spikes are. The LM's logits
match at rtol 1e-4, atol 1e-4 (a few layers of f32 products summed in
another order, and XLA's CPU rsqrt, which is not correctly rounded, in
every RMSNorm); its per-layer spike totals and packed state words are
equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs import build_model as jbuild
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import events as jev
from repro.core.lif import LIFConfig as JLIF
from repro.kernels.fused_pe import fused_pe as jax_fused_pe
from repro.models import layers as jlayers
from repro_torch import convert, ops
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.core import events as tev
from repro_torch.core.lif import LIFConfig
from repro_torch.kernels.fused_pe import fused_pe
from repro_torch.models import layers as tlayers
from repro_torch.models.lm import spike_totals

NEAR_VTH = 1e-4
V_TH = 1.0
RTOL = ATOL = 1e-4
POLICIES = ["reference", "fused_dense", "fused_packed"]


def bf16_exact(a: np.ndarray) -> np.ndarray:
    """f32 values that a bf16 holds exactly (round to nearest even)."""
    return torch.tensor(a).to(torch.bfloat16).to(torch.float32).numpy()


# ---------------------------------------------------------- head_lane_masks
@pytest.mark.parametrize("h,dh,total", [(8, 16, 128), (4, 32, 128),
                                        (2, 128, 256), (5, 24, 128),
                                        (3, 48, 160), (1, 32, 32)])
def test_head_lane_masks_bit_equal_to_jax(h, dh, total):
    got = tev.head_lane_masks(h, dh, total)
    want = np.asarray(jev.head_lane_masks(h, dh, total))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------- K2 head-blocked, dense activations
# (dh, h, q format, out format, x dtype, bias, M): every option at least
# twice; dh 16, 32 and 128 divide the 128-wide tile, 24 and 48 do not (a
# head straddles two tiles); M is never a multiple of 128
HEAD_CASES = [
    (16, 8, "dense", "dense", "f32", True, 200),
    (16, 8, "packed", "packed", "bf16", False, 200),
    (32, 4, "dense", "packed", "bf16", True, 130),
    (32, 4, "packed", "dense", "f32", False, 130),
    (128, 2, "dense", "dense", "bf16", False, 77),
    (128, 2, "packed", "packed", "f32", True, 77),
    (24, 5, "dense", "dense", "f32", True, 300),
    (24, 5, "packed", "packed", "bf16", False, 300),
    (48, 6, "dense", "packed", "f32", False, 140),
    (48, 6, "packed", "dense", "bf16", True, 140),
    (16, 8, "packed", "packed", "int8", True, 150),   # spikes, head mask
    (None, 1, "dense", "dense", "f32", True, 90),     # activation, whole row
]


def _head_case(dh, h, xdt, bias, m, seed):
    rng = np.random.default_rng(seed)
    k = 192
    n = h * dh if dh else 100
    if xdt == "int8":
        x = (rng.random((m, k)) < 0.3).astype(np.int8)
        cur_x = x.astype(np.float64)
        scale = 2.0
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        if xdt == "bf16":
            x = bf16_exact(x)
        cur_x = x.astype(np.float64)
        scale = 1.0
    w = (rng.standard_normal((k, n)) * (scale / np.sqrt(k))).astype(
        np.float32)
    b = ((0.5 * rng.standard_normal(n)).astype(np.float32)
         if bias else None)
    q = (rng.random((m, n)) < 0.05).astype(np.int8)
    thr = float(1 + (dh or n) // 32)
    cur = cur_x @ w.astype(np.float64) + (0.0 if b is None else b)
    return x, w, b, q, thr, cur


def _as(a, xdt, to_jax):
    if to_jax:
        t = jnp.asarray(a)
        return t.astype(jnp.bfloat16) if xdt == "bf16" else t
    t = torch.tensor(a)
    return t.to(torch.bfloat16) if xdt == "bf16" else t


@pytest.mark.parametrize("dh,h,qfmt,ofmt,xdt,bias,m", HEAD_CASES)
def test_fused_pe_heads_dense_x_matches_jax(dh, h, qfmt, ofmt, xdt, bias, m):
    seed = [m, h, dh or 0, len(qfmt), len(ofmt), len(xdt), int(bias)]
    x, w, b, q, thr, cur = _head_case(dh, h, xdt, bias, m, seed)
    heads = None if dh is None else (h, dh)
    pq = qfmt == "packed"
    tq = tev.pack_spikes_ref(torch.tensor(q)) if pq else torch.tensor(q)
    jq = jev.pack_spikes_ref(jnp.asarray(q)) if pq else jnp.asarray(q)
    spk, vld = fused_pe(_as(x, xdt, False), torch.tensor(w),
                        bias=None if b is None else torch.tensor(b), q=tq,
                        v_th=V_TH, qk_threshold=thr, out_format=ofmt,
                        heads=heads)
    j = jax_fused_pe(_as(x, xdt, True), jnp.asarray(w),
                     bias=None if b is None else jnp.asarray(b), q=jq,
                     v_th=V_TH, qk_threshold=thr, out_format=ofmt,
                     heads=heads)
    if ofmt == "packed":
        assert isinstance(spk, tev.PackedSpikes) and spk.shape == (m, w.shape[1])
        assert tev.check_packed_invariants(spk)["ok"]
        got = tev.unpack_spikes_ref(spk).numpy()
        want = np.asarray(jev.unpack_spikes_ref(j.spikes))
    else:
        got, want = spk.numpy(), np.asarray(j.spikes)
    near = np.abs(cur - V_TH) < NEAR_VTH
    bad = (got != want) & ~near
    assert not bad.any(), f"{int(bad.sum())} spikes differ away from v_th"
    flips = int((got != want).sum())
    print(f"{int(near.sum())} currents within {NEAR_VTH} of v_th, "
          f"{flips} spikes flipped")
    # each side's vld_next is the block count of its own spikes
    own = tev.block_count_map_2d(tev.pad_to_blocks(torch.tensor(got),
                                                   128, 128), 128, 128)
    np.testing.assert_array_equal(vld.numpy(), own.numpy())
    if flips == 0:
        np.testing.assert_array_equal(vld.numpy(), np.asarray(j.vld_next))
        if ofmt == "packed":
            np.testing.assert_array_equal(spk.words.numpy(),
                                          np.asarray(j.spikes.words))
    # the head mask is what the reference's per-head row sums say
    if heads is not None:
        rs = q[:, :h * dh].reshape(m, h, dh).sum(-1) >= thr
        gate = np.repeat(rs, dh, axis=1)
        assert not (got.astype(bool) & ~gate).any()
        assert 0 < gate.mean() < 1, "the case should gate some heads only"


def test_fused_pe_dense_x_takes_the_dense_route_only():
    x = torch.ones((4, 8))
    w = torch.ones((8, 8))
    with pytest.raises(ValueError, match="dense"):
        fused_pe(x, w, skip="gated")
    with pytest.raises(ValueError, match="q operand"):
        fused_pe(x, w, heads=(2, 4))
    with pytest.raises(ValueError, match="tile the output"):
        fused_pe(x, w, q=torch.ones((4, 8), dtype=torch.int8), heads=(3, 4))
    with pytest.raises(TypeError, match="bf16"):
        fused_pe(x.to(torch.float64), w)


# ---------------------------------------------------------------- dense_lif
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-1.7b"])
def test_dense_lif_matches_jax(arch, policy):
    """wq and the head-masked, group-expanded wk pass of the reduced
    config (qwen2.5-3b: 4 heads over 1 kv head; qwen3-1.7b: 4 over 2)."""
    cfg = reduced(get_config(arch))
    h, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, \
        cfg.d_model
    rng = np.random.default_rng([h, hkv, len(policy)])
    x = rng.standard_normal((3, 7, d)).astype(np.float32)
    wq = (rng.standard_normal((d, h * dh)) * (1.5 / np.sqrt(d))).astype(
        np.float32)
    wk = (rng.standard_normal((d, hkv * dh)) * (1.5 / np.sqrt(d))).astype(
        np.float32)
    thr = 2.0
    t_q = ops.dense_lif({"w": torch.tensor(wq)}, torch.tensor(x),
                        LIFConfig(), policy=policy)
    t_out = ops.dense_lif({"w": torch.tensor(wk)}, torch.tensor(x),
                          LIFConfig(), q=t_q, qk_threshold=thr,
                          heads=(h, dh), kv_heads=hkv, policy=policy)
    j_q = jops.dense_lif({"w": jnp.asarray(wq)}, jnp.asarray(x), JLIF(),
                         policy=policy)
    j_out = jops.dense_lif({"w": jnp.asarray(wk)}, jnp.asarray(x), JLIF(),
                           q=j_q, qk_threshold=thr, heads=(h, dh),
                           kv_heads=hkv, policy=policy)
    assert t_out.is_packed == (policy == "fused_packed")
    for t, j in ((t_q, j_q), (t_out, j_out)):
        assert tuple(t.shape) == tuple(j.shape) == (21, h * dh)
        np.testing.assert_array_equal(t.to_dense().numpy(),
                                      np.asarray(j.to_dense()))
        np.testing.assert_array_equal(t.vld_cnt.numpy(),
                                      np.asarray(j.vld_cnt))
        if t.is_packed:
            np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    dense = t_out.to_dense().numpy()
    assert 0 < dense.mean() < 1


@pytest.mark.parametrize("policy", [None, "fused_packed", "reference"])
@pytest.mark.parametrize("with_q", [False, True])
def test_fused_dense_lif_matches_jax(policy, with_q):
    """The layer-level veneer over ``ops.dense_lif`` (``fused_dense`` when
    no policy is given): JAX's spikes, and ``maybe_spike(dense_apply(p,
    x))`` gated by the row sums of q where the f64 current is away from
    v_th."""
    rng = np.random.default_rng([7, int(with_q), len(policy or "")])
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * (1.5 / np.sqrt(48))).astype(
        np.float32)
    b = (0.3 * rng.standard_normal(40)).astype(np.float32)
    q = (rng.random((18, 40)) < 0.08).astype(np.int8) if with_q else None
    thr = 3.0
    got = tlayers.fused_dense_lif(
        {"w": torch.tensor(w), "b": torch.tensor(b)}, torch.tensor(x),
        LIFConfig(), q=None if q is None else torch.tensor(q),
        qk_threshold=thr, policy=policy)
    want = jlayers.fused_dense_lif(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), JLIF(),
        q=None if q is None else jnp.asarray(q), qk_threshold=thr,
        policy=policy)
    assert got.is_packed == (policy == "fused_packed")
    assert tuple(got.shape) == tuple(want.shape) == (18, 40)
    spk = got.to_dense().numpy()
    np.testing.assert_array_equal(spk, np.asarray(want.to_dense()))
    plain = tlayers.maybe_spike(
        tlayers.dense_apply({"w": torch.tensor(w), "b": torch.tensor(b)},
                            torch.tensor(x)), True, LIFConfig())
    plain = plain.reshape(18, 40).numpy()
    if q is not None:
        plain = plain * (q.sum(-1, keepdims=True) >= thr)
    cur = x.reshape(18, 48).astype(np.float64) @ w.astype(np.float64) + b
    near = np.abs(cur - V_TH) < NEAR_VTH
    assert not ((spk != plain) & ~near).any()
    assert 0 < spk.mean() < 1


def test_grouped_wk_is_expanded_once_per_weight():
    """The fused pass repeats a grouped wk's columns once per weight
    tensor and reuses it, until the weight changes in place."""
    from repro_torch.ops import impls

    calls = []
    real = impls.expand_group_weights

    def counting(p, heads, kv_heads):
        calls.append(1)
        return real(p, heads, kv_heads)

    impls.expand_group_weights = counting
    try:
        w = torch.randn(16, 8)
        x = torch.randn(5, 16)
        q = torch.ones((5, 16), dtype=torch.int8)
        for _ in range(3):
            ops.dense_lif({"w": w}, x, LIFConfig(), q=q, heads=(4, 4),
                          kv_heads=2, policy="fused_dense")
        assert len(calls) == 1
        w.mul_(2.0)
        out = ops.dense_lif({"w": w}, x, LIFConfig(), q=q, heads=(4, 4),
                            kv_heads=2, policy="fused_dense")
        assert len(calls) == 2
        ref = ops.dense_lif({"w": w}, x, LIFConfig(), q=q, heads=(4, 4),
                            kv_heads=2, policy="reference")
        np.testing.assert_array_equal(out.data.numpy(), ref.data.numpy())
    finally:
        impls.expand_group_weights = real


def test_grouped_wk_is_expanded_anew_for_a_new_bias():
    """A parameter dict that keeps its ``w`` but gets a new bias tensor is
    expanded again, also when the new bias reuses the old one's id (the
    old bias is freed first, so CPython may hand out its id again)."""
    from repro_torch.tree import derived

    w = torch.randn(16, 8)
    p = {"w": w, "b": torch.zeros(8)}
    first = derived(w, "bias swap", lambda: p["b"].clone(), p["b"])
    assert not first.any()
    reused = 0
    for i in range(1, 6):
        old = id(p["b"])
        del p["b"]
        p["b"] = torch.full((8,), float(i))
        reused += id(p["b"]) == old
        got = derived(w, "bias swap", lambda: p["b"].clone(), p["b"])
        assert torch.equal(got, p["b"]), f"stale value after swap {i}"
    print(f"{reused} of 5 new biases reused the old one's id")
    # and through the fused pass: the new bias shifts every current
    x = torch.randn(5, 16)
    q = torch.ones((5, 16), dtype=torch.int8)
    p = {"w": w, "b": torch.zeros(8)}
    ops.dense_lif(p, x, LIFConfig(), q=q, heads=(4, 4), kv_heads=2,
                  policy="fused_dense")
    del p["b"]
    p["b"] = torch.full((8,), 100.0)
    out = ops.dense_lif(p, x, LIFConfig(), q=q, heads=(4, 4), kv_heads=2,
                        policy="fused_dense")
    ref = ops.dense_lif(p, x, LIFConfig(), q=q, heads=(4, 4), kv_heads=2,
                        policy="reference")
    np.testing.assert_array_equal(out.data.numpy(), ref.data.numpy())
    assert out.data.all()


# --------------------------------------------------------------------- LM
SPIKING = dict(spiking=True, attention_kind="qk_spiking")
_JAX_LM: dict = {}


def lm_pair(policy: str):
    """(JAX model, jitted steps, JAX params, port model, port params) of
    the reduced spiking qwen3-1.7b under ``policy``; the JAX side is built
    and jitted once per policy."""
    if policy not in _JAX_LM:
        jcfg = jreduced(jget("qwen3-1.7b", **SPIKING), policy=policy)
        jm = jbuild(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        steps = (jax.jit(functools.partial(jm.prefill,
                                           return_all_logits=True)),
                 jax.jit(jm.prefill_chunk), jax.jit(jm.decode_step))
        tcfg = reduced(get_config("qwen3-1.7b", **SPIKING), policy=policy)
        tm = build_model(tcfg)
        tp = convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _JAX_LM[policy] = (jm, steps, jp, tm, tp)
    return _JAX_LM[policy]


def _jax_spike_totals(jm, jp, tokens) -> dict:
    """Per-layer spike totals of the reference model over ``tokens``: its
    blocks walked one by one with JAX's own functions, counting the Q map,
    the masked attention map and the MLP gate of each."""
    from repro.core.qk_attention import qk_grouped_token_attention
    from repro.models.attention import attn_prefill
    from repro.models.ffn import mlp_apply

    cfg = jm.cfg
    pol = cfg.exec_policy
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = jlayers.embedding_lookup(jp["embed"], jnp.asarray(tokens), cfg.dtype)
    b, s, _ = x.shape
    positions = jnp.zeros((b, s), jnp.int32)   # qk_spiking reads none
    out = {"q": [], "attn": [], "mlp": []}
    for i in range(cfg.n_layers):
        p = jax.tree_util.tree_map(lambda a: a[i], jp["blocks"])
        y = jlayers.rmsnorm_apply(p["ln1"], x, cfg.rms_eps)
        a = p["attn"]
        if pol.fused:
            q = jops.dense_lif(a["wq"], y, cfg.lif, policy=pol)
            o = jops.dense_lif(a["wk"], y, cfg.lif, q=q,
                               qk_threshold=cfg.lif.v_th, heads=(h, dh),
                               kv_heads=hkv, policy=pol)
            nq, no = int(q.count()), int(o.count())
        else:
            qs = jlayers.maybe_spike(jlayers.dense_apply(a["wq"], y), True,
                                     cfg.lif).reshape(b, s, h, dh)
            ks = jlayers.maybe_spike(jlayers.dense_apply(a["wk"], y), True,
                                     cfg.lif).reshape(b, s, hkv, dh)
            o = qk_grouped_token_attention(qs, ks, threshold=cfg.lif.v_th)
            # counted in int32: a bf16 sum cannot hold a count above 256
            nq, no = (int((qs != 0).sum()), int((o != 0).sum()))
        out["q"].append(nq)
        out["attn"].append(no)
        x = x + attn_prefill(a, cfg, y, positions)[0]
        y2 = jlayers.rmsnorm_apply(p["ln2"], x, cfg.rms_eps)
        g = jlayers.dense_apply(p["mlp"]["gate"], y2)
        out["mlp"].append(int((jlayers.maybe_spike(g, True, cfg.lif)
                               != 0).sum()))
        x = x + mlp_apply(p["mlp"], cfg, y2)
    return out


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_lm_prefill_matches_jax(policy):
    jm, (jprefill, _, _), jp, tm, tp = lm_pair(policy)
    toks = _tokens(1, 2, 9, tm.cfg.vocab_size)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    with tlayers.spike_log() as log:
        tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks)},
                            return_all_logits=True)
    assert tl.shape == (2, 9, tm.cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    totals = spike_totals(log, tm.cfg.n_layers)
    want = _jax_spike_totals(jm, jp, toks)
    for kind in ("q", "attn", "mlp"):
        assert totals[kind].tolist() == want[kind], kind
        assert all(v > 0 for v in want[kind]), kind
    assert len(tc["layers"]) == len(jc["layers"]) == 2
    for t, j in zip(tc["layers"], jc["layers"]):
        assert tuple(t.shape) == tuple(j.shape)
        if t.dtype == torch.int32:        # the packed per-slot state words
            assert policy == "fused_packed"
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            assert int(t.ne(0).sum()) > 0
    assert int(tc["len"]) == int(jc["len"]) == 9


@pytest.mark.parametrize("policy", POLICIES)
def test_lm_prefill_chunk_and_decode_match_jax(policy):
    jm, (_, jchunk, jdecode), jp, tm, tp = lm_pair(policy)
    vocab = tm.cfg.vocab_size
    toks = _tokens(2, 2, 6, vocab)
    jcache = jm.init_cache(2, 16)
    jcache["len"] = jnp.zeros((), jnp.int32)
    tcache = tm.init_cache(2, 16, device="cpu")
    tcache["len"] = torch.zeros((), dtype=torch.int32)
    for t, j in zip(tcache["layers"], jcache["layers"]):
        assert tuple(t.shape) == tuple(j.shape)
    for lo in (0, 4):                        # two chunks of 4 and 2 tokens
        chunk = toks[:, lo:lo + 4]
        jl, jcache = jchunk(jp, jnp.asarray(chunk), jcache)
        tl, tcache = tm.prefill_chunk(tp, torch.tensor(chunk), tcache)
        _close(tl, jl)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    assert (tl[:, -1].argmax(-1).numpy() == nxt).all()
    lens = np.array([6, 3], np.int32)        # a per-slot length vector
    jcache["len"] = jnp.asarray(lens)
    tcache["len"] = torch.tensor(lens)
    for _ in range(3):
        jl, jcache = jdecode(jp, jnp.asarray(nxt[:, None]), jcache)
        tl, tcache = tm.decode_step(tp, torch.tensor(nxt[:, None]), tcache)
        assert tl.shape == (2, vocab)
        _close(tl, jl)
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        for t, j in zip(tcache["layers"], jcache["layers"]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert (tl.argmax(-1).numpy() == nxt).all()


@pytest.mark.parametrize("policy", POLICIES)
def test_chunked_prefill_equals_blocking(policy):
    """Chunks of 3 give the blocking prefill's logits and cache. torch's
    CPU matmul may sum a row in another order when M changes, so the
    logits are held at rtol 1e-5 (the greedy tokens exactly) and the
    spike totals and state words exactly."""
    _, _, _, tm, tp = lm_pair(policy)
    toks = torch.tensor(_tokens(3, 1, 10, tm.cfg.vocab_size))
    with tlayers.spike_log() as flog:
        full, fcache = tm.prefill(tp, {"tokens": toks},
                                  return_all_logits=True)
    cache = tm.init_cache(1, 10, device="cpu")
    cache["len"] = torch.zeros((), dtype=torch.int32)
    parts = []
    with tlayers.spike_log() as clog:
        for lo in range(0, 10, 3):
            lg, cache = tm.prefill_chunk(tp, toks[:, lo:lo + 3], cache)
            parts.append(lg)
    chunked = torch.cat(parts, dim=1)
    torch.testing.assert_close(chunked, full, rtol=1e-5, atol=1e-6)
    assert torch.equal(chunked.argmax(-1), full.argmax(-1))
    n = tm.cfg.n_layers
    ftot, ctot = spike_totals(flog, n), spike_totals(clog, n)
    for kind in ftot:
        assert torch.equal(ctot[kind], ftot[kind]), kind
    for a, b in zip(cache["layers"], fcache["layers"]):
        assert torch.equal(a, b)
    assert int(cache["len"]) == 10


def test_fused_policies_spike_as_the_reference_does():
    """The three policies give the same per-layer spike totals and the
    same logits on the same parameters (f32 activations: the fused pass
    sums what the reference sums)."""
    toks = torch.tensor(_tokens(4, 3, 8, 512))
    outs = {}
    for policy in POLICIES:
        _, _, _, tm, tp = lm_pair(policy)
        with tlayers.spike_log() as log:
            lg, _ = tm.prefill(tp, {"tokens": toks}, return_all_logits=True)
        outs[policy] = (lg, spike_totals(log, tm.cfg.n_layers))
    ref_lg, ref_tot = outs["reference"]
    for policy in ("fused_dense", "fused_packed"):
        lg, tot = outs[policy]
        torch.testing.assert_close(lg, ref_lg, rtol=1e-5, atol=1e-5)
        for kind in ref_tot:
            assert torch.equal(tot[kind], ref_tot[kind]), (policy, kind)


def test_lm_is_built_for_the_dense_family_only():
    """The decoder-only ``LM`` is built for every family but encdec, which
    gets ``EncDecLM`` (the other families are held to JAX in
    ``test_torch_moe.py``, ``test_torch_ssm.py`` and
    ``test_torch_vlm_encdec.py``); the dense family's softmax attention
    (every config's default) runs: prefill, a chunk and a decode step give
    finite logits of the expected shapes."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.lm import LM

    for arch in ("olmoe-1b-7b", "mamba2-130m", "zamba2-7b",
                 "phi-3-vision-4.2b"):
        assert type(build_model(reduced(get_config(arch)))) is LM
    assert type(build_model(reduced(get_config(
        "seamless-m4t-large-v2")))) is EncDecLM
    cfg = reduced(get_config("qwen3-1.7b"))      # softmax attention
    assert cfg.attention_kind == "softmax"
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    logits, cache = model.prefill(params, {"tokens": toks}, max_len=8)
    assert logits.shape == (1, cfg.vocab_size)
    assert cache["layers"][0].shape == (cfg.n_layers, 1, 8, cfg.n_kv_heads,
                                        cfg.resolved_head_dim)
    lg, cache = model.decode_step(params, toks[:, :1], cache)
    assert lg.shape == (1, cfg.vocab_size) and int(cache["len"]) == 5
    assert bool(torch.isfinite(lg).all())


def test_configs_match_the_reference_registry():
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS

    assert sorted(ARCHS) == sorted(JARCHS)
    skip = {"policy", "use_event_kernels", "spike_format", "dtype",
            "param_dtype", "lif", "quant", "scan_layers", "dp_over_model",
            "loss_chunk", "seq_shard", "decode_cp_axis"}
    for name, jcfg in JARCHS.items():
        for cfg in (ARCHS[name], reduced(ARCHS[name])):
            j = jcfg if cfg is ARCHS[name] else jreduced(jcfg)
            for f in dataclasses.fields(cfg):
                if f.name not in skip:
                    assert getattr(cfg, f.name) == getattr(j, f.name), \
                        (name, f.name)
            assert str(cfg.dtype).split(".")[-1] == str(
                jnp.dtype(j.dtype)), name


# ------------------------------------------------------------- softmax LM
SOFTMAX_ARCHS = ["qwen3-1.7b", "qwen2.5-3b"]     # qk_norm; QKV bias
_JAX_SOFTMAX: dict = {}


def softmax_pair(arch: str):
    """(JAX model, jitted steps, JAX params, port model, port params) of
    the reduced softmax ``arch`` (f32), built and jitted once."""
    if arch not in _JAX_SOFTMAX:
        jm = jbuild(jreduced(jget(arch)))
        jp = jm.init(jax.random.PRNGKey(0))
        steps = (jax.jit(functools.partial(jm.prefill,
                                           return_all_logits=True)),
                 jax.jit(jm.prefill_chunk), jax.jit(jm.decode_step))
        tm = build_model(reduced(get_config(arch)))
        tp = convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _JAX_SOFTMAX[arch] = (jm, steps, jp, tm, tp)
    return _JAX_SOFTMAX[arch]


@pytest.mark.parametrize("arch", SOFTMAX_ARCHS)
def test_softmax_params_carry_qk_norm_and_qkv_bias(arch):
    jm, _, jp, tm, tp = softmax_pair(arch)
    attn = tp["blocks"][0]["attn"]
    assert ("q_norm" in attn) == tm.cfg.qk_norm == ("q_norm" in jp["blocks"]
                                                    ["attn"])
    assert ("b" in attn["wq"]) == tm.cfg.qkv_bias == ("b" in jp["blocks"]
                                                      ["attn"]["wq"])
    assert tm.cfg.qk_norm or tm.cfg.qkv_bias
    for i, blk in enumerate(tp["blocks"]):
        for name in ("wq", "wk", "wv"):
            for leaf, t in blk["attn"][name].items():
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jp["blocks"]["attn"][name][leaf][i]))


@pytest.mark.parametrize("arch", SOFTMAX_ARCHS)
def test_softmax_lm_prefill_matches_jax(arch):
    _, (jprefill, _, _), jp, tm, tp = softmax_pair(arch)
    toks = _tokens(1, 2, 9, tm.cfg.vocab_size)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks)},
                        return_all_logits=True)
    assert tl.shape == (2, 9, tm.cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    assert torch.equal(tl.argmax(-1), torch.tensor(np.asarray(
        jnp.argmax(jl, -1))).long())
    for t, j in zip(tc["layers"], jc["layers"]):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
    assert int(tc["len"]) == int(jc["len"]) == 9


@pytest.mark.parametrize("arch", SOFTMAX_ARCHS)
def test_softmax_lm_prefill_chunk_and_decode_match_jax(arch):
    jm, (_, jchunk, jdecode), jp, tm, tp = softmax_pair(arch)
    vocab = tm.cfg.vocab_size
    toks = _tokens(2, 2, 6, vocab)
    jcache = jm.init_cache(2, 16)
    jcache["len"] = jnp.zeros((), jnp.int32)
    tcache = tm.init_cache(2, 16, device="cpu")
    tcache["len"] = torch.zeros((), dtype=torch.int32)
    pools = tcache["layers"]
    for t, j in zip(tcache["layers"], jcache["layers"]):
        assert tuple(t.shape) == tuple(j.shape) and t.dtype == torch.float32
    for lo in (0, 4):                        # two chunks of 4 and 2 tokens
        chunk = toks[:, lo:lo + 4]
        jl, jcache = jchunk(jp, jnp.asarray(chunk), jcache)
        tl, tcache = tm.prefill_chunk(tp, torch.tensor(chunk), tcache)
        _close(tl, jl)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
    assert (tl[:, -1].argmax(-1).numpy() == nxt).all()
    lens = np.array([6, 3], np.int32)        # a per-slot length vector
    jcache["len"] = jnp.asarray(lens)
    tcache["len"] = torch.tensor(lens)
    for _ in range(3):
        jl, jcache = jdecode(jp, jnp.asarray(nxt[:, None]), jcache)
        tl, tcache = tm.decode_step(tp, torch.tensor(nxt[:, None]), tcache)
        assert tl.shape == (2, vocab)
        _close(tl, jl)
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        for t, j in zip(tcache["layers"], jcache["layers"]):
            _close(t, j)
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        assert (tl.argmax(-1).numpy() == nxt).all()
    # the rows went into the pool's own tensors
    assert all(a is b for a, b in zip(tcache["layers"], pools))


@pytest.mark.parametrize("arch", SOFTMAX_ARCHS)
def test_softmax_chunked_prefill_equals_blocking(arch):
    """Chunks of 3 give the blocking prefill's logits and KV rows. The
    chunk's scores are f32 sums as the blocking pass's are; torch's CPU
    matmul may sum a row in another order when M changes, so the logits
    and rows are held at rtol 1e-5 and the greedy tokens exactly."""
    _, _, _, tm, tp = softmax_pair(arch)
    toks = torch.tensor(_tokens(3, 1, 10, tm.cfg.vocab_size))
    full, fcache = tm.prefill(tp, {"tokens": toks}, return_all_logits=True)
    cache = tm.init_cache(1, 10, device="cpu")
    cache["len"] = torch.zeros((), dtype=torch.int32)
    parts = []
    for lo in range(0, 10, 3):
        lg, cache = tm.prefill_chunk(tp, toks[:, lo:lo + 3], cache)
        parts.append(lg)
    chunked = torch.cat(parts, dim=1)
    torch.testing.assert_close(chunked, full, rtol=1e-5, atol=1e-6)
    assert torch.equal(chunked.argmax(-1), full.argmax(-1))
    for a, b in zip(cache["layers"], fcache["layers"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert int(cache["len"]) == 10


@pytest.mark.parametrize("kv_dtype", ["", "f8_e4m3"])
def test_softmax_init_cache_matches_jax(kv_dtype):
    jm = jbuild(jreduced(jget("qwen3-1.7b"), dtype=jnp.bfloat16,
                         kv_dtype=kv_dtype))
    tm = build_model(reduced(get_config("qwen3-1.7b"), dtype=torch.bfloat16,
                             kv_dtype=kv_dtype))
    jc, tc = jm.init_cache(3, 12), tm.init_cache(3, 12, device="cpu")
    want = torch.float8_e4m3fn if kv_dtype else torch.bfloat16
    for t, j in zip(tc["layers"], jc["layers"]):
        assert tuple(t.shape) == tuple(j.shape) == (2, 3, 12, 2, 16)
        assert t.dtype == want and str(j.dtype) == str(want).split(".")[-1]
        assert int(t.view(torch.uint8).ne(0).sum()) == 0
    assert int(tc["len"]) == int(jc["len"]) == 11


def test_pad_kv_layers_pads_float_leaves_as_jax():
    from repro.models.lm import _pad_kv_layers as jpad
    from repro_torch.models.lm import _pad_kv_layers as tpad

    rng = np.random.default_rng(16)
    k = rng.standard_normal((2, 1, 5, 2, 4)).astype(np.float32)
    words = rng.integers(0, 7, (2, 1, 1, 1, 4)).astype(np.int32)
    empty = np.zeros((2, 1, 0, 2, 4), np.float32)
    for leaf in (k, words, empty):
        got = tpad((torch.tensor(leaf),), 9)[0]
        want = jpad((jnp.asarray(leaf),), 9)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- bf16, JAX run op by op
def _bf16_anchor(arch: str, policy: str, **kw):
    """Logits of a 4 x 33-token prefill of the reduced ``arch`` at bf16 in
    both packages, JAX's with ``scan_layers=False`` run op by op
    (``jax.disable_jit``): compiled JAX keeps bf16 intermediates in
    excess precision, and ``lax.scan`` and ``jit`` differ from each other,
    so it is no single function at bf16. Returns (JAX model, JAX params,
    port logits, JAX logits, port spike log, tokens)."""
    jm = jbuild(jreduced(jget(arch, **kw), dtype=jnp.bfloat16,
                         scan_layers=False, policy=policy))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(reduced(get_config(arch, **kw), dtype=torch.bfloat16,
                             policy=policy))
    tp = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    toks = _tokens(0, 4, 33, tm.cfg.vocab_size)
    with jax.disable_jit():
        jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                           return_all_logits=True)
    with tlayers.spike_log() as log:
        tl, _ = tm.prefill(tp, {"tokens": torch.tensor(toks)},
                           return_all_logits=True)
    return jm, jp, tl, np.asarray(jl), log, toks


# Bit-equality is what shows on this draw of tokens. Both packages round
# where the other rounds (bf16 products, f32 scores, the bf16 logistic of
# SwiGLU); what they cannot share is the order in which a bf16 GEMM sums its
# f32 products (XLA's Eigen against torch's oneDNN). On other draws about
# one GEMM output in 10^4 rounds to the neighbouring bf16 value, which a
# LIF threshold or the causal attention then carries to later positions
# (seen on 3 of 8 draws of 4 x 33 tokens); that is the GEMM libraries'
# order, not a rounding rule of the port.
@pytest.mark.parametrize("policy", POLICIES)
def test_spiking_lm_bf16_bit_equal_to_jax_op_by_op(policy):
    jm, jp, tl, jl, log, toks = _bf16_anchor("qwen3-1.7b", policy, **SPIKING)
    assert tl.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), jl)
    with jax.disable_jit():
        want = _jax_spike_totals(jm, jp, toks)
    totals = spike_totals(log, jm.cfg.n_layers)
    for kind in ("q", "attn", "mlp"):
        assert totals[kind].tolist() == want[kind], kind


@pytest.mark.parametrize("arch", SOFTMAX_ARCHS)
def test_softmax_lm_bf16_bit_equal_to_jax_op_by_op(arch):
    _, _, tl, jl, _, _ = _bf16_anchor(arch, "reference")
    np.testing.assert_array_equal(tl.numpy(), jl)
