"""The small core twins on the CPU against the JAX package: W2TTFS's
Algorithm 1 and time-reuse forms, the QKFormer channel mask, token and
channel attention and the Spikformer SSA, the event statistics, and the
fp8 fake-quant with ``quantize_tree``. Each mirrors the reference's own
test (``test_w2ttfs.py``, ``test_qk_attention.py``, ``test_kd_quant.py``,
``test_ops_api.py``) and holds the port to JAX on the same numpy inputs.

Tolerances: spike maps, masks, counts and fp8 values bit-equal; f32 sums
at rtol 1e-5 with an absolute term of 1e-6 of the largest |value| (the
same products summed in another order); the four W2TTFS forms against each
other at rtol = atol = 1e-4, as the reference's test holds them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import qk_attention as jqk
from repro.core import quant as jquant
from repro.core import w2ttfs as jw
from repro_torch.core import events as tev
from repro_torch.core import qk_attention as tqk
from repro_torch.core import quant as tquant
from repro_torch.core import w2ttfs as tw

RTOL = 1e-5


def close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    atol = 1e-6 * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol)


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def spikes(seed, shape, rate=0.3):
    return (np.random.default_rng(seed).random(shape) < rate).astype(
        np.float32)


def t(a):
    return torch.tensor(np.array(a))


# ------------------------------------------------------------------ W2TTFS
W2_CASES = [(2, 3, 8, 16, 10), (4, 2, 8, 8, 100), (8, 1, 8, 4, 10),
            (4, 5, 16, 3, 7)]


@pytest.mark.parametrize("window,b,hw,c,cls", W2_CASES)
def test_w2ttfs_forms_match_jax_and_each_other(window, b, hw, c, cls):
    """Algorithm 1, the WTFC head, the time-reuse replay and avg-pool + FC:
    each against JAX's, and the four equal to each other."""
    rng = np.random.default_rng(window * 100 + hw)
    x = spikes(window + b, (b, hw, hw, c))
    ho = hw // window
    fc_w = (0.1 * rng.standard_normal((ho * ho * c, cls))).astype(np.float32)
    fc_b = rng.standard_normal(cls).astype(np.float32)
    forms = {}
    for name in ("w2ttfs_reference", "w2ttfs_classifier",
                 "w2ttfs_time_reuse", "avgpool_classifier"):
        want = getattr(jw, name)(jnp.asarray(x), jnp.asarray(fc_w),
                                 jnp.asarray(fc_b), window)
        got = getattr(tw, name)(t(x), t(fc_w), t(fc_b), window)
        close(got, want)
        forms[name] = got.numpy()
    for name, got in forms.items():
        np.testing.assert_allclose(got, forms["w2ttfs_classifier"],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_w2ttfs_expand_is_one_hot_at_the_count():
    x = spikes(0, (2, 8, 8, 4))
    got = tw.w2ttfs_expand(t(x), 4)
    eq(got, jw.w2ttfs_expand(jnp.asarray(x), 4))
    assert got.shape[0] == 17
    eq(got.sum(dim=0), np.ones((2, 2, 2, 4)))
    eq(got.argmax(dim=0), tw.window_counts(t(x), 4))


@pytest.mark.parametrize("seed,window,rate", [(0, 2, 0.0), (1, 4, 1.0),
                                              (2, 2, 0.5), (3, 4, 0.1)])
def test_w2ttfs_reference_equals_wtfc_at_any_rate(seed, window, rate):
    x = spikes(seed, (2, 8, 8, 4), rate)
    ho = 8 // window
    fc_w = (0.1 * np.random.default_rng(seed).standard_normal(
        (ho * ho * 4, 10))).astype(np.float32)
    fc_b = np.zeros(10, np.float32)
    ref = tw.w2ttfs_reference(t(x), t(fc_w), t(fc_b), window)
    opt = tw.w2ttfs_classifier(t(x), t(fc_w), t(fc_b), window)
    np.testing.assert_allclose(ref.numpy(), opt.numpy(), rtol=1e-4,
                               atol=1e-4)
    cnt = tw.window_counts(t(x), window)
    assert int(cnt.min()) >= 0 and int(cnt.max()) <= window * window


# ----------------------------------------------------------- QK attention
@pytest.mark.parametrize("mode", ["or", "threshold"])
@pytest.mark.parametrize("threshold", [1.0, 4.0])
def test_qk_masks_and_attention_match_jax(mode, threshold):
    q = spikes(5, (2, 4, 16, 32), 0.1)
    k = spikes(6, (2, 4, 16, 32), 0.5)
    kw = dict(mode=mode, threshold=threshold)
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    for name, args in (("qk_token_mask", (q,)), ("qk_channel_mask", (q,)),
                       ("qk_token_attention", (q, k)),
                       ("qk_channel_attention", (q, k))):
        want = getattr(jqk, name)(*[jnp.asarray(a) for a in args], **kw)
        got = getattr(tqk, name)(*[t(a) for a in args], **kw)
        eq(got, want)
    out = tqk.qk_token_attention(t(q), t(k), mode="or")
    inactive = q.sum(-1) == 0
    assert not out.numpy()[inactive].any()
    eq(out.numpy()[~inactive], k[~inactive])
    assert tqk.qk_channel_attention(t(q), t(k)).shape == k.shape
    del jq, jk


def test_qk_channel_mask_gradient_matches_jax():
    """The threshold mode's surrogate gradient into Q (column sums)."""
    import jax

    q = spikes(7, (3, 16, 8), 0.2)
    g = np.random.default_rng(8).standard_normal((3, 1, 8)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a: jqk.qk_channel_mask(a, threshold=2.0),
                     jnp.asarray(q))
    (want,) = vjp(jnp.asarray(g))
    tq = t(q).requires_grad_(True)
    (got,) = torch.autograd.grad(tqk.qk_channel_mask(tq, threshold=2.0),
                                 tq, t(g))
    close(got, want)


@pytest.mark.parametrize("n", [17, 64, 130])
@pytest.mark.parametrize("causal", [False, True])
def test_spiking_self_attention_matches_jax(n, causal):
    """Q (K^T V) non-causal, and the chunked causal prefix form, against
    JAX and against the naive masked (Q K^T) V."""
    q, k, v = (spikes(n + i, (2, n, 16), 0.2) for i in range(3))
    got = tqk.spiking_self_attention(t(q), t(k), t(v), scale=0.5,
                                     causal=causal)
    want = jqk.spiking_self_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), scale=0.5,
                                      causal=causal)
    close(got, want)
    scores = np.einsum("bnd,bmd->bnm", q, k)
    if causal:
        scores = scores * np.tril(np.ones((n, n), np.float32))
    np.testing.assert_allclose(got.numpy(),
                               np.einsum("bnm,bme->bne", scores, v) * 0.5,
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ event stats
@pytest.mark.parametrize("shape,rate", [((300, 200), 0.1), ((2, 4, 70, 33),
                                                             0.3),
                                        ((256, 256), 0.0)])
def test_event_stats_match_jax(shape, rate):
    x = spikes(9, shape, rate)
    if len(shape) == 2 and shape[0] > 128:
        x[128:256] = 0.0                     # silent blocks to count
    want = jev.event_stats(jnp.asarray(x))
    got = tev.event_stats(t(x))
    for key in ("spike_rate", "total_spikes", "block_occupancy"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6,
                                                abs=0), key
    assert float(tev.block_occupancy(t(x), 64, 32)) == float(
        jev.block_occupancy(jnp.asarray(x), 64, 32))
    assert float(tev.synaptic_ops(t(x), 9)) == float(
        jev.synaptic_ops(jnp.asarray(x), 9))


# ----------------------------------------------------------- fp8 fake-quant
@pytest.mark.parametrize("variant", ["e4m3", "e5m2"])
def test_fp8_fake_quant_matches_jax(variant):
    """Values, overflow (e4m3 has no infinity: NaN past 464, as the
    reference's cast gives), subnormals and the straight-through gradient;
    binary spikes pass exactly."""
    rng = np.random.default_rng(10)
    x = np.concatenate([
        (rng.standard_normal(200) * 30).astype(np.float32),
        np.array([449.0, 464.0, -464.0, 465.0, 480.0, 1e-3, -1e-9, 57344.0,
                  60000.0, 1e5, np.inf], np.float32)])
    want = np.asarray(jquant.quantize_fp8(jnp.asarray(x), variant))
    tx = t(x).requires_grad_(True)
    got = tquant.quantize_fp8(tx, variant)
    eq(got.detach(), want)
    (grad,) = torch.autograd.grad(got.sum(), tx)
    eq(grad, np.ones_like(x))
    binary = spikes(11, (64,), 0.5)
    eq(tquant.quantize_fp8(t(binary), variant), binary)
    cfg = tquant.QuantConfig(enabled=True, mode=f"fp8_{variant}")
    eq(tquant.fake_quant(t(x[:200]), cfg),
       jquant.fake_quant(jnp.asarray(x[:200]),
                         jquant.QuantConfig(enabled=True,
                                            mode=f"fp8_{variant}")))


@pytest.mark.parametrize("mode", ["int", "fp8_e4m3"])
def test_quantize_tree_matches_jax(mode):
    rng = np.random.default_rng(12)
    tree = [{"w": rng.standard_normal((8, 4)).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32)},
            {"fc": {"w": rng.standard_normal((4, 3)).astype(np.float32)}}]
    jcfg = jquant.QuantConfig(enabled=True, mode=mode)
    tcfg = tquant.QuantConfig(enabled=True, mode=mode)
    want = jquant.quantize_tree(
        [{"w": jnp.asarray(tree[0]["w"]), "b": jnp.asarray(tree[0]["b"])},
         {"fc": {"w": jnp.asarray(tree[1]["fc"]["w"])}}], jcfg)
    got = tquant.quantize_tree(
        [{"w": t(tree[0]["w"]), "b": t(tree[0]["b"])},
         {"fc": {"w": t(tree[1]["fc"]["w"])}}], tcfg)
    eq(got[0]["w"], want[0]["w"])
    eq(got[0]["b"], want[0]["b"])
    eq(got[1]["fc"]["w"], want[1]["fc"]["w"])
    off = tquant.quantize_tree(tree, tquant.QuantConfig())
    assert off is tree
