"""The modules of KD training on the CPU against the JAX package.

Inputs are numpy arrays made from a seed and handed to both frameworks.
Tolerances: values at rtol 1e-5 with atol 1e-6 * max|value| (f32 sums in
another order; a sum that cancels keeps the absolute error of its terms);
gradients at rtol 1e-4 with atol 1e-6 * max|grad| (the backward sums more
terms, in another order); spike maps equal, except where the membrane current lies
within 1e-4 of ``v_th`` (the order of the f32 sums may decide the compare
there). The surrogates and the KD loss are elementwise or short sums and
are held at rtol 1e-6 (with the same absolute term).

The JAX side runs its ops as its own tests run them on the CPU: the jnp
executor by default, and under ``force_pallas_backward`` the Pallas
kernels in interpret mode, so the port's one fused backward is held against
both of the reference's branches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.core import kd as jkd
from repro.core import quant as jquant
from repro.core import surrogate as jsurr
from repro.core.lif import LIFConfig as JLIFConfig
from repro.kernels.fused_pe import fused_pe as jax_fused_pe
from repro.kernels.qk_attention import qk_attention_fused as jax_qk_fused
from repro.kernels.qk_attention.qk_attention import qk_attention_pallas
from repro.kernels.spike_matmul import spike_matmul_dw as jax_dw
from repro.kernels.spike_matmul import spike_matmul_dx as jax_dx
from repro.kernels.spike_matmul.backward import (spike_matmul_dw_pallas,
                                                 spike_matmul_dx_pallas)
from repro.models import nn as jnn
from repro.ops.grad import force_pallas_backward
from repro_torch import ops as tops
from repro_torch.core import kd as tkd
from repro_torch.core import quant as tquant
from repro_torch.core import surrogate as tsurr
from repro_torch.core.lif import LIFConfig as TLIFConfig
from repro_torch.kernels import _build
from repro_torch.kernels.fused_pe import fused_pe as torch_fused_pe
from repro_torch.kernels.qk_attention import qk_attention_fused
from repro_torch.kernels.spike_matmul import spike_matmul_dw, spike_matmul_dx
from repro_torch.models import nn as tnn

RTOL = 1e-5
GRAD_RTOL = 1e-4
SURR_RTOL = 1e-6
NEAR_VTH = 1e-4
SURROGATES = ("atan", "sigmoid", "triangle", "rect")


def spikes_np(rng, shape, density=0.3, silent_rows=True):
    x = (rng.random(shape) < density).astype(np.float32)
    if silent_rows and shape[-2] > 128:
        x[..., 128:256, :] = 0.0
    return x


def assert_values(got, want, rtol=RTOL, atol=None):
    """rtol, with an absolute term of 1e-6 of the largest |value| unless
    ``atol`` is given: a sum that cancels to near zero keeps the absolute
    error of its terms."""
    want = np.asarray(want, np.float64)
    if atol is None:
        atol = 1e-6 * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol)


def assert_grad(got, want):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=GRAD_RTOL, atol=1e-6 * max(scale, 1e-30))


def assert_spikes(got, want, current, v_th=1.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    near = np.abs(np.asarray(current, np.float64) - v_th) < NEAR_VTH
    bad = (got != want) & ~near
    assert not bad.any(), f"{int(bad.sum())} spikes differ away from v_th"


def t(a):
    return torch.tensor(np.array(a))


def torch_vjp(fn, args, cot):
    """(outputs, grads) of ``fn`` at ``args`` (numpy arrays; None stays
    None) for the cotangent ``cot``, on the CPU."""
    ins = [None if a is None else t(a).requires_grad_(True) for a in args]
    out = fn(*ins)
    live = [x for x in ins if x is not None]
    grads = iter(torch.autograd.grad(out, live, t(cot), allow_unused=True))
    gs = [None if x is None else next(grads) for x in ins]
    # an input the output does not reach gets zeros, as jax.vjp gives
    gs = [g if g is not None or x is None else torch.zeros_like(x)
          for g, x in zip(gs, ins)]
    return out.detach().numpy(), [None if g is None else g.numpy()
                                  for g in gs]


def jax_vjp(fn, args, cot):
    live = [i for i, a in enumerate(args) if a is not None]

    def f(*xs):
        full = list(args)
        for i, x in zip(live, xs):
            full[i] = x
        return fn(*full)

    out, vjp = jax.vjp(f, *[jnp.asarray(args[i]) for i in live])
    grads = vjp(jnp.asarray(cot))
    gs = [None] * len(args)
    for i, g in zip(live, grads):
        gs[i] = np.asarray(g)
    return np.asarray(out), gs


# ---------------------------------------------------------------- surrogate
@pytest.mark.parametrize("surrogate", SURROGATES)
def test_surrogate_values_and_spike_gradient_match_jax(surrogate):
    rng = np.random.default_rng(0)
    v = rng.uniform(-1.5, 1.5, 20000).astype(np.float32)
    g = rng.standard_normal(v.shape).astype(np.float32)
    want = np.asarray(jsurr.surrogate_grad(jnp.asarray(v), surrogate, 2.0))
    got = tsurr.surrogate_grad(t(v), surrogate, 2.0).numpy()
    # sigmoid's s * (1 - s) turns the frameworks' one-ulp difference in
    # exp into up to ~2e-6 relative where s is near 1, so the absolute
    # term is 1e-6 of the surrogate's peak, as for gradients
    peak = 1e-6 * float(np.abs(want).max())
    assert_values(got, want, rtol=SURR_RTOL, atol=peak)
    out_t, (dv_t,) = torch_vjp(lambda x: tsurr.spike(x, surrogate, 2.0),
                               [v], g)
    out_j, (dv_j,) = jax_vjp(lambda x: jsurr.spike(x, surrogate, 2.0),
                             [v], g)
    np.testing.assert_array_equal(out_t, out_j)
    assert_values(dv_t, dv_j, rtol=SURR_RTOL,
                  atol=1e-6 * float(np.abs(dv_j).max()))


# ------------------------------------------------------------------ quant
def test_fake_quant_value_and_straight_through_gradient():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    g = rng.standard_normal(w.shape).astype(np.float32)
    for cfg_kw in (dict(enabled=True, bits=4), dict(enabled=True, bits=8,
                                                    per_channel=False)):
        jcfg, tcfg = jquant.QuantConfig(**cfg_kw), tquant.QuantConfig(**cfg_kw)
        out_t, (dw_t,) = torch_vjp(lambda x: tquant.fake_quant(x, tcfg),
                                   [w], g)
        out_j, (dw_j,) = jax_vjp(lambda x: jquant.fake_quant(x, jcfg),
                                 [w], g)
        np.testing.assert_array_equal(out_t, out_j)
        np.testing.assert_array_equal(dw_t, g)      # identity, exactly
        np.testing.assert_array_equal(dw_j, g)


# ----------------------------------------------------------------- BN, rsqrt
def test_rsqrt_is_correctly_rounded_and_within_an_ulp_of_jax():
    """``torch.rsqrt`` and XLA's CPU rsqrt are both not correctly rounded
    (XLA's comes from the host CPU's estimate instruction and a Newton
    step, so its last bit cannot be reproduced portably); the port's BN
    takes the root in f64 and rounds once. On 1e5 seeded values that is
    the correctly rounded result everywhere and within one ulp of JAX's."""
    rng = np.random.default_rng(2)
    v = rng.uniform(1e-3, 4.0, 100000).astype(np.float32)
    exact = (1.0 / np.sqrt(v.astype(np.float64))).astype(np.float32)
    got = tnn._rsqrt_rn(t(v)).numpy()
    np.testing.assert_array_equal(got, exact)
    jax_r = np.asarray(jax.lax.rsqrt(jnp.asarray(v)))
    ulps = np.abs(jax_r.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= 1


@pytest.mark.parametrize("train", [True, False])
def test_bn_apply_matches_jax(train):
    """Outputs and new running statistics. The batch mean and variance are
    reductions in another order (XLA splits them into a shape-dependent
    tree) and the rsqrt differs by at most an ulp, so the comparison is at
    rtol 2e-6 rather than bit for bit; the update rule and the biased
    variance are the reference's."""
    rng = np.random.default_rng(3)
    x = (0.7 * rng.standard_normal((4, 8, 8, 16)) + 0.3).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(16)).astype(np.float32)}
    s = {"mean": (0.1 * rng.standard_normal(16)).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    jy, js = jnn.bn_apply(jax.tree_util.tree_map(jnp.asarray, p),
                          jax.tree_util.tree_map(jnp.asarray, s),
                          jnp.asarray(x), train)
    ty, ts = tnn.bn_apply({k: t(v) for k, v in p.items()},
                          {k: t(v) for k, v in s.items()}, t(x), train)
    assert_values(ty.numpy(), jy, rtol=2e-6, atol=2e-6)
    for key in ("mean", "var"):
        assert_values(ts[key].numpy(), js[key], rtol=2e-6, atol=1e-7)
    # the reference's rule, not F.batch_norm's unbiased variance update
    xv = x.reshape(-1, 16).astype(np.float64)
    want_var = 0.9 * s["var"] + 0.1 * xv.var(axis=0) if train else s["var"]
    assert_values(ts["var"].numpy(), want_var, rtol=1e-5, atol=0.0)


# ------------------------------------------------------------------- KD loss
def test_kd_loss_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    s_logits = (3 * rng.standard_normal((32, 10))).astype(np.float32)
    t_logits = (3 * rng.standard_normal((32, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 32).astype(np.int32)
    jcfg, tcfg = jkd.KDConfig(alpha=0.7), tkd.KDConfig(alpha=0.7)
    (jl, jm), jg = jax.value_and_grad(
        lambda s: jkd.kd_loss(s, jnp.asarray(t_logits), jnp.asarray(labels),
                              jcfg), has_aux=True)(jnp.asarray(s_logits))
    st = t(s_logits).requires_grad_(True)
    tl, tm = tkd.kd_loss(st, t(t_logits), t(labels), tcfg)
    (tg,) = torch.autograd.grad(tl, st)
    tm = {key: v.detach() for key, v in tm.items()}
    for key in ("ce", "kl", "loss"):
        assert_values(float(tm[key]), float(jm[key]), rtol=SURR_RTOL,
                      atol=0.0)
    assert_values(tg.numpy(), jg, rtol=SURR_RTOL, atol=1e-7)


# ------------------------------------------------------- the three kernels
SHAPES = [(256, 256, 256), (300, 200, 150)]   # (M, N, K); the second ragged


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("surrogate", SURROGATES + (None,))
def test_plain_dx_matches_pallas(m, n, k, surrogate):
    rng = np.random.default_rng(5)
    g = rng.standard_normal((m, n)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    v = (1.0 + 0.5 * rng.standard_normal((m, n))).astype(np.float32)
    v_arg = None if surrogate is None else v
    surr = surrogate or "atan"
    if m % 128 == 0 and n % 128 == 0 and k % 128 == 0:
        jdx, jdv = spike_matmul_dx_pallas(
            jnp.asarray(g), jnp.asarray(w),
            None if v_arg is None else jnp.asarray(v_arg), surrogate=surr,
            alpha=2.0, v_th=1.0, interpret=True)
    else:
        jdx, jdv = jax_dx(jnp.asarray(g), jnp.asarray(w),
                          None if v_arg is None else jnp.asarray(v_arg),
                          surrogate=surr, alpha=2.0, v_th=1.0,
                          interpret=True)
    tdx, tdv = spike_matmul_dx(t(g), t(w), None if v_arg is None
                               else t(v_arg), surrogate=surr, alpha=2.0,
                               v_th=1.0)
    assert_grad(tdx.numpy(), jdx)
    assert_values(tdv.numpy(), jdv, rtol=SURR_RTOL, atol=0.0)


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
def test_plain_dw_matches_pallas(m, n, k, density):
    rng = np.random.default_rng(6)
    x = spikes_np(rng, (m, k), density)
    g = rng.standard_normal((m, n)).astype(np.float32)
    if m % 128 == 0 and n % 128 == 0 and k % 128 == 0:
        xi = jnp.asarray(x.astype(np.int8))
        from repro.core.events import block_count_map_2d as jcount

        jdw = spike_matmul_dw_pallas(xi, jnp.asarray(g),
                                     jcount(xi, 128, 128), interpret=True)
    else:
        jdw = jax_dw(jnp.asarray(x), jnp.asarray(g), interpret=True)
    tdw = spike_matmul_dw(t(x), t(g))
    assert_grad(tdw.numpy(), jdw)
    if density == 0.0:
        assert not tdw.any()


@pytest.mark.parametrize("rows,d", [(256, 256), (300, 200)])
@pytest.mark.parametrize("threshold", [1.0, 3.0])
def test_plain_qk_attention_matches_pallas(rows, d, threshold):
    rng = np.random.default_rng(7)
    q = spikes_np(rng, (rows, d), 0.01, silent_rows=False)
    k = spikes_np(rng, (rows, d), 0.3, silent_rows=False)
    if rows % 256 == 0:
        want = qk_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   block_n=256, threshold=threshold,
                                   interpret=True)
    else:
        want = jax_qk_fused(jnp.asarray(q[None]), jnp.asarray(k[None]),
                            threshold=threshold, interpret=True)[0]
    got = qk_attention_fused(t(q), t(k), threshold=threshold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got8 = qk_attention_fused(t(q).to(torch.int8), t(k).to(torch.int8),
                              threshold=threshold)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("with_q", [False, True])
def test_plain_fused_pe_current_matches_pallas(m, n, k, with_q):
    rng = np.random.default_rng(8)
    x = spikes_np(rng, (m, k))
    w = (rng.standard_normal((k, n)) * 2.0 / np.sqrt(k)).astype(np.float32)
    b = (0.6 + 0.4 * rng.standard_normal(n)).astype(np.float32)
    r = (0.5 * rng.standard_normal((m, n))).astype(np.float32)
    q = spikes_np(rng, (m, n), 0.002, silent_rows=False) if with_q else None
    jout = jax_fused_pe(jnp.asarray(x.astype(np.int8)), jnp.asarray(w),
                        bias=jnp.asarray(b), residual=jnp.asarray(r),
                        q=None if q is None else jnp.asarray(q),
                        emit_current=True, interpret=True)
    spk, _, cur = torch_fused_pe(t(x).to(torch.int8), t(w), bias=t(b),
                                 residual=t(r),
                                 q=None if q is None else t(q),
                                 emit_current=True)
    assert tuple(cur.shape) == (m, n)
    assert_values(cur.numpy(), jout.current, rtol=RTOL, atol=1e-5)
    assert_spikes(spk.numpy(), np.asarray(jout.spikes), jout.current)
    # the kernel's spikes are its own current thresholded, then masked
    own = cur >= 1.0
    if q is not None:
        own &= t(q).sum(dim=1, keepdim=True) >= 1.0
    assert torch.equal(spk, own.to(torch.int8))


# ----------------------------------------------------------- the +grad ops
JAX_POLICIES = [("reference+grad", False), ("fused_dense+grad", False),
                ("fused_dense+grad", True), ("fused_packed+grad", True)]
IDS = ["reference", "fused-jnp", "fused-pallas", "packed-pallas"]


def _jax_ctx(pallas):
    return force_pallas_backward() if pallas else _nullctx()


class _nullctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("policy,pallas", JAX_POLICIES, ids=IDS)
def test_grad_matmul_matches_jax(policy, pallas):
    rng = np.random.default_rng(9)
    x = spikes_np(rng, (2, 150, 200))
    w = rng.standard_normal((200, 130)).astype(np.float32)
    g = rng.standard_normal((2, 150, 130)).astype(np.float32)
    with _jax_ctx(pallas):
        jo, jg = jax_vjp(lambda a, b: jops.matmul(a, b, policy=policy),
                         [x, w], g)
    to, tg = torch_vjp(lambda a, b: tops.matmul(a, b, policy=policy),
                       [x, w], g)
    assert_values(to, jo)
    for a, b in zip(tg, jg):
        assert_grad(a, b)


@pytest.mark.parametrize("policy,pallas", JAX_POLICIES[:2], ids=IDS[:2])
@pytest.mark.parametrize("surrogate", SURROGATES)
def test_grad_lif_matches_jax(policy, pallas, surrogate):
    rng = np.random.default_rng(10)
    cur = (1.0 + 0.6 * rng.standard_normal((64, 48))).astype(np.float32)
    vp = (0.5 * rng.standard_normal((64, 48))).astype(np.float32)
    sp = (rng.random((64, 48)) < 0.3).astype(np.float32)
    gs = rng.standard_normal((64, 48)).astype(np.float32)
    gv = rng.standard_normal((64, 48)).astype(np.float32)
    jcfg = JLIFConfig(surrogate=surrogate)
    tcfg = TLIFConfig(surrogate=surrogate)
    outs = {}
    for name, lif, cfg, vjp in (("jax", jops.lif, jcfg, jax_vjp),
                                ("torch", tops.lif, tcfg, torch_vjp)):
        for which, cot in ((0, gs), (1, gv)):
            outs[name, which] = vjp(
                lambda c, v, s, lif=lif, cfg=cfg, which=which: lif(
                    c, v, s, lif_cfg=cfg, policy=policy)[which],
                [cur, vp, sp], cot)
    for which in (0, 1):
        (to, tg), (jo, jg) = outs["torch", which], outs["jax", which]
        assert_values(to, jo)
        for a, b in zip(tg, jg):
            assert_grad(a, b)


def _pe_args(rng, m=200, k=150, n=130):
    x = spikes_np(rng, (m, k))
    w = (rng.standard_normal((k, n)) * 2.0 / np.sqrt(k)).astype(np.float32)
    b = (0.6 + 0.4 * rng.standard_normal(n)).astype(np.float32)
    r = (0.5 * rng.standard_normal((m, n))).astype(np.float32)
    q = spikes_np(rng, (m, n), 0.004, silent_rows=False)
    g = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, b, r, q, g


@pytest.mark.parametrize("policy,pallas", JAX_POLICIES, ids=IDS)
@pytest.mark.parametrize("with_q", [False, True])
def test_grad_fused_pe_matches_jax(policy, pallas, with_q):
    rng = np.random.default_rng(11)
    x, w, b, r, q, g = _pe_args(rng)
    q = q if with_q else None

    def run(ops_mod, cfg):
        return lambda x_, w_, b_, r_, q_: ops_mod.fused_pe(
            x_, w_, bias=b_, residual=r_, q=q_, lif_cfg=cfg,
            policy=policy).spikes.data

    with _jax_ctx(pallas):
        jo, jg = jax_vjp(run(jops, JLIFConfig()), [x, w, b, r, q], g)
    to, tg = torch_vjp(run(tops, TLIFConfig()), [x, w, b, r, q], g)
    cur = x @ w + b + r
    assert_spikes(to, jo, cur)
    for a, c in zip(tg, jg):
        assert (a is None) == (c is None)
        if a is not None:
            assert_grad(a, c)


@pytest.mark.parametrize("policy,pallas", JAX_POLICIES, ids=IDS)
def test_grad_fused_pe_layer_matches_jax(policy, pallas):
    """T=1 with the QK mask and an f32 residual (the folded QKFormer K pass
    and a shortcut pass in one)."""
    rng = np.random.default_rng(12)
    x, w, b, r, q, g = _pe_args(rng)

    def run(ops_mod, cfg):
        return lambda x_, w_, b_, r_, q_: ops_mod.fused_pe_layer(
            x_[None], w_, bias=b_, residual=r_[None], q=q_[None],
            qk_threshold=1.0, lif_cfg=cfg, policy=policy).spikes.data[0]

    with _jax_ctx(pallas):
        jo, jg = jax_vjp(run(jops, JLIFConfig()), [x, w, b, r, q], g)
    to, tg = torch_vjp(run(tops, TLIFConfig()), [x, w, b, r, q], g)
    assert_spikes(to, jo, x @ w + b + r)
    for a, c in zip(tg, jg):
        assert_grad(a, c)


@pytest.mark.parametrize("policy,pallas", JAX_POLICIES[:2], ids=IDS[:2])
@pytest.mark.parametrize("mode", ["threshold", "or"])
def test_grad_qk_mask_matches_jax(policy, pallas, mode):
    rng = np.random.default_rng(13)
    q = spikes_np(rng, (2, 64, 32), 0.03, silent_rows=False)
    k = spikes_np(rng, (2, 64, 32), 0.3, silent_rows=False)
    g = rng.standard_normal(q.shape).astype(np.float32)

    def run(ops_mod):
        return lambda q_, k_: ops_mod.qk_mask(q_, k_, mode=mode,
                                              policy=policy).data

    jo, jg = jax_vjp(run(jops), [q, k], g)
    to, tg = torch_vjp(run(tops), [q, k], g)
    np.testing.assert_array_equal(to, jo)
    for a, c in zip(tg, jg):
        assert_grad(a, c)
    if mode == "or":
        assert not np.asarray(tg[0]).any()


@pytest.mark.parametrize("policy,pallas", JAX_POLICIES[:2], ids=IDS[:2])
def test_grad_w2ttfs_head_matches_jax(policy, pallas):
    rng = np.random.default_rng(14)
    s = spikes_np(rng, (4, 4, 4, 32), 0.4, silent_rows=False)
    fc_w = rng.standard_normal((32, 10)).astype(np.float32)
    fc_b = rng.standard_normal(10).astype(np.float32)
    g = rng.standard_normal((4, 10)).astype(np.float32)

    def run(ops_mod):
        return lambda s_, w_, b_: ops_mod.w2ttfs_head(s_, w_, b_, window=4,
                                                      policy=policy)

    jo, jg = jax_vjp(run(jops), [s, fc_w, fc_b], g)
    to, tg = torch_vjp(run(tops), [s, fc_w, fc_b], g)
    assert_values(to, jo)
    for a, c in zip(tg, jg):
        assert_grad(a, c)


@pytest.mark.parametrize("policy", ["reference+grad", "fused_dense+grad"])
@pytest.mark.parametrize("op", ["im2col", "pool"])
def test_grad_data_movement_matches_jax(policy, op):
    rng = np.random.default_rng(15)
    spatial = (2, 8, 8, 16)
    x = spikes_np(rng, (1, 128, 16), 0.3, silent_rows=False)

    def run(ops_mod):
        if op == "im2col":
            return lambda x_: ops_mod.im2col(x_, spatial, 3, 3, 2, t=1,
                                             policy=policy)[0].data
        return lambda x_: ops_mod.pool(x_, spatial, t=1,
                                       policy=policy)[0].data

    out = run(tops)(t(x))
    g = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    jo, (jg,) = jax_vjp(run(jops), [x], g)
    to, (tg,) = torch_vjp(run(tops), [x], g)
    np.testing.assert_array_equal(to, jo)
    assert_grad(tg, jg)


def test_cpu_grad_ops_launch_no_kernel():
    """On CPU tensors the fused modes run the wrappers' plain versions."""
    rng = np.random.default_rng(16)
    x, w, b, r, q, g = _pe_args(rng, 64, 40, 30)
    _build.reset_launches()
    torch_vjp(lambda x_, w_, b_, r_, q_: tops.fused_pe(
        x_, w_, bias=b_, residual=r_, q=q_,
        policy="fused_packed+grad").spikes.data, [x, w, b, r, q], g)
    assert not any(_build.LAUNCHES.values())
