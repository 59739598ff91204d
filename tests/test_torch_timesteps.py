"""The SNN CNNs at T > 1 on the CPU against the JAX package: the fused PE
kernel's LIF-state variant (with_state), the 2-D ``ops.fused_pe`` entry
with state, the multi-timestep ``ops.fused_pe_layer`` and its ``+grad``
chain, the T = 2 forward of the three archs, one folded KD step of
QKFResNet-11 at T = 2, the ``core.lif`` twins, and the dw kernel's
bit-packed operand (packed_in).

Inputs are numpy arrays made from a seed and handed to both frameworks.
The JAX side runs its Pallas kernels as its own tests run them on the CPU
(interpret mode); the port runs its kernels' plain versions. Tolerances:
spike maps, packed words and ``vld`` maps bit-equal (on these seeds no
membrane potential lies within an ulp of ``v_th``, where the order of the
f32 sums could decide the compare); ``v_next`` and logits at rtol 1e-5
with an absolute term of 1e-6 of the largest |value| (f32 sums in another
order; a value that cancels keeps the absolute error of its terms), as the
port's T = 1 tests hold f32 currents; gradients at rtol 1e-4 with the same
absolute term (the backward sums more terms); the KD step as in
``test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.core import kd as jkd
from repro.core import lif as jlif
from repro.data import synthetic as jdata
from repro.kernels.fused_pe import fused_pe as jax_fused_pe
from repro.kernels.packed import pack_spikes as jax_pack_spikes
from repro.kernels.spike_matmul import spike_matmul_dw as jax_dw
from repro.models import snn_cnn as jsnn
from repro.optim import sgd_init as j_sgd_init
from repro.optim.schedules import cosine_lr as j_cosine_lr
from repro_torch import convert
from repro_torch import ops as tops
from repro_torch.core import kd as tkd
from repro_torch.core import lif as tlif
from repro_torch.core.events import PackedSpikes
from repro_torch.kernels import _build
from repro_torch.kernels.fused_pe import fused_pe as torch_fused_pe
from repro_torch.kernels.fused_pe import fused_pe_layer as torch_fused_pe_layer
from repro_torch.kernels.packed import pack_spikes, unpack_spikes
from repro_torch.kernels.spike_matmul import spike_matmul_dw
from repro_torch.models import ann_cnn as tann
from repro_torch.models import snn_cnn as tsnn
from repro_torch.optim import cosine_lr as t_cosine_lr
from repro_torch.train import trainer
from repro_torch.train.trainer import make_kd_train_step
from test_torch_grad import _jax_ctx, jax_vjp, torch_vjp
from test_torch_packed import to_torch_ps
from test_torch_snn_cnn import assert_aux_equal, images, numpy_variables
from test_torch_train import (BATCH, assert_trees_close, t_numpy, teacher,
                              to_numpy, _jax_step)

RTOL = 1e-5
GRAD_RTOL = 1e-4


def assert_values(got, want, rtol=RTOL):
    """rtol with an absolute term of 1e-6 of the largest |value|."""
    want = np.asarray(want, np.float64)
    atol = 1e-6 * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol)


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def spikes_np(rng, shape, density=0.3):
    """Seeded 0/1 int8 spikes; rows 128-255 silent where there are any, so
    the block skip and the gated walks have a silent block to leave out."""
    x = (rng.random(shape) < density).astype(np.int8)
    if shape[-2] > 128:
        x[..., 128:256, :] = 0
    return x


def t(a):
    return torch.tensor(np.array(a))


# -------------------------------------------- K2 with_state: plain vs JAX
# (M, K, N): ragged in every dim, and one with two column tiles
STATE_SHAPES = [(200, 300, 130), (300, 257, 100)]
# (residual, q, packed x / residual / out, skip)
STATE_CASES = [
    ("f32", None, False, "dense"),
    (None, "row", False, "dense"),
    ("f32", "row", False, "gated"),
    ("f32", None, False, "two_level"),
    ("spikes", "row", True, "dense"),
    ("spikes", None, True, "gated"),
    ("spikes", "row", True, "two_level"),
]


@pytest.mark.parametrize("soft_reset,tau", [(False, 0.5), (True, 0.7)])
@pytest.mark.parametrize("case", range(len(STATE_CASES)))
def test_state_variant_matches_pallas(soft_reset, tau, case):
    """The stateful fused PE's plain version against JAX's fused_pe_pallas
    (interpret mode): v = tau v_prev (1 - s_prev) + cur, the reset from
    the pre-mask spike; spikes (or packed words), vld_next bit-equal,
    v_next within rtol 1e-5. The cases alternate between the shapes."""
    res, q_kind, packed, skip = STATE_CASES[case]
    m, k, n = STATE_SHAPES[(case + int(soft_reset)) % len(STATE_SHAPES)]
    rng = np.random.default_rng(100 + m)
    x = spikes_np(rng, (m, k), 0.2)
    w = (rng.standard_normal((k, n)) * 2.0 / np.sqrt(k)).astype(np.float32)
    b = (0.3 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    v = rng.standard_normal((m, n)).astype(np.float32)
    s = (rng.random((m, n)) < 0.5).astype(np.int8)
    r = None
    if res == "f32":
        r = (0.5 * rng.standard_normal((m, n))).astype(np.float32)
    elif res == "spikes":
        r = spikes_np(rng, (m, n), 0.3)
    q = (rng.random((m, 64)) < 0.02).astype(np.int8) if q_kind else None
    fmt = "packed" if packed else "dense"
    kw = dict(v_th=0.9, tau=tau, soft_reset=soft_reset, out_format=fmt,
              skip=skip)

    def j(a):
        return None if a is None else jnp.asarray(a)

    jx, jr, jq = j(x), j(r), j(q)
    tx, tr, tq = (None if a is None else t(a) for a in (x, r, q))
    if packed:
        jx = jax_pack_spikes(jx)
        tx = to_torch_ps(jx)
        if r is not None:
            jr = jax_pack_spikes(jr)
            tr = to_torch_ps(jr)
        if q is not None:
            jq = jax_pack_spikes(jq)
            tq = to_torch_ps(jq)
    jo = jax_fused_pe(jx, j(w), bias=j(b), residual=jr, q=jq, v_prev=j(v),
                      s_prev=j(s), **kw)
    spikes, vld, v_next = torch_fused_pe(
        tx, t(w), bias=t(b), residual=tr, q=tq, v_prev=t(v), s_prev=t(s),
        **kw)
    if packed:
        eq(spikes.words, jo.spikes.words)
        eq(spikes.vld_cnt, jo.spikes.vld_cnt)
    else:
        eq(spikes, jo.spikes)
    eq(vld, jo.vld_next)
    assert_values(v_next, jo.v_next)
    assert 0 < int(vld.sum()) < m * n


def test_state_hard_reset_zeroes_the_pre_mask_spikes():
    """A neuron that fired sits at exactly 0 after a hard reset, also where
    the QK mask kept its spike out of the output."""
    rng = np.random.default_rng(3)
    m, k, n = 130, 96, 70
    x = spikes_np(rng, (m, k), 0.3)
    w = (rng.standard_normal((k, n)) * 0.3).astype(np.float32)
    v = rng.standard_normal((m, n)).astype(np.float32)
    q = np.zeros((m, 32), np.int8)                 # every row masked
    spikes, _, v_next = torch_fused_pe(t(x), t(w), q=t(q), v_prev=t(v),
                                       s_prev=torch.zeros((m, n)))
    cur = x.astype(np.float32) @ w
    fired = (0.5 * v + cur) >= 1.0
    assert fired.any() and int(spikes.sum()) == 0
    assert float(v_next[torch.tensor(fired)].abs().max()) == 0.0


def test_state_refuses_what_the_kernel_does_not_take():
    w = torch.ones((8, 8))
    with pytest.raises(ValueError, match="no LIF state"):
        torch_fused_pe(torch.ones((4, 8)), w, v_prev=torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="s_prev needs v_prev"):
        torch_fused_pe(torch.ones((4, 8), dtype=torch.int8), w,
                       s_prev=torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="v_prev"):
        torch_fused_pe(torch.ones((4, 8), dtype=torch.int8), w,
                       v_prev=torch.zeros((4, 7)))


# --------------------------------------------- ops.fused_pe with the state
@pytest.mark.parametrize("policy", ["reference", "fused_dense",
                                    "fused_packed"])
@pytest.mark.parametrize("with_q", [False, True])
def test_ops_fused_pe_with_state_matches_jax(policy, with_q):
    rng = np.random.default_rng(21)
    m, k, n = 200, 150, 130
    x = spikes_np(rng, (m, k))
    w = (rng.standard_normal((k, n)) * 2.0 / np.sqrt(k)).astype(np.float32)
    b = (0.3 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    r = (0.5 * rng.standard_normal((m, n))).astype(np.float32)
    v = rng.standard_normal((m, n)).astype(np.float32)
    s = (rng.random((m, n)) < 0.5).astype(np.float32)
    q = (rng.random((m, 40)) < 0.02).astype(np.int8) if with_q else None
    jx, tx = jnp.asarray(x), t(x)
    if policy == "fused_packed":
        jx = jops.pack(jx, policy=policy)
        tx = tops.pack(tx, policy=policy)
    jo = jops.fused_pe(jx, jnp.asarray(w), bias=jnp.asarray(b),
                       residual=jnp.asarray(r),
                       q=None if q is None else jnp.asarray(q),
                       v_prev=jnp.asarray(v), s_prev=jnp.asarray(s),
                       policy=policy)
    to = tops.fused_pe(tx, t(w), bias=t(b), residual=t(r),
                       q=None if q is None else t(q), v_prev=t(v),
                       s_prev=t(s), policy=policy)
    eq(to.spikes.to_dense(), jo.spikes.to_dense())
    eq(to.vld_next, jo.vld_next)
    assert_values(to.v_next, jo.v_next)
    assert to.spikes.is_packed == (policy == "fused_packed")


# ----------------------------------------------- ops.fused_pe_layer, T = 3
LAYER_CASES = [(None, None), ("f32", "row"), ("spikes", None),
               (None, "heads")]


@pytest.mark.parametrize("policy", ["reference", "fused_dense",
                                    "fused_packed"])
@pytest.mark.parametrize("res,q_kind", LAYER_CASES)
def test_fused_pe_layer_three_steps_matches_jax(policy, res, q_kind):
    """The stateful scan: the carry is the pre-mask spike map, the QK mask
    gates outside it and the vld map is recounted on the masked map; a
    packed output is packed after the scan. Spikes and vld bit-equal to
    JAX's under the same policy."""
    rng = np.random.default_rng(31)
    tt, m, k, n = 3, 200, 150, 96
    x = spikes_np(rng, (tt, m, k), 0.25)
    w = (rng.standard_normal((k, n)) * 2.0 / np.sqrt(k)).astype(np.float32)
    b = (0.2 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    r = None
    if res == "f32":
        r = (0.5 * rng.standard_normal((tt, m, n))).astype(np.float32)
    elif res == "spikes":
        r = spikes_np(rng, (tt, m, n), 0.3)
    q = (rng.random((tt, m, n)) < 0.03).astype(np.int8) if q_kind else None
    heads = (4, 24) if q_kind == "heads" else None
    packed = policy == "fused_packed"

    def operands(pack, asarray, policy_mod):
        xs, rs, qs = asarray(x), None if r is None else asarray(r), \
            None if q is None else asarray(q)
        if packed:
            xs = pack(xs, policy=policy)
            qs = None if qs is None else pack(qs, policy=policy)
            if res == "spikes":
                rs = pack(rs, policy=policy)
        return xs, rs, qs

    jx, jr, jq = operands(jops.pack, jnp.asarray, jops)
    tx, tr, tq = operands(tops.pack, t, tops)
    jo = jops.fused_pe_layer(jx, jnp.asarray(w), bias=jnp.asarray(b),
                             residual=jr, q=jq, heads=heads, policy=policy)
    to = tops.fused_pe_layer(tx, t(w), bias=t(b), residual=tr, q=tq,
                             heads=heads, policy=policy)
    got, want = to.spikes.to_dense(), jo.spikes.to_dense()
    eq(got, want)
    eq(to.vld_next, jo.vld_next)
    if packed:
        eq(to.spikes.data, jo.spikes.data)
    assert 0 < int(got.sum()) < got.numel()


def test_fused_pe_layer_multistep_is_lif_multistep():
    """Without mask or residual the scan is ``core.lif.lif_multistep`` of
    the per-step currents (the reference test's twin)."""
    rng = np.random.default_rng(5)
    tt, m, k, n = 3, 96, 128, 64
    x = (rng.random((tt, m, k)) < 0.2).astype(np.int8)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    spikes, vld = torch_fused_pe_layer(t(x), t(w), bias=t(b))
    cur = torch.einsum("tmk,kn->tmn", t(x).float(), t(w)) + t(b)
    eq(spikes, tlif.lif_multistep(cur).to(torch.int8))
    assert tuple(vld.shape) == (tt, 1, 1)


# -------------------------------------------------- +grad against jax.vjp
JAX_POLICIES = [("reference+grad", False), ("fused_dense+grad", False),
                ("fused_dense+grad", True), ("fused_packed+grad", True)]
IDS = ["reference", "fused-jnp", "fused-pallas", "packed-pallas"]


def _grads_close(tg, jg):
    for a, c in zip(tg, jg):
        assert (a is None) == (c is None)
        if a is not None:
            want = np.asarray(c, np.float64)
            scale = float(np.abs(want).max()) if want.size else 0.0
            np.testing.assert_allclose(np.asarray(a, np.float64), want,
                                       rtol=GRAD_RTOL,
                                       atol=1e-6 * max(scale, 1e-30))


@pytest.mark.parametrize("policy,pallas", JAX_POLICIES, ids=IDS)
def test_grad_fused_pe_layer_three_steps_matches_jax(policy, pallas):
    """BPTT through both carries: T = 3 with an f32 residual and the QK
    mask, against ``jax.vjp`` of JAX's op in both of its executors."""
    rng = np.random.default_rng(41)
    tt, m, k, n = 3, 200, 150, 96
    x = spikes_np(rng, (tt, m, k), 0.25).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 2.0 / np.sqrt(k)).astype(np.float32)
    b = (0.2 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    r = (0.5 * rng.standard_normal((tt, m, n))).astype(np.float32)
    q = (rng.random((tt, m, n)) < 0.03).astype(np.float32)
    g = rng.standard_normal((tt, m, n)).astype(np.float32)

    def run(ops_mod):
        return lambda x_, w_, b_, r_, q_: ops_mod.fused_pe_layer(
            x_, w_, bias=b_, residual=r_, q=q_, policy=policy).spikes.data

    with _jax_ctx(pallas):
        jo, jg = jax_vjp(run(jops), [x, w, b, r, q], g)
    to, tg = torch_vjp(run(tops), [x, w, b, r, q], g)
    eq(to, jo)
    _grads_close(tg, jg)


@pytest.mark.parametrize("policy,pallas", JAX_POLICIES, ids=IDS)
@pytest.mark.parametrize("soft_reset", [False, True])
def test_grad_fused_pe_with_state_matches_jax(policy, pallas, soft_reset):
    """The 2-D entry with v_prev, s_prev and q under ``+grad``: the
    gradients into x, w, bias, residual, q, v_prev and s_prev, from
    cotangents on both the spikes and v_next."""
    rng = np.random.default_rng(51)
    m, k, n = 200, 150, 130
    x = spikes_np(rng, (m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 2.0 / np.sqrt(k)).astype(np.float32)
    b = (0.3 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    r = (0.5 * rng.standard_normal((m, n))).astype(np.float32)
    q = (rng.random((m, n)) < 0.004).astype(np.float32)
    v = rng.standard_normal((m, n)).astype(np.float32)
    s = (rng.random((m, n)) < 0.5).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    gv = rng.standard_normal((m, n)).astype(np.float32)

    def run(ops_mod, lif_mod, backend):
        cfg = lif_mod.LIFConfig(soft_reset=soft_reset)
        mix = backend(gv)

        def f(x_, w_, b_, r_, q_, v_, s_):
            out = ops_mod.fused_pe(x_, w_, bias=b_, residual=r_, q=q_,
                                   v_prev=v_, s_prev=s_, lif_cfg=cfg,
                                   policy=policy)
            # one output carrying both: v_next enters weighted by a fixed
            # map, so its cotangent is g * gv beside the spikes' g
            return out.spikes.data + out.v_next * mix
        return f

    args = [x, w, b, r, q, v, s]
    with _jax_ctx(pallas):
        jo, jg = jax_vjp(run(jops, jlif, jnp.asarray), args, g)
    to, tg = torch_vjp(run(tops, tlif, t), args, g)
    assert_values(to, jo)
    _grads_close(tg, jg)


# ------------------------------------------------ forward at T = 2, 3 archs
ARCHS = [("resnet11", 16), ("qkfresnet11", 16), ("vgg11", 32)]


@pytest.mark.parametrize("arch,size", ARCHS, ids=[a for a, _ in ARCHS])
@pytest.mark.parametrize("policy", ["fused_dense", "fused_packed"])
def test_forward_two_steps_matches_jax_reference(arch, size, policy):
    """The port's kernel paths at T = 2 against JAX's reference walk:
    logits at rtol 1e-5, per-layer spike counts equal."""
    common = dict(arch=arch, image_size=size, width_mult=0.125,
                  num_classes=10, timesteps=2)
    jcfg, tcfg = jsnn.SNNCNNConfig(**common), tsnn.SNNCNNConfig(**common)
    variables = numpy_variables(jcfg)
    fused = jsnn.fuse_model(jax.tree_util.tree_map(jnp.asarray, variables),
                            jcfg)
    x = images(size, seed=6)
    j_logits, _, j_aux = jsnn.forward(fused, jnp.asarray(x), jcfg,
                                      policy="reference")
    t_logits, _, t_aux = tsnn.forward(
        convert.fused_from_jax(to_numpy(fused), device="cpu"),
        torch.tensor(x), tcfg, policy=policy)
    assert_values(t_logits, j_logits)
    # the per-layer counts (the walks' other keys differ by branch)
    assert sorted(t_aux["rates"]) == sorted(j_aux["rates"])
    for name in t_aux["rates"]:
        assert float(t_aux["spikes"][name]) == float(j_aux["spikes"][name]), \
            name
    assert np.ptp(np.asarray(j_logits)) > 0.0


def test_forward_two_steps_fused_packed_aux_matches_jax():
    """The packed walk's whole ``aux`` at T = 2 (spike counts, rates, vld
    reuse and the spike bytes between kernels) against JAX's fused_packed
    walk (its Pallas kernels in interpret mode)."""
    common = dict(arch="qkfresnet11", image_size=16, width_mult=0.125,
                  num_classes=10, timesteps=2)
    jcfg, tcfg = jsnn.SNNCNNConfig(**common), tsnn.SNNCNNConfig(**common)
    fused = jsnn.fuse_model(jax.tree_util.tree_map(
        jnp.asarray, numpy_variables(jcfg)), jcfg)
    x = images(16, seed=7)
    j_logits, _, j_aux = jsnn.forward(fused, jnp.asarray(x), jcfg,
                                      policy="fused_packed")
    t_logits, _, t_aux = tsnn.forward(
        convert.fused_from_jax(to_numpy(fused), device="cpu"),
        torch.tensor(x), tcfg, policy="fused_packed")
    assert_values(t_logits, j_logits)
    assert_aux_equal(j_aux, t_aux)


@pytest.mark.parametrize("policy", ["auto", "auto_packed", "reference"])
def test_forward_two_steps_other_policies_equal_fused_dense(policy):
    """Every other policy runs at T = 2 too, with fused_dense's spikes."""
    cfg = tsnn.SNNCNNConfig(arch="qkfresnet11", image_size=16,
                            width_mult=0.125, timesteps=2)
    variables = convert.variables_from_jax(numpy_variables(
        jsnn.SNNCNNConfig(arch="qkfresnet11", image_size=16,
                          width_mult=0.125, timesteps=2)), device="cpu")
    fused = tsnn.fuse_model(variables, cfg)
    x = torch.tensor(images(16, seed=8))
    d_logits, _, d_aux = tsnn.forward(fused, x, cfg, policy="fused_dense")
    logits, _, aux = tsnn.forward(fused, x, cfg, policy=policy)
    assert_values(logits, d_logits)
    for name, val in d_aux["spikes"].items():
        assert float(aux["spikes"][name]) == float(val), name


# ------------------------------------------- one folded KD step at T = 2
@pytest.fixture(scope="module")
def jax_kd_step_two_timesteps():
    common = dict(arch="qkfresnet11", image_size=16, width_mult=0.125,
                  num_classes=10, bn_fold=True, timesteps=2)
    jcfg = jsnn.SNNCNNConfig(**common)
    variables = numpy_variables(jcfg)
    tcfg_j, _, tvar = teacher(16)
    step = _jax_step(jcfg, tcfg_j, tvar, jkd.KDConfig(alpha=0.7),
                     j_cosine_lr(0.1, 10))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    carry = (jvars["params"], j_sgd_init(jvars["params"]), jvars["state"])
    imgs, labels = jdata.SyntheticImageDataset(
        num_classes=10, image_size=16, seed=0).batch(0, BATCH)
    batch = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
    compiled = jax.jit(step).lower(carry, batch).compile(
        {"xla_backend_optimization_level": 0})
    carry, metrics, grads, aux = compiled(carry, batch)
    return (common, variables, (imgs, labels),
            to_numpy((carry, metrics, grads, aux["spikes"])))


@pytest.mark.parametrize("policy", ["fused_dense+grad", "fused_packed+grad"])
def test_folded_kd_step_two_timesteps_matches_jax(jax_kd_step_two_timesteps,
                                                  policy, monkeypatch):
    common, variables, (imgs, labels), j_out = jax_kd_step_two_timesteps
    j_carry, j_metrics, j_grads, j_spikes = j_out
    tcfg = tsnn.SNNCNNConfig(**common)
    _, tcfg_t, tvar = teacher(16)
    captured = {}

    def student(p, s, x, policy=None):
        out = tsnn.forward({"params": p, "state": s}, x, tcfg, train=True,
                           policy=policy)
        captured["aux"] = out[2]
        return out

    real_update = trainer.sgd_update

    def recording_update(grads, *args, **kw):
        captured["grads"] = grads
        return real_update(grads, *args, **kw)

    monkeypatch.setattr(trainer, "sgd_update", recording_update)
    step = make_kd_train_step(
        student, lambda tp, x: tann.apply(tp, x, tcfg_t)[0],
        convert.variables_from_jax(tvar, device="cpu"),
        kd=tkd.KDConfig(alpha=0.7), schedule=t_cosine_lr(0.1, 10),
        optimizer="sgd", policy=policy)
    tvars = convert.variables_from_jax(variables, device="cpu")
    j_opt = to_numpy(j_sgd_init(jax.tree_util.tree_map(
        jnp.asarray, variables["params"])))
    carry = (tvars["params"],
             convert.optimizer_state_from_jax(j_opt, device="cpu"),
             tvars["state"])
    carry, metrics = step(carry, {"images": torch.tensor(imgs),
                                  "labels": torch.tensor(labels)})
    for name, val in j_spikes.items():
        assert float(captured["aux"]["spikes"][name]) == float(val), name
    for key in ("loss", "ce", "kl"):
        assert float(metrics[key]) == pytest.approx(float(j_metrics[key]),
                                                    rel=RTOL), key
    assert_trees_close(t_numpy(captured["grads"]), j_grads, GRAD_RTOL,
                       "grads")
    assert_trees_close(t_numpy(carry[0]), j_carry[0], GRAD_RTOL, "params")


# ----------------------------------------------------- core.lif twins
def test_lif_single_step_matches_jax():
    rng = np.random.default_rng(61)
    cur = (1.0 + rng.standard_normal((64, 32))).astype(np.float32)
    vp = rng.standard_normal((64, 32)).astype(np.float32)
    for soft in (False, True):
        jcfg = jlif.LIFConfig(soft_reset=soft)
        tcfg = tlif.LIFConfig(soft_reset=soft)
        for v in (None, vp):
            js, jv = jlif.lif_single_step(
                jnp.asarray(cur), jcfg, None if v is None else jnp.asarray(v))
            ts, tv = tlif.lif_single_step(t(cur), tcfg,
                                          None if v is None else t(v))
            eq(ts, js)
            eq(tv, jv)


def test_lif_hard_reset_and_accumulation():
    """The reference's own cases: a fired neuron resets to 0; sub-threshold
    inputs accumulate until they fire (tau 1, no leak)."""
    s, v = tlif.lif_single_step(torch.tensor([2.0, 0.5]),
                                tlif.LIFConfig(v_th=1.0))
    eq(s, [1.0, 0.0])
    eq(v, [0.0, 0.5])
    spikes = tlif.lif_multistep(torch.full((4, 1), 0.4),
                                tlif.LIFConfig(tau=1.0, v_th=1.0))
    eq(spikes[:, 0], [0.0, 0.0, 1.0, 0.0])


@pytest.mark.parametrize("steps,v_th", [(1, 0.1), (4, 1.0), (8, 2.0)])
def test_lif_multistep_rate_and_total_match_jax(steps, v_th):
    rng = np.random.default_rng(steps)
    cur = rng.standard_normal((steps, 16, 8)).astype(np.float32)
    js = jlif.lif_multistep(jnp.asarray(cur), jlif.LIFConfig(v_th=v_th))
    ts = tlif.lif_multistep(t(cur), tlif.LIFConfig(v_th=v_th))
    eq(ts, js)
    assert float(tlif.spike_rate(ts)) == float(jlif.spike_rate(js))
    assert int(tlif.total_spikes(ts)) == int(jlif.total_spikes(js))
    assert tlif.total_spikes(ts).dtype == torch.int32
    assert 0.0 <= float(tlif.spike_rate(ts)) <= 1.0


def test_lif_multistep_gradient_matches_jax():
    rng = np.random.default_rng(62)
    cur = (0.8 + rng.standard_normal((3, 32, 16))).astype(np.float32)
    g = rng.standard_normal((3, 32, 16)).astype(np.float32)
    jo, jg = jax_vjp(lambda c: jlif.lif_multistep(c), [cur], g)
    to, tg = torch_vjp(lambda c: tlif.lif_multistep(c), [cur], g)
    eq(to, jo)
    _grads_close(tg, jg)


# ---------------------------------------------- K7 packed_in: plain vs JAX
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("skip", ["dense", "gated", "two_level"])
def test_dw_packed_operand_matches_jax(density, skip):
    """dw = xᵀ g over a packed x (the mirror of the reference's packed dw
    test, on the port's 128 x 128 grid): the plain version against JAX's
    spike_matmul_dw on the same packed operand, and bit-equal to the int8
    operand's dw."""
    rng = np.random.default_rng(71)
    m, k, n = 300, 200, 96
    x = spikes_np(rng, (m, k), density)
    g = rng.standard_normal((m, n)).astype(np.float32)
    jps = jax_pack_spikes(jnp.asarray(x))
    want = jax_dw(jps, jnp.asarray(g), skip=skip)
    ps = to_torch_ps(jps)
    got = spike_matmul_dw(ps, t(g), skip=skip)
    assert_values(got, want)
    assert torch.equal(got, spike_matmul_dw(t(x), t(g), skip=skip))
    assert torch.equal(got, spike_matmul_dw(pack_spikes(t(x)), t(g),
                                            skip=skip))


def test_dw_packed_operand_contract():
    g = torch.zeros((300, 8))
    x = torch.zeros((300, 200), dtype=torch.int8)
    with pytest.raises(ValueError, match="re-pack"):
        spike_matmul_dw(pack_spikes(x, block_m=128, block_k=64), g)
    ps = pack_spikes(torch.zeros((2, 300, 200), dtype=torch.int8))
    with pytest.raises(ValueError, match="do not chain"):
        spike_matmul_dw(PackedSpikes(ps.words, ps.vld_cnt, ps.shape), g)


def test_cpu_state_and_packed_dw_launch_no_kernel():
    """On CPU tensors the new variants run their plain versions and count
    no launch."""
    _build.reset_launches()
    x = torch.ones((3, 8, 8), dtype=torch.int8)
    torch_fused_pe_layer(x, torch.ones((8, 8)), out_format="packed")
    spike_matmul_dw(pack_spikes(x[0]), torch.ones((8, 4)), skip="gated")
    unpack_spikes(pack_spikes(x))
    assert all(v == 0 for v in _build.LAUNCHES.values())
