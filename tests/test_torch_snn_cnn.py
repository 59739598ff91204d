"""The port's deployed SNN CNNs against the JAX package, at test size.

Both packages get the same variables, made from a seed with numpy in the
layout of the reference's ``init`` and carried to the port by
``repro_torch.convert``. Every BN beta is 0.5, so that no layer of a random
net goes silent and the checks are not vacuous. Logits match at rtol 1e-5,
atol 1e-5 (f32 sums in another order), and ``aux`` has the same keys and
the same values: per-layer spike counts, rates, ``vld_reused`` and spike
bytes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import snn_cnn as jsnn
from repro_torch import convert
from repro_torch.models import snn_cnn as tsnn

RTOL = ATOL = 1e-5
# (arch, image size): the ResNets at 16x16; VGG-11 needs 32x32, where its
# last layer still fires at this width
ARCHS = [("resnet11", 16), ("qkfresnet11", 16), ("vgg11", 32)]


def cfgs(arch, size, **kw):
    common = dict(arch=arch, image_size=size, width_mult=0.125,
                  num_classes=10, **kw)
    return jsnn.SNNCNNConfig(**common), tsnn.SNNCNNConfig(**common)


def numpy_variables(cfg, seed=0):
    """Seeded numpy variables in the tree of ``jsnn.init``: He-normal conv
    weights, Glorot-uniform linear weights, zero FC bias, and BN statistics
    near the identity with beta = 0.5."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jsnn.init(jax.random.PRNGKey(0), cfg))

    def leaf(path, sds):
        keys = [getattr(k, "key", None) for k in path]
        shape, name = sds.shape, keys[-1]
        if name == "w" and len(shape) == 4:
            fan_in = shape[0] * shape[1] * shape[2]
            return rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        if name == "w":
            lim = np.sqrt(6.0 / (shape[0] + shape[1]))
            return rng.uniform(-lim, lim, shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(shape)
        if name == "mean":
            return 0.1 * rng.standard_normal(shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        if name == "bias" and str(keys[-2]).startswith("bn"):
            return np.full(shape, 0.5)
        return np.zeros(shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, torch cfg, numpy variables, jax fused list)."""
    out = {}
    for arch, size in ARCHS:
        jcfg, tcfg = cfgs(arch, size)
        variables = numpy_variables(jcfg)
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)
        out[arch] = (jcfg, tcfg, variables, jsnn.fuse_model(jvars, jcfg))
    return out


def images(size, batch=2, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(batch, size, size, 3)).astype(np.float32)


def as_float(v):
    return float(np.asarray(v)) if not isinstance(v, torch.Tensor) \
        else float(v)


def assert_aux_equal(j_aux, t_aux):
    assert sorted(j_aux) == sorted(t_aux)
    for key in ("spikes", "rates"):
        assert sorted(j_aux[key]) == sorted(t_aux[key]), key
        for name in j_aux[key]:
            assert as_float(t_aux[key][name]) == pytest.approx(
                as_float(j_aux[key][name]), rel=1e-6, abs=0), (key, name)
    for key in ("vld_reused", "spike_hbm_bytes", "spike_hbm_packed_bytes",
                "spike_hbm_dense_bytes"):
        if key in j_aux:
            assert int(t_aux[key]) == int(j_aux[key]), key
    for key in ("total_spikes", "active_frac"):
        assert as_float(t_aux[key]) == pytest.approx(as_float(j_aux[key]),
                                                     rel=1e-6), key


# ------------------------------------------------------------ build_layers
@pytest.mark.parametrize("arch", ["vgg11", "resnet11", "qkfresnet11"])
@pytest.mark.parametrize("width,size,qk_blocks", [(0.125, 16, 1),
                                                  (1.0, 32, 2)])
def test_build_layers_equal(arch, width, size, qk_blocks):
    common = dict(arch=arch, width_mult=width, image_size=size,
                  qk_blocks=qk_blocks)
    assert (tsnn.build_layers(tsnn.SNNCNNConfig(**common))
            == jsnn.build_layers(jsnn.SNNCNNConfig(**common)))


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown snn-cnn arch"):
        tsnn.build_layers(tsnn.SNNCNNConfig(arch="alexnet"))


# -------------------------------------------------------------- fuse_model
@pytest.mark.parametrize("arch,quant", [("resnet11", False),
                                        ("qkfresnet11", False),
                                        ("vgg11", False),
                                        ("qkfresnet11", True)])
def test_fuse_model_matches_jax(models, arch, quant):
    jcfg, tcfg, variables, fused = models[arch]
    if quant:
        jcfg = dataclasses.replace(jcfg, quant=dataclasses.replace(
            jcfg.quant, enabled=True))
        tcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(
            tcfg.quant, enabled=True))
        fused = jsnn.fuse_model(jax.tree_util.tree_map(jnp.asarray,
                                                       variables), jcfg)
    want = to_numpy(fused)
    got = tsnn.fuse_model(convert.variables_from_jax(variables,
                                                     device="cpu"), tcfg)
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    assert w_def == g_def
    for w, g in zip(w_leaves, g_leaves):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)


def test_init_layout_matches_jax():
    """The port's own init draws other numbers but builds the same tree of
    shapes, which ``fuse_model`` and ``forward`` accept."""
    jcfg, tcfg = cfgs("qkfresnet11", 16)
    want = jax.eval_shape(lambda: jsnn.init(jax.random.PRNGKey(0), jcfg))
    got = tsnn.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    assert w_def == g_def
    assert [tuple(w.shape) for w in w_leaves] == \
        [tuple(g.shape) for g in g_leaves]
    logits, state, _ = tsnn.forward(tsnn.fuse_model(got, tcfg),
                                    torch.tensor(images(16)), tcfg,
                                    policy="fused_dense")
    assert state is None and logits.shape == (2, 10)
    assert bool(torch.isfinite(logits).all())


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("arch,size", ARCHS)
@pytest.mark.parametrize("policy", ["reference", "fused_dense",
                                    "fused_packed"])
def test_forward_matches_jax(models, arch, size, policy):
    jcfg, tcfg, _, fused = models[arch]
    x = images(size)
    j_logits, j_state, j_aux = jsnn.forward(fused, jnp.asarray(x), jcfg,
                                            policy=policy)
    t_fused = convert.fused_from_jax(to_numpy(fused), device="cpu")
    t_logits, t_state, t_aux = tsnn.forward(t_fused, torch.tensor(x), tcfg,
                                            policy=policy)
    assert j_state is None and t_state is None
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=RTOL, atol=ATOL)
    assert_aux_equal(j_aux, t_aux)
    last = sorted(t_aux["rates"], key=lambda k: int(k[len("layer"):]))[-1]
    assert float(t_aux["rates"][last]) > 0.0     # not a silent net
    assert np.ptp(np.asarray(j_logits)) > 0.0


def test_fused_dense_matches_jax_reference(models):
    """Across policies too: the port's kernel path against the JAX
    reference path, logits and per-layer spike counts."""
    jcfg, tcfg, _, fused = models["qkfresnet11"]
    x = images(16, seed=1)
    j_logits, _, j_aux = jsnn.forward(fused, jnp.asarray(x), jcfg,
                                      policy="reference")
    t_logits, _, t_aux = tsnn.forward(
        convert.fused_from_jax(to_numpy(fused), device="cpu"),
        torch.tensor(x), tcfg, policy="fused_dense")
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=RTOL, atol=ATOL)
    for name in t_aux["rates"]:
        assert float(t_aux["spikes"][name]) == float(j_aux["spikes"][name])


@pytest.mark.parametrize("arch,size", ARCHS)
def test_fused_packed_equals_fused_dense(models, arch, size):
    """The packed format changes the bytes, not the spikes: the port's
    fused_packed logits and per-layer spike counts equal its fused_dense
    ones exactly, and the packed spike maps ship about 1/8 of the int8
    bytes."""
    _, tcfg, _, fused = models[arch]
    t_fused = convert.fused_from_jax(to_numpy(fused), device="cpu")
    x = torch.tensor(images(size, seed=4))
    d_logits, _, d_aux = tsnn.forward(t_fused, x, tcfg, policy="fused_dense")
    p_logits, _, p_aux = tsnn.forward(t_fused, x, tcfg, policy="fused_packed")
    assert torch.equal(p_logits, d_logits)
    assert sorted(p_aux["spikes"]) == sorted(d_aux["spikes"])
    for name in d_aux["spikes"]:
        assert float(p_aux["spikes"][name]) == float(d_aux["spikes"][name])
    assert p_aux["spike_hbm_bytes"] == p_aux["spike_hbm_packed_bytes"]
    assert 7 * p_aux["spike_hbm_packed_bytes"] < \
        p_aux["spike_hbm_dense_bytes"] < 9 * p_aux["spike_hbm_packed_bytes"]


def test_reference_multi_timestep_matches_jax(models):
    """The reference walk carries LIF state over T > 1, as JAX does."""
    jcfg, tcfg, _, fused = models["resnet11"]
    jcfg = dataclasses.replace(jcfg, timesteps=2)
    tcfg = dataclasses.replace(tcfg, timesteps=2)
    x = images(16, seed=2)
    j_logits, _, j_aux = jsnn.forward(fused, jnp.asarray(x), jcfg,
                                      policy="reference")
    t_logits, _, t_aux = tsnn.forward(
        convert.fused_from_jax(to_numpy(fused), device="cpu"),
        torch.tensor(x), tcfg, policy="reference")
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=RTOL, atol=ATOL)
    assert_aux_equal(j_aux, t_aux)


def test_avgpool_head_matches_jax(models):
    jcfg, tcfg, _, fused = models["resnet11"]
    jcfg = dataclasses.replace(jcfg, head="avgpool")
    tcfg = dataclasses.replace(tcfg, head="avgpool")
    x = images(16, seed=3)
    j_logits, _, _ = jsnn.forward(fused, jnp.asarray(x), jcfg,
                                  policy="reference")
    t_logits, _, _ = tsnn.forward(
        convert.fused_from_jax(to_numpy(fused), device="cpu"),
        torch.tensor(x), tcfg, policy="reference")
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=RTOL, atol=ATOL)
