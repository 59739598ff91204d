"""The byte-skip ladder and the roofline autotuner of the port against the
JAX package on the CPU (the twin of ``tests/test_sparsity_adaptive.py`` and
of the gated cases of ``tests/test_grad_backward.py``).

Inputs are numpy arrays made from a seed and handed to both frameworks;
JAX's Pallas kernels run in interpret mode, as its own tests run them, and
the port's wrappers run their plain versions (CPU tensors).

  * ``compact_kmap`` and ``PackedSpikes.with_occ`` are bit-equal;
  * the gated and two-level spike matmul, fused PE and dw equal JAX's
    kernels for int8 and packed x, across silent-block fractions and both
    block widths the tuner can plan (currents at rtol 1e-5, atol 1e-5: the
    f32 sums run in another order; spikes equal away from v_th);
  * the cost model's traffic arithmetic equals JAX's exactly, and the
    tuner, handed JAX's TPU constants, returns JAX's plans;
  * ``forward(policy="auto" | "auto_packed")`` of the three archs matches
    JAX's, and with every plan forced to a gated route (and a 256-wide
    tile where N allows) equals the port's fused forward;
  * one ``auto+grad`` KD step matches JAX's loss and gradients at the
    tolerances of ``tests/test_torch_train.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import kd as jkd
from repro.data import synthetic as jdata
from repro.kernels.fused_pe import fused_pe as jax_fused_pe
from repro.kernels.packed import pack_spikes as jax_pack_spikes
from repro.kernels.spike_matmul import spike_matmul as jax_spike_matmul
from repro.kernels.spike_matmul import spike_matmul_dw as jax_spike_matmul_dw
from repro.launch import roofline as jroof
from repro.models import ann_cnn as jann
from repro.models import snn_cnn as jsnn
from repro.ops import autotune as jtune
from repro.optim import sgd_init as j_sgd_init
from repro.optim import sgd_update as j_sgd_update
from repro.optim.schedules import cosine_lr as j_cosine_lr
from repro_torch import convert, ops
from repro_torch.core import events as tev
from repro_torch.core import kd as tkd
from repro_torch.kernels.fused_pe import fused_pe
from repro_torch.kernels.spike_matmul import spike_matmul, spike_matmul_dw
from repro_torch.launch import roofline as troof
from repro_torch.models import ann_cnn as tann
from repro_torch.models import snn_cnn as tsnn
from repro_torch.ops import autotune as ttune
from repro_torch.optim import cosine_lr as t_cosine_lr
from repro_torch.train import trainer
from repro_torch.train.trainer import (make_kd_train_step,
                                       observe_train_sparsity)
from test_torch_snn_cnn import ARCHS, assert_aux_equal, cfgs, numpy_variables
from test_torch_train import assert_trees_close, t_numpy, teacher

RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-4
NEAR_VTH = 1e-4
SILENT = [0.0, 0.5, 0.9, 1.0]
SKIPS = ["gated", "two_level"]
# JAX's cost-model constants (a TPU v5e's), handed to the port's tuner
TPU = troof.CostModel(jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.LAUNCH_OVERHEAD_S,
                      jroof.GATING_OVERHEAD_S, jroof.SUBTILE_MXU_EFF)


def gated_np(rng, m, k, silent, block_k, density=0.3):
    """0/1 int8 spikes whose (128, block_k) blocks are silent with
    probability ``silent`` (row block 0 wholly silent when ``silent`` > 0,
    so nact = 0 there), with the 32-column stripes (s + row block) % 3 == 0
    silent inside every block: clustered empty stripes for two_level."""
    x = rng.random((m, k)) < density
    gm, gk = -(-m // 128), -(-k // block_k)
    keep = rng.random((gm, gk)) >= silent
    if silent > 0:
        keep[0] = False
    stripes = (np.arange(-(-k // 32))[None, :]
               + np.arange(gm)[:, None]) % 3 != 0
    rows, cols = np.arange(m) // 128, np.arange(k)
    x &= keep[rows][:, cols // block_k] & stripes[rows][:, cols // 32]
    return x.astype(np.int8)


def to_torch_ps(jps):
    """A JAX PackedSpikes as the port's (same words and maps)."""
    return tev.PackedSpikes(
        torch.tensor(np.array(jps.words)), torch.tensor(np.array(jps.vld_cnt)),
        tuple(jps.shape), jps.block_m, jps.block_k,
        None if jps.occ is None else torch.tensor(np.array(jps.occ)))


def eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- event maps
@pytest.mark.parametrize("seed,gm,gk,silent", [(0, 7, 9, 0.5), (1, 4, 1, 0.9),
                                               (2, 16, 36, 0.0),
                                               (3, 5, 18, 1.0)])
def test_compact_kmap_bit_equal(seed, gm, gk, silent):
    rng = np.random.default_rng(seed)
    vld = np.where(rng.random((gm, gk)) < silent, 0,
                   rng.integers(1, 500, (gm, gk))).astype(np.int32)
    vld[0] = 0                              # a fully silent row -> block 0
    nact, kmap = tev.compact_kmap(torch.tensor(vld))
    j_nact, j_kmap = jev.compact_kmap(jnp.asarray(vld))
    eq(nact, j_nact)
    eq(kmap, j_kmap)
    assert nact.dtype == kmap.dtype == torch.int32


@pytest.mark.parametrize("block_k", [128, 256])
def test_with_occ_bit_equal(block_k):
    x = gated_np(np.random.default_rng(4), 300, 512, 0.5, block_k)
    jps = jev.pack_spikes_ref(jnp.asarray(x), block_k=block_k)
    tps = tev.pack_spikes_ref(torch.tensor(x), block_k=block_k)
    assert tps.occ is None and tps.with_occ().with_occ().occ is not None
    eq(tps.with_occ().occ, jps.with_occ().occ)


# ----------------------------------------------------- gated spike matmul
MATMUL_CASES = [(128, 128, s) for s in SILENT] + [(256, 256, 0.5),
                                                  (256, 128, 0.9),
                                                  (128, 256, 0.5)]


@pytest.mark.parametrize("block_k,block_n,silent", MATMUL_CASES)
@pytest.mark.parametrize("skip", SKIPS)
@pytest.mark.parametrize("packed", [False, True])
def test_gated_spike_matmul_matches_jax(block_k, block_n, silent, skip,
                                        packed):
    m, k, n = 260, 500, 256
    rng = np.random.default_rng([block_k, block_n, int(silent * 10),
                                 len(skip), int(packed)])
    x = gated_np(rng, m, k, silent, block_k)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    blocks = dict(block_n=block_n, block_k=block_k)
    if packed:
        jx = jax_pack_spikes(jnp.asarray(x), block_k=block_k)
        tx = to_torch_ps(jx)
    else:
        jx, tx = jnp.asarray(x), torch.tensor(x)
    want = jax_spike_matmul(jx, jnp.asarray(w), skip=skip, block_m=128,
                            **blocks)
    got = spike_matmul(tx, torch.tensor(w), skip=skip, **blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    dense = spike_matmul(tx, torch.tensor(w), **blocks)
    assert torch.equal(got, dense)            # the skip changes no bit


# -------------------------------------------------------- gated fused PE
FUSED_CASES = [
    # (packed in/out, block_k, block_n, silent)
    (False, 128, 128, 0.5), (False, 128, 128, 1.0), (False, 256, 256, 0.9),
    (True, 128, 128, 0.5), (True, 256, 256, 0.5), (True, 128, 256, 0.0),
]


@pytest.mark.parametrize("packed,block_k,block_n,silent", FUSED_CASES)
@pytest.mark.parametrize("skip", SKIPS)
def test_gated_fused_pe_matches_jax(packed, block_k, block_n, silent, skip):
    """Residual (f32 with int8 x, packed shortcut with packed x), the
    whole-row Q mask and, for int8, the emitted current."""
    m, k, n = 260, 512, 256
    rng = np.random.default_rng([block_k, block_n, int(silent * 10),
                                 len(skip), int(packed)])
    x = gated_np(rng, m, k, silent, block_k)
    w = (rng.standard_normal((k, n)) * (4.0 / np.sqrt(k))).astype(np.float32)
    b = (0.6 + 0.4 * rng.standard_normal(n)).astype(np.float32)
    q = (rng.random((m, n)) < 0.01).astype(np.int8)
    fmt = "packed" if packed else "dense"
    kw = dict(block_n=block_n, block_k=block_k, skip=skip, out_format=fmt)
    if packed:
        r = (rng.random((m, n)) < 0.3).astype(np.int8)
        jx = jax_pack_spikes(jnp.asarray(x), block_k=block_k)
        jr = jax_pack_spikes(jnp.asarray(r), block_k=block_n)
        jq = jax_pack_spikes(jnp.asarray(q))
        targs = (to_torch_ps(jx), to_torch_ps(jr), to_torch_ps(jq))
        jargs = (jx, jr, jq)
    else:
        r = (0.5 * rng.standard_normal((m, n))).astype(np.float32)
        jargs = (jnp.asarray(x), jnp.asarray(r), jnp.asarray(q))
        targs = (torch.tensor(x), torch.tensor(r), torch.tensor(q))
        kw["emit_current"] = True
    j = jax_fused_pe(jargs[0], jnp.asarray(w), bias=jnp.asarray(b),
                     residual=jargs[1], q=jargs[2], block_m=128, **kw)
    out = fused_pe(targs[0], torch.tensor(w), bias=torch.tensor(b),
                   residual=targs[1], q=targs[2], **kw)
    spk, vld = out[:2]
    cur = x.astype(np.float64) @ w.astype(np.float64) + b + r
    near = np.abs(cur - 1.0) < NEAR_VTH
    if packed:
        assert spk.block_k == block_n and tev.check_packed_invariants(
            spk)["ok"]
        got, want = tev.unpack_spikes_ref(spk), jev.unpack_spikes_ref(
            j.spikes)
    else:
        got, want = spk, j.spikes
        np.testing.assert_allclose(out[2].numpy(), np.asarray(j.current),
                                   rtol=RTOL, atol=ATOL)
    bad = (got.numpy() != np.asarray(want)) & ~near
    assert not bad.any(), f"{int(bad.sum())} spikes differ away from v_th"
    assert tuple(vld.shape) == tuple(j.vld_next.shape)
    if (got.numpy() == np.asarray(want)).all():
        eq(vld, j.vld_next)
    dense = fused_pe(targs[0], torch.tensor(w), bias=torch.tensor(b),
                     residual=targs[1], q=targs[2],
                     **dict(kw, skip="dense"))
    for a, c in zip(out, dense):              # the skip changes no bit
        a, c = (a.words, c.words) if packed and a is out[0] else (a, c)
        assert torch.equal(a, c)


# -------------------------------------------------------------- gated dw
@pytest.mark.parametrize("silent", SILENT)
@pytest.mark.parametrize("skip", SKIPS)
def test_gated_dw_matches_jax(silent, skip):
    m, k, n = 300, 320, 96
    rng = np.random.default_rng([int(silent * 10), len(skip)])
    x = gated_np(rng, m, k, silent, 128)
    g = rng.standard_normal((m, n)).astype(np.float32)
    want = jax_spike_matmul_dw(jnp.asarray(x), jnp.asarray(g), skip=skip)
    got = spike_matmul_dw(torch.tensor(x), torch.tensor(g), skip=skip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(got, spike_matmul_dw(torch.tensor(x),
                                            torch.tensor(g)))


# ------------------------------------------------------------ cost model
GRID = [(m, k, n) for m in (128, 1000, 4096) for k in (64, 1152, 4608)
        for n in (64, 256, 512)]
TRAFFIC = [dict(skip=s, kernels="fused", packed=p) for s in
           ("dense", "gated", "two_level") for p in (False, True)] + [
    dict(skip="dense", kernels="reference", packed=p) for p in (False, True)]


@pytest.mark.parametrize("kw", TRAFFIC, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_traffic_arithmetic_equals_jax(kw):
    for m, k, n in GRID:
        for bn, bk in ((128, 128), (256, 128), (256, 256)):
            for a in (1.0, 0.5, 0.05):
                for o in (1.0, 0.3):
                    args = dict(block_n=bn, block_k=bk, active_frac=a,
                                occ_frac=o, **kw)
                    t = troof.spike_matmul_traffic(m, k, n, costs=TPU, **args)
                    assert t == jroof.spike_matmul_traffic(m, k, n, **args)
                    t = troof.spike_matmul_grad_traffic(m, k, n, costs=TPU,
                                                        **args)
                    j = jroof.spike_matmul_grad_traffic(m, k, n, **args)
                    assert t == j
                    assert troof.kernel_time_s(t, TPU) == \
                        jroof.kernel_time_s(j)


@pytest.mark.parametrize("packed", [False, True])
def test_qk_chain_traffic_equals_jax(packed):
    for tokens, d, h, dh, hkv in [(4096, 512, 8, 64, None),
                                  (1000, 256, 4, 64, 2)]:
        assert troof.qk_chain_traffic(tokens, d, h, dh, hkv, packed=packed,
                                      costs=TPU) == \
            jroof.qk_chain_traffic(tokens, d, h, dh, hkv, packed=packed)


@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_tuner_with_tpu_constants_returns_jax_plans(fmt):
    port, ref = ttune.AutoTuner(costs=TPU), jtune.AutoTuner()
    for m, k, n in GRID:
        for a in (1.0, 0.6, 0.2, 0.04, 0.0):
            for o in (1.0, 0.4):
                for wide in (True, False):
                    kw = dict(fmt=fmt, active_frac=a, occ_frac=o,
                              allow_wide_n=wide)
                    got = port.plan_matmul(m, k, n, **kw)
                    want = ref.plan_matmul(m, k, n, **kw)
                    assert dataclasses.asdict(got) == dataclasses.asdict(want)
                kw = dict(fmt=fmt, active_frac=a, occ_frac=o)
                got = port.plan_grad_matmul(m, k, n, **kw)
                want = ref.plan_grad_matmul(m, k, n, **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port.snapshot() == ref.snapshot()


def test_card_tuner_plans_gated_when_sparse_and_cheap_to_gate():
    """The twin of the reference's test at the card's constants. There a
    gated launch pays ``compact_kmap`` on the host (about 0.2 ms), so the
    compacted walk wins only where the dense skip's streamed bytes cost
    more: a large sweep (res4.conv2's K and N at 16384 rows), very sparse;
    a small one plans to the reference."""
    tuner = ttune.AutoTuner()
    plan = tuner.plan_matmul(16384, 4608, 512, fmt="packed", active_frac=0.05)
    assert plan.kernels == "fused" and plan.skip in ("gated", "two_level")
    streamed = troof.spike_matmul_traffic(16384, 4608, 512, packed=True,
                                          active_frac=0.05)["hbm_bytes"]
    assert plan.est_hbm_bytes < streamed          # the dense skip's bytes
    assert tuner.plan_matmul(16384, 4608, 512, fmt="packed",
                             active_frac=0.06) is plan     # same bucket
    assert tuner.plan_matmul(128, 4096, 512, fmt="packed",
                             active_frac=0.05).kernels == "reference"


def test_bucket_and_observe_match_jax():
    for f in np.linspace(-0.2, 1.2, 57):
        assert ttune.bucket(f) == jtune.bucket(f)
    port, ref = ttune.AutoTuner(), jtune.AutoTuner()
    assert port.sparsity_of(ops.SpikeTensor.dense(
        torch.ones((8, 8), dtype=torch.int8))) == (1.0, 1.0)
    for a, o in [(0.2, 0.5), (0.2, 0.5), (0.9, 0.1), (0.0, 1.0)]:
        port.observe(a, o)
        ref.observe(a, o)
        assert port._hint == ref._hint


@pytest.mark.parametrize("packed", [False, True])
def test_sparsity_of_matches_jax(packed):
    """Active-block and stripe fractions of a live operand, from its maps
    (packed, with occ) or its payload (dense), in float64 as JAX."""
    x = gated_np(np.random.default_rng(5), 700, 600, 0.5, 128)
    if packed:
        jst = jax_ops_tensor(jev.pack_spikes_ref(jnp.asarray(x),
                                                 with_occ=True))
        tst = ops.SpikeTensor.from_packed(tev.pack_spikes_ref(
            torch.tensor(x), with_occ=True))
    else:
        jst = jax_ops_tensor(jnp.asarray(x))
        tst = ops.SpikeTensor.dense(torch.tensor(x))
    port = ttune.AutoTuner()
    assert port.sparsity_of(tst) == jtune.AutoTuner().sparsity_of(jst)
    assert port.reads == 1 and port.read_s > 0.0


def jax_ops_tensor(x):
    from repro.ops import SpikeTensor

    return SpikeTensor.wrap(x)


# ------------------------------------------------------- model forwards
@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, torch cfg, jax fused list, port fused list)."""
    out = {}
    for arch, size in ARCHS:
        jcfg, tcfg = cfgs(arch, size)
        jvars = jax.tree_util.tree_map(jnp.asarray, numpy_variables(jcfg))
        fused = jsnn.fuse_model(jvars, jcfg)
        out[arch] = (jcfg, tcfg, fused, convert.fused_from_jax(
            jax.tree_util.tree_map(np.asarray, fused), device="cpu"))
    return out


def images(size, batch=2, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(batch, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("arch,size", ARCHS)
@pytest.mark.parametrize("policy", ["auto", "auto_packed"])
def test_auto_forward_matches_jax(models, arch, size, policy):
    jcfg, tcfg, jfused, tfused = models[arch]
    x = images(size)
    jtune.get_tuner().reset()
    ttune.get_tuner().reset()
    j_logits, _, j_aux = jsnn.forward(jfused, jnp.asarray(x), jcfg,
                                      policy=policy)
    t_logits, _, t_aux = tsnn.forward(tfused, torch.tensor(x), tcfg,
                                      policy=policy)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=RTOL, atol=ATOL)
    assert_aux_equal(j_aux, t_aux)
    assert ttune.get_tuner().reads > 0          # the plans read the maps


def _forced(skip, wide):
    """A tuner plan forced to the fused kernels with ``skip``, 256 wide
    where N allows it and the op lets the tile widen."""
    def enumerate_(self, m, k, n, *, fmt, active_frac, occ_frac, block_m,
                   block_n, block_k, allow_reference, allow_wide_n=True):
        bn = 2 * block_n if wide and allow_wide_n and n % (2 * block_n) == 0 \
            else block_n
        return ttune.KernelPlan("fused", skip, block_m, bn, block_k, 0.0,
                                0.0, active_frac, occ_frac)
    return enumerate_


@functools.lru_cache(maxsize=None)
def _wide_model():
    """QKFResNet-11 at width 0.5, the port's fused list and JAX's
    reference forward of it (logits and per-layer spikes, as numpy)."""
    jcfg, tcfg = cfgs("qkfresnet11", 16)
    jcfg = dataclasses.replace(jcfg, width_mult=0.5)
    tcfg = dataclasses.replace(tcfg, width_mult=0.5)
    jvars = jax.tree_util.tree_map(jnp.asarray, numpy_variables(jcfg))
    jfused = jsnn.fuse_model(jvars, jcfg)
    tfused = convert.fused_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jfused),
                                    device="cpu")
    x = images(16, seed=3)
    j_logits, _, j_aux = jsnn.forward(jfused, jnp.asarray(x), jcfg,
                                      policy="reference")
    return tcfg, tfused, x, np.asarray(j_logits), {
        k: float(v) for k, v in j_aux["spikes"].items()}


@pytest.mark.parametrize("skip,wide,fmt", [("gated", True, "dense"),
                                           ("two_level", True, "packed"),
                                           ("gated", False, "packed")])
def test_auto_forward_through_the_gated_routes(monkeypatch, skip, wide, fmt):
    """QKFResNet-11 at width 0.5 (resblock 4 and the QKFormer are 256
    wide, so a plan may tile N 256 wide and the next layer inherits a
    256-wide k grid; a packed residual pins the grid): with every plan
    forced to the fused kernels under ``skip``, the auto forward gives the
    fused forward's spikes in every layer and its logits, and JAX's."""
    tcfg, tfused, x, j_logits, j_spikes = _wide_model()
    fixed = "fused_packed" if fmt == "packed" else "fused_dense"
    f_logits, _, f_aux = tsnn.forward(tfused, torch.tensor(x), tcfg,
                                      policy=fixed)
    tuner = ttune.get_tuner()
    tuner.reset()
    monkeypatch.setattr(ttune.AutoTuner, "_enumerate", _forced(skip, wide))
    auto = "auto_packed" if fmt == "packed" else "auto"
    a_logits, _, a_aux = tsnn.forward(tfused, torch.tensor(x), tcfg,
                                      policy=auto)
    plans = tuner.snapshot()["plans"].values()
    assert {p["skip"] for p in plans} == {skip}
    assert any(p["blocks"][1] == 256 for p in plans) == wide
    for name in f_aux["spikes"]:
        assert float(a_aux["spikes"][name]) == float(f_aux["spikes"][name])
        assert float(a_aux["spikes"][name]) == j_spikes[name]
    np.testing.assert_allclose(a_logits.numpy(), f_logits.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a_logits.numpy(), j_logits, rtol=RTOL,
                               atol=ATOL)
    tuner.reset()


# ----------------------------------------------------------- auto+grad
@functools.lru_cache(maxsize=None)
def _jax_auto_grad_step(arch, size):
    """One KD step of the reference under ``auto+grad`` from the seeded
    state (the body of its make_kd_train_step, jitted without backend
    optimisation), as numpy."""
    jcfg, _ = cfgs(arch, size, bn_fold=True)
    variables = numpy_variables(jcfg)
    tcfg_j, _, tvar = teacher(size)
    tparams = jax.tree_util.tree_map(jnp.asarray, tvar)
    kd, schedule = jkd.KDConfig(alpha=0.7), j_cosine_lr(0.1, 10)

    def loss_fn(params, state, batch):
        logits, new_state, aux = jsnn.forward(
            {"params": params, "state": state}, batch["images"], jcfg,
            train=True, policy="auto+grad")
        t_logits = jann.apply(tparams, batch["images"], tcfg_j)[0]
        loss, metrics = jkd.kd_loss(logits, t_logits, batch["labels"], kd)
        return loss, (metrics, aux)

    def step(params, opt, state, batch):
        (_, (metrics, aux)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, state, batch)
        new_p, _ = j_sgd_update(grads, opt, params, lr=schedule(opt.step),
                                momentum=0.9, weight_decay=5e-4)
        return metrics, grads, aux["spikes"], new_p

    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    imgs, labels = jdata.SyntheticImageDataset(
        num_classes=10, image_size=size, seed=0).batch(0, 4)
    batch = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
    args = (jvars["params"], j_sgd_init(jvars["params"]), jvars["state"],
            batch)
    jtune.get_tuner().reset()
    compiled = jax.jit(step).lower(*args).compile(
        {"xla_backend_optimization_level": 0})
    out = jax.tree_util.tree_map(np.asarray, compiled(*args))
    return variables, (imgs, labels), out


@pytest.mark.parametrize("policy", ["auto+grad", "auto_packed+grad"])
def test_auto_grad_kd_step_matches_jax(policy, monkeypatch):
    variables, (imgs, labels), (j_metrics, j_grads, j_spikes, j_params) = \
        _jax_auto_grad_step("qkfresnet11", 16)
    _, tcfg = cfgs("qkfresnet11", 16, bn_fold=True)
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
    ttune.get_tuner().reset()
    step = make_kd_train_step(
        student, lambda tp, x: tann.apply(tp, x, tcfg_t)[0],
        convert.variables_from_jax(tvar, device="cpu"),
        kd=tkd.KDConfig(alpha=0.7), schedule=t_cosine_lr(0.1, 10),
        optimizer="sgd", policy=policy)
    tvars = convert.variables_from_jax(variables, device="cpu")
    from repro_torch.optim import sgd_init

    carry, metrics = step((tvars["params"], sgd_init(tvars["params"]),
                           tvars["state"]),
                          {"images": torch.tensor(imgs),
                           "labels": torch.tensor(labels)})
    for name, val in j_spikes.items():
        assert float(captured["aux"]["spikes"][name]) == float(val), name
    for key in ("loss", "ce", "kl"):
        assert float(metrics[key]) == pytest.approx(float(j_metrics[key]),
                                                    rel=RTOL), key
    assert_trees_close(t_numpy(captured["grads"]), j_grads, GRAD_RTOL,
                       "grads")
    assert_trees_close(t_numpy(carry[0]), j_params, GRAD_RTOL, "params")
    plans = ttune.get_tuner().snapshot()["plans"]
    assert plans and all(k.startswith("matmul_grad") for k in plans)
    # the host half of the loop: the step's firing rate becomes the hint
    ttune.get_tuner().reset()
    observe_train_sparsity({k: float(v) for k, v in metrics.items()})
    assert ttune.get_tuner()._hint[0] == pytest.approx(
        float(metrics["active_frac"]))
    observe_train_sparsity({"loss": 1.0})
    ttune.get_tuner().reset()


def test_tuner_reset_clears_reads_and_plans():
    tuner = ttune.AutoTuner()
    tuner.sparsity_of(ops.SpikeTensor.dense(torch.zeros((4, 4))))
    tuner.plan_matmul(128, 128, 128)
    tuner.demote("matmul")
    assert tuner.reads == 1 and tuner.is_demoted("matmul")
    tuner.reset()
    assert (tuner.reads, tuner.read_s, tuner.snapshot()["plans"],
            tuner.is_demoted("matmul")) == (0, 0.0, {}, False)
