"""LM training of the port on the CPU against the JAX package: the token
batches, ``LM.loss`` and its gradients on the reduced spiking qwen3-1.7b
(``spiking=True, attention_kind="qk_spiking"``: 2 layers, d 64, 4 / 2 heads
of 16, vocab 512, f32) under ``reference+grad``, ``fused_dense+grad`` and
``fused_packed+grad``, two steps of ``make_train_step`` with and without
microbatches from one JAX ``TrainState``, the softmax teacher's loss and
gradients (full and chunked attention), ``sequence_kd_loss``,
``clip_by_global_norm``, the head-blocked grouped ``dense_lif`` gradients,
and the two example twins.

The LM's parameters are JAX's, carried across by
``convert.lm_params_from_jax`` (and a JAX ``TrainState`` by
``convert.train_state_from_jax``). On the CPU the reference's ``fused+grad``
runs the same jnp math as its ``reference+grad``; the port runs its
kernels' plain versions. Its packed gradients are held to JAX's
``fused_dense+grad``, whose packed twin differs from the test's
closed-form ``loss_ref`` by f32 rounding beyond 1e-5 in
``tests/test_kernel_parity.py``. Targets: the loss at rtol 1e-5; every
gradient and updated parameter leaf at rtol 1e-4 with an absolute term of
1e-5 of the leaf's largest |value| (many terms summed in another order);
spike totals exactly. Each JAX function is jitted once per policy.
"""
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.core import kd as jkd
from repro.core.lif import LIFConfig as JLIF
from repro.data import synthetic as jdata
from repro.ops.grad import force_pallas_backward
from repro.optim import clip_by_global_norm as j_clip
from repro.optim.schedules import linear_warmup_cosine as j_warmup
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_init as j_train_state_init
from repro_torch import convert, ops
from repro_torch.core import kd as tkd
from repro_torch.core.lif import LIFConfig
from repro_torch.core.surrogate import spike
from repro_torch.data import synthetic as tdata
from repro_torch.models.layers import spike_log
from repro_torch.models.lm import spike_totals
from repro_torch.ops import impls
from repro_torch.optim import clip_by_global_norm, linear_warmup_cosine
from repro_torch.train import make_grad_fn, make_train_step
from repro_torch.tree import tree_leaves
from test_torch_lm import _jax_spike_totals, _tokens, lm_pair, softmax_pair

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_POLICIES = ["reference+grad", "fused_dense+grad", "fused_packed+grad"]
# the JAX policy each port policy is held to
JAX_POLICY = {"reference+grad": "reference+grad",
              "fused_dense+grad": "fused_dense+grad",
              "fused_packed+grad": "fused_dense+grad"}
B, S = 2, 9


def assert_close(got, want, rtol=GRAD_RTOL, what=""):
    want = np.asarray(want, np.float64)
    atol = 1e-5 * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol, err_msg=what)


def assert_lm_trees_close(got, want_jax, rtol=GRAD_RTOL, what=""):
    """A port LM tree against a JAX one (its blocks stacked): both to the
    port's layout, leaf by leaf."""
    want = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, want_jax), device="cpu")
    g_leaves, w_leaves = tree_leaves(got), tree_leaves(want)
    assert len(g_leaves) == len(w_leaves), what
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        assert tuple(g.shape) == tuple(w.shape), (what, i)
        assert_close(g.detach().numpy(), w.numpy(), rtol, f"{what} leaf {i}")


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (3, 5, 1)])
def test_token_batches_bit_equal(seed, step, shard):
    jds = jdata.SyntheticTokenDataset(512, 33, seed=seed)
    tds = tdata.SyntheticTokenDataset(512, 33, seed=seed)
    np.testing.assert_array_equal(tds.table, jds.table)
    want = jds.batch(step, 6, shard, 2)
    got = tds.batch(step, 6, shard, 2)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    jit = jdata.token_batches(jds, 3, start_step=step, shard=shard)
    tit = tdata.token_batches(tds, 3, start_step=step, shard=shard)
    for _ in range(2):
        np.testing.assert_array_equal(next(tit), next(jit))
    ids = jdata.SyntheticImageDataset(image_size=8, seed=seed)
    tis = tdata.SyntheticImageDataset(image_size=8, seed=seed)
    for (ti, tl), (ji, jl) in zip(
            [next(tdata.image_batches(tis, 2, start_step=step))],
            [next(jdata.image_batches(ids, 2, start_step=step))]):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


# ------------------------------------------------------ losses and clipping
@pytest.mark.parametrize("masked", [False, True])
def test_sequence_kd_loss_matches_jax(masked):
    rng = np.random.default_rng(3)
    s_logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    t_logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    tokens = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    cfg_j = jkd.KDConfig(alpha=0.5, temperature=2.0)
    cfg_t = tkd.KDConfig(alpha=0.5, temperature=2.0)

    def jloss(sl):
        return jkd.sequence_kd_loss(sl, jnp.asarray(t_logits),
                                    jnp.asarray(tokens), cfg_j,
                                    None if mask is None
                                    else jnp.asarray(mask))
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(s_logits))
    sl = torch.tensor(s_logits, requires_grad=True)
    tl, tm = tkd.sequence_kd_loss(sl, torch.tensor(t_logits),
                                  torch.tensor(tokens), cfg_t,
                                  None if mask is None
                                  else torch.tensor(mask))
    (tg,) = torch.autograd.grad(tl, sl)
    for k in ("ce", "kl", "loss"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    jg, jn = j_clip(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    tg, tn = clip_by_global_norm(
        {"a": torch.tensor(tree["a"]), "b": [torch.tensor(tree["b"][0])]},
        max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    for g, w in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    assert (float(tn) > max_norm) == (max_norm == 0.5)


# ---------------------------------------------------------------- LM.loss
@functools.lru_cache(maxsize=None)
def jax_value_and_grad(policy: str):
    jm = lm_pair(policy)[0]
    return jax.jit(jax.value_and_grad(jm.loss, has_aux=True))


@pytest.mark.parametrize("policy", GRAD_POLICIES)
def test_lm_loss_and_grads_match_jax(policy):
    _, _, jp, tm, tp = lm_pair(policy)
    jm = lm_pair(JAX_POLICY[policy])[0]
    toks = _tokens(5, B, S, tm.cfg.vocab_size)
    (jl, jmet), jg = jax_value_and_grad(JAX_POLICY[policy])(
        jp, {"tokens": jnp.asarray(toks)})
    with spike_log() as log:
        tl, tmet, grads = make_grad_fn(tm.loss)(
            tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(tmet["nll"]), float(jmet["nll"]),
                               rtol=RTOL)
    assert_lm_trees_close(grads, jg, what=policy)
    # every weight of every layer is reached (wq through the head mask)
    for blk in grads["blocks"]:
        for name in ("wq", "wk", "wo"):
            assert float(blk["attn"][name]["w"].abs().max()) > 0, name
    totals = spike_totals(log, tm.cfg.n_layers)
    want = _jax_spike_totals(jm, jp, toks)
    for kind in ("q", "attn", "mlp"):
        assert totals[kind].tolist() == want[kind], kind


@pytest.mark.parametrize("chunked", [False, True])
def test_softmax_lm_loss_and_grads_match_jax(chunked):
    """The softmax teacher (qwen3-1.7b as published, reduced) trains
    through full attention and, with ``flash_threshold`` below the
    sequence, through the chunked (flash-style) form: loss and gradients
    against JAX's."""
    import dataclasses

    from repro_torch.configs import build_model

    jm, _, jp, tm, tp = softmax_pair("qwen3-1.7b")
    kw = dict(flash_threshold=2, attn_q_block=3, attn_kv_block=3) \
        if chunked else {}
    jm = type(jm)(dataclasses.replace(jm.cfg, **kw))
    tm = build_model(dataclasses.replace(tm.cfg, **kw))
    toks = _tokens(7, B, S, tm.cfg.vocab_size)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, _, grads = make_grad_fn(tm.loss)(tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert_lm_trees_close(grads, jg, what=f"softmax chunked={chunked}")


def test_lm_loss_remat_equals_no_remat():
    """``remat="full"`` and ``"dots"`` recompute the layers in the backward
    pass: the same loss, gradients and spike totals as without."""
    import dataclasses

    from repro_torch.configs import build_model

    _, _, _, tm, tp = lm_pair("fused_dense+grad")
    toks = torch.tensor(_tokens(6, B, S, tm.cfg.vocab_size))
    out = {}
    for remat in ("none", "full", "dots"):
        m = build_model(dataclasses.replace(tm.cfg, remat=remat))
        with spike_log() as log:
            loss, _, g = make_grad_fn(m.loss)(tp, {"tokens": toks})
        out[remat] = (loss, tree_leaves(g),
                      spike_totals(log, tm.cfg.n_layers))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for a, b in zip(out[remat][1], out["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        for kind, t in out["none"][2].items():
            assert torch.equal(out[remat][2][kind], t), (remat, kind)


# ------------------------------------------------------------ train step
@functools.lru_cache(maxsize=None)
def jax_train_step(microbatch: int):
    jm = lm_pair("fused_dense+grad")[0]
    return jax.jit(j_make_train_step(jm, schedule=j_warmup(3e-3, 1, 4),
                                     microbatch=microbatch))


@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_steps_match_jax(microbatch):
    _, _, jp, tm, _ = lm_pair("fused_dense+grad")
    jstep = jax_train_step(microbatch)
    jstate = j_train_state_init(jp)
    tstate = convert.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    tstep = make_train_step(tm, schedule=linear_warmup_cosine(3e-3, 1, 4),
                            microbatch=microbatch)
    for i in range(2):
        toks = _tokens(10 + i, 4, S, tm.cfg.vocab_size)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tmet = tstep(tstate, {"tokens": torch.tensor(toks)})
        assert int(tstate.step) == int(jstate.step) == i + 1
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=GRAD_RTOL if k == "grad_norm"
                                       else RTOL, err_msg=k)
        assert_lm_trees_close(tstate.params, jstate.params,
                              what=f"params after step {i + 1}")
        assert_lm_trees_close(tstate.opt_state.m, jstate.opt_state.m,
                              what=f"m after step {i + 1}")
    assert float(tmet["grad_norm"]) > 1.0      # the clip was active


# ------------------------------------- head-blocked grouped dense_lif grads
MH_DH, MH_QK, MH_M, MH_K = 16, 5.0, 130, 96


def _mh_case(h, hkv):
    rng = np.random.default_rng(7 * h + hkv)
    x = (rng.standard_normal((MH_M, MH_K)) * 0.6).astype(np.float32)

    def weights(n):
        return {"w": (rng.standard_normal((MH_K, n)) / 4).astype(np.float32),
                "b": np.full((n,), 0.05, np.float32)}
    return x, weights(h * MH_DH), weights(hkv * MH_DH)


def _t_loss(policy, h, hkv, cfg):
    def loss(x, pq, pk):
        q = ops.dense_lif(pq, x, cfg, policy=policy)
        out = ops.dense_lif(pk, x, cfg, q=q, qk_threshold=MH_QK,
                            heads=(h, MH_DH), kv_heads=hkv, policy=policy)
        return (out.data * torch.arange(h * MH_DH,
                                        dtype=torch.float32)).sum()
    return loss


def _t_loss_ref(h, hkv, cfg):
    """The closed form of ``tests/test_kernel_parity.py::loss_ref``."""
    def loss(x, pq, pk):
        m, g = x.shape[0], h // hkv
        qs = spike(x @ pq["w"] + pq["b"] - cfg.v_th, cfg.surrogate,
                   cfg.alpha)
        ks = spike(x @ pk["w"] + pk["b"] - cfg.v_th, cfg.surrogate,
                   cfg.alpha)
        rs = qs.reshape(m, h, MH_DH).sum(dim=-1)
        mask = spike(rs - MH_QK, cfg.surrogate, cfg.alpha)
        out = (ks.reshape(m, hkv, 1, MH_DH)
               * mask.reshape(m, hkv, g, 1)).reshape(m, h * MH_DH)
        return (out * torch.arange(h * MH_DH, dtype=torch.float32)).sum()
    return loss


def _t_grads(loss, x, pq, pk):
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (x, pq["w"], pq["b"], pk["w"], pk["b"])]
    val = loss(leaves[0], {"w": leaves[1], "b": leaves[2]},
               {"w": leaves[3], "b": leaves[4]})
    return val, torch.autograd.grad(val, leaves)


@functools.lru_cache(maxsize=None)
def _jax_kernel_grads(h, hkv):
    """JAX's ``fused_dense+grad`` on its Pallas kernels (interpret mode)."""
    x, pq, pk = _mh_case(h, hkv)
    cfg = JLIF(v_th=0.5)

    def loss(x_, pq_, pk_):
        q = jops.dense_lif(pq_, x_, cfg, policy="fused_dense+grad")
        out = jops.dense_lif(pk_, x_, cfg, q=q, qk_threshold=MH_QK,
                             heads=(h, MH_DH), kv_heads=hkv,
                             policy="fused_dense+grad")
        return (out.data * jnp.arange(h * MH_DH, dtype=jnp.float32)).sum()

    with force_pallas_backward():
        g = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, pq),
            jax.tree_util.tree_map(jnp.asarray, pk))
    x_g, q_g, k_g = g
    return [np.asarray(t) for t in (x_g, q_g["w"], q_g["b"], k_g["w"],
                                    k_g["b"])]


@pytest.mark.parametrize("h,hkv", [(2, 1), (4, 2), (4, 4)])
@pytest.mark.parametrize("policy", ["fused_dense+grad", "fused_packed+grad"])
def test_multihead_dense_lif_grads(policy, h, hkv):
    cfg = LIFConfig(v_th=0.5)
    x, pq, pk = _mh_case(h, hkv)
    val, grads = _t_grads(_t_loss(policy, h, hkv, cfg), x, pq, pk)
    ref_val, ref = _t_grads(_t_loss_ref(h, hkv, cfg), x, pq, pk)
    np.testing.assert_allclose(float(val.detach()), float(ref_val.detach()),
                               rtol=1e-5)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # against JAX's kernels: the gradient tolerance (its sums run in
    # another order; the port's equal the closed form bit for bit here)
    for a, b in zip(grads, _jax_kernel_grads(h, hkv)):
        assert_close(a.numpy(), b)
    assert float(grads[1].abs().max()) > 0     # wq reached through the mask
    # the head mask varies by head (no degenerate sweep)
    q = ops.dense_lif({"w": torch.tensor(pq["w"]),
                       "b": torch.tensor(pq["b"])}, torch.tensor(x), cfg,
                      policy="reference")
    per_head = q.data.reshape(-1, h, MH_DH).sum(-1) >= MH_QK
    assert 0 < float(per_head.float().mean()) < 1 or h == 1


def test_grouped_wk_memo_follows_the_weight_under_training():
    """A grouped wk changed between two calls, in place or as a new
    tensor, is expanded anew: the fused +grad forward and its gradients
    follow the weight's values."""
    cfg = LIFConfig(v_th=0.5)
    x, pq, pk = _mh_case(4, 2)
    loss = _t_loss("fused_dense+grad", 4, 2, cfg)
    ref = _t_loss_ref(4, 2, cfg)
    xt = torch.tensor(x)
    pqt = {k: torch.tensor(v) for k, v in pq.items()}
    wk = torch.tensor(pk["w"], requires_grad=True)
    bk = torch.tensor(pk["b"])
    expanded = []
    real = impls.expand_group_weights

    def counting(p, heads, kv_heads):
        expanded.append(1)
        return real(p, heads, kv_heads)

    impls.expand_group_weights = counting
    try:
        for change in ("none", "in place", "new tensor"):
            if change == "in place":
                with torch.no_grad():
                    wk.mul_(-1.5)
            elif change == "new tensor":
                wk = (wk.detach() * 0.5).requires_grad_(True)
            got = loss(xt, pqt, {"w": wk, "b": bk})
            (gw,) = torch.autograd.grad(got, wk)
            want = ref(xt, pqt, {"w": wk, "b": bk})
            (rw,) = torch.autograd.grad(want, wk)
            assert float(got.detach()) == pytest.approx(
                float(want.detach()), rel=1e-6), change
            np.testing.assert_allclose(gw.numpy(), rw.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=change)
        assert len(expanded) == 3
    finally:
        impls.expand_group_weights = real


def test_dense_lif_grad_records_its_dispatches():
    cfg = LIFConfig()
    x = torch.randn(5, 16)
    with ops.record_dispatches() as log:
        ops.dense_lif({"w": torch.randn(16, 8)}, x, cfg,
                      policy="fused_packed+grad")
        ops.dense_lif({"w": torch.randn(16, 8)}, x, cfg, policy="reference")
    assert log == [("dense_lif", "fused+grad"), ("dense_lif", "reference")]


# ------------------------------------------- the kernels' own-sum witness
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("fmt", ["dense", "packed"])
def test_fused_pe_chain_ref_is_the_plain_launch(grouped, fmt):
    """``fused_pe_chain_ref`` (the float-x tile's own sums, which the
    card's gradients are held to) against the plain version on one K2
    launch of the LM's training forward: the current within rtol = atol =
    1e-5, the spikes and block counts equal away from v_th."""
    from repro_torch.core.events import unpack_words
    from repro_torch.kernels import fused_pe as K
    from repro_torch.kernels.chain import fused_pe_chain_ref

    gen = torch.Generator().manual_seed(5)
    h, hkv, dh, k = 4, 2, 16, 96
    x = torch.randn((40, k), generator=gen)
    if grouped:
        w = (torch.randn((k, hkv, 1, dh), generator=gen) / k ** 0.5).expand(
            k, hkv, h // hkv, dh).reshape(k, h * dh).contiguous()
        q, heads = (torch.rand((40, h * dh), generator=gen) < 0.2).to(
            torch.int8), (h, dh)
    else:
        w, q, heads = torch.randn((k, h * dh), generator=gen) / k ** 0.5, \
            None, None
    args = K.fused_pe_operands(x, w, q=q, qk_threshold=2.0, out_format=fmt,
                               emit_current=True, heads=heads)
    got, want = fused_pe_chain_ref(*args), K.fused_pe_block_ref(*args)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=1e-5,
                               atol=1e-5)
    spk, ref = ((unpack_words(got[0]), unpack_words(want[0]))
                if fmt == "packed" else (got[0], want[0]))
    assert spk.shape == ref.shape
    near = torch.zeros_like(spk, dtype=torch.bool)
    near[:40, :h * dh] = (want[2] - 1.0).abs() < 1e-5
    assert not bool(((spk != ref) & ~near).any())
    assert 0 < int(spk.sum()) < spk.numel() // 2
    if not bool(near.any()):
        assert torch.equal(got[1], want[1])


def test_chain_launchers_swap_and_restore():
    """Inside ``chain_launchers()`` the four launchers of the
    ``fused_dense+grad`` path and the launch counter are plain PyTorch;
    after it, the kernels' own again."""
    from repro_torch.kernels import _build, chain
    from repro_torch.kernels.fused_pe import ops as pe_ops
    from repro_torch.kernels.spike_matmul import backward as bwd
    from repro_torch.kernels.spike_matmul import ops as mm_ops

    names = [(pe_ops, "fused_pe_cuda"), (mm_ops, "spike_matmul_cuda"),
             (bwd, "spike_matmul_dx_cuda"), (bwd, "spike_matmul_dw_cuda"),
             (_build, "count_launch")]
    before = [getattr(m, n) for m, n in names]
    with chain.chain_launchers():
        inside = [getattr(m, n) for m, n in names]
        _build.reset_launches()
        _build.count_launch("fused_pe", (), ())
        assert not any(_build.LAUNCHES.values())
    assert all(a is not b for a, b in zip(before, inside))
    assert [getattr(m, n) for m, n in names] == before


# --------------------------------------------------------- example twins
@pytest.mark.parametrize("example", ["torch_quickstart.py",
                                     "torch_spiking_qkformer_lm.py"])
def test_example_twin_runs_on_the_cpu(example):
    path = ROOT / "examples" / example
    imported = {m.split(".")[0] for m in re.findall(
        r"^\s*(?:from|import)\s+([\w.]+)", path.read_text(), re.M)}
    assert not imported & {"jax", "jaxlib", "repro"}, imported
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(path), "--device", "cpu",
                          "--steps", "2"], capture_output=True, text=True,
                         env=env, timeout=300, check=True).stdout
    losses = [float(v) for v in re.findall(r"loss[= :]+(-?[\d.]+|nan|inf)",
                                           out)]
    assert losses and all(np.isfinite(losses)), out
    if example == "torch_spiking_qkformer_lm.py":
        assert "context: 0 elements" in out, out
