"""The port's mixture of experts on the CPU against the JAX package: the
router's top-k experts, the dispatch ranks, the capacity drop mask and
``dropped_frac`` (exactly), ``moe_apply`` on inputs that drop tokens,
``moe_apply_dense_ref`` against ``moe_apply`` where nothing drops, the
reduced olmoe-1b-7b through
``prefill``, ``prefill_chunk`` and ``decode_step`` (logits rtol 1e-5) and
its loss, aux metrics and gradients (``jax.value_and_grad``: loss 1e-4,
gradients 1e-3 relative L2), the port's engine against JAX's engine on
one trace (a chunk is a dispatch group of its own, so the comparison is
engine against engine), and the spiking QKFormer MoE LM under
``reference``, ``fused_dense`` and ``fused_packed`` (logits, and per-layer
spike totals equal to JAX's: the Q map, the masked attention map and the
experts' gate spikes).

Inputs are numpy arrays made from a seed; the parameters are JAX's,
carried across by ``convert.lm_params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro_torch.configs import get_config, reduced
from repro_torch.models import ffn as tffn
from repro_torch.models.layers import spike_log
from repro_torch.models.lm import spike_totals
from repro_torch.serve import Engine, EngineConfig
from repro_torch.tree import tree_map
from torch_families import (check_loss_and_grads, close, family_pair,
                            tokens)

ARCH = "olmoe-1b-7b"
POLICIES = ["reference", "fused_dense", "fused_packed"]
SPIKING = dict(spiking=True, attention_kind="qk_spiking")


def moe_params(cfg_over: dict, seed: int = 0):
    """(JAX cfg, port cfg, JAX MoE params, the port's copy)."""
    jcfg = jreduced(jget(ARCH), **cfg_over)
    tcfg = reduced(get_config(ARCH), **cfg_over)
    jp = jffn.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = tree_map(lambda a: torch.tensor(np.array(a)),
                  jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _jax_routing(jp, jcfg, x):
    """The reference's top-k, ranks and keep mask, in its own jnp lines."""
    b, s, _ = x.shape
    e, k = jcfg.n_experts, jcfg.top_k
    probs, _ = jffn.router_probs(jp, x)
    topv, topi = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(topi, e, dtype=jnp.int32)
    flat = onehot.reshape(b, s * k, e)
    ranks = jnp.cumsum(flat, axis=1) - flat
    rank = (ranks * flat).sum(-1).reshape(b, s, k)
    return topi, rank, rank < jffn.moe_capacity(jcfg, s)


@pytest.mark.parametrize("top_k,s", [(2, 64), (2, 7), (1, 40)])
def test_routing_ranks_and_drops_equal_jax(top_k, s):
    over = dict(top_k=top_k, capacity_factor=0.5)
    jcfg, tcfg, jp, tp = moe_params(over, seed=top_k)
    x = _x(s, 3, s, tcfg.d_model)
    topi, rank, keep = _jax_routing(jp, jcfg, jnp.asarray(x))
    _, _, _, ti = tffn._route(tp, tcfg, torch.tensor(x))
    tr = tffn.dispatch_ranks(ti, tcfg.n_experts)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(topi))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(rank))
    cap = tffn.moe_capacity(tcfg, s)
    assert cap == jffn.moe_capacity(jcfg, s)
    np.testing.assert_array_equal((tr < cap).numpy(), np.asarray(keep))
    _, jaux = jffn.moe_apply(jp, jcfg, jnp.asarray(x))
    _, taux = tffn.moe_apply(tp, tcfg, torch.tensor(x))
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    if s >= 40:
        assert float(taux["dropped_frac"]) > 0.0      # the drops happen


def test_top_k_takes_the_lower_expert_on_a_tie():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1]], np.float32)
    v, i = tffn.top_k(torch.tensor(probs), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert i.tolist() == [[1, 2, 3]]


@pytest.mark.parametrize("spiking", [False, True])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_drops_as_jax(spiking, shared):
    over = dict(capacity_factor=0.5, spiking=spiking,
                n_shared_experts=shared)
    jcfg, tcfg, jp, tp = moe_params(over, seed=3 + shared)
    x = _x(5, 2, 48, tcfg.d_model) * (3.0 if spiking else 1.0)
    jy, jaux = jffn.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = tffn.moe_apply(tp, tcfg, torch.tensor(x))
    close(ty, jy)
    assert float(taux["dropped_frac"]) > 0.0
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("spiking", [False, True])
def test_dense_ref_equals_moe_apply_where_nothing_drops(spiking):
    over = dict(capacity_factor=8.0, spiking=spiking)
    jcfg, tcfg, jp, tp = moe_params(over, seed=7)
    x = torch.tensor(_x(6, 2, 24, tcfg.d_model))
    y, aux = tffn.moe_apply(tp, tcfg, x)
    assert float(aux["dropped_frac"]) == 0.0
    ref = tffn.moe_apply_dense_ref(tp, tcfg, x)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    close(ref, jffn.moe_apply_dense_ref(jp, jcfg, jnp.asarray(x.numpy())))


# ------------------------------------------------------------------ the LM
def test_moe_lm_prefill_chunk_and_decode_match_jax():
    jm, steps, jp, tm, tp = family_pair(ARCH)
    toks = tokens(1, 2, 12, tm.cfg.vocab_size)
    jl, jc = steps["prefill"](jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks)},
                        return_all_logits=True)
    close(tl, jl)
    jcache = jm.init_cache(2, 16)
    jcache["len"] = jnp.zeros((), jnp.int32)
    tcache = tm.init_cache(2, 16, device="cpu")
    tcache["len"] = torch.zeros((), dtype=torch.int32)
    for lo in (0, 8):
        jl, jcache = steps["chunk"](jp, jnp.asarray(toks[:, lo:lo + 8]),
                                    jcache)
        tl, tcache = tm.prefill_chunk(tp, torch.tensor(toks[:, lo:lo + 8]),
                                      tcache)
        close(tl, jl)
    lens = np.array([12, 7], np.int32)
    jcache["len"], tcache["len"] = jnp.asarray(lens), torch.tensor(lens)
    nxt = toks[:, -1:]
    for _ in range(3):
        jl, jcache = steps["decode"](jp, jnp.asarray(nxt), jcache)
        tl, tcache = tm.decode_step(tp, torch.tensor(nxt), tcache)
        close(tl, jl)
        for t, j in zip(tcache["layers"], jcache["layers"]):
            close(t, j)
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)


def test_moe_lm_loss_metrics_and_grads_match_jax():
    batch = {"tokens": tokens(2, 2, 24, 512)}
    metrics = check_loss_and_grads(ARCH, batch)
    assert float(metrics["load_balance"].detach()) > 0.0
    assert float(metrics["loss"].detach()) > float(metrics["nll"].detach())


@pytest.mark.parametrize("chunk", [0, 8])
def test_moe_engine_tokens_equal_jax_engine(chunk):
    """A 16-token bucket is one dispatch group in the blocking engine and
    two in the chunked one: each engine is held to its JAX twin."""
    jm, _, jp, tm, tp = family_pair(ARCH)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, int(rng.integers(3, 14)))
               for _ in range(4)]
    outs = []
    for eng_cls, cfg_cls, m, p in ((JEngine, JEngineConfig, jm, jp),
                                   (Engine, EngineConfig, tm, tp)):
        eng = eng_cls(m, p, cfg_cls(max_slots=2, max_len=32, prefill_pad=16,
                                    prefill_chunk=chunk))
        uids = [eng.submit(pr, max_new=5) for pr in prompts]
        fin = {r.uid: r.out for r in eng.run_until_drained()}
        outs.append([fin[u] for u in uids])
    assert outs[0] == outs[1]


# --------------------------------------------------- spiking QKFormer MoE
def _jax_moe_spike_totals(jm, jp, toks) -> dict:
    """Per-layer spike totals of the reference's spiking MoE LM: its
    blocks walked with JAX's own functions, counting the Q map, the
    masked attention map and the experts' gate spikes (its dispatch lines
    repeated to reach the gate)."""
    from repro.core.qk_attention import qk_grouped_token_attention
    from repro.models.attention import attn_prefill

    cfg = jm.cfg
    pol = cfg.exec_policy
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = jlayers.embedding_lookup(jp["embed"], jnp.asarray(toks), cfg.dtype)
    b, s, _ = x.shape
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
            nq, no = int((qs != 0).sum()), int((o != 0).sum())
        out["q"].append(nq)
        out["attn"].append(no)
        x = x + attn_prefill(a, cfg, y, jnp.zeros((b, s), jnp.int32))[0]
        y2 = jlayers.rmsnorm_apply(p["ln2"], x, cfg.rms_eps)
        m = p["moe"]
        e, k, cap = cfg.n_experts, cfg.top_k, jffn.moe_capacity(cfg, s)
        topi, rank, keep = _jax_routing(m, cfg, y2)
        pos = jax.nn.one_hot(jnp.where(keep, rank, cap), cap + 1,
                             dtype=y2.dtype)[..., :cap]
        disp = jnp.einsum("bske,bskc->bsec",
                          jax.nn.one_hot(topi, e, dtype=y2.dtype), pos)
        xe = jnp.einsum("bsd,bsec->becd", y2, disp)
        g = jnp.einsum("becd,edf->becf", xe, m["w_gate"])
        out["mlp"].append(int((jlayers.maybe_spike(g, True, cfg.lif)
                               != 0).sum()))
        x = x + jffn.moe_apply(m, cfg, y2)[0]
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_spiking_moe_lm_matches_jax(policy):
    jm, steps, jp, tm, tp = family_pair(ARCH, policy=policy, **SPIKING)
    toks = tokens(3, 2, 10, tm.cfg.vocab_size)
    jl, _ = steps["prefill"](jp, {"tokens": jnp.asarray(toks)})
    with spike_log() as log:
        tl, tc = tm.prefill(tp, {"tokens": torch.tensor(toks)},
                            return_all_logits=True)
    close(tl, jl)
    totals = spike_totals(log, tm.cfg.n_layers)
    want = _jax_moe_spike_totals(jm, jp, toks)
    for kind in ("q", "attn", "mlp"):
        assert totals[kind].tolist() == want[kind], kind
        assert all(v > 0 for v in want[kind]), kind
    if policy != "fused_packed":
        return
    # a chunk and a decode tick against JAX's, and the packed state words
    jcache = jm.init_cache(2, 8)
    jcache["len"] = jnp.zeros((), jnp.int32)
    tcache = tm.init_cache(2, 8, device="cpu")
    tcache["len"] = torch.zeros((), dtype=torch.int32)
    jl, jcache = steps["chunk"](jp, jnp.asarray(toks[:, :5]), jcache)
    tl, tcache = tm.prefill_chunk(tp, torch.tensor(toks[:, :5]), tcache)
    close(tl, jl)
    jl, jcache = steps["decode"](jp, jnp.asarray(toks[:, 5:6]), jcache)
    tl, tcache = tm.decode_step(tp, torch.tensor(toks[:, 5:6]), tcache)
    close(tl, jl)
    for t, j in zip(tcache["layers"], jcache["layers"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_spiking_moe_policies_spike_alike():
    """The three policies give the same per-layer spike totals on the same
    parameters (f32: the fused pass sums what the reference sums)."""
    toks = torch.tensor(tokens(5, 2, 9, 512))
    got = {}
    for policy in POLICIES:
        _, _, _, tm, tp = family_pair(ARCH, policy=policy, **SPIKING)
        with spike_log() as log:
            tm.prefill(tp, {"tokens": toks})
        got[policy] = spike_totals(log, tm.cfg.n_layers)
    for policy in POLICIES[1:]:
        for kind, t in got["reference"].items():
            assert torch.equal(got[policy][kind], t), (policy, kind)
