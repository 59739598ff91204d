"""The port's continuous-batching engine on the CPU, serving the reduced
spiking qwen3-1.7b (``attention_kind="qk_spiking"``) and the reduced
softmax qwen3-1.7b and qwen2.5-3b (KV cache in the slot pool), against the
JAX package's engine on the same parameters and trace, and against a
direct ``prefill`` / ``decode_step`` loop of the port.

Greedy decoding is deterministic, so the engines must agree token for
token (this mirrors ``tests/test_serve_engine.py`` and
``tests/test_multihead_attention.py``). Temperature sampling draws from
the engine's ``torch.Generator``, not ``jax.random``: it is held to be
deterministic under one seed, not to JAX.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import build_model as jbuild
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro_torch import convert
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.serve import Engine, EngineConfig, QueueFull, StalledEngine

SPIKING = dict(spiking=True, attention_kind="qk_spiking")
POLICIES = ["reference", "fused_dense", "fused_packed"]
_MODELS: dict = {}


def models():
    """(JAX model, JAX params, port model, port params): the reduced
    spiking qwen3-1.7b under its default (reference) policy, built once."""
    if not _MODELS:
        jm = jbuild(jreduced(jget("qwen3-1.7b", **SPIKING)))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(reduced(get_config("qwen3-1.7b", **SPIKING)))
        tp = convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _MODELS["pair"] = (jm, jp, tm, tp)
    return _MODELS["pair"]


def trace(n=5, seed=0, lens=(3, 14), vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(*lens))) for _ in range(n)]


def run(engine_cls, cfg_cls, model, params, prompts, max_new=(4, 6),
        **kw):
    ecfg = dict(max_slots=2, max_len=32, prefill_pad=8)
    ecfg.update(kw)
    eng = engine_cls(model, params, cfg_cls(**ecfg))
    uids = [eng.submit(p, max_new=max_new[i % 2])
            for i, p in enumerate(prompts)]
    fin = {r.uid: r for r in eng.run_until_drained()}
    assert len(fin) == len(prompts)
    return [fin[u].out for u in uids], eng


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("chunk", [0, 4])
def test_engine_tokens_equal_jax_engine(policy, chunk):
    """More requests than slots, blocking and chunked prefill: the port's
    greedy tokens are JAX's, request by request."""
    jm, jp, tm, tp = models()
    prompts = trace()
    jout, _ = run(JEngine, JEngineConfig, jm, jp, prompts,
                  policy=policy, prefill_chunk=chunk)
    tout, eng = run(Engine, EngineConfig, tm, tp, prompts,
                    policy=policy, prefill_chunk=chunk)
    assert tout == jout
    st = eng.stats()
    assert st["n"] == len(prompts)
    assert st["prefill_mode"] == ("chunked" if chunk else "blocking")


def _direct_greedy(model, params, prompt, max_new):
    """One request through ``prefill`` and ``decode_step`` alone."""
    toks = torch.tensor(np.asarray(prompt, np.int64)[None, :])
    logits, cache = model.prefill(params, {"tokens": toks}, max_len=32)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(max_new - 1):
        lg, cache = model.decode_step(params, torch.tensor([[out[-1]]]),
                                      cache)
        out.append(int(torch.argmax(lg[0])))
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_equals_a_direct_loop(policy):
    from repro_torch.models.lm import LM
    from repro_torch.ops import with_policy

    _, _, tm, tp = models()
    prompts = trace(n=4, seed=1)
    tout, _ = run(Engine, EngineConfig, tm, tp, prompts, policy=policy,
                  prefill_chunk=4)
    direct_model = LM(with_policy(tm.cfg, policy))
    want = [_direct_greedy(direct_model, tp, p, (4, 6)[i % 2])
            for i, p in enumerate(prompts)]
    assert tout == want


def test_packed_engine_equals_dense_and_reports_its_policy():
    _, _, tm, tp = models()
    prompts = trace(n=4, seed=2)
    dense, eng_d = run(Engine, EngineConfig, tm, tp, prompts,
                       policy="fused_dense")
    packed, eng_p = run(Engine, EngineConfig, tm, tp, prompts,
                        policy="fused_packed")
    assert packed == dense
    sd, sp = eng_d.stats(), eng_p.stats()
    assert (sd["policy"], sd["spike_format"]) == ("fused_dense", "dense")
    assert (sp["policy"], sp["spike_format"]) == ("fused_packed", "packed")
    assert sp["decode_ticks_measured"] > 0
    assert "decode_ticks_measured" not in sd
    assert 0.0 < sp["spike_rate_mean"] < 1.0
    assert sp["spike_state_hbm_reduction"] == pytest.approx(
        sp["dense_spike_bytes_per_tick_mean"]
        / sp["packed_spike_bytes_per_tick_mean"])
    # the caller's model keeps its own policy
    assert tm.cfg.exec_policy.name == "reference"


def test_packed_spike_state_is_written_into_the_slot_row():
    """After a blocking prefill the slot row of the pool holds the packed
    spike state of the prefill's cache (the last position of the padded
    bucket, layer by layer), with clean pad lanes; a dense policy's pool
    holds no state at all."""
    from repro_torch.core.events import unpack_words
    from repro_torch.models.attention import qk_spike_state_width
    from repro_torch.models.lm import LM
    from repro_torch.ops import with_policy

    _, _, tm, tp = models()
    cfg = tm.cfg
    prompt = trace(n=1, seed=3)[0]
    eng = Engine(tm, tp, EngineConfig(max_slots=2, max_len=32, prefill_pad=8,
                                      policy="fused_packed"))
    eng.submit(prompt, max_new=2)
    eng._admit()
    slot = next(iter(eng.active))
    words = eng.cache["layers"][0]
    assert words.dtype == torch.int32
    assert tuple(words.shape) == (cfg.n_layers, 2, 1, 1,
                                  qk_spike_state_width(cfg))
    toks = np.zeros((1, 16), np.int64)
    toks[0, :len(prompt)] = prompt
    _, cache = LM(with_policy(cfg, "fused_packed")).prefill(
        tp, {"tokens": torch.tensor(toks)})
    assert torch.equal(words[:, slot], cache["layers"][0][:, 0])
    assert int(words[:, 1 - slot].ne(0).sum()) == 0
    bits = unpack_words(words)
    assert int(bits[..., cfg.n_heads * cfg.resolved_head_dim:].sum()) == 0
    assert int(bits.sum()) > 0
    _, eng_d = run(Engine, EngineConfig, tm, tp, [prompt],
                   policy="fused_dense", max_new=(1, 1))
    assert all(t.shape[-3] == 0 for t in eng_d.cache["layers"])


def test_temperature_sampling_is_deterministic_under_one_seed():
    _, _, tm, tp = models()
    prompts = trace(n=3, seed=4)

    def sample(seed):
        eng = Engine(tm, tp, EngineConfig(max_slots=2, max_len=32,
                                          prefill_pad=8), rng_seed=seed)
        uids = [eng.submit(p, max_new=6, temperature=1.5) for p in prompts]
        fin = {r.uid: r.out for r in eng.run_until_drained()}
        return [fin[u] for u in uids]

    a, b, c = sample(7), sample(7), sample(8)
    assert a == b
    assert a != c


def test_backpressure_out_fifo_stalls_and_cancel():
    _, _, tm, tp = models()
    prompts = trace(n=4, seed=5)
    want, _ = run(Engine, EngineConfig, tm, tp, prompts)
    # a full admission FIFO: a non-blocking submit raises, a blocking one
    # donates ticks until a place frees
    eng = Engine(tm, tp, EngineConfig(max_slots=2, max_len=32, prefill_pad=8,
                                      max_queue=1))
    eng.submit(prompts[0], max_new=4)
    with pytest.raises(QueueFull):
        eng.submit(prompts[1], max_new=6, block=False)
    eng.submit(prompts[1], max_new=6)
    eng.run_until_drained()
    assert eng.stats()["queue_hwm"] == 1
    # a lazy consumer: slots stall on their full output FIFO (exact: the
    # state rolls back, the token is fed again), tokens unchanged
    eng = Engine(tm, tp, EngineConfig(max_slots=2, max_len=32, prefill_pad=8,
                                      out_fifo_depth=2))
    uids = [eng.submit(p, max_new=(4, 6)[i % 2])
            for i, p in enumerate(prompts)]
    got = {u: [] for u in uids}
    for t in range(500):
        eng.step()
        if t % 3 == 2:
            for u in uids:
                got[u] += eng.pop_output(u)
        if not eng.pending():
            break
    for u in uids:
        got[u] += eng.pop_output(u)
    assert [got[u] for u in uids] == want
    st = eng.stats()
    assert st["stall_ticks"] > 0 and st["out_fifo_hwm"] <= 2
    # nobody drains at all: the engine reports the livelock
    eng = Engine(tm, tp, EngineConfig(max_slots=1, max_len=32, prefill_pad=8,
                                      out_fifo_depth=1))
    eng.submit(prompts[0], max_new=5)
    with pytest.raises(StalledEngine):
        eng.run_until_drained(stall_grace=5)
    # cancel and deadlines free the slot
    eng = Engine(tm, tp, EngineConfig(max_slots=1, max_len=32, prefill_pad=8))
    u0 = eng.submit(prompts[0], max_new=20)
    u1 = eng.submit(prompts[1], max_new=20, deadline_ticks=3)
    eng.step()
    assert eng.cancel(u0)
    fin = {r.uid: r for r in eng.run_until_drained()}
    assert fin[u0].status == "cancelled"
    assert fin[u1].status == "deadline_miss"
    assert eng.stats()["deadline_miss"] == 1


def test_launch_serve_runs_reduced_on_the_cpu():
    from repro_torch.launch import serve

    st = serve.main(["--reduced", "--spiking", "--qk-attention",
                     "--requests", "3", "--max-new", "3", "--slots", "2",
                     "--max-len", "32", "--policy", "fused_packed",
                     "--prefill-chunk", "8", "--device", "cpu"])
    assert st["n"] == 3 and st["policy"] == "fused_packed"
    assert st["device"] == "cpu" and st["decode_ticks_measured"] > 0


# --------------------------------------------------------- softmax models
_SOFTMAX: dict = {}


def softmax_models(arch: str = "qwen3-1.7b", **over):
    """(JAX model, JAX params, port model, port params) of the reduced
    softmax ``arch`` (f32, with ``over`` applied to both configs)."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _SOFTMAX:
        jm = jbuild(jreduced(jget(arch), **over))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(reduced(get_config(arch), **over))
        tp = convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _SOFTMAX[key] = (jm, jp, tm, tp)
    return _SOFTMAX[key]


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2.5-3b"])
def test_softmax_engine_tokens_equal_jax_engine(arch, chunk):
    """More requests than slots, blocking and chunked prefill: the softmax
    engine's greedy tokens are JAX's, request by request."""
    jm, jp, tm, tp = softmax_models(arch)
    prompts = trace(seed=6)
    jout, _ = run(JEngine, JEngineConfig, jm, jp, prompts,
                  prefill_chunk=chunk)
    tout, eng = run(Engine, EngineConfig, tm, tp, prompts,
                    prefill_chunk=chunk)
    assert tout == jout
    st = eng.stats()
    assert st["n"] == len(prompts) and st["policy"] == "reference"
    assert st["prefill_mode"] == ("chunked" if chunk else "blocking")


@pytest.mark.parametrize("chunk", [0, 4])
def test_softmax_engine_equals_a_direct_loop(chunk):
    _, _, tm, tp = softmax_models()
    prompts = trace(n=4, seed=7)
    tout, _ = run(Engine, EngineConfig, tm, tp, prompts, prefill_chunk=chunk)
    want = [_direct_greedy(tm, tp, p, (4, 6)[i % 2])
            for i, p in enumerate(prompts)]
    assert tout == want


def test_softmax_kv_rows_are_written_into_the_slot_row():
    """After a blocking prefill the slot row of the pool holds the
    prefill's K/V rows of the prompt's bucket; the other slot stays 0."""
    _, _, tm, tp = softmax_models()
    prompt = trace(n=1, seed=8)[0]
    eng = Engine(tm, tp, EngineConfig(max_slots=2, max_len=32, prefill_pad=8))
    eng.submit(prompt, max_new=2)
    eng._admit()
    slot = next(iter(eng.active))
    k_pool, v_pool = eng.cache["layers"]
    cfg = tm.cfg
    assert tuple(k_pool.shape) == (cfg.n_layers, 2, 32, cfg.n_kv_heads,
                                   cfg.resolved_head_dim)
    bucket = -(-len(prompt) // 8) * 8
    toks = np.zeros((1, bucket), np.int64)
    toks[0, :len(prompt)] = prompt
    _, cache = tm.prefill(tp, {"tokens": torch.tensor(toks)})
    assert torch.equal(k_pool[:, slot, :bucket], cache["layers"][0][:, 0])
    assert torch.equal(v_pool[:, slot, :bucket], cache["layers"][1][:, 0])
    assert int(k_pool[:, slot, bucket:].ne(0).sum()) == 0
    assert int(k_pool[:, 1 - slot].ne(0).sum()) == 0


def test_softmax_f8_kv_chunked_equals_blocking():
    """An f8 serving pool (``kv_dtype="f8_e4m3"``): chunked prefill keeps
    each request's chunk cache at compute precision and quantizes once at
    the slot write, where the blocking path does, so the tokens are the
    blocking engine's (``tests/test_serve_engine.py``'s f8 case) and
    JAX's."""
    jm, jp, tm, tp = softmax_models(kv_dtype="f8_e4m3")
    prompts = trace(n=3, seed=5, lens=(3, 14))
    blocking, eng = run(Engine, EngineConfig, tm, tp, prompts)
    chunked, _ = run(Engine, EngineConfig, tm, tp, prompts, prefill_chunk=8)
    assert chunked == blocking
    assert all(t.dtype == torch.float8_e4m3fn for t in eng.cache["layers"])
    jout, _ = run(JEngine, JEngineConfig, jm, jp, prompts, prefill_chunk=8)
    assert chunked == jout


def test_softmax_out_fifo_stall_keeps_the_tokens():
    """A lazy consumer stalls slots on their full output FIFO; the decode
    writes the pool in place, so a stalled slot's rows are copied aside
    before the tick and written back after it: the tokens are unchanged,
    and a stalled tick leaves its rows as they were."""
    _, _, tm, tp = softmax_models()
    prompts = trace(n=4, seed=9)
    want, _ = run(Engine, EngineConfig, tm, tp, prompts)
    eng = Engine(tm, tp, EngineConfig(max_slots=2, max_len=32, prefill_pad=8,
                                      out_fifo_depth=2))
    uids = [eng.submit(p, max_new=(4, 6)[i % 2])
            for i, p in enumerate(prompts)]
    got = {u: [] for u in uids}
    checked = 0
    for t in range(500):
        stalled = eng._stalled_slots()
        if stalled and len(stalled) < len(eng.active):
            before = {s: [p[:, s].clone() for p in eng.cache["layers"]]
                      for s in stalled}
        else:
            before = {}
        eng.step()
        for s, rows in before.items():
            for pool, row in zip(eng.cache["layers"], rows):
                assert torch.equal(pool[:, s], row)
            checked += 1
        for i, u in enumerate(uids):     # even requests drained each tick
            if i % 2 == 0 or t % 4 == 3:
                got[u] += eng.pop_output(u)
        if not eng.pending():
            break
    for u in uids:
        got[u] += eng.pop_output(u)
    assert [got[u] for u in uids] == want
    assert eng.stats()["stall_ticks"] > 0 and checked > 0


def test_launch_serve_runs_the_softmax_model_on_the_cpu():
    from repro_torch.launch import serve

    st = serve.main(["--reduced", "--requests", "3", "--max-new", "3",
                     "--slots", "2", "--max-len", "32", "--prefill-chunk",
                     "8", "--device", "cpu"])
    assert st["n"] == 3 and st["tokens"] == 9
    assert st["device"] == "cpu" and st["prefill_mode"] == "chunked"
