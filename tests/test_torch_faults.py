"""Self-healing serving in the port, on the CPU (mirrors
``tests/test_faults.py``): the fault plan, the fused -> reference
demotion, the integrity guard with its quarantine, forced consumer stalls,
livelock detection and the replica router's failover.

Where a fault plan runs the engine, the port is also held to the JAX
package's engine under the same plan, prompts and parameters
(``convert.lm_params_from_jax``): the packed quarantine, the dense-KV
quarantine and the seeded chaos trace give the same greedy tokens and the
same self-healing counters (quarantines, requeues, failovers, demoted
ops). The models are the reduced qwen3-1.7b, spiking (``qk_spiking``)
and softmax, built once per module.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs import build_model as jbuild
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.ops import fallback as jfallback
from repro_torch import convert, ops
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.ops import fallback
from repro_torch.serve import faults as tfaults
from repro_torch.serve import (AllReplicasDead, Engine, EngineConfig,
                               FaultPlan, ReplicaFailure, ReplicaRouter,
                               StalledEngine, demo_chaos_plan)
from repro_torch.serve.engine import pool_leaves, slot_row

SPIKING = dict(spiking=True, attention_kind="qk_spiking")
SEED = 7
_MODELS: dict = {}


def models(spiking: bool = True):
    """(JAX model, JAX params, port model, port params) of the reduced
    qwen3-1.7b, spiking or softmax, built once."""
    over = SPIKING if spiking else {}
    if spiking not in _MODELS:
        jm = jbuild(jreduced(jget("qwen3-1.7b", **over)))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(reduced(get_config("qwen3-1.7b", **over)))
        tp = convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _MODELS[spiking] = (jm, jp, tm, tp)
    return _MODELS[spiking]


@pytest.fixture(autouse=True)
def _fault_hygiene():
    """Demotions and armed kernel faults are process-global and sticky in
    both packages (and the JAX engine's compiled steps bake a demotion
    in): reset them after every test."""
    yield
    fallback.reset()
    if jfallback.demotions() or jfallback.armed_kernel_faults():
        jfallback.reset()
        jserve.clear_jit_cache()


def _prompts(n=4, lens=(3, 10), seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(*lens)))
            for _ in range(n)]


def _ecfg(cfg_cls, spiking=True, **kw):
    base = dict(max_slots=2, max_len=64, prefill_pad=8)
    if spiking:
        base["policy"] = "fused_packed"
    base.update(kw)
    return cfg_cls(**base)


def _engine(faults=None, spiking=True, **kw):
    _, _, tm, tp = models(spiking)
    return Engine(tm, tp, _ecfg(EngineConfig, spiking, **kw), faults=faults)


def _jengine(faults=None, spiking=True, **kw):
    jm, jp, _, _ = models(spiking)
    return jserve.Engine(jm, jp, _ecfg(jserve.EngineConfig, spiking, **kw),
                         faults=faults)


def _drain(eng, prompts, max_new=6):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    fin = {r.uid: r for r in eng.run_until_drained()}
    return uids, fin


def _healing(st: dict) -> tuple:
    return st["quarantined"], st["requeues"], st["failed"]


# ================================================================ FaultPlan
def _plan(mod):
    return (mod.FaultPlan(SEED).nan_state(3).corrupt_word(5, slot=1)
            .kill_replica(8, replica=1).stall_consumer(2, ticks=4)
            .fail_kernel("dense_lif", at_call=2))


def test_fault_plan_builders_and_determinism():
    plan = _plan(tfaults)
    assert len(plan) == 5
    s = plan.summary()
    assert s == _plan(jserve.faults).summary()
    assert s["seed"] == SEED and s["pending"] == 5 and s["fired"] == 0
    # events fire once at the first tick >= their tick; defer re-arms
    assert [e.kind for e in plan.due(("nan_state", "corrupt_word"), 4)] \
        == ["nan_state"]
    assert plan.due("nan_state", 10) == []
    (ev,) = plan.due("corrupt_word", 6)
    plan.defer(ev)
    assert [e.kind for e in plan.due("corrupt_word", 6)] == ["corrupt_word"]
    assert plan.die_due(7) is None and plan.die_due(8).replica == 1
    assert plan.summary()["fired"] == 3


def test_fault_plan_view_slices_by_replica_and_shares_events():
    plan = (FaultPlan(0).nan_state(2, replica=0).kill_replica(4, replica=1)
            .fail_kernel())
    v0, v1 = plan.view(0), plan.view(1)
    assert [e.kind for e in v0.events] == ["nan_state"]
    assert [e.kind for e in v1.events] == ["die"]    # kernel faults left out
    v1.die_due(4)
    assert plan.events[1].fired                     # shared event objects


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_demo_chaos_plan_summary_equals_jax(n_replicas):
    kw = dict(n_replicas=n_replicas, kill_tick=3, nan_ticks=(2, 5))
    plan = demo_chaos_plan(SEED, **kw)
    assert plan.summary() == jserve.demo_chaos_plan(SEED, **kw).summary()
    # arming a kernel fault marks its event fired, once
    assert plan.arm_kernel_faults() == 1 and plan.arm_kernel_faults() == 0
    assert [f["op"] for f in fallback.armed_kernel_faults()] == ["dense_lif"]


# ==================================================== fused-kernel demotion
def test_kernel_fault_demotes_to_reference():
    """An armed fused-kernel raise falls back to the reference for that
    (op, mode), warns, records the demotion and steers the autotuner away
    from the op; a reset restores the fused kernel."""
    gen = torch.Generator().manual_seed(0)
    x = (torch.rand((16, 64), generator=gen) < 0.3).to(torch.int8)
    w = torch.randn((64, 32), generator=gen)
    ref = ops.matmul(x, w, policy="reference")
    fallback.arm_kernel_fault("matmul", at_call=0)
    with pytest.warns(RuntimeWarning, match="demoted"):
        out = ops.matmul(x, w, policy="fused_dense")
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert fallback.is_demoted("matmul")
    assert fallback.is_demoted("matmul", "fused")
    assert not fallback.is_demoted("matmul", "fused+grad")
    (d,) = fallback.demotions()
    assert (d["op"], d["mode"], d["fallback"]) == ("matmul", "fused",
                                                    "reference")
    assert d["reason"].startswith("InjectedKernelFault")
    # sticky: later fused calls take the reference without raising
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out2 = ops.matmul(x, w, policy="fused_dense")
        torch.testing.assert_close(out2, ref, rtol=0, atol=0)
        # the autotuner stops planning the op: "auto" resolves reference
        assert ops.get_tuner().is_demoted("matmul")
        with ops.record_dispatches() as log:
            out3 = ops.matmul(x, w, policy="auto")
        torch.testing.assert_close(out3, ref, rtol=0, atol=0)
        assert log == [("matmul", "reference")]
    assert "matmul" in ops.get_tuner().snapshot()["demoted_ops"]
    fallback.reset_demotions()
    assert not fallback.is_demoted("matmul")
    assert not ops.get_tuner().is_demoted("matmul")


def test_contract_errors_do_not_demote():
    """A ValueError from a shape or argument contract propagates; only a
    RuntimeError demotes."""
    from repro_torch.ops.registry import _REGISTRY, lookup, register

    def _contract(*a, **k):
        raise ValueError("bad block shape")

    def _boom(*a, **k):
        raise RuntimeError("CUDA error: invalid configuration argument")

    try:
        register("tmp_contract_op", "fused")(_contract)
        register("tmp_contract_op", "reference")(lambda *a, **k: "ref")
        with pytest.raises(ValueError, match="bad block shape"):
            lookup("tmp_contract_op", "fused")()
        assert not fallback.demotions()
        _REGISTRY[("tmp_contract_op", "fused")] = _boom
        with pytest.warns(RuntimeWarning, match="demoted"):
            assert lookup("tmp_contract_op", "fused")() == "ref"
        assert fallback.is_demoted("tmp_contract_op")
    finally:
        _REGISTRY.pop(("tmp_contract_op", "fused"), None)
        _REGISTRY.pop(("tmp_contract_op", "reference"), None)


def _mm_mismatch(x):
    """A torch error of the caller's kind: a shape mismatch torch raises
    as a ``RuntimeError``."""
    return torch.mm(x, x[:, :1].t())


@pytest.mark.parametrize("arg", ["tensor", "spike_tensor", "kwarg"])
def test_a_real_error_off_the_cpu_propagates(arg):
    """With a tensor argument off the CPU (here on the ``meta`` device,
    which stands in for the card) a real ``RuntimeError`` from a fused
    wrapper propagates and demotes nothing; only an injected fault
    demotes there. On CPU tensors the same error demotes."""
    from repro_torch.ops.registry import _REGISTRY, lookup, register

    def _fused(x=None, *, y=None):
        x = y if x is None else x
        return _mm_mismatch(x.data if isinstance(x, ops.SpikeTensor) else x)

    def call(dev):
        t = torch.ones((4, 3), device=dev)
        fn = lookup("tmp_card_op", "fused")
        if arg == "spike_tensor":
            return fn(ops.SpikeTensor.dense(t))
        return fn(y=t) if arg == "kwarg" else fn(t)

    try:
        register("tmp_card_op", "fused")(_fused)
        register("tmp_card_op", "reference")(lambda *a, **k: "ref")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(RuntimeError) as info:
                call("meta")
        assert not isinstance(info.value, fallback.InjectedKernelFault)
        assert fallback.demotions() == []
        fallback.arm_kernel_fault("tmp_card_op", at_call=0)
        with pytest.warns(RuntimeWarning, match="demoted"):
            assert call("meta") == "ref"
        (d,) = fallback.demotions()
        assert d["reason"].startswith("InjectedKernelFault")
        fallback.reset()
        with pytest.warns(RuntimeWarning, match="demoted"):
            assert call("cpu") == "ref"
        (d,) = fallback.demotions()
        assert d["reason"].startswith("RuntimeError")
    finally:
        _REGISTRY.pop(("tmp_card_op", "fused"), None)
        _REGISTRY.pop(("tmp_card_op", "reference"), None)


def test_every_fused_mode_is_guarded_and_passes_results_through():
    """``lookup`` returns each fused mode (``+grad`` too) behind the
    guard, one closure per (op, mode); with nothing armed the guard hands
    back the kernel's result unchanged."""
    table = ops.implementations()
    for op, mode in table:
        fn = ops.lookup(op, mode)
        if "fused" in mode:
            assert fn.__name__ == f"guarded_{op}_{mode.replace('+', '_')}"
            assert ops.lookup(op, mode) is fn
        else:
            assert fn is table[op, mode]
    x = torch.ones((8, 8), dtype=torch.int8)
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    torch.testing.assert_close(ops.matmul(x, w, policy="fused_dense"),
                               x.float() @ w, rtol=0, atol=0)
    assert fallback.demotions() == []


# ====================================================== integrity quarantine
def test_quarantine_replay_packed_equals_jax():
    """A corrupted packed word and a NaN (on the logits: a packed
    qk_spiking pool keeps no float state) on the spiking packed engine:
    the guard quarantines the poisoned slot, the replay gives the clean
    run's tokens, each delivered once, and the counters are JAX's."""
    prompts = _prompts(3, seed=1)
    _, clean = _drain(_engine(integrity_every=1), prompts)
    eng = _engine(FaultPlan(SEED).corrupt_word(2).nan_state(4),
                  integrity_every=1)
    uids, fin = _drain(eng, prompts)
    assert sorted(fin) == sorted(uids)
    assert {u: fin[u].out for u in uids} == {u: clean[u].out for u in uids}
    assert all(fin[u].status == "done" for u in uids)
    st = eng.stats()
    assert _healing(st) == (2, 2, 0)
    for u in uids:
        assert eng.pop_output(u) == fin[u].out
    jeng = _jengine(jserve.FaultPlan(SEED).corrupt_word(2).nan_state(4),
                    integrity_every=1)
    _, jfin = _drain(jeng, prompts)
    assert {u: fin[u].out for u in uids} == {u: jfin[u].out for u in uids}
    assert _healing(st) == _healing(jeng.stats())
    assert st["guard_scans"] == jeng.stats()["guard_scans"]


def test_quarantine_nan_state_dense_kv_equals_jax():
    """Softmax engine: the NaN lands in the float KV pool and the finite
    check evicts and replays the slot, as JAX's engine does."""
    prompts = _prompts(3, seed=2)
    _, clean = _drain(_engine(spiking=False, integrity_every=1), prompts)
    eng = _engine(FaultPlan(SEED).nan_state(3), spiking=False,
                  integrity_every=1)
    uids, fin = _drain(eng, prompts)
    assert {u: fin[u].out for u in uids} == {u: clean[u].out for u in uids}
    assert _healing(eng.stats()) == (1, 1, 0)
    jeng = _jengine(jserve.FaultPlan(SEED).nan_state(3), spiking=False,
                    integrity_every=1)
    _, jfin = _drain(jeng, prompts)
    assert {u: fin[u].out for u in uids} == {u: jfin[u].out for u in uids}
    assert _healing(eng.stats()) == _healing(jeng.stats())


def test_quarantine_scrubs_the_slot_rows():
    """After a quarantine the poisoned slot's pool rows are zero (a
    prefill writes only its own positions)."""
    eng = _engine(FaultPlan(SEED).nan_state(2, slot=1), spiking=False,
                  integrity_every=1)
    uid = eng.submit(np.arange(1, 5), max_new=20)
    while eng._quarantined == 0 and eng._tick < 5:
        eng.step()
    assert eng._quarantined == 1 and 1 not in eng.active
    assert eng.queue[0].uid == uid and eng.queue[0].retries == 1
    for kind, pool in pool_leaves(eng.cache["layers"]):
        assert bool((slot_row(kind, pool, 1) == 0).all())


def test_quarantine_retry_budget_fails_request():
    """A slot poisoned on every tick exhausts its retry budget and fails
    (in its status and the stats) instead of requeueing forever."""
    plan = FaultPlan(SEED)
    for t in range(1, 30):
        plan.nan_logits(t, slot=1)      # the highest slot is admitted first
    eng = _engine(plan, quarantine_retries=1, integrity_every=1)
    uid = eng.submit(np.arange(1, 5), max_new=6)
    fin = {r.uid: r for r in eng.run_until_drained()}
    assert fin[uid].status == "failed"
    st = eng.stats()
    assert st["failed"] == 1 and st["quarantined"] == 2  # budget 1: 2 hits
    assert st["n"] == 0 and st["n_terminal"] == 1


def test_guard_disabled_by_default():
    eng = _engine(spiking=False)
    _drain(eng, _prompts(2))
    st = eng.stats()
    assert st["guard_scans"] == 0 and st["kernel_demotions"] == []
    assert "fault_plan" not in st


def test_no_fault_guard_parity():
    """Guard on and off without faults: the same tokens."""
    prompts = _prompts(4, seed=3)
    e0 = _engine(integrity_every=0)
    _, r0 = _drain(e0, prompts)
    e1 = _engine(integrity_every=1)
    _, r1 = _drain(e1, prompts)
    assert {u: r.out for u, r in r0.items()} \
        == {u: r.out for u, r in r1.items()}
    assert e1.stats()["guard_scans"] > 0 and e1.stats()["quarantined"] == 0


def test_guard_adds_no_host_read(monkeypatch):
    """The greedy tokens and the guard's verdict come back in one read a
    decode tick: ``tolist`` runs once a tick with the guard on."""
    calls = []
    tolist = torch.Tensor.tolist

    def counted(self):
        calls.append(1)
        return tolist(self)

    eng = _engine(policy="fused_dense", integrity_every=1)
    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    _drain(eng, _prompts(3, seed=5))
    st = eng.stats()
    assert st["guard_scans"] == st["decode_ticks"] > 0
    assert len(calls) == st["decode_ticks"]


def test_cancel_scrubs_when_the_guard_is_on():
    eng = _engine(spiking=False, integrity_every=1)
    uid = eng.submit(np.arange(1, 6), max_new=20)
    for _ in range(3):
        eng.step()
    slot = eng.requests[uid].slot
    assert slot >= 0 and eng.cancel(uid)
    for kind, pool in pool_leaves(eng.cache["layers"]):
        assert bool((slot_row(kind, pool, slot) == 0).all())


# ========================================================== consumer stalls
def test_forced_consumer_stall_is_exact():
    """stall_consumer freezes one slot's drain for a window; the tokens
    stay the clean run's (the rollback path of the out-FIFO stall)."""
    prompts = _prompts(3, seed=4)
    _, ref = _drain(_engine(spiking=False), prompts)
    eng = _engine(FaultPlan(SEED).stall_consumer(2, ticks=3),
                  spiking=False, out_fifo_depth=64)
    uids, fin = _drain(eng, prompts)
    assert {u: fin[u].out for u in uids} == {u: ref[u].out for u in uids}
    assert eng.stats()["stall_ticks"] > 0


# ========================================================== StalledEngine
def test_run_until_drained_raises_on_livelock():
    eng = _engine(spiking=False, out_fifo_depth=1)
    uids = [eng.submit(p, max_new=8) for p in _prompts(2)]
    with pytest.raises(StalledEngine) as ei:
        eng.run_until_drained(stall_grace=10)
    rep = ei.value.report
    assert set(rep["stuck_slots"]) and rep["queued"] == 0
    assert {s["uid"] for s in rep["stuck_slots"].values()} <= set(uids)
    for _ in range(200):        # draining the FIFOs un-stalls the engine
        eng.step()
        for u in uids:
            eng.pop_output(u)
        if not eng.pending():
            break
    assert not eng.pending()
    assert {r.uid for r in eng.finished} == set(uids)


def test_router_run_until_drained_raises_on_livelock():
    _, _, tm, tp = models(False)
    router = ReplicaRouter(tm, tp, _ecfg(EngineConfig, False,
                                         out_fifo_depth=1), n_replicas=2)
    for p in _prompts(3, seed=5):
        router.submit(p, max_new=8)
    with pytest.raises(StalledEngine):
        router.run_until_drained(stall_grace=10)


# ============================================== the seeded chaos acceptance
def test_chaos_trace_exactly_once_equals_jax():
    """One replica killed mid-trace, two NaN injections and a forced
    fused-kernel failure: every request completes exactly once with the
    tokens of a run whose only fault is the same kernel fault, delivered
    once; tokens and counters equal JAX's router under the same plan."""
    _, _, tm, tp = models()
    ecfg = _ecfg(EngineConfig, integrity_every=1)
    prompts = _prompts(6, seed=6)
    kw = dict(n_replicas=2, kill_tick=3, nan_ticks=(2, 5))
    with pytest.warns(RuntimeWarning, match="demoted"):
        ref_router = ReplicaRouter(tm, tp, ecfg, n_replicas=2,
                                   faults=FaultPlan(SEED).fail_kernel(
                                       "dense_lif", 0))
        ref_uids = [ref_router.submit(p, max_new=6) for p in prompts]
        ref = {r.uid: r.out for r in ref_router.run_until_drained()}
    fallback.reset()
    with pytest.warns(RuntimeWarning, match="demoted"):
        router = ReplicaRouter(tm, tp, ecfg, n_replicas=2,
                               faults=demo_chaos_plan(SEED, **kw))
        uids = [router.submit(p, max_new=6) for p in prompts]
        fin = router.run_until_drained()
    got = {r.uid: r.out for r in fin}
    assert sorted(got) == sorted(uids) and len(fin) == len(prompts)
    assert all(r.status == "done" for r in fin)
    assert got == {u: ref[ru] for u, ru in zip(uids, ref_uids)}
    st = router.stats()
    assert st["alive"] == [True, False] and st["failovers"] == 1
    assert [(f["replica"], f["reason"]) for f in st["failures"]] == [
        (1, "step raised: injected replica death at tick 3")]
    assert st["requeued"] >= 1
    quarantined = sum(p.get("quarantined", 0) for p in st["per_replica"])
    assert [d["op"] for d in fallback.demotions()] == ["dense_lif"]
    for u in uids:                      # at-most-once through the router
        assert router.pop_output(u) == got[u]
        assert router.pop_output(u) == []

    jm, jp, _, _ = models()
    jserve.clear_jit_cache()    # the kernel fault fires while tracing
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jrouter = jserve.ReplicaRouter(
            jm, jp, _ecfg(jserve.EngineConfig, integrity_every=1),
            n_replicas=2, faults=jserve.demo_chaos_plan(SEED, **kw))
        juids = [jrouter.submit(p, max_new=6) for p in prompts]
        jgot = {r.uid: r.out for r in jrouter.run_until_drained()}
    assert got == {u: jgot[ju] for u, ju in zip(uids, juids)}
    jst = jrouter.stats()
    assert (st["failovers"], st["requeued"], st["alive"]) \
        == (jst["failovers"], jst["requeued"], jst["alive"])
    assert quarantined == sum(p.get("quarantined", 0)
                              for p in jst["per_replica"])
    assert [p.get("requeues") for p in st["per_replica"]] \
        == [p.get("requeues") for p in jst["per_replica"]]
    assert [d["op"] for d in jfallback.demotions()] == ["dense_lif"]


def test_failover_preserves_partial_delivery():
    """Tokens the consumer popped before the replica died are never
    delivered again; the rest arrives exactly once."""
    _, _, tm, tp = models(False)
    ecfg = _ecfg(EngineConfig, False)
    ref_router = ReplicaRouter(tm, tp, ecfg, n_replicas=2)
    prompts = _prompts(2, seed=7)
    ref_uids = [ref_router.submit(p, max_new=8) for p in prompts]
    ref = {r.uid: r.out for r in ref_router.run_until_drained()}
    router = ReplicaRouter(tm, tp, ecfg, n_replicas=2,
                           faults=FaultPlan(SEED).kill_replica(4, replica=1))
    uids = [router.submit(p, max_new=8) for p in prompts]
    streamed = {u: [] for u in uids}
    for _ in range(200):
        router.step()
        for u in uids:
            streamed[u].extend(router.pop_output(u))
        if not router.pending():
            break
    assert not router.pending()
    assert streamed == {u: ref[ru] for u, ru in zip(uids, ref_uids)}
    assert router.stats()["failovers"] == 1


def test_all_replicas_dead_raises():
    _, _, tm, tp = models(False)
    plan = FaultPlan(SEED).kill_replica(2, replica=0) \
        .kill_replica(3, replica=1)
    router = ReplicaRouter(tm, tp, _ecfg(EngineConfig, False), n_replicas=2,
                           faults=plan)
    for p in _prompts(3, seed=8):
        router.submit(p, max_new=20)
    with pytest.raises(AllReplicasDead):
        router.run_until_drained()


def test_single_engine_replica_death_propagates():
    """Without a router there is nowhere to fail over: the death reaches
    the caller."""
    eng = _engine(FaultPlan(SEED).kill_replica(1), spiking=False)
    eng.submit(np.arange(1, 5), max_new=8)
    with pytest.raises(ReplicaFailure):
        eng.run_until_drained()


def test_submit_skips_dead_replica():
    _, _, tm, tp = models(False)
    router = ReplicaRouter(tm, tp, _ecfg(EngineConfig, False), n_replicas=2)
    router._fail_replica(1, "test")
    for p in _prompts(4, seed=9):
        router.submit(p, max_new=4)
    assert len(router.run_until_drained()) == 4
    st = router.stats()
    assert st["dispatch"][1] == 0 and st["alive"] == [True, False]
    assert st["devices"] == ["cpu", "cpu"]
