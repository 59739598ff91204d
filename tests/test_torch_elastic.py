"""The port's elastic runner (``repro_torch.train.elastic``) against the
reference's, on the CPU at world size 1 (a gloo group of one).

The reduced qwen3-1.7b (spiking ``qk_spiking`` under ``fused_dense+grad``,
and the softmax model) trained by each package's ``ElasticRunner`` as
``launch/train.py`` builds it: ``ckpt_every=2``, a failure injected at step
3, ``run(5)``, batches of ``SyntheticTokenDataset`` through each package's
``ShardedLoader``, the reference's meshes from
``repro.launch.mesh.make_test_mesh`` (Auto axes). Both give the same events
(their paths aside), the same loss each step (rtol 1e-5) and the same
final state (the reference's carried by ``convert.train_state_from_jax``;
rtol 1e-4 with an absolute term of 1e-5 of the leaf's largest |value|, the
tolerances of ``tests/test_torch_lm_train.py``). Then the three runner
edge cases of ``tests/test_elastic_podscale.py``: a failure at step 0 with
no checkpoint, back-to-back failures, and a failure on the first step
after a downgrade, the port's events equal to the reference runner's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import ShardedLoader as JShardedLoader
from repro.data import SyntheticTokenDataset as JTokens
from repro.launch.mesh import make_test_mesh as j_make_test_mesh
from repro.optim.schedules import constant_lr as j_constant_lr
from repro.optim.schedules import linear_warmup_cosine as j_warmup
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_init as j_train_state_init
from repro.train.elastic import ElasticConfig as JElasticConfig
from repro.train.elastic import ElasticRunner as JElasticRunner
from repro_torch import convert
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.data import ShardedLoader, SyntheticTokenDataset
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import constant_lr, linear_warmup_cosine
from repro_torch.train import make_train_step, train_state_init
from repro_torch.train.elastic import ElasticConfig, ElasticRunner
from repro_torch.tree import tree_leaves
from torch_families import QuickJit

RTOL = 1e-5
STATE_RTOL = 1e-4
B, SEQ, STEPS = 4, 16, 5
SPIKING = dict(spiking=True, attention_kind="qk_spiking",
               policy="fused_dense+grad")


@pytest.fixture(scope="module", autouse=True)
def group_of_one():
    """A gloo group of one for the port's collectives; one intra-op thread
    (the reduced steps are tiny; the CPU is shared)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    made = tmesh.init_distributed("cpu")
    yield
    if made:
        tmesh.shutdown_distributed()
    torch.set_num_threads(threads)


def _events(events):
    return [{k: v for k, v in e.items() if k != "path"} for e in events]


def _jax_runner(jstep, jparams, ckpt_dir, loader, n_builders=2,
                ckpt_every=2):
    """The reference's runner as its ``launch/train.py`` builds it, over
    ``jstep`` (compiled once by the caller, without backend optimisation:
    the compiles dominate this file)."""
    losses = {}

    def make_step(mesh):
        def step(state, batch):
            i = int(state.step)
            state, m = jstep(state, batch)
            losses[i] = float(m["loss"])
            return state, m
        return step

    runner = JElasticRunner(
        [lambda: j_make_test_mesh((1,), ("data",))] * n_builders, make_step,
        lambda mesh: j_train_state_init(jparams),
        lambda shape, mesh: jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, P()), shape),
        loader, JElasticConfig(ckpt_dir=str(ckpt_dir),
                               ckpt_every=ckpt_every))
    return runner, losses


def _port_runner(model, params, schedule, ckpt_dir, loader, n_builders=2,
                 ckpt_every=2):
    losses = {}

    def make_step(mesh):
        step = make_train_step(model, schedule=schedule,
                               dp_group=mesh.get_group("data"))

        def timed(state, batch):
            i = int(state.step)
            state, m = step(state, batch)
            losses[i] = float(m["loss"])
            return state, m
        return timed

    runner = ElasticRunner(
        [lambda: tmesh.make_test_mesh((1,), ("data",), device="cpu")]
        * n_builders, make_step,
        lambda mesh: train_state_init(params), lambda shape, mesh: "cpu",
        loader, ElasticConfig(ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every))
    return runner, losses


def _pair(overrides):
    jcfg = j_reduced(j_get_config("qwen3-1.7b", **overrides), **overrides)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("qwen3-1.7b", **overrides), **overrides)
    params = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, build_model(cfg), params


def _assert_state_close(got, want_jax):
    want = convert.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, want_jax), device="cpu")
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        b = b.numpy().astype(np.float64)
        atol = 1e-5 * float(np.abs(b).max()) if b.size else 0.0
        np.testing.assert_allclose(a.numpy().astype(np.float64), b,
                                   rtol=STATE_RTOL, atol=atol,
                                   err_msg=f"state leaf {i}")


@pytest.mark.parametrize("overrides", [SPIKING, {}],
                         ids=["spiking-fused_dense+grad", "softmax"])
def test_runner_matches_the_reference(overrides, tmp_path):
    jmodel, jparams, model, params = _pair(overrides)
    vocab = jmodel.cfg.vocab_size
    jds, tds = JTokens(vocab, SEQ + 1), SyntheticTokenDataset(vocab, SEQ + 1)
    jloader = JShardedLoader(
        lambda s, bs, sh, n: {"tokens": jds.batch(s, bs, sh, n)}, B,
        j_make_test_mesh((1,), ("data",)))
    tloader = ShardedLoader(
        lambda s, bs, sh, n: {"tokens": tds.batch(s, bs, sh, n)}, B,
        tmesh.make_test_mesh((1,), ("data",), device="cpu"))
    jstep = QuickJit(j_make_train_step(jmodel,
                                       schedule=j_warmup(3e-4, 10, STEPS)))
    jrun, jlosses = _jax_runner(jstep, jparams, tmp_path / "jax", jloader)
    trun, tlosses = _port_runner(model, params,
                                 linear_warmup_cosine(3e-4, 10, STEPS),
                                 tmp_path / "torch", tloader)
    jrun.inject_failure(3)
    trun.inject_failure(3)
    jstate, jevents = jrun.run(STEPS)
    tstate, tevents = trun.run(STEPS)
    assert _events(tevents) == _events(jevents) == [
        {"kind": "checkpoint", "step": 2}, {"kind": "failure", "step": 3},
        {"kind": "restore", "step": 2},
        {"kind": "remesh", "mesh": {"data": 1}, "resume_step": 3},
        {"kind": "checkpoint", "step": 4}]
    assert sorted(tlosses) == sorted(jlosses) == list(range(STEPS))
    np.testing.assert_allclose([tlosses[i] for i in range(STEPS)],
                               [jlosses[i] for i in range(STEPS)], rtol=RTOL)
    assert int(tstate.step) == int(jstate.step) == STEPS
    _assert_state_close(tstate, jstate)
    assert trun.level == jrun.level == 1
    assert (trun.monitor.summary()["stragglers"]
            == jrun.monitor.summary()["stragglers"] == [])


# ====================================================== the edge cases
@pytest.fixture(scope="module")
def edge_pair():
    jmodel, jparams, model, params = _pair({})
    tokens = np.random.default_rng(0).integers(
        0, jmodel.cfg.vocab_size, (2, 16)).astype(np.int32)
    jstep = QuickJit(j_make_train_step(jmodel, schedule=j_constant_lr(1e-3)))
    return jstep, jparams, model, params, tokens


def _edge_runners(edge_pair, tmp_path, name):
    jstep, jparams, model, params, tokens = edge_pair
    jtok = jnp.asarray(tokens)
    ttok = torch.from_numpy(tokens)
    jrun, _ = _jax_runner(jstep, jparams, tmp_path / f"jax_{name}",
                          lambda i: {"tokens": jtok}, n_builders=3)
    trun, _ = _port_runner(model, params, constant_lr(1e-3),
                           tmp_path / f"torch_{name}",
                           lambda i: {"tokens": ttok}, n_builders=3)
    return jrun, trun


def _edge_failure_at_step_zero(run):
    run.inject_failure(0)
    state, events = run.run(2)
    return int(state.step), run.level, events


def _edge_back_to_back(run):
    state, _ = run.run(3)
    run.inject_failure(3)
    state, _ = run.run(4)
    first = (run.level, int(state.step))
    run.inject_failure(4)
    state, events = run.run(6)
    second = (run.level, int(state.step))
    run.restore_capacity()
    return first, second, run.level, events


def _edge_first_step_after_downgrade(run):
    base_loader, tripped = run.loader, []

    def tripwire(step_idx):
        if not tripped and any(e["kind"] == "remesh" for e in run.events):
            tripped.append(step_idx)
            run.inject_failure(step_idx + 1)
        return base_loader(step_idx)

    run.loader = tripwire
    run.run(3)
    run.inject_failure(3)
    state, events = run.run(6)
    return int(state.step), run.level, tripped, events


EDGES = {"failure at step 0, no checkpoint": _edge_failure_at_step_zero,
         "back-to-back failures": _edge_back_to_back,
         "failure on the first step after a downgrade":
             _edge_first_step_after_downgrade}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_edge_cases_match_the_reference(case, edge_pair, tmp_path):
    jrun, trun = _edge_runners(edge_pair, tmp_path, "edge")
    *jrest, jevents = EDGES[case](jrun)
    *trest, tevents = EDGES[case](trun)
    assert trest == jrest
    assert _events(tevents) == _events(jevents)
    kinds = [e["kind"] for e in tevents]
    if case.startswith("failure at step 0"):
        assert kinds[:2] == ["failure", "remesh"] and "restore" not in kinds
        assert trest == [2, 1]
    elif case.startswith("back-to-back"):
        assert trest == [(1, 4), (2, 6), 0]
        assert [e["step"] for e in tevents if e["kind"] == "failure"] == [3, 4]
        assert {e["step"] for e in tevents if e["kind"] == "restore"} == {2}
    else:
        assert trest == [6, 2, [3]]
        assert [e["resume_step"] for e in tevents
                if e["kind"] == "remesh"] == [3, 3]
