"""The dry runs: ``repro_torch.analysis.abstract``'s model-level shape walk,
``repro_torch.launch.dryrun`` (the spec half at the production meshes, the
trace half on fake tensors), ``launch.hlo_analysis`` (the op record and the
reference's cost rules) and the report half of ``launch.roofline``, against
the reference's dry run, HLO analysis and report. No JAX mesh is built with
``jax.make_mesh``: specs take a ``jax.sharding.AbstractMesh``, and every
compile here is on one device.
"""
import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import cells_for as jax_cells_for
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import hlo_analysis as jax_hlo
from repro.launch import roofline as jax_roofline
from repro.models import sharding as jax_shd
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch.analysis.abstract import (module_param_shapes,
                                          optimizer_shapes)
from repro_torch.configs import ARCHS, SHAPES, build_model, get_config
from repro_torch.configs import reduced
from repro_torch.configs.base import ShapeSpec, cells_for
from repro_torch.launch import dryrun, hlo_analysis, roofline
from repro_torch.launch.mesh import Mesh
from repro_torch.ops import registry
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_leaves_with_path

MESH_SHAPES = {"single": ((16, 16), ("data", "model")),
               "multi": ((2, 16, 16), ("pod", "data", "model"))}
STACKED = ("blocks", "enc_blocks", "dec_blocks")
SMALL = ShapeSpec("small", "train", 64, 4)       # 4 x 64 tokens


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without its module-level
    ``XLA_FLAGS`` (512 host devices) reaching this process."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


def _jax_shapes(arch):
    model = jax_build_model(jax_get_config(arch))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return model, params, jax.eval_shape(jax_adamw_init, params)


def _unstacked(tree):
    """JAX's shape tree as the port lays it out: a stacked tree's leaves
    [L, ...] as a list of L trees of [...] leaves; "dtype[shape]"
    leaves."""
    def leaf(x, drop):
        return f"{jnp.dtype(x.dtype).name}{list(x.shape[drop:])}"

    def walk(t, drop):
        if isinstance(t, dict):
            return {k: walk(v, drop) for k, v in t.items()}
        return leaf(t, drop)

    out = {}
    for k, v in tree.items():
        if k in STACKED:
            n = jax.tree_util.tree_leaves(v)[0].shape[0]
            out[k] = [walk(v, 1) for _ in range(n)]
        else:
            out[k] = walk(v, 0)
    return out


def _port_leaves(tree):
    return [(path, f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}")
            for path, t in tree_leaves_with_path(tree)]


# ------------------------------------------------------ parameter shapes
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_optimizer_shapes_match_jax(arch):
    """Full width: every leaf of ``module_param_shapes`` /
    ``optimizer_shapes`` is JAX's ``eval_shape`` leaf (a port layer is a
    stacked leaf without its leading dimension); the counts and every
    cell's analytic model flops are the reference's."""
    ref = _reference_dryrun()
    jmodel, jparams, jopt = _jax_shapes(arch)
    model = build_model(get_config(arch))
    params = module_param_shapes(model.init)
    opt = optimizer_shapes(adamw_init, params)
    assert all(type(t).__name__ == "FakeTensor" for t in tree_leaves(params))
    assert _port_leaves(params) == tree_leaves_with_path(_unstacked(jparams))
    assert tuple(opt.step.shape) == tuple(jopt.step.shape) == ()
    assert str(opt.step.dtype) == "torch.int32"
    for mine, theirs in ((opt.m, jopt.m), (opt.v, jopt.v)):
        assert _port_leaves(mine) == tree_leaves_with_path(
            _unstacked(theirs))
    cfg = get_config(arch)
    assert dryrun.param_count(params) == ref.param_count(jparams)
    assert dryrun.active_param_count(cfg, params) == \
        ref.active_param_count(jmodel.cfg, jparams)
    assert cells_for(cfg) == jax_cells_for(jmodel.cfg)
    for cell in cells_for(cfg):
        assert dryrun.analytic_model_flops(cfg, params, SHAPES[cell]) == \
            ref.analytic_model_flops(jmodel.cfg, jparams, SHAPES[cell])


# ------------------------------------------------------- per-device bytes
def _ref_shard_bytes(shapes, specs, mesh):
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    total = 0
    for x, spec in zip(leaves, spec_leaves, strict=True):
        div = 1
        for s in spec:
            for a in ((s,) if isinstance(s, str) else (s or ())):
                div *= mesh.shape[a]
        n = jnp.dtype(x.dtype).itemsize
        for d in x.shape:
            n *= d
        assert n % div == 0
        total += n // div
    return total


@pytest.mark.parametrize("mesh_mode", ["single", "multi"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "mamba2-130m"])
def test_per_device_bytes_match_the_reference_specs(arch, mesh_mode):
    """The spec half at the production mesh: parameter, moment and batch
    bytes on one device equal those of the reference's ``param_specs``,
    ``zero1_specs`` and ``batch_specs`` over a ``jax.sharding.AbstractMesh``
    of the same shape."""
    shape_, axes = MESH_SHAPES[mesh_mode]
    jmesh = jax.sharding.AbstractMesh(shape_, axes)
    jmodel, jparams, jopt = _jax_shapes(arch)
    jbatch = jmodel.input_specs(SHAPES["train_4k"])["batch"]
    model = build_model(get_config(arch))
    params = module_param_shapes(model.init)
    opt = optimizer_shapes(adamw_init, params)
    got = dryrun.per_device_bytes(model, SHAPES["train_4k"],
                                  dryrun.production_mesh(mesh_mode),
                                  params, opt)
    z1 = jax_shd.zero1_specs(jparams, jmesh)
    assert got["params"] == _ref_shard_bytes(
        jparams, jax_shd.param_specs(jparams, jmesh), jmesh)
    assert got["opt_state"] == 4 + 2 * _ref_shard_bytes(jopt.m, z1, jmesh)
    assert got["batch"] == _ref_shard_bytes(
        jbatch, jax_shd.batch_specs(jbatch, jmesh), jmesh)
    assert got["arguments"] == (got["params"] + got["opt_state"]
                                + got["batch"] + 4)


def test_cli_cell_keeps_its_spec_half_and_names_the_trace(tmp_path):
    """A production cell: the trace needs tensor parallelism, so the JSON
    holds the spec half, the argument bytes and the reason."""
    dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k", "--mesh",
                 "single", "--outdir", str(tmp_path)])
    rec = json.loads(
        (tmp_path / "qwen3-1.7b__train_4k__single.json").read_text())
    assert not rec["trace"]["ported"]
    assert "ROADMAP queue 1 item 6" in rec["trace"]["reason"]
    assert rec["hlo"] is None and rec["n_chips"] == 256
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        rec["per_device_bytes"]["arguments"]
    cell = roofline.analyze_cell(rec)
    assert cell["bound"] == "not ported" and cell["fits"]
    assert "not ported" in roofline.markdown([cell])


# ---------------------------------------------------------- flops vs JAX
VARIANTS = {"softmax": {}, "spiking": dict(spiking=True,
                                          attention_kind="qk_spiking")}


def _jax_flops(kw, train: bool):
    model = jax_build_model(jax_reduced(jax_get_config("qwen3-1.7b", **kw)))
    p = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((SMALL.global_batch,
                                             SMALL.seq_len), jnp.int32)}
    if not train:
        fn = jax.jit(lambda p, b: model.loss(p, b)[0])
        return jax_hlo.analyze(fn.lower(p, batch).compile().as_text())

    def train_step(params, opt_state, batch):
        # the reference dry run's step (repro.launch.dryrun.run_cell)
        (_, metrics), grads = jax.value_and_grad(
            model.loss, has_aux=True)(params, batch)
        grads = jax.lax.optimization_barrier(grads)
        grads, gnorm = jax_clip(grads, 1.0)
        new_p, new_o = jax_adamw_update(grads, opt_state, params, lr=3e-4,
                                        weight_decay=0.1)
        return new_p, new_o, dict(metrics, grad_norm=gnorm)

    o = jax.eval_shape(jax_adamw_init, p)
    fn = jax.jit(train_step, donate_argnums=(0, 1))
    return jax_hlo.analyze(fn.lower(p, o, batch).compile().as_text())


def _port_trace(kw, train: bool, mesh=(1, 1)):
    model = build_model(reduced(get_config("qwen3-1.7b", **kw)))
    params = module_param_shapes(model.init)
    mesh = Mesh(mesh, ("data", "model"), device="cpu")
    if train:
        return dryrun.trace_step(model, SMALL, mesh, params,
                                 optimizer_shapes(adamw_init, params))
    with tree_leaves(params)[0].fake_mode:
        batch = {"tokens": torch.zeros((SMALL.global_batch, SMALL.seq_len),
                                       dtype=torch.int32)}
        with hlo_analysis.OpRecorder((params, batch)) as rec:
            out = model.loss(params, batch)
    return rec, out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flops_match_the_reference_analysis(variant):
    """Reduced qwen3-1.7b (f32) on one device: ``analyze`` of the port's
    record against ``analyze`` of the reference's compiled HLO. The loss
    within 1e-6, the train step (loss, backward, clip, AdamW) within 1 %:
    both count the same matmuls (every projection, the attention's two
    products, the read-out, and each one's two backward products), so
    they agree exactly here; XLA's rewrites would be the gap."""
    kw = VARIANTS[variant]
    for train, tol in ((False, 1e-6), (True, 1e-2)):
        rec, _ = _port_trace(kw, train)
        got = hlo_analysis.analyze(rec.record)["flops"]
        want = _jax_flops(kw, train)["flops"]
        assert want > 0
        assert abs(got - want) <= tol * want, (train, got, want)


def test_real_and_fake_records_agree():
    """The recorder on real CPU tensors gives the fake trace's ops, flops,
    bytes and memory fields exactly (what the card's phase checks)."""
    model = build_model(reduced(get_config("qwen3-1.7b")))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((SMALL.global_batch, SMALL.seq_len),
                                   dtype=torch.int32)}
    with hlo_analysis.OpRecorder((params, batch)) as rec:
        out = model.loss(params, batch)
    fake, fake_out = _port_trace({}, False)
    assert [e["op"] for e in rec.record] == [e["op"] for e in fake.record]
    assert hlo_analysis.analyze(rec.record) == \
        hlo_analysis.analyze(fake.record)
    assert rec.memory_analysis(out) == fake.memory_analysis(fake_out)


def test_conv_flops_match_the_reference_rule():
    """A 3x3 conv: the recorded forward at the reference's ``_conv_flops``
    of the same conv compiled by XLA (NHWC, HWIO), and its backward one
    such product for each gradient it makes (input, weight)."""
    b, h, w, cin, cout = 2, 8, 8, 4, 6
    fn = jax.jit(lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    want = jax_hlo.analyze(fn.lower(
        jax.ShapeDtypeStruct((b, h, w, cin), jnp.float32),
        jax.ShapeDtypeStruct((3, 3, cin, cout), jnp.float32),
    ).compile().as_text())["flops"]
    x = torch.randn(b, cin, h, w, requires_grad=True)
    k = torch.randn(cout, cin, 3, 3, requires_grad=True)
    with hlo_analysis.OpRecorder((x, k)) as rec:
        y = torch.nn.functional.conv2d(x, k, padding=1)
        y.sum().backward()
    flops = {e["op"]: hlo_analysis.op_flops(e) for e in rec.record
             if hlo_analysis.op_flops(e)}
    assert flops == {"aten.convolution.default": want,
                     "aten.convolution_backward.default": 2 * want}
    assert want == 2.0 * b * h * w * cout * cin * 9


# ---------------------------------------------------------- collectives
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("n", [1, 2, 16, 512])
def test_collective_wire_bytes_match_the_reference(kind, n):
    for size in (0, 4, 1 << 20, 12345678):
        assert hlo_analysis._collective_wire_bytes(kind, size, n) == \
            jax_hlo._collective_wire_bytes(kind, size, n)


def test_recorded_all_reduces_on_a_data_parallel_mesh():
    """A train step on a DP mesh of 2 (the fake backend): one all-reduce a
    gradient leaf, summing the leaves' bytes, and the metrics' one; each
    over a group of 2, priced by the ring model."""
    rec, (state, _) = _port_trace({}, True, mesh=(2, 1))
    coll = [e for e in rec.record if e["op"].startswith("c10d.")]
    leaves = tree_leaves(state.params)
    assert len(coll) == len(leaves) + 1
    assert {e["group"] for e in coll} == {2}
    per_leaf = coll[:len(leaves)]
    assert sum(hlo_analysis.type_bytes(e["out"]) for e in per_leaf) == \
        sum(t.numel() * t.element_size() for t in leaves)
    r = hlo_analysis.analyze(rec.record)
    assert r["collectives"]["all-reduce"]["count"] == len(leaves) + 1
    assert r["collective_wire_bytes"] == pytest.approx(
        r["collective_bytes"])                      # 2 (n - 1) / n at n = 2
    # the batch is this rank's half
    rows = {d[1][0] for e in rec.record for d in e["in"]
            if d[0] == "int32" and len(d[1]) == 2}
    assert rows == {SMALL.global_batch // 2}


# ----------------------------------------------------------- fused nodes
def _prefill_record(policy):
    """A warm prefill's record: the call before it made what the model
    memoises once a weight (the fused path's grouped-KV columns,
    ``tree.derived``), which a served model holds from its first call."""
    cfg = reduced(get_config("qwen3-1.7b", spiking=True,
                             attention_kind="qk_spiking", policy=policy))
    model = build_model(cfg)
    params = module_param_shapes(model.init)
    with tree_leaves(params)[0].fake_mode, warnings.catch_warnings():
        # the fused wrappers' CPU branch asks a fake tensor for its address
        warnings.filterwarnings(
            "ignore", message="Accessing the data pointer of FakeTensor")
        batch = {"tokens": torch.zeros((2, 32), dtype=torch.int32)}
        with hlo_analysis.OpRecorder():
            model.prefill(params, batch)      # the warm-up, not kept
        with registry.record_dispatches() as log, \
                hlo_analysis.OpRecorder((params, batch)) as rec:
            out = model.prefill(params, batch)
    return rec, out, log


def test_fused_ops_are_one_node_each():
    """Under ``fused_dense`` every fused call is one record entry, its
    flops its plain version's: the same total as ``reference``, and no
    higher a peak (the plain version's intermediates do not count)."""
    fused, fused_out, log = _prefill_record("fused_dense")
    ref, ref_out, _ = _prefill_record("reference")
    nodes = [e for e in fused.record if e.get("node")]
    assert len(nodes) == sum("fused" in mode for _, mode in log) > 0
    assert {e["op"] for e in nodes} >= {"dense_lif[fused]", "matmul[fused]"}
    assert all(e["inner"] for e in nodes)
    a, b = hlo_analysis.analyze(fused.record), hlo_analysis.analyze(
        ref.record)
    assert a["flops"] == b["flops"] > 0
    assert fused.memory_analysis(fused_out)["temp_size_in_bytes"] <= \
        ref.memory_analysis(ref_out)["temp_size_in_bytes"]


def test_pricing_a_node_logs_no_dispatch():
    """A fused node's plain version is priced without a dispatch: the
    ``(op, mode)`` log under the recorder is the one without it."""
    _, _, log = _prefill_record("fused_dense")
    cfg = reduced(get_config("qwen3-1.7b", spiking=True,
                             attention_kind="qk_spiking",
                             policy="fused_dense"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((2, 32), dtype=torch.int32)}
    model.prefill(params, batch)
    with registry.record_dispatches() as plain_log:
        model.prefill(params, batch)
    assert log == plain_log
    assert not any(mode.startswith("reference") for _, mode in log)


def test_a_fake_trace_leaves_real_constants():
    """A model run on fake tensors caches no fake constant (the RoPE
    frequencies): a real run after it, from a cold cache, still works and
    gives the same record."""
    from repro_torch.models import layers

    model = build_model(reduced(get_config("qwen3-1.7b")))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((SMALL.global_batch, SMALL.seq_len),
                                   dtype=torch.int32)}
    layers._rope_freqs_on.cache_clear()
    fake, _ = _port_trace({}, False)
    with hlo_analysis.OpRecorder((params, batch)) as rec:
        loss = model.loss(params, batch)[0]
    assert not isinstance(loss, torch._subclasses.FakeTensor)
    assert bool(torch.isfinite(loss))
    assert [e["op"] for e in rec.record] == [e["op"] for e in fake.record]


def test_tensors_walks_spike_tensors():
    """``hlo_analysis.tensors`` finds the tensors inside a ``SpikeTensor``
    and a ``PackedSpikes``, in field order, and nothing else."""
    from repro_torch.core.events import pack_spikes_ref
    from repro_torch.ops import SpikeTensor

    x = (torch.arange(2 * 128 * 128).reshape(2, 128, 128) % 3 == 0).to(
        torch.int8)
    ps = pack_spikes_ref(x)
    st = SpikeTensor.from_packed(ps)
    got = hlo_analysis.tensors([x, {"s": st, "n": 3}, (ps, None)])
    want = [x, st.data, st.vld_cnt] + ([st.occ] if st.occ is not None
                                       else []) + [ps.words, ps.vld_cnt] + (
        [ps.occ] if ps.occ is not None else [])
    assert len(got) == len(want)
    assert all(a is b for a, b in zip(got, want))


# ------------------------------------------------------------- the report
def _hand_made_records():
    base = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "single",
            "tag": "", "n_chips": 256, "model_flops": 8.867e15,
            "memory_analysis": {"argument_size_in_bytes": 4.8e8,
                                "temp_size_in_bytes": 9.0e9}}
    hlos = [
        {"flops": 4.0e13, "bytes": 2.0e12, "collective_bytes": 5e9,
         "collective_wire_bytes": 9.9e9,
         "collectives": {"all-reduce": {"count": 311, "bytes": 5e9,
                                        "wire_bytes": 9.9e9}}},
        {"flops": 4.0e14, "bytes": 1.0e10, "collective_bytes": 0.0,
         "collective_wire_bytes": 0.0, "collectives": {}},
        {"flops": 1.0e12, "bytes": 1.0e11, "collective_bytes": 0.0,
         "collective_wire_bytes": 0.0, "collectives": {}},
        {"flops": 1.0e11, "bytes": 1.0e11, "collective_bytes": 1e12,
         "collective_wire_bytes": 3e12,
         "collectives": {"all-gather": {"count": 3, "bytes": 1e12,
                                        "wire_bytes": 3e12}}},
    ]
    recs = []
    for i, hlo in enumerate(hlos):
        rec = dict(base, hlo=hlo, shape=f"cell{i}")
        if i == 2:
            rec["model_flops"] = 1e11       # a low useful ratio
        recs.append(rec)
    return recs


def test_report_matches_the_reference_at_its_constants():
    chip = roofline.Chip("TPU v5e", jax_roofline.PEAK_FLOPS,
                         jax_roofline.HBM_BW, jax_roofline.LINK_BW,
                         jax_roofline.HBM_PER_CHIP)
    recs = _hand_made_records()
    mine = [roofline.analyze_cell(r, chip) for r in recs]
    theirs = [jax_roofline.analyze_cell(r) for r in recs]
    for m, t in zip(mine, theirs):
        assert {k: m[k] for k in t} == t
        assert roofline.suggestion(m) == jax_roofline.suggestion(t)
    assert roofline.markdown(mine, chip) == jax_roofline.markdown(theirs)
    assert "fits 80G" in roofline.markdown(
        [roofline.analyze_cell(recs[0])])


def test_list_matches_the_reference(capsys):
    ref = _reference_dryrun()
    argv = sys.argv
    try:
        sys.argv = ["dryrun", "--list", "--mesh", "both"]
        ref.main()
    finally:
        sys.argv = argv
    want = capsys.readouterr().out
    dryrun.main(["--list", "--mesh", "both"])
    assert capsys.readouterr().out == want
    assert dryrun._cells(["single", "multi"]) == ref._cells(
        ["single", "multi"])
