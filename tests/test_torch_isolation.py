"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points never drop to the CPU on their own, and every fused variant
whose kernel is still to port, and every part of the LM and serving path
still to port, raises instead of running a plain version; the variants
ported since run.
"""
import ast
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys
import tempfile
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert, ops
from repro_torch.configs import SHAPES, build_model, get_config, reduced
from repro_torch.core.lif import LIFConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import sharding, snn_cnn
from repro_torch.models.attention import attn_apply
from repro_torch.ops import fallback
from repro_torch.serve import Engine, EngineConfig, FaultPlan

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "torch_train_kd_cifar.py",
        ROOT / "tools" / "torch_neurallint.py"]


def _kd_pipeline():
    spec = importlib.util.spec_from_file_location(
        "torch_train_kd_cifar", ROOT / "examples" / "torch_train_kd_cifar.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kd_run():
    """The KD pipeline's ``run`` with no device: its KDT weights."""
    rec = {}
    _kd_pipeline().run(steps=1, quiet=True, record=rec)
    return rec["vars"]["KDT"]


def _imported_roots(path):
    """Top-level names of every absolute import in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.ops\n"
        "import repro_torch.models.snn_cnn, repro_torch.kernels._build\n"
        "import repro_torch.kernels.fused_pe, repro_torch.kernels.lif_update\n"
        "import repro_torch.kernels.spike_matmul\n"
        "import repro_torch.kernels.packed\n"
        "import repro_torch.kernels.w2ttfs_pool\n"
        "import repro_torch.kernels.qk_attention\n"
        "import repro_torch.core.surrogate, repro_torch.core.kd\n"
        "import repro_torch.core.qk_attention, repro_torch.tree\n"
        "import repro_torch.models.ann_cnn, repro_torch.optim\n"
        "import repro_torch.train.trainer, repro_torch.data.synthetic\n"
        "import repro_torch.ops.grad, repro_torch.ops.autotune\n"
        "import repro_torch.launch.roofline\n"
        "import repro_torch.configs, repro_torch.models.lm\n"
        "import repro_torch.models.layers, repro_torch.models.attention\n"
        "import repro_torch.models.ffn, repro_torch.serve\n"
        "import repro_torch.models.ssm, repro_torch.models.encdec\n"
        "import repro_torch.launch.serve, repro_torch.serve.router\n"
        "import repro_torch.serve.faults, repro_torch.ops.fallback\n"
        "import repro_torch.launch.train, repro_torch.launch.mesh\n"
        "import repro_torch.train.elastic, repro_torch.train.checkpoint\n"
        "import repro_torch.train.straggler, repro_torch.data.loader\n"
        "import repro_torch.optim.compression, repro_torch.models.sharding\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis\n"
        "import repro_torch.analysis.abstract\n"
        "repro_torch.ops.lookup('matmul', 'reference')\n"
        "repro_torch.ops.lookup('dense_lif', 'fused')\n"
        "repro_torch.ops.lookup('matmul', 'fused+grad')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ------------------------------------------------------------------ devices
def _entry_points():
    cfg = snn_cnn.SNNCNNConfig(arch="resnet11", width_mult=0.125,
                               image_size=16)
    lm_cfg = reduced(get_config("qwen3-1.7b", spiking=True,
                                attention_kind="qk_spiking"))
    ed_cfg = reduced(get_config("seamless-m4t-large-v2"))
    return {
        "lm init": lambda: build_model(lm_cfg).init(torch.Generator()),
        "lm init_cache": lambda: build_model(lm_cfg).init_cache(2, 8),
        "encdec init": lambda: build_model(ed_cfg).init(torch.Generator()),
        "encdec init_cache": lambda: build_model(ed_cfg).init_cache(2, 8, 4),
        "encdec_params_from_jax": lambda: convert.encdec_params_from_jax(
            {"embed": {"emb": np.ones((4, 2), np.float32)},
             "enc_blocks": {"ln1": {"scale": np.ones((2, 2), np.float32)}},
             "dec_blocks": {"ln1": {"scale": np.ones((2, 2), np.float32)}}}),
        "lm_params_from_jax": lambda: convert.lm_params_from_jax(
            {"embed": {"emb": np.ones((4, 2), np.float32)},
             "blocks": {"ln1": {"scale": np.ones((2, 2), np.float32)}}}),
        "launch.serve": lambda: serve_main(
            ["--reduced", "--spiking", "--qk-attention", "--requests", "1"]),
        "launch.train": lambda: train_main(
            ["--reduced", "--steps", "1", "--batch", "2", "--seq", "8",
             "--ckpt-dir", tempfile.mkdtemp()]),
        "resolve_device": lambda: repro_torch.resolve_device(),
        "kd pipeline run": _kd_run,
        "init": lambda: snn_cnn.init(torch.Generator(), cfg),
        "variables_from_jax": lambda: convert.variables_from_jax(
            {"params": [{"w": np.ones(2, np.float32)}], "state": [{}]}),
        "fused_from_jax": lambda: convert.fused_from_jax(
            [{"w": np.ones(2, np.float32)}]),
    }


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else tree
    for v in values:
        found = _first_tensor(v)
        if found is not None:
            return found
    return None


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """With no device given, the entry points run on CUDA; where there is
    no card they raise rather than carry on on the CPU."""
    call = _entry_points()[name]
    if torch.cuda.is_available():
        out = call()
        if not isinstance(out, torch.device):
            out = _first_tensor(out).device
        assert out.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_explicit_cpu_device_is_honoured():
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    fused = convert.fused_from_jax([{"w": np.ones(2, np.float32)}],
                                   device="cpu")
    assert fused[0]["w"].device.type == "cpu"


# ------------------------------------------------------ unported variants
def _spikes(t=1, m=8, k=8):
    return ops.SpikeTensor.dense(torch.ones((t, m, k), dtype=torch.int8))


def _packed(t=1, m=8, k=8):
    return ops.pack(torch.ones((t, m, k), dtype=torch.int8),
                    policy="fused_packed")


def _unported():
    w = torch.ones((8, 8))
    cfg = snn_cnn.SNNCNNConfig(arch="resnet11", width_mult=0.125,
                               image_size=16)
    fused = snn_cnn.fuse_model(
        snn_cnn.init(torch.Generator(), cfg, device="cpu"), cfg)
    img = torch.zeros((1, 16, 16, 3))
    variables = snn_cnn.init(torch.Generator(), cfg, device="cpu")
    lm_softmax = build_model(reduced(get_config("qwen3-1.7b")))
    lm_softmax_params = lm_softmax.init(torch.Generator(), device="cpu")
    lm_softmax_cp = build_model(reduced(get_config("qwen3-1.7b"),
                                        decode_cp_axis="data"))
    return {
        "lm softmax context-parallel decode":
            lambda: lm_softmax_cp.decode_step(
                lm_softmax_params, torch.zeros((1, 1), dtype=torch.int64),
                lm_softmax_cp.init_cache(1, 8, device="cpu")),
        "param_shardings over a model axis": lambda: sharding.param_shardings(
            lm_softmax_params, Mesh((1, 2), ("data", "model"),
                                    device="cpu")),
        "dry-run trace over a model axis": lambda: dryrun.trace_step(
            lm_softmax, SHAPES["train_4k"],
            Mesh((1, 2), ("data", "model"), device="cpu"),
            lm_softmax_params),
    }


@pytest.mark.parametrize("case", sorted(_unported()))
def test_unported_variants_raise(case):
    with pytest.raises((NotImplementedError, TypeError)) as err:
        _unported()[case]()
    assert "ROADMAP" in str(err.value)


SERVE_SPIKING = ["--reduced", "--spiking", "--qk-attention", "--requests",
                 "4", "--device", "cpu"]


def _ported_with_self_healing():
    """Parts of the serving path that raised until self-healing serving
    was ported: each serves a few requests of the reduced spiking
    qwen3-1.7b on the CPU to the end. Returns (stats, requests, tokens
    each request asks for)."""
    def engine(faults, **kw):
        def run():
            model = build_model(reduced(get_config(
                "qwen3-1.7b", spiking=True, attention_kind="qk_spiking")))
            params = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            eng = Engine(model, params, EngineConfig(
                max_slots=2, max_len=32, prefill_pad=8, **kw), faults=faults)
            for n in (3, 5, 4):
                eng.submit(np.arange(1, n + 1), max_new=4)
            eng.run_until_drained()
            return eng.stats(), 3, 4
        return run

    return {
        "engine fault plan": engine(FaultPlan(0).stall_consumer(1, ticks=2)),
        "engine integrity guard": engine(None, integrity_every=1),
        "serve replica router": lambda: (serve_main(
            SERVE_SPIKING + ["--replicas", "2"]), 4, 16),
        "serve chaos plan": lambda: (serve_main(
            SERVE_SPIKING + ["--chaos"]), 4, 16),
    }


@pytest.mark.parametrize("case", sorted(_ported_with_self_healing()))
def test_variants_ported_with_self_healing_run(case):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            st, n, max_new = _ported_with_self_healing()[case]()
    finally:
        fallback.reset()
    per = [p for p in st.get("per_replica", [st]) if p]
    assert st["n"] == n and sum(p["n_terminal"] for p in per) == n
    assert all(p["tokens"] == max_new * p["n"] for p in per)


def test_launch_serve_replicas_chaos_fails_over_and_demotes():
    """The canned chaos plan through two replicas on the CPU: the second
    replica dies, its requests finish on the first, and the armed fault
    demotes the fused ``dense_lif`` (the engine runs ``fused_packed``: the
    reduced model's own policy, ``reference``, has no fused call to
    fail)."""
    try:
        with pytest.warns(RuntimeWarning, match="dense_lif"):
            st = serve_main(SERVE_SPIKING + [
                "--replicas", "2", "--chaos", "--policy", "fused_packed"])
        demoted = [d["op"] for d in fallback.demotions()]
    finally:
        fallback.reset()
    assert st["failovers"] == 1 and st["alive"] == [True, False]
    assert [f["reason"] for f in st["failures"]] == [
        "step raised: injected replica death at tick 12"]
    assert st["n"] == 4 and demoted == ["dense_lif"]
    assert [d["op"] for d in st["per_replica"][0]["kernel_demotions"]] \
        == ["dense_lif"]


def test_serve_example_twin_runs_on_the_cpu():
    """``examples/torch_serve_lm.py`` at reduced width on the CPU: the
    spiking packed engine behind two replicas under the chaos plan streams
    every request to its end."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_serve_lm", ROOT / "examples" / "torch_serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    try:
        with pytest.warns(RuntimeWarning, match="demoted"):
            out = mod.main(["--device", "cpu", "--requests", "6",
                            "--spiking", "--policy", "fused_packed",
                            "--replicas", "2", "--chaos"])
    finally:
        fallback.reset()
    st = out["stats"]
    assert st["n"] == 6 and st["failovers"] == 1
    assert all(out["streamed"].values())


TRAIN_REDUCED = ["--reduced", "--device", "cpu", "--steps", "4", "--batch",
                 "2", "--seq", "8"]


def _ported_with_the_training_driver():
    """The training driver, which raised until it was ported: the reduced
    qwen3-1.7b on the CPU through a checkpoint, a failure and the remesh,
    and the int8 + error-feedback compressed path, each to its last step.
    Returns (the run, the events it must give)."""
    def run(extra):
        return lambda: train_main(TRAIN_REDUCED + extra + [
            "--ckpt-dir", tempfile.mkdtemp()])

    elastic = [{"kind": "checkpoint", "step": 2},
               {"kind": "failure", "step": 3}, {"kind": "restore", "step": 2},
               {"kind": "remesh", "mesh": {"data": 1}, "resume_step": 3}]
    return {
        "launch.train --simulate-failure": lambda: (run(
            ["--ckpt-every", "2", "--simulate-failure", "3"])(), elastic),
        "launch.train spiking fused_dense --simulate-failure": lambda: (run(
            ["--spiking", "--qk-attention", "--policy", "fused_dense",
             "--ckpt-every", "2", "--simulate-failure", "3"])(), elastic),
        "launch.train --compress": lambda: (run(["--compress"])(), []),
    }


@pytest.mark.parametrize("case", sorted(_ported_with_the_training_driver()))
def test_variants_ported_with_the_training_driver_run(case):
    out, events = _ported_with_the_training_driver()[case]()
    assert int(out.state.step) == 4 and len(out.losses) == 4
    assert all(np.isfinite(out.losses))
    assert [{k: v for k, v in e.items() if k != "path"}
            for e in out.events] == events
    assert not torch.distributed.is_initialized()


def test_training_runs_without_a_ckpt_dir_share_no_checkpoint(monkeypatch,
                                                            tmp_path):
    """Two runs without ``--ckpt-dir`` each checkpoint into a directory of
    their own under the temporary directory, removed at the end: the
    second starts at step 0 and restores nothing of the first."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    args = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "8", "--ckpt-every", "1"]
    first, second = train_main(args), train_main(args)
    assert ([e["kind"] for e in first.events]
            == [e["kind"] for e in second.events] == ["checkpoint"])
    assert first.losses == second.losses
    assert list(tmp_path.iterdir()) == []


def _ported_with_the_families():
    """Parts of the LM path that raised until the other families were
    ported: each family builds, initialises on the CPU and gives finite
    logits of the expected shape from a short prefill, and softmax
    attention over external K/V (the encdec family's cross-attention)
    runs."""
    def family(arch):
        def run():
            cfg = reduced(get_config(arch))
            model = build_model(cfg)
            params = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            toks = torch.zeros((1, 3), dtype=torch.int64)
            if cfg.family == "encdec":
                batch = {"src_embeds": torch.ones((1, 4, cfg.d_src)),
                         "tgt_tokens": toks}
            else:
                batch = {"tokens": toks}
            logits, _ = model.prefill(params, batch)
            return logits, (1, cfg.vocab_size)
        return run

    def kv_override():
        model = build_model(reduced(get_config("qwen3-1.7b")))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        out = attn_apply(
            params["blocks"][0]["attn"], model.cfg, torch.ones((1, 2, 64)),
            torch.zeros((1, 2), dtype=torch.int64),
            kv_override=(torch.ones((1, 5, 2, 16)),) * 2)
        return out, (1, 2, 64)

    return {
        "lm family moe": family("olmoe-1b-7b"),
        "lm family ssm": family("mamba2-130m"),
        "lm family hybrid": family("zamba2-7b"),
        "lm family vlm": family("phi-3-vision-4.2b"),
        "lm family encdec": family("seamless-m4t-large-v2"),
        "lm softmax kv_override": kv_override,
    }


@pytest.mark.parametrize("case", sorted(_ported_with_the_families()))
def test_variants_ported_with_the_families_run(case):
    out, shape = _ported_with_the_families()[case]()
    assert tuple(out.shape) == shape
    assert bool(torch.isfinite(out).all())


def _ported_with_lm_training():
    """Variants that raised until LM training was ported: the
    differentiable head-blocked fused PE and ``dense_lif`` now run on the
    CPU (the plain versions) and give spikes of the expected shape, with a
    gradient into the weight."""
    w = torch.ones((8, 8))
    return {
        "fused_pe +grad heads": lambda: ops.fused_pe(
            torch.ones((8, 8)), w, q=torch.ones((8, 8)), heads=(2, 4),
            policy="fused_dense+grad").spikes.data,
        "dense_lif fused+grad lookup": lambda: ops.lookup(
            "dense_lif", "fused+grad")(
                {"w": w}, torch.ones((4, 8)), LIFConfig(), q=None,
                qk_threshold=1.0, fmt="dense").data,
        "dense_lif reference+grad lookup": lambda: ops.lookup(
            "dense_lif", "reference+grad")(
                {"w": w}, torch.ones((4, 8)), LIFConfig(), q=None,
                qk_threshold=1.0, fmt="dense").data,
        "dense_lif fused_dense+grad": lambda: ops.dense_lif(
            {"w": w}, torch.ones((4, 8)), LIFConfig(),
            policy="fused_dense+grad").data,
        "dense_lif reference+grad": lambda: ops.dense_lif(
            {"w": w}, torch.ones((4, 8)), LIFConfig(),
            policy="reference+grad").data,
    }


@pytest.mark.parametrize("case", sorted(_ported_with_lm_training()))
def test_variants_ported_with_lm_training_run(case):
    out = _ported_with_lm_training()[case]()
    assert isinstance(out, torch.Tensor) and out.numel() > 0
    assert out.dtype == torch.float32
    assert bool(((out == 0) | (out == 1)).all()) and bool(out.any())


def _ported_with_kd_training():
    """Variants that raised until KD training was ported: they now
    run on the CPU (the plain versions) and give spikes or currents of the
    expected shape."""
    w = torch.ones((8, 8))
    cfg = snn_cnn.SNNCNNConfig(arch="resnet11", width_mult=0.125,
                               image_size=16)
    variables = snn_cnn.init(torch.Generator(), cfg, device="cpu")
    fused = snn_cnn.fuse_model(variables, cfg)
    img = torch.zeros((1, 16, 16, 3))
    return {
        "qk_mask fused (K8)": lambda: ops.qk_mask(
            torch.ones((4, 8)), torch.ones((4, 8)),
            policy="fused_dense").data,
        "matmul +grad policy": lambda: ops.matmul(
            torch.ones((8, 8), dtype=torch.int8), w,
            policy="fused_dense+grad"),
        "forward +grad": lambda: snn_cnn.forward(
            fused, img, cfg, policy="reference+grad")[0],
        "forward unfused graph": lambda: snn_cnn.forward(
            variables, img, cfg)[0],
        "fold_train_params": lambda: snn_cnn.fold_train_params(
            variables["params"], variables["state"], cfg)[0]["conv"]["w"],
    }


@pytest.mark.parametrize("case", sorted(_ported_with_kd_training()))
def test_variants_ported_with_kd_training_run(case):
    out = _ported_with_kd_training()[case]()
    assert isinstance(out, torch.Tensor) and out.numel() > 0
    assert bool(torch.isfinite(out.to(torch.float32)).all())


def _ported_with_the_autotuner():
    """Variants that raised until the byte-skip ladder and the autotuner
    were ported: the gated and two-level skips and the auto policies now
    run on the CPU (the plain versions) and give the product of the
    dense skip."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8) / 64.0
    ones = torch.ones((8, 8), dtype=torch.int8)
    return {
        "matmul skip=gated": lambda: ops.matmul(
            ones, w, skip="gated", policy="fused_dense"),
        "matmul skip=two_level": lambda: ops.matmul(
            ones, w, skip="two_level", policy="fused_dense"),
        "fused_pe_layer packed skip=gated": lambda: ops.fused_pe_layer(
            _packed(), w * 8.0, skip="gated",
            policy="fused_packed").spikes.to_dense(torch.float32)[0],
        "matmul packed skip=gated": lambda: ops.matmul(
            _packed()[0], w, skip="gated", policy="fused_packed"),
        "matmul packed skip=two_level": lambda: ops.matmul(
            _packed()[0], w, skip="two_level", policy="fused_packed"),
        "matmul auto policy": lambda: ops.matmul(ones, w, policy="auto"),
        "matmul +grad skip=gated": lambda: ops.matmul(
            torch.ones((8, 8)), w, skip="gated", policy="fused_dense+grad"),
        "matmul auto+grad policy": lambda: ops.matmul(
            torch.ones((8, 8)), w, policy="auto+grad"),
    }


@pytest.mark.parametrize("case", sorted(_ported_with_the_autotuner()))
def test_variants_ported_with_the_autotuner_run(case):
    out = _ported_with_the_autotuner()[case]()
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8) / 64.0
    if case.startswith("fused_pe_layer"):
        want = (w.sum(dim=0) * 8.0 >= 1.0).to(torch.float32).expand(8, 8)
    else:
        want = torch.ones((8, 8)) @ w
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)


def _ported_with_the_lm():
    """Variants that raised until the spiking LM was ported: the
    head-blocked QK mask (int8 and packed, fused and reference) and the
    dense-activation x of the fused PE now run on the CPU (the plain
    versions). All-ones operands: every head's row sum passes, so each
    gives the all-ones spike map of the whole-row mask."""
    w = torch.ones((8, 8))
    return {
        "fused_pe_layer heads": lambda: ops.fused_pe_layer(
            _spikes(), w, q=_spikes(), heads=(2, 4), policy="fused_dense"),
        "fused_pe_layer heads reference": lambda: ops.fused_pe_layer(
            _spikes(), w, q=_spikes(), heads=(2, 4), policy="reference"),
        "fused_pe_layer dense activations": lambda: ops.fused_pe_layer(
            ops.SpikeTensor.dense(torch.ones((1, 8, 8))), w,
            policy="fused_dense"),
        "fused_pe_layer packed heads": lambda: ops.fused_pe_layer(
            _packed(), w, q=_packed(), heads=(2, 4), policy="fused_packed"),
    }


@pytest.mark.parametrize("case", sorted(_ported_with_the_lm()))
def test_variants_ported_with_the_lm_run(case):
    out = _ported_with_the_lm()[case]()
    spikes = out.spikes.to_dense(torch.float32)
    torch.testing.assert_close(spikes, torch.ones((1, 8, 8)), rtol=0, atol=0)
    assert int(out.vld_next.sum()) == 64


def _ported_with_state():
    """Variants that raised until the LIF-state variant of the fused PE
    (T > 1) was ported: each now runs on the CPU (the plain versions) and
    gives a result of the expected shape, (T, M, N) spikes, (M, N) spikes
    and v_next, or (batch, classes) logits."""
    w = torch.ones((8, 8))
    cfg = snn_cnn.SNNCNNConfig(arch="resnet11", width_mult=0.125,
                               image_size=16)
    variables = snn_cnn.init(torch.Generator(), cfg, device="cpu")
    fused = snn_cnn.fuse_model(variables, cfg)
    img = torch.zeros((1, 16, 16, 3))
    two = dataclasses.replace(cfg, timesteps=2)

    def layer(x, policy):
        return ops.fused_pe_layer(x, w, policy=policy).spikes.to_dense(
            torch.float32), (2, 8, 8)

    def pe(policy):
        out = ops.fused_pe(torch.ones((8, 8), dtype=torch.int8), w,
                           v_prev=torch.zeros((8, 8)), policy=policy)
        return torch.cat([out.spikes.to_dense(torch.float32), out.v_next]), \
            (16, 8)

    return {
        "fused_pe_layer T=2": lambda: layer(_spikes(t=2), "fused_dense"),
        "fused_pe_layer packed T=2": lambda: layer(_packed(t=2),
                                                   "fused_packed"),
        "fused_pe_layer +grad T=2": lambda: layer(
            ops.SpikeTensor.dense(torch.ones((2, 8, 8))), "fused_dense+grad"),
        "fused_pe_layer reference+grad T=2": lambda: layer(
            ops.SpikeTensor.dense(torch.ones((2, 8, 8))), "reference+grad"),
        "fused_pe +grad LIF state": lambda: pe("fused_dense+grad"),
        "fused_pe inference": lambda: pe("fused_dense"),
        "forward fused_packed T=2": lambda: (snn_cnn.forward(
            fused, img, two, policy="fused_packed")[0], (1, 10)),
        "forward fused T=2": lambda: (snn_cnn.forward(
            fused, img, two, policy="fused_dense")[0], (1, 10)),
        "forward +grad bn_fold T=2": lambda: (snn_cnn.forward(
            variables, img, dataclasses.replace(two, bn_fold=True),
            policy="fused_dense")[0], (1, 10)),
    }


@pytest.mark.parametrize("case", sorted(_ported_with_state()))
def test_variants_ported_with_state_run(case):
    out, shape = _ported_with_state()[case]()
    assert tuple(out.shape) == shape
    assert bool(torch.isfinite(out.to(torch.float32)).all())


def test_fp8_fake_quant_ported_runs():
    """The fp8 fake-quant modes raised until the core twins were ported:
    they now round through e4m3 / e5m2 (``test_torch_core_twins.py`` holds
    the values to JAX's)."""
    w = torch.full((8, 8), 3.3)
    out = snn_cnn.fake_quant(w, snn_cnn.QuantConfig(enabled=True,
                                                    mode="fp8_e4m3"))
    torch.testing.assert_close(out, torch.full((8, 8), 3.25), rtol=0,
                               atol=0)


def test_reference_twins_stay_registered():
    """Every op of the slice has a reference mode, and a fused mode where
    its kernel is ported; every op of the training walks (the CNNs' and
    the LM's) has both "+grad" modes."""
    table = ops.implementations()
    for op in ("matmul", "lif", "fused_pe", "fused_pe_layer", "im2col",
               "pool", "qk_mask", "w2ttfs_head", "pack", "unpack"):
        assert (op, "reference") in table, op
    for op in ("matmul", "lif", "fused_pe", "fused_pe_layer", "im2col",
               "pool", "qk_mask", "w2ttfs_head", "pack", "unpack"):
        assert (op, "fused") in table, op
    for op in ("matmul", "lif", "fused_pe", "fused_pe_layer", "qk_mask",
               "w2ttfs_head", "im2col", "pool"):
        for mode in ("reference+grad", "fused+grad"):
            assert (op, mode) in table, (op, mode)
    # the LM's projection: its inference and training modes
    assert {m for op, m in table if op == "dense_lif"} == {
        "reference", "fused", "reference+grad", "fused+grad"}


# ---------------------------------------------------------------- convert
def test_converter_takes_read_only_arrays_without_a_warning():
    """``np.asarray`` of a JAX array is read-only; ``torch.from_numpy`` on
    it would warn, and the repo's warnings-as-errors setting would fail the
    run. The converter copies first."""
    ro = np.asarray(jnp.arange(6, dtype=jnp.float32).reshape(2, 3))
    assert not ro.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = convert.fused_from_jax([{"conv": {"w": ro, "b": ro[0]}}],
                                     device="cpu")
        tree = convert.variables_from_jax(
            {"params": [{"fc": {"w": ro}}], "state": [{}]}, device="cpu")
    np.testing.assert_array_equal(out[0]["conv"]["w"].numpy(), ro)
    assert tree["params"][0]["fc"]["w"].dtype == torch.float32
    out[0]["conv"]["w"].add_(1.0)           # a copy: the source is intact
    assert float(ro[0, 0]) == 0.0
