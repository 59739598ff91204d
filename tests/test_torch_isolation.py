"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points never drop to the CPU on their own, and every fused variant
whose kernel is still to port, and every part of the LM and serving path
still to port, raises instead of running a plain version; the variants
ported since run.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert, ops
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.core.lif import LIFConfig
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import snn_cnn
from repro_torch.models.attention import attn_apply
from repro_torch.serve import Engine, EngineConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
        "import repro_torch.launch.serve\n"
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
    return {
        "lm init": lambda: build_model(lm_cfg).init(torch.Generator()),
        "lm init_cache": lambda: build_model(lm_cfg).init_cache(2, 8),
        "lm_params_from_jax": lambda: convert.lm_params_from_jax(
            {"embed": {"emb": np.ones((4, 2), np.float32)},
             "blocks": {"ln1": {"scale": np.ones((2, 2), np.float32)}}}),
        "launch.serve": lambda: serve_main(
            ["--reduced", "--spiking", "--qk-attention", "--requests", "1"]),
        "resolve_device": lambda: repro_torch.resolve_device(),
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
    lm_spiking = build_model(reduced(get_config(
        "qwen3-1.7b", spiking=True, attention_kind="qk_spiking")))
    lm_spiking_params = lm_spiking.init(torch.Generator(), device="cpu")
    return {
        "fused_pe +grad heads": lambda: ops.fused_pe(
            torch.ones((8, 8)), w, q=torch.ones((8, 8)), heads=(2, 4),
            policy="fused_dense+grad"),
        "dense_lif fused+grad lookup": lambda: ops.lookup(
            "dense_lif", "fused+grad"),
        "dense_lif reference+grad lookup": lambda: ops.lookup(
            "dense_lif", "reference+grad"),
        "dense_lif fused_dense+grad": lambda: ops.dense_lif(
            {"w": w}, torch.ones((4, 8)), LIFConfig(),
            policy="fused_dense+grad"),
        "dense_lif reference+grad": lambda: ops.dense_lif(
            {"w": w}, torch.ones((4, 8)), LIFConfig(),
            policy="reference+grad"),
        "lm family moe": lambda: build_model(
            reduced(get_config("olmoe-1b-7b"))),
        "lm family ssm": lambda: build_model(
            reduced(get_config("mamba2-130m"))),
        "lm family hybrid": lambda: build_model(
            reduced(get_config("zamba2-7b"))),
        "lm family vlm": lambda: build_model(
            reduced(get_config("phi-3-vision-4.2b"))),
        "lm family encdec": lambda: build_model(
            reduced(get_config("seamless-m4t-large-v2"))),
        "lm softmax context-parallel decode":
            lambda: lm_softmax_cp.decode_step(
                lm_softmax_params, torch.zeros((1, 1), dtype=torch.int64),
                lm_softmax_cp.init_cache(1, 8, device="cpu")),
        "lm softmax kv_override": lambda: attn_apply(
            lm_softmax_params["blocks"][0]["attn"], lm_softmax.cfg,
            torch.zeros((1, 2, 64)), torch.zeros((1, 2), dtype=torch.int64),
            kv_override=(torch.zeros((1, 2, 2, 16)),) * 2),
        "engine fault plan": lambda: Engine(
            lm_spiking, lm_spiking_params, EngineConfig(), faults=object()),
        "engine integrity guard": lambda: EngineConfig(integrity_every=1),
        "serve replica router": lambda: serve_main(
            ["--reduced", "--spiking", "--qk-attention", "--replicas", "2",
             "--device", "cpu"]),
        "serve chaos plan": lambda: serve_main(
            ["--reduced", "--spiking", "--qk-attention", "--chaos",
             "--device", "cpu"]),
    }


@pytest.mark.parametrize("case", sorted(_unported()))
def test_unported_variants_raise(case):
    with pytest.raises((NotImplementedError, TypeError)) as err:
        _unported()[case]()
    assert "ROADMAP" in str(err.value)


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
    its kernel is ported; every op of the training walk has both "+grad"
    modes."""
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
    # the LM's projection: its inference modes only (LM training waits)
    assert {m for op, m in table if op == "dense_lif"} == {"reference",
                                                          "fused"}


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
