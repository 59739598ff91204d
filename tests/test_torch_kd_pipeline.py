"""The KD pipeline twin (``examples/torch_train_kd_cifar.py``) against the
reference pipeline (``benchmarks/fig8_kd_accuracy.py``) on the CPU, at the
reference's width 0.125, stage by stage, from the reference's own initial
weights carried across with ``repro_torch.convert``:

* the teacher after 2 steps of ``train_teacher`` (the reference's own
  function, its batch cut to 8 through its module constant): parameters
  and eval logits within rtol 1e-4, BN state within rtol 1e-5;
* one KDT step and one KD-QAT step (4-bit fake quant) of ``train_student``
  on the same teacher: loss within rtol 1e-5, gradients within rtol 1e-4
  (the JAX side is the body of the reference's ``make_kd_train_step``
  written out, as in ``tests/test_torch_train.py``, so that its gradients
  can be read);
* the F&Q and W2TTFS stages' eval forwards: logits within rtol 1e-5, spike
  totals exactly;
* ``main`` at two steps on the CPU.

The tolerances are those of ``tests/test_torch_train.py``: an absolute
term of 1e-5 (gradients, parameters) or 1e-6 (BN state, losses, logits)
of the leaf's largest |value| beside the relative one.
"""
import functools
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kd as jkd
from repro.core.quant import QuantConfig as JQuant
from repro.models import ann_cnn as jann
from repro.models import snn_cnn as jsnn
from repro_torch import convert
from repro_torch.core.quant import QuantConfig as TQuant
from repro_torch.data import SyntheticImageDataset
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves
from test_torch_snn_cnn import numpy_variables
from test_torch_train import (GRAD_RTOL, RTOL, assert_close,
                              assert_trees_close, t_numpy, to_numpy)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmarks import fig8_kd_accuracy as jfig8  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "torch_train_kd_cifar", ROOT / "examples" / "torch_train_kd_cifar.py")
ex = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ex)

BATCH = 8             # the pipeline's batch, cut in both modules
ARCH = "vgg11"


def _jax_batch(ds, step):
    imgs, labels = ds.batch(step, BATCH)
    return {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}


@functools.lru_cache(maxsize=None)
def _jax_teacher():
    """The reference's ``train_teacher`` at 2 steps, from PRNGKey(0)."""
    saved = jfig8.BATCH
    jfig8.BATCH = BATCH
    try:
        ds = jfig8.SyntheticImageDataset(num_classes=10, image_size=32,
                                         seed=0, noise=0.8)
        tcfg = jann.ANNCNNConfig(arch="resnet18", width_mult=jfig8.WIDTH)
        init = to_numpy(jann.init(jax.random.PRNGKey(0), tcfg))
        apply, params, state, _ = jfig8.train_teacher(ds, 2)
        x = ds.batch(10_000, 128)[0]
        logits = np.asarray(apply(params, jnp.asarray(x)))
    finally:
        jfig8.BATCH = saved
    return init, to_numpy(params), to_numpy(state), x, logits


@pytest.fixture
def small_batch(monkeypatch):
    monkeypatch.setattr(ex, "BATCH", BATCH)


def test_teacher_two_steps_match_jax(small_batch):
    init, j_params, j_state, x, j_logits = _jax_teacher()
    ds = SyntheticImageDataset(num_classes=10, image_size=32, seed=0,
                               noise=0.8)
    apply, params, state, _ = ex.train_teacher(
        ds, 2, device="cpu", init=convert.variables_from_jax(init, "cpu"))
    assert_trees_close(t_numpy(params), j_params, GRAD_RTOL, "params")
    assert_trees_close(t_numpy(state), j_state, RTOL, "BN state")
    # the logits of parameters held at GRAD_RTOL, so at GRAD_RTOL too
    assert_close(apply(params, torch.tensor(x)).numpy(), j_logits, GRAD_RTOL)


def _student_cfgs(quant_bits, head="avgpool"):
    jq = (JQuant(enabled=True, bits=quant_bits) if quant_bits
          else JQuant(enabled=False))
    tq = (TQuant(enabled=True, bits=quant_bits) if quant_bits
          else TQuant(enabled=False))
    jcfg = jsnn.SNNCNNConfig(arch=ARCH, width_mult=jfig8.WIDTH, timesteps=1,
                             quant=jq, head=head)
    return jcfg, ex.make_student(ARCH, tq, head)


@functools.lru_cache(maxsize=None)
def _jax_kd_step(quant_bits):
    """Loss, metrics and gradients of the reference's KD step (alpha 0.7)
    from PRNGKey(1)'s student on batch 0, against the 2-step teacher."""
    jcfg, _ = _student_cfgs(quant_bits)
    _, t_params, t_state, _, _ = _jax_teacher()
    tcfg = jann.ANNCNNConfig(arch="resnet18", width_mult=jfig8.WIDTH)
    tvars = jax.tree_util.tree_map(jnp.asarray,
                                   {"params": t_params, "state": t_state})
    var = jsnn.init(jax.random.PRNGKey(1), jcfg)
    apply = jfig8._student_apply(jcfg)

    def loss_fn(params, state, batch):
        logits, _, _ = apply(params, state, batch["images"])
        t_logits = jann.apply(tvars, batch["images"], tcfg)[0]
        return jkd.kd_loss(logits, t_logits, batch["labels"],
                           jkd.KDConfig(alpha=0.7))

    ds = jfig8.SyntheticImageDataset(num_classes=10, image_size=32, seed=0,
                                     noise=0.8)
    batch = _jax_batch(ds, 0)
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        var["params"], var["state"], batch).compile(
        {"xla_backend_optimization_level": 0})
    (loss, metrics), grads = fn(var["params"], var["state"], batch)
    return to_numpy(var), float(loss), to_numpy(metrics), to_numpy(grads)


@pytest.mark.parametrize("quant_bits,lr,policy", [
    (0, 0.1, None), (0, 0.1, "fused_dense"), (4, 0.02, None)],
    ids=["KDT", "KDT-fused_dense", "KD-QAT"])
def test_student_step_matches_jax(quant_bits, lr, policy, small_batch,
                                  monkeypatch):
    init, j_loss, j_metrics, j_grads = _jax_kd_step(quant_bits)
    _, t_params, t_state, _, _ = _jax_teacher()
    _, tcfg = _student_cfgs(quant_bits)
    captured = {}
    real_update, real_step = trainer.sgd_update, ex.make_kd_train_step

    def recording_update(grads, *args, **kw):
        captured["grads"] = grads
        return real_update(grads, *args, **kw)

    def recording_step(*args, **kw):
        step = real_step(*args, **kw)

        def run(carry, batch):
            carry, captured["metrics"] = step(carry, batch)
            return carry

        return lambda carry, batch: (run(carry, batch), None)

    monkeypatch.setattr(trainer, "sgd_update", recording_update)
    monkeypatch.setattr(ex, "make_kd_train_step", recording_step)
    teacher = ex.train_teacher(
        None, 0, device="cpu", init=convert.variables_from_jax(
            {"params": t_params, "state": t_state}, "cpu"))
    tv = convert.variables_from_jax(init, "cpu")
    ds = SyntheticImageDataset(num_classes=10, image_size=32, seed=0,
                               noise=0.8)
    ex.train_student(tcfg, ds, teacher[0], teacher[1], steps=1, lr=lr,
                     init=(tv["params"], tv["state"]), policy=policy,
                     device="cpu")
    metrics = captured["metrics"]
    assert float(metrics["loss"]) == pytest.approx(j_loss, rel=RTOL)
    for key in ("ce", "kl"):
        assert float(metrics[key]) == pytest.approx(float(j_metrics[key]),
                                                    rel=RTOL), key
    assert_trees_close(t_numpy(captured["grads"]), j_grads, GRAD_RTOL,
                       "gradients")


@pytest.mark.parametrize("head", ["avgpool", "w2ttfs"],
                         ids=["F&Q", "W2TTFS"])
def test_quantized_eval_stages_match_jax(head):
    """F&Q (4-bit, AP head) and W2TTFS (4-bit, W2TTFS head) in eval mode on
    seeded weights whose every layer fires (BN beta 0.5)."""
    jcfg, tcfg = _student_cfgs(4, head)
    var = numpy_variables(jcfg, seed=2)
    x = SyntheticImageDataset(num_classes=10, image_size=32, seed=0,
                              noise=0.8).batch(10_000, 32)[0]
    j_logits, _, j_aux = jax.jit(lambda v, x_: jsnn.forward(
        v, x_, jcfg, train=False))(
        jax.tree_util.tree_map(jnp.asarray, var), jnp.asarray(x))
    tv = convert.variables_from_jax(var, "cpu")
    with torch.no_grad():
        t_logits, _, t_aux = ex.snn_cnn.forward(tv, torch.tensor(x), tcfg,
                                                train=False)
    assert_close(t_logits.numpy(), np.asarray(j_logits), RTOL)
    assert sorted(t_aux["spikes"]) == sorted(j_aux["spikes"])
    for name, val in j_aux["spikes"].items():
        assert float(t_aux["spikes"][name]) == float(val), name
    assert float(t_aux["total_spikes"]) == float(j_aux["total_spikes"]) > 0


def test_w2ttfs_stage_equals_the_ap_stage_on_the_same_weights():
    """Claim 3 on the port: the head swap keeps the QAT weights' logits."""
    jcfg, tcfg_ap = _student_cfgs(4, "avgpool")
    _, tcfg_w = _student_cfgs(4, "w2ttfs")
    tv = convert.variables_from_jax(numpy_variables(jcfg, seed=2), "cpu")
    x = torch.tensor(SyntheticImageDataset(
        num_classes=10, image_size=32, seed=0, noise=0.8).batch(10_000,
                                                                32)[0])
    with torch.no_grad():
        ap = ex.snn_cnn.forward(tv, x, tcfg_ap, train=False)[0]
        w2 = ex.snn_cnn.forward(tv, x, tcfg_w, train=False)[0]
    np.testing.assert_allclose(w2.numpy(), ap.numpy(), rtol=1e-4, atol=1e-4)


def test_main_runs_the_five_stages_on_the_cpu(small_batch, capsys):
    res = ex.main(["--device", "cpu", "--steps", "2"])
    assert list(res) == list(ex.STAGES)
    assert all(0.0 <= v <= 1.0 for v in res.values())
    out = capsys.readouterr().out
    assert "# claim3 W2TTFS == AP head" in out
    assert "total_spikes/img" in out


def test_run_records_each_stage(small_batch):
    rec = {}
    ex.run(steps=2, quiet=True, device="cpu", record=rec)
    assert list(rec["seconds"]) == list(ex.STAGES)
    assert [len(rec["step_ms"][k]) for k in ("teacher", "KDT", "KD-QAT")] \
        == [2, 2, 20]
    assert rec["cfg"]["W2TTFS"].head == "w2ttfs"
    assert rec["vars"]["W2TTFS"] is rec["vars"]["KD-QAT"] or all(
        a is b for a, b in zip(tree_leaves(rec["vars"]["W2TTFS"]),
                               tree_leaves(rec["vars"]["KD-QAT"])))
