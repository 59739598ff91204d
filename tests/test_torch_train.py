"""KD training as a whole on the CPU against the JAX package: the
synthetic data, the ANN teacher, the optimizers and the KD train step.

Both packages start from one state: seeded numpy variables in the tree of
the reference's ``init`` (every BN beta 0.5, so no layer of a random net
goes silent), carried to the port with ``repro_torch.convert`` together
with the reference's optimizer state. Two KD steps run in each package on
the same synthetic batches. Targets: equal per-layer spike totals; the
loss within rtol 1e-5; every parameter leaf's gradient and updated value
within rtol 1e-4, with an absolute term of 1e-5 of the leaf's largest
|value|: the backward sums many terms in another order, and on the unfused
graph every train-mode BN's backward subtracts batch means, which leaves
entries near zero with absolute errors of about 1e-6 of their leaf's
scale (the BN state is held at rtol 1e-5 with an absolute term of 1e-6).

The JAX step is the body of ``repro.train.trainer.make_kd_train_step``
(``jax.value_and_grad`` of the KD loss, then ``sgd_update``), written out
and jitted so that its gradients and the student's ``aux`` can be read; it
runs once per (arch, graph) under ``reference+grad`` and every policy of
the port is held against it. On the CPU the reference's ``fused+grad``
runs the same jnp math as its ``reference+grad`` (its own
``tests/test_grad_backward.py`` holds the two equal), and
``tests/test_torch_grad.py`` holds the port's fused ops against the
reference's fused ops in both of its executors. The port runs its
``make_kd_train_step``, its gradients read where it hands them to
``sgd_update``, on its kernels' plain versions.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kd as jkd
from repro.data import synthetic as jdata
from repro.models import ann_cnn as jann
from repro.models import snn_cnn as jsnn
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import sgd_init as j_sgd_init
from repro.optim import sgd_update as j_sgd_update
from repro.optim.schedules import cosine_lr as j_cosine_lr
from repro_torch import convert
from repro_torch.core import kd as tkd
from repro_torch.data import synthetic as tdata
from repro_torch.models import ann_cnn as tann
from repro_torch.models import snn_cnn as tsnn
from repro_torch.optim import adamw_update as t_adamw_update
from repro_torch.optim import cosine_lr as t_cosine_lr
from repro_torch.train import trainer
from repro_torch.train.trainer import make_kd_train_step
from repro_torch.tree import tree_leaves
from test_torch_snn_cnn import numpy_variables

RTOL = 1e-5
GRAD_RTOL = 1e-4
BATCH = 4
# (arch, image size): the ResNets at 16x16, VGG-11 at 32x32, where its
# last layer still fires at width 0.125 (as in test_torch_snn_cnn.py)
ARCHS = [("resnet11", 16), ("qkfresnet11", 16), ("vgg11", 32)]
CASES = [(bn_fold, policy) for bn_fold in (True, False)
         for policy in ("reference+grad", "fused_dense+grad")] \
    + [(True, "fused_packed+grad")]


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_numpy(tree):
    return [leaf.detach().numpy() for leaf in tree_leaves(tree)]


def assert_close(got, want, rtol):
    want = np.asarray(want, np.float64)
    scale = 1e-5 if rtol >= GRAD_RTOL else 1e-6
    atol = scale * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol)


def assert_trees_close(got_leaves, want_tree, rtol, what):
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got_leaves) == len(want), what
    for i, (g, w) in enumerate(zip(got_leaves, want)):
        assert g.shape == np.asarray(w).shape, (what, i)
        assert_close(g, w, rtol)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("step,shard", [(0, 0), (3, 1)])
def test_synthetic_batches_bit_equal(step, shard):
    kw = dict(num_classes=10, image_size=16, seed=7, noise=0.8)
    ji, jl = jdata.SyntheticImageDataset(**kw).batch(step, 5, shard, 2)
    ti, tl = tdata.SyntheticImageDataset(**kw).batch(step, 5, shard, 2)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    assert ti.dtype == ji.dtype and tl.dtype == jl.dtype


# ---------------------------------------------------------------- teacher
def teacher(size):
    jcfg = jann.ANNCNNConfig(arch="resnet18", width_mult=0.125,
                             image_size=size)
    tcfg = tann.ANNCNNConfig(arch="resnet18", width_mult=0.125,
                             image_size=size)
    # seeded numpy variables in the tree of jann.init, BN statistics away
    # from the identity so that eval mode is exercised
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(lambda: jann.init(jax.random.PRNGKey(0), jcfg))

    def leaf(path, sds):
        name, shape = getattr(path[-1], "key", None), sds.shape
        if name == "w":
            fan_in = int(np.prod(shape[:-1]))
            return rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return 0.1 * rng.standard_normal(shape)

    var = jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes)
    return jcfg, tcfg, var


def test_ann_teacher_eval_logits_match_jax():
    jcfg, tcfg, var = teacher(16)
    x = np.random.default_rng(0).standard_normal((BATCH, 16, 16, 3)
                                                 ).astype(np.float32)
    jl, _ = jax.jit(lambda v, x_: jann.apply(v, x_, jcfg, train=False))(
        jax.tree_util.tree_map(jnp.asarray, var), jnp.asarray(x))
    tl, _ = tann.apply(convert.variables_from_jax(var, device="cpu"),
                       torch.tensor(x), tcfg, train=False)
    assert tuple(tl.shape) == (BATCH, 10)
    assert_close(tl.numpy(), jl, RTOL)
    assert tann.build_layers(tcfg) == jann.build_layers(jcfg)


def test_ann_teacher_train_mode_state_matches_jax():
    jcfg, tcfg, var = teacher(16)
    x = np.random.default_rng(1).standard_normal((BATCH, 16, 16, 3)
                                                 ).astype(np.float32)
    jl, js = jax.jit(lambda v, x_: jann.apply(v, x_, jcfg, train=True))(
        jax.tree_util.tree_map(jnp.asarray, var), jnp.asarray(x))
    tl, ts = tann.apply(convert.variables_from_jax(var, device="cpu"),
                        torch.tensor(x), tcfg, train=True)
    assert_close(tl.numpy(), jl, 1e-4)
    assert_trees_close(t_numpy(ts), js, 1e-4, "BN state")


# ------------------------------------------------------------- optimizers
def test_adamw_state_carries_across_and_updates_like_jax():
    rng = np.random.default_rng(5)
    params = {"a": [rng.standard_normal((3, 4)).astype(np.float32)],
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = j_adamw_init(jp)
    jp1, jopt1 = j_adamw_update(jax.tree_util.tree_map(jnp.asarray, grads),
                                jopt, jp, lr=1e-2, weight_decay=0.1)
    jp2, jopt2 = j_adamw_update(jax.tree_util.tree_map(jnp.asarray, grads),
                                jopt1, jp1, lr=1e-2, weight_decay=0.1)
    tp1 = convert.variables_from_jax(to_numpy(jp1), device="cpu")
    topt1 = convert.optimizer_state_from_jax(to_numpy(jopt1), device="cpu")
    assert int(topt1.step) == 1
    tp2, topt2 = t_adamw_update(
        convert.variables_from_jax(grads, device="cpu"), topt1, tp1,
        lr=1e-2, weight_decay=0.1)
    assert int(topt2.step) == int(jopt2.step) == 2
    assert_trees_close(t_numpy(tp2), jp2, RTOL, "adamw params")
    assert_trees_close(t_numpy(topt2.m), jopt2.m, RTOL, "adamw m")
    assert_trees_close(t_numpy(topt2.v), jopt2.v, RTOL, "adamw v")


@pytest.mark.parametrize("name,args", [("cosine_lr", (0.1, 10)),
                                       ("constant_lr", (0.3,)),
                                       ("linear_warmup_cosine", (1.0, 3, 10))])
def test_schedules_match_jax(name, args):
    from repro.optim import schedules as jsched
    from repro_torch.optim import schedules as tsched

    j, tt = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in (0, 1, 2, 5, 10, 13):
        assert float(tt(torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(float(j(jnp.asarray(step, jnp.int32))), rel=1e-6)


# ------------------------------------------------------------ KD train step
def _student_cfgs(arch, size, bn_fold):
    common = dict(arch=arch, image_size=size, width_mult=0.125,
                  num_classes=10, bn_fold=bn_fold)
    return jsnn.SNNCNNConfig(**common), tsnn.SNNCNNConfig(**common)


def _jax_step(jcfg, tcfg_j, tvar_j, kd, schedule):
    """The body of the reference's make_kd_train_step under
    ``reference+grad``, with the gradients and the student's aux
    returned."""
    tparams = jax.tree_util.tree_map(jnp.asarray, tvar_j)

    def loss_fn(params, state, batch):
        logits, new_state, aux = jsnn.forward(
            {"params": params, "state": state}, batch["images"], jcfg,
            train=True, policy="reference+grad")
        t_logits = jann.apply(tparams, batch["images"], tcfg_j)[0]
        loss, metrics = jkd.kd_loss(logits, t_logits, batch["labels"], kd)
        return loss, (metrics, new_state, aux)

    def step(carry, batch):
        params, opt, state = carry
        (loss, (metrics, new_state, aux)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, state, batch)
        new_p, new_o = j_sgd_update(grads, opt, params, lr=schedule(opt.step),
                                    momentum=0.9, weight_decay=5e-4)
        return (new_p, new_o, new_state), metrics, grads, aux

    return step


@functools.lru_cache(maxsize=None)
def _jax_run(arch, size, bn_fold):
    """Two steps of the reference's KD step from the seeded state, as
    numpy, run once per (arch, graph) and shared by the port's policies.
    XLA compiles it without backend optimisation, which keeps this file's
    run short; the results are the same function of the same inputs."""
    jcfg, _ = _student_cfgs(arch, size, bn_fold)
    variables = numpy_variables(jcfg)
    tcfg_j, _, tvar = teacher(size)
    step = _jax_step(jcfg, tcfg_j, tvar, jkd.KDConfig(alpha=0.7),
                     j_cosine_lr(0.1, 10))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    carry = (jvars["params"], j_sgd_init(jvars["params"]), jvars["state"])
    ds = jdata.SyntheticImageDataset(num_classes=10, image_size=size, seed=0)
    batches = [ds.batch(i, BATCH) for i in range(2)]
    jb = [{"images": jnp.asarray(x), "labels": jnp.asarray(y)}
          for x, y in batches]
    compiled = jax.jit(step).lower(carry, jb[0]).compile(
        {"xla_backend_optimization_level": 0})
    out = []
    for b in jb:
        carry, metrics, grads, aux = compiled(carry, b)
        out.append(to_numpy((carry, metrics, grads, aux["spikes"])))
    return variables, batches, out


@pytest.mark.parametrize("arch,size", ARCHS, ids=[a for a, _ in ARCHS])
@pytest.mark.parametrize("bn_fold,policy", CASES,
                         ids=[f"{'fold' if f else 'unfused'}-{p}"
                              for f, p in CASES])
def test_kd_train_step_matches_jax(arch, size, bn_fold, policy,
                                   monkeypatch):
    variables, batches, j_steps = _jax_run(arch, size, bn_fold)
    _, tcfg = _student_cfgs(arch, size, bn_fold)
    _, tcfg_t, tvar = teacher(size)
    captured = {}

    def student(p, s, x, policy=None):
        out = tsnn.forward({"params": p, "state": s}, x, tcfg, train=True,
                           policy=policy)
        captured["aux"] = out[2]
        return out

    def teacher_apply(tp, x):
        return tann.apply(tp, x, tcfg_t)[0]

    real_update = trainer.sgd_update

    def recording_update(grads, *args, **kw):
        captured["grads"] = grads
        return real_update(grads, *args, **kw)

    monkeypatch.setattr(trainer, "sgd_update", recording_update)
    t_step = make_kd_train_step(
        student, teacher_apply,
        convert.variables_from_jax(tvar, device="cpu"),
        kd=tkd.KDConfig(alpha=0.7), schedule=t_cosine_lr(0.1, 10),
        optimizer="sgd", policy=policy)
    tvars = convert.variables_from_jax(variables, device="cpu")
    j_opt = to_numpy(j_sgd_init(jax.tree_util.tree_map(
        jnp.asarray, variables["params"])))
    t_carry = (tvars["params"],
               convert.optimizer_state_from_jax(j_opt, device="cpu"),
               tvars["state"])
    for step, ((imgs, labels), j_out) in enumerate(zip(batches, j_steps)):
        j_carry, j_metrics, j_grads, j_spikes = j_out
        batch = {"images": torch.tensor(imgs), "labels": torch.tensor(labels)}
        t_carry, t_metrics = t_step(t_carry, batch)
        t_aux, grads = captured["aux"], captured["grads"]
        what = f"step {step}"
        assert sorted(t_aux["spikes"]) == sorted(j_spikes), what
        for name, val in j_spikes.items():
            assert float(t_aux["spikes"][name]) == float(val), (what, name)
        for key in ("loss", "ce", "kl"):
            assert float(t_metrics[key]) == pytest.approx(
                float(j_metrics[key]), rel=RTOL), (what, key)
        assert_trees_close(t_numpy(grads), j_grads, GRAD_RTOL,
                           f"{what} grads")
        assert_trees_close(t_numpy(t_carry[0]), j_carry[0], GRAD_RTOL,
                           f"{what} params")
        assert_trees_close(t_numpy(t_carry[1].momentum), j_carry[1].momentum,
                           GRAD_RTOL, f"{what} momentum")
        assert_trees_close(t_numpy(t_carry[2]), j_carry[2], RTOL,
                           f"{what} BN state")
        assert int(t_carry[1].step) == int(j_carry[1].step) == step + 1


def test_bn_fold_state_passes_through_unchanged():
    """On the folded graph the running statistics are frozen: the step's
    new state is the state it was given."""
    jcfg, tcfg = _student_cfgs("resnet11", 16, True)
    tvars = convert.variables_from_jax(numpy_variables(jcfg), device="cpu")
    x = torch.rand((2, 16, 16, 3))
    _, new_state, _ = tsnn.forward(tvars, x, tcfg, train=True,
                                   policy="fused_dense")
    for a, b in zip(tree_leaves(new_state), tree_leaves(tvars["state"])):
        assert a is b


def test_train_step_policy_none_keeps_three_argument_student():
    jcfg, tcfg = _student_cfgs("resnet11", 16, False)
    tvars = convert.variables_from_jax(numpy_variables(jcfg), device="cpu")
    calls = []

    def student(p, s, x):
        calls.append(True)
        return tsnn.forward({"params": p, "state": s}, x, tcfg, train=True)

    step = make_kd_train_step(
        student, lambda _, x: torch.zeros((x.shape[0], 10)), None,
        schedule=t_cosine_lr(0.1, 10))
    from repro_torch.optim import sgd_init

    batch = {"images": torch.rand((2, 16, 16, 3)),
             "labels": torch.tensor([1, 2])}
    (p, _, _), m = step((tvars["params"], sgd_init(tvars["params"]),
                         tvars["state"]), batch)
    assert calls and np.isfinite(float(m["loss"]))
    assert dataclasses.is_dataclass(tcfg)
