"""Shared helpers of the CPU tests that hold the port's other LM families
(moe, ssm, hybrid, vlm, encdec) against the JAX package: the reduced
models of both packages on JAX's parameters (``convert``), their jitted
JAX steps built once per configuration, the token and tolerance helpers,
and the gradient comparison (a relative L2 error per leaf)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import build_model as jbuild
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro_torch import convert
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.tree import tree_leaves, tree_map

LOGIT_RTOL = LOGIT_ATOL = 1e-5     # prefill, prefill_chunk, decode_step
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-3
_PAIRS: dict = {}


def family_pair(arch: str, **over):
    """(JAX model, its jitted steps, JAX params, port model, port params)
    of ``reduced(get_config(arch), **over)`` in both packages (f32), the
    port's parameters JAX's; built and jitted once per configuration. The
    steps: prefill (all logits), prefill_chunk, decode_step and the loss's
    value and gradient."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _PAIRS:
        jm = jbuild(jreduced(jget(arch), **over))
        jp = jm.init(jax.random.PRNGKey(0))
        steps = jitted_steps(jm)
        if hasattr(jm, "prefill_chunk"):
            quick_engine_steps(jm)
        tm = build_model(reduced(get_config(arch), **over))
        leaves = jax.tree_util.tree_map(np.asarray, jp)
        tp = (convert.encdec_params_from_jax(leaves, device="cpu")
              if tm.cfg.family == "encdec"
              else convert.lm_params_from_jax(leaves, device="cpu"))
        _PAIRS[key] = (jm, steps, jp, tm, tp)
    return _PAIRS[key]


class QuickJit:
    """``jax.jit(fn)`` compiled once per argument shapes without backend
    optimisation (the reduced models' compiles dominate these files)."""

    def __init__(self, fn):
        self.jitted = jax.jit(fn)
        self.compiled: dict = {}

    def __call__(self, *args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(a), np.result_type(a)) for a in leaves))
        if key not in self.compiled:
            self.compiled[key] = self.jitted.lower(*args).compile(
                {"xla_backend_optimization_level": 0})
        return self.compiled[key](*args)


def jitted_steps(jm) -> dict:
    steps = {"prefill": QuickJit(functools.partial(jm.prefill,
                                                   return_all_logits=True)),
             "decode": QuickJit(jm.decode_step),
             "grad": QuickJit(jax.value_and_grad(jm.loss, has_aux=True))}
    if hasattr(jm, "prefill_chunk"):
        steps["chunk"] = QuickJit(jm.prefill_chunk)
    return steps


def quick_engine_steps(jm) -> None:
    """The JAX engine's jitted steps for ``jm`` (kept per model config in
    its module), compiled without backend optimisation as ``QuickJit``
    compiles them."""
    from repro.serve import engine as jengine

    def prefill_fn(params, toks):
        return jm.prefill(params, {"tokens": toks}, return_all_logits=True)

    jengine._JIT_CACHE[(type(jm), jm.cfg)] = (
        QuickJit(prefill_fn), QuickJit(jm.decode_step),
        QuickJit(jm.prefill_chunk))


def tokens(seed: int, b: int, s: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def close(got: torch.Tensor, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def port_loss_and_grads(tm, tp, batch: dict):
    """The port's loss, metrics and gradients (a tree like the params)."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss, metrics = tm.loss(params, to_torch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params),
                                allow_unused=True)
    return loss, metrics, grads


def check_loss_and_grads(arch: str, batch: dict, **over) -> dict:
    """The port's loss, metrics and gradients against
    ``jax.value_and_grad`` of the reference's loss: loss and metrics at
    rtol 1e-4, each gradient leaf within 1e-3 relative L2. Returns the
    port's metrics."""
    jm, steps, jp, tm, tp = family_pair(arch, **over)
    (jl, jmet), jg = steps["grad"](jp, to_jax(batch))
    loss, metrics, grads = port_loss_and_grads(tm, tp, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    assert sorted(metrics) == sorted(jmet)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    leaves = jax.tree_util.tree_map(np.asarray, jg)
    want = (convert.encdec_params_from_jax(leaves, device="cpu")
            if tm.cfg.family == "encdec"
            else convert.lm_params_from_jax(leaves, device="cpu"))
    want = tree_leaves(want)
    assert len(grads) == len(want)
    worst = 0.0
    for i, (g, w) in enumerate(zip(grads, want)):
        if float(w.abs().max()) == 0.0:
            assert g is None or float(g.abs().max()) == 0.0, i
            continue
        assert g is not None and tuple(g.shape) == tuple(w.shape), i
        err = rel_l2(g, w)
        worst = max(worst, err)
        assert err <= GRAD_REL_L2, (arch, i, err)
    return metrics
