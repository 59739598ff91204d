"""The paper's KD training step (twin of ``repro.train.trainer``, the KD
half, C1): a spiking student trained against a frozen ANN teacher with the
logit KD loss, SGD with momentum by default.

The step is eager PyTorch: autograd differentiates the student's forward,
whose ops run the policy's kernels forward and their surrogate-gradient
backward (``repro_torch.ops.grad``). A cuDNN conv in the student (the stem)
or the teacher reads ``torch.backends.cudnn.allow_tf32`` when it runs,
backward included; turn it off, with ``torch.backends.cuda.matmul
.allow_tf32``, where parity with the reference matters.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.kd import KDConfig, kd_loss
from ..optim import adamw_update, sgd_update
from ..tree import tree_leaves, tree_unflatten_like


def make_kd_grad_fn(student_apply: Callable, teacher_apply: Callable,
                    teacher_params: Any, *, kd: KDConfig = KDConfig(),
                    policy: Any = None) -> Callable:
    """``fn(params, state, batch) -> (loss, metrics, new_state, grads)``:
    the KD loss of one batch and its gradient with respect to every leaf of
    ``params`` (zeros for a leaf the loss does not reach). The teacher runs
    without autograd; ``policy`` as in ``make_kd_train_step``."""
    if policy is not None:
        from .. import ops

        pol = ops.as_policy(policy).for_training()
        _student = student_apply

        def student_apply(params, state, images):  # noqa: F811
            return _student(params, state, images, policy=pol)

    def fn(params, state, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        live = tree_unflatten_like(params, leaves)
        out = student_apply(live, state, batch["images"])
        # students return (logits, state) or (logits, state, aux); an aux
        # with "active_frac" (snn_cnn's mean firing rate) becomes a metric
        s_logits, new_state = out[0], out[1]
        aux = out[2] if len(out) > 2 else None
        with torch.no_grad():
            t_logits = teacher_apply(teacher_params, batch["images"])
        loss, metrics = kd_loss(s_logits, t_logits, batch["labels"], kd)
        if isinstance(aux, dict) and "active_frac" in aux:
            metrics = dict(metrics, active_frac=aux["active_frac"])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return (loss.detach(), metrics, new_state,
                tree_unflatten_like(params, grads))

    return fn


def make_kd_train_step(student_apply: Callable, teacher_apply: Callable,
                       teacher_params: Any, *,
                       kd: KDConfig = KDConfig(),
                       schedule: Callable[[torch.Tensor], torch.Tensor],
                       optimizer: str = "sgd", momentum: float = 0.9,
                       weight_decay: float = 5e-4,
                       policy: Any = None) -> Callable:
    """The paper's KD training step (Fig 2(b)).

    ``student_apply(params, state, images) -> (logits, new_state[, aux])``:
    the state carries BN running statistics (threaded, not differentiated);
    the params must already encode quantization (KD-QAT) when it is on.
    ``teacher_apply(teacher_params, images) -> logits`` (frozen, eval
    mode). ``policy``: an optional ``ExecutionPolicy`` or preset name for
    the student's training forward; when given it is resolved through its
    gradient axis (``for_training()``) and passed to ``student_apply`` as
    ``policy=``, so a policy-driven student (``snn_cnn.forward``) trains
    through the kernels it deploys on. When None, ``student_apply`` keeps
    its three-argument form.

    Returns ``step((params, opt, state), batch={"images", "labels"}) ->
    ((params, opt, new_state), metrics)``; ``optimizer`` is ``"sgd"``
    (momentum, per the paper) or ``"adamw"``. Nothing is updated in place.
    """
    if optimizer not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    grad_fn = make_kd_grad_fn(student_apply, teacher_apply, teacher_params,
                              kd=kd, policy=policy)

    def step(carry, batch):
        params, opt, state = carry
        _, metrics, new_state, grads = grad_fn(params, state, batch)
        lr = schedule(opt.step)
        if optimizer == "sgd":
            new_p, new_o = sgd_update(grads, opt, params, lr=lr,
                                      momentum=momentum,
                                      weight_decay=weight_decay)
        else:
            new_p, new_o = adamw_update(grads, opt, params, lr=lr,
                                        weight_decay=weight_decay)
        return (new_p, new_o, new_state), dict(metrics, lr=lr)

    return step


def observe_train_sparsity(metrics: dict) -> None:
    """Feed one training step's measured spike sparsity into the roofline
    autotuner: the host half of the ``"auto+grad"`` loop.

    Call it on the metrics dict a ``make_kd_train_step`` step returned.
    When the student surfaced an ``active_frac`` (snn_cnn's mean firing
    rate), it EWMA-feeds ``AutoTuner.observe``, the hint the tuner prices
    an operand with when it has no maps to measure. The rate is a
    neuron-level proxy for the active-block fraction the cost model wants;
    the tuner's buckets absorb the gap. No-op when the metric is absent."""
    frac = metrics.get("active_frac")
    if frac is None:
        return
    from ..ops.autotune import get_tuner

    get_tuner().observe(float(frac))
