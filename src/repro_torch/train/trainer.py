"""Training steps (twin of ``repro.train.trainer``): the LM's causal
training step (``make_train_step``: AdamW, global-norm clipping, optional
gradient accumulation over microbatches, the gradients averaged over a
data-parallel process group), the paper's KD step (C1,
``make_kd_train_step``): a spiking student trained against a frozen ANN
teacher with the logit KD loss, SGD with momentum by default, and the
data-parallel step with int8 + error-feedback gradient compression
(``make_compressed_train_step``).

The steps are eager PyTorch: autograd differentiates the model's forward,
whose ops run the policy's kernels forward and their surrogate-gradient
backward (``repro_torch.ops.grad``). Each step returns a new state; nothing
is updated in place. A cuDNN conv in the student (the stem) or the teacher
reads ``torch.backends.cudnn.allow_tf32`` when it runs, backward included;
turn it off, with ``torch.backends.cuda.matmul.allow_tf32``, where parity
with the reference matters.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from ..core.kd import KDConfig, kd_loss
from ..optim import (adamw_init, adamw_update, compressed_psum_grads,
                     global_norm, sgd_update)
from ..optim.adamw import AdamWState
from ..tree import tree_leaves, tree_map, tree_unflatten_like


class TrainState(NamedTuple):
    """The LM step's state: its step counter (int32), the parameters and
    the AdamW state."""
    step: torch.Tensor
    params: Any
    opt_state: AdamWState


def train_state_init(params: Any) -> TrainState:
    """Step 0, ``params`` and a fresh AdamW state on their device."""
    device = tree_leaves(params)[0].device
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                      params=params, opt_state=adamw_init(params))


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """``batch`` cut along its leading axis into ``n`` equal microbatches,
    in order."""
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows does not "
                             f"split into {n} microbatches")
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _grads_of(loss_fn: Callable, params: Any, batch: dict) -> tuple:
    """(loss, detached metrics, the gradient of the loss with respect to
    every leaf of ``params``) of ``loss_fn(params, batch) -> (loss,
    metrics)``; a leaf the loss does not reach gets zeros."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten_like(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten_like(params, grads)


def make_grad_fn(loss_fn: Callable) -> Callable:
    """``fn(params, batch) -> (loss, metrics, grads)`` of ``loss_fn(params,
    batch) -> (loss, metrics)`` (``LM.loss``, or a distillation loss)."""
    return lambda params, batch: _grads_of(loss_fn, params, batch)


@torch.no_grad()
def _clip_own(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """``clip_by_global_norm`` of gradients the step made itself, its f32
    leaves scaled where they are: the same bits, without a second copy of
    the gradients at full width."""
    norm = global_norm(grads)
    scale = torch.clamp(norm.new_tensor(max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    f32 = [g for g in tree_leaves(grads) if g.dtype == torch.float32]
    torch._foreach_mul_(f32, scale)
    return tree_map(lambda g: g if g.dtype == torch.float32 else
                    (g.to(torch.float32) * scale).to(g.dtype), grads), norm


@torch.no_grad()
def _pmean(metrics: dict, group) -> dict:
    """The metrics averaged over ``group``: one all-reduce of them stacked
    in f32, divided by the group's size (a tensor, so a true division on
    the card)."""
    keys = sorted(metrics)
    stacked = torch.stack([metrics[k].to(torch.float32) for k in keys])
    dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=group)
    stacked.div_(stacked.new_full((), float(dist.get_world_size(group))))
    return {k: stacked[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


@torch.no_grad()
def _average_grads(grads: Any, group) -> Any:
    """The step's own gradients summed over ``group`` in place, then
    divided by its size (not at a size of 1, where that is exact)."""
    leaves = tree_leaves(grads)
    for g in leaves:
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
    size = dist.get_world_size(group)
    if size > 1:
        n = leaves[0].new_full((), float(size), dtype=torch.float32)
        for g in leaves:
            g.div_(n)
    return grads


def make_train_step(model, *, schedule: Callable[[torch.Tensor],
                                                 torch.Tensor],
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    microbatch: int = 0, dp_group=None) -> Callable:
    """The LM training step: ``step(state, batch) -> (state, metrics)``.

    The gradient of ``model.loss``, accumulated in f32 over ``microbatch``
    equal slices of the batch when ``microbatch > 1`` (the metrics their
    means), clipped to the global norm ``clip_norm``, then one AdamW update
    at ``schedule(state.step)``. The metrics add ``grad_norm`` (before
    clipping) and ``lr``. The state is not updated in place.

    With ``dp_group`` (a ``torch.distributed`` process group; the batch is
    this rank's rows) the gradients are averaged over the group before the
    clip, and so are the metrics: the port's form of the reference's
    batch-sharded step, whose mean loss spans the global batch. The
    all-reduce runs at a group size of 1 too."""
    grad_fn = make_grad_fn(model.loss)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if microbatch and microbatch > 1:
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            mets = []
            for mb in _split_microbatches(batch, microbatch):
                _, m, g = grad_fn(state.params, mb)
                grads = tree_map(lambda a, g_: a + g_.to(torch.float32)
                                 / microbatch, grads, g)
                del g
                mets.append(m)
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        else:
            _, metrics, grads = grad_fn(state.params, batch)
        if dp_group is not None:
            grads = _average_grads(grads, dp_group)
            metrics = _pmean(metrics, dp_group)
        grads, gnorm = _clip_own(grads, clip_norm)
        lr = schedule(state.step)
        new_p, new_o = adamw_update(grads, state.opt_state, state.params,
                                    lr=lr, weight_decay=weight_decay)
        del grads
        return (TrainState(step=state.step + 1, params=new_p, opt_state=new_o),
                dict(metrics, grad_norm=gnorm, lr=lr))

    return step


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
        out = {}

        def loss_fn(live, batch):
            res = student_apply(live, state, batch["images"])
            # students return (logits, state) or (logits, state, aux); an
            # aux with "active_frac" (snn_cnn's mean firing rate) becomes
            # a metric
            s_logits, out["state"] = res[0], res[1]
            aux = res[2] if len(res) > 2 else None
            with torch.no_grad():
                t_logits = teacher_apply(teacher_params, batch["images"])
            loss, metrics = kd_loss(s_logits, t_logits, batch["labels"], kd)
            if isinstance(aux, dict) and "active_frac" in aux:
                metrics = dict(metrics, active_frac=aux["active_frac"])
            return loss, metrics

        loss, metrics, grads = _grads_of(loss_fn, params, batch)
        return loss, metrics, out["state"], grads

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


def make_compressed_train_step(model, mesh, *, schedule,
                               dp_axis: str = "data",
                               weight_decay: float = 0.1,
                               clip_norm: float = 1.0) -> Callable:
    """Data-parallel train step with int8 + error-feedback gradient
    compression.

    The parameters are replicated over ``dp_axis`` of ``mesh`` (pure DP):
    each rank takes its rows of the global batch (as the reference's
    ``shard_map`` gives each replica its shard), computes its gradients,
    quantises them with its carried error (``compressed_psum_grads``: the
    dequantised values all-reduced and averaged), clips, and takes one
    AdamW step; the metrics are averaged over the group.

    Returns ``step((state, err), batch) -> ((state, err), metrics)``."""
    from ..data.loader import local_rows

    grad_fn = make_grad_fn(model.loss)

    def step(carry, batch):
        state, err = carry
        group = mesh.get_group(dp_axis)
        local = tree_map(lambda x: local_rows(x, mesh), batch)
        _, metrics, grads = grad_fn(state.params, local)
        grads, new_err = compressed_psum_grads(grads, err, group)
        grads, gnorm = _clip_own(grads, clip_norm)
        lr = schedule(state.step)
        new_p, new_o = adamw_update(grads, state.opt_state, state.params,
                                    lr=lr, weight_decay=weight_decay)
        del grads
        metrics = _pmean(metrics, group)
        return ((TrainState(step=state.step + 1, params=new_p,
                            opt_state=new_o), new_err),
                dict(metrics, grad_norm=gnorm, lr=lr))

    return step
