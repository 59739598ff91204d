"""The paper's experiment (Fig 2b / Fig 8) on the PyTorch port.

  ANN teacher (ResNet-18) -> KD single-timestep SNN student (VGG-11)
  -> F&Q quantization -> KD-QAT -> W2TTFS head -> fused deployment model.

  PYTHONPATH=src python examples/torch_train_kd_cifar.py [--steps 220]
      [--arch vgg11] [--policy reference|fused_dense|fused_packed]
      [--device cpu]

The twin of ``examples/train_kd_cifar.py`` together with the pipeline half
of ``benchmarks/fig8_kd_accuracy.py`` (``_eval_acc``, ``train_teacher``,
``_student_apply``, ``run``), which that example imports; the throughput
half of the benchmark is not here. The stages, in order, with the
reference's hyper-parameters:

  teacher — ANN ResNet-18, NLL of log_softmax, SGD lr 0.05, momentum 0.9,
            weight decay 5e-4, BN state carried; evaluated in eval mode
  KDT     — full-precision single-timestep student, logit KD (alpha 0.7),
            SGD on ``cosine_lr(0.1, steps)``
  F&Q     — the KDT weights under 4-bit fixed-point quantization, no
            fine-tune
  KD-QAT  — KD fine-tuning with the 4-bit fake quant in the graph,
            ``max(steps // 2, 20)`` steps at lr 0.02 from the KDT state
  W2TTFS  — the KD-QAT weights with the W2TTFS head in place of the AP head

Every stage runs ``snn_cnn.forward``; ``--policy`` is the execution policy
of the student's forward (None: ``reference``), resolved through its
gradient axis, so ``fused_dense`` trains on the kernels the model deploys
on. Runs on the card unless ``--device`` says otherwise. The initial
weights come from ``torch.Generator`` seeds 0 (teacher) and 1 (student);
each stage function takes an initial state instead, so that a test can
start both packages from the reference's own draws.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.kd import KDConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.data import SyntheticImageDataset
from repro_torch.models import ann_cnn, snn_cnn
from repro_torch.optim import cosine_lr, sgd_init, sgd_update
from repro_torch.train import make_kd_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

DEFAULT_STEPS = 220
BATCH = 64
WIDTH = 0.125
EVAL_BATCHES = 4          # of 128 images: batches 10_000 .. 10_003
STAGES = ("teacher", "KDT", "F&Q", "KD-QAT", "W2TTFS")


def _dataset() -> SyntheticImageDataset:
    return SyntheticImageDataset(num_classes=10, image_size=32, seed=0,
                                 noise=0.8)


def _batch(ds, step: int, size: int, dev: torch.device) -> dict:
    imgs, labels = ds.batch(step, size)
    return {"images": torch.as_tensor(imgs, device=dev),
            "labels": torch.as_tensor(labels, device=dev)}


def _timed_steps(n: int, step: Callable[[int], None],
                 dev: torch.device) -> list:
    """Run ``step(i)`` for i < n; returns each step's milliseconds: CUDA
    events on the card, read once the last step is done, else the host's
    clock."""
    if dev.type == "cuda":
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        marks[0].record()
        for i in range(n):
            step(i)
            marks[i + 1].record()
        marks[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    out = []
    for i in range(n):
        t0 = time.perf_counter()
        step(i)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _eval_acc(apply_fn: Callable, n_batches: int, ds, *,
              device: DeviceLike = None) -> float:
    """Top-1 accuracy of ``apply_fn(images) -> logits`` over batches
    ``10_000 + i`` of 128 images. The argmax and the count stay on the
    device; only the count crosses to the host."""
    dev = resolve_device(device)
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    total = 0
    with torch.no_grad():
        for i in range(n_batches):
            b = _batch(ds, 10_000 + i, 128, dev)
            logits = apply_fn(b["images"])
            correct += (logits.argmax(-1) == b["labels"]).sum()
            total += b["labels"].shape[0]
    return int(correct) / total


def train_teacher(ds, steps: int, *, width: float = WIDTH,
                  device: DeviceLike = None, init: Optional[dict] = None,
                  step_ms: Optional[list] = None):
    """The ANN ResNet-18 teacher: ``steps`` SGD steps on the NLL of its
    log_softmax from ``init`` (``{"params", "state"}``; else seed 0), the
    BN state carried from step to step. Returns (``teacher_apply(params,
    images) -> logits`` in eval mode on the final BN state, params,
    state, config); ``step_ms`` collects each step's milliseconds."""
    dev = resolve_device(device)
    tcfg = ann_cnn.ANNCNNConfig(arch="resnet18", width_mult=width)
    tvar = init if init is not None else ann_cnn.init(
        torch.Generator().manual_seed(0), tcfg, device=dev)

    def step_fn(params, state, opt, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        logits, new_state = ann_cnn.apply(
            {"params": tree_unflatten_like(params, leaves), "state": state},
            batch["images"], tcfg, train=True)
        logp = torch.log_softmax(logits, -1)
        nll = -torch.gather(logp, 1, batch["labels"].long()[:, None]).mean()
        grads = torch.autograd.grad(nll, leaves)
        params, opt = sgd_update(tree_unflatten_like(params, list(grads)),
                                 opt, params, lr=0.05, momentum=0.9,
                                 weight_decay=5e-4)
        return params, tree_map(torch.Tensor.detach, new_state), opt

    carry = [tvar["params"], tvar["state"], sgd_init(tvar["params"])]

    def one(s: int) -> None:
        carry[:] = step_fn(*carry, _batch(ds, s, BATCH, dev))

    times = _timed_steps(steps, one, dev)
    if step_ms is not None:
        step_ms.extend(times)
    params, state, _ = carry

    def teacher_apply(p, x):
        with torch.no_grad():
            return ann_cnn.apply({"params": p, "state": state}, x, tcfg,
                                 train=False)[0]

    return teacher_apply, params, state, tcfg


def _student_apply(cfg: snn_cnn.SNNCNNConfig) -> Callable:
    """``apply_fn(p, s, x, policy=None) -> (logits, new_state, aux)`` in
    train mode, the student ``make_kd_train_step`` expects; the aux carries
    ``active_frac``, the measured sparsity the ``auto+grad`` tuner reads."""
    def apply_fn(p, s, x, policy=None):
        return snn_cnn.forward({"params": p, "state": s}, x, cfg,
                               train=True, policy=policy)
    return apply_fn


def make_student(arch: str, quant: QuantConfig, head: str = "avgpool", *,
                 width: float = WIDTH) -> snn_cnn.SNNCNNConfig:
    return snn_cnn.SNNCNNConfig(arch=arch, width_mult=width, timesteps=1,
                                quant=quant, head=head)


def train_student(cfg, ds, teacher_apply: Callable, tparams, *, steps: int,
                  lr: float = 0.1, init: Optional[tuple] = None,
                  policy=None, device: DeviceLike = None,
                  step_ms: Optional[list] = None) -> tuple:
    """``steps`` KD steps (alpha 0.7, SGD on ``cosine_lr(lr, steps)``)
    from ``init`` = (params, state), else seed 1's draws. Returns the final
    (params, state); ``step_ms`` collects each step's milliseconds."""
    dev = resolve_device(device)
    if init is None:
        var = snn_cnn.init(torch.Generator().manual_seed(1), cfg, device=dev)
        init = (var["params"], var["state"])
    step_fn = make_kd_train_step(
        _student_apply(cfg), teacher_apply, tparams, kd=KDConfig(alpha=0.7),
        schedule=cosine_lr(lr, steps), optimizer="sgd", policy=policy)
    carry = [(init[0], sgd_init(init[0]), init[1])]

    def one(s: int) -> None:
        carry[0], _ = step_fn(carry[0], _batch(ds, s, BATCH, dev))

    times = _timed_steps(steps, one, dev)
    if step_ms is not None:
        step_ms.extend(times)
    return carry[0][0], carry[0][2]


def run(arch: str = "vgg11", steps: int = DEFAULT_STEPS, quiet: bool = False,
        policy=None, *, width: float = WIDTH, device: DeviceLike = None,
        record: Optional[dict] = None) -> dict:
    """Run the pipeline; ``steps`` is the teacher's and KDT's budget
    (KD-QAT fine-tunes for ``max(steps // 2, 20)``), ``policy`` the
    student forward's execution policy (None: ``reference``). Returns each
    stage's accuracy. ``record``, when given, receives each stage's
    seconds (``seconds``) and step milliseconds (``step_ms``), the teacher
    (``teacher``: apply, params, state, config), and each student stage's
    config and (params, state) (``cfg``, ``vars``; ``init`` is KDT's
    starting point)."""
    dev = resolve_device(device)
    rec = record if record is not None else {}
    rec.update(seconds={}, step_ms={"teacher": [], "KDT": [], "KD-QAT": []},
               cfg={}, vars={})
    ds = _dataset()
    clock = [time.perf_counter()]

    def stage_done(name: str) -> None:
        now = time.perf_counter()       # each stage ends on a host read
        rec["seconds"][name] = now - clock[0]
        clock[0] = now

    teacher_apply, tparams, tstate, tcfg = train_teacher(
        ds, steps, width=width, device=dev, step_ms=rec["step_ms"]["teacher"])
    rec["teacher"] = (teacher_apply, tparams, tstate, tcfg)
    acc_teacher = _eval_acc(lambda x: teacher_apply(tparams, x),
                            EVAL_BATCHES, ds, device=dev)
    stage_done("teacher")

    def acc_of(name, params, state, cfg):
        """The student's eval-mode accuracy (running BN statistics) under
        the training forward's policy."""
        rec["cfg"][name], rec["vars"][name] = cfg, (params, state)
        acc = _eval_acc(lambda x: snn_cnn.forward(
            {"params": params, "state": state}, x, cfg, train=False,
            policy=policy)[0], EVAL_BATCHES, ds, device=dev)
        stage_done(name)
        return acc

    # KDT: full-precision KD student
    cfg_kdt = make_student(arch, QuantConfig(enabled=False), width=width)
    var = snn_cnn.init(torch.Generator().manual_seed(1), cfg_kdt, device=dev)
    rec["init"] = (var["params"], var["state"])
    p_kdt, s_kdt = train_student(cfg_kdt, ds, teacher_apply, tparams,
                                 steps=steps, init=rec["init"], policy=policy,
                                 device=dev, step_ms=rec["step_ms"]["KDT"])
    acc_kdt = acc_of("KDT", p_kdt, s_kdt, cfg_kdt)

    # F&Q: post-training 4-bit quantization (no fine-tune)
    cfg_fq = make_student(arch, QuantConfig(enabled=True, bits=4),
                          width=width)
    acc_fq = acc_of("F&Q", p_kdt, s_kdt, cfg_fq)

    # KD-QAT: fine-tune with the fake quant in the graph
    p_qat, s_qat = train_student(cfg_fq, ds, teacher_apply, tparams,
                                 steps=max(steps // 2, 20), lr=0.02,
                                 init=(p_kdt, s_kdt), policy=policy,
                                 device=dev,
                                 step_ms=rec["step_ms"]["KD-QAT"])
    acc_qat = acc_of("KD-QAT", p_qat, s_qat, cfg_fq)

    # W2TTFS: the head swapped at inference (no retraining)
    cfg_w = make_student(arch, QuantConfig(enabled=True, bits=4),
                         head="w2ttfs", width=width)
    acc_w2 = acc_of("W2TTFS", p_qat, s_qat, cfg_w)

    res = dict(zip(STAGES, (acc_teacher, acc_kdt, acc_fq, acc_qat, acc_w2)))
    if not quiet:
        print("stage,accuracy")
        for k, v in res.items():
            print(f"{k},{v:.4f}")
        print(f"# claim1 single-timestep KD useful: KDT={acc_kdt:.3f} "
              f"(chance=0.10)")
        print(f"# claim2 QAT recovers F&Q loss: drop_FQ="
              f"{acc_kdt - acc_fq:+.3f}, drop_QAT={acc_kdt - acc_qat:+.3f}")
        print(f"# claim3 W2TTFS == AP head: delta={acc_w2 - acc_qat:+.4f}")
    return res


def deployment_spikes(arch: str, policy=None, *, width: float = WIDTH,
                      device: DeviceLike = None) -> float:
    """The deployment artifact's Total-Spikes per image (Table II's
    metric): ``fuse_model`` of a fresh int8 student (seed 1), one forward
    of 16 images under ``policy``."""
    dev = resolve_device(device)
    cfg = snn_cnn.SNNCNNConfig(arch=arch, width_mult=width, timesteps=1,
                               quant=QuantConfig(enabled=True, bits=8),
                               policy=policy)
    var = snn_cnn.init(torch.Generator().manual_seed(1), cfg, device=dev)
    fused = snn_cnn.fuse_model(var, cfg)
    imgs, _ = SyntheticImageDataset(image_size=32, seed=0).batch(0, 16)
    with torch.no_grad():
        _, _, aux = snn_cnn.forward(fused, torch.as_tensor(imgs, device=dev),
                                    cfg)
    return float(aux["total_spikes"]) / 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--arch", default="vgg11",
                    choices=["vgg11", "resnet11", "qkfresnet11"])
    ap.add_argument("--policy", default=None,
                    choices=["reference", "fused_dense", "fused_packed"],
                    help="execution policy of the KD training forward "
                         "(default: reference); the deployment below uses "
                         "the same choice")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = run(args.arch, steps=args.steps, policy=args.policy, device=dev)
    per_img = deployment_spikes(args.arch, args.policy, device=dev)
    print(f"\ndeployment model: fused+int8, total_spikes/img = "
          f"{per_img:.0f} (paper Table II metric)")
    print("stage accuracies:", {k: round(v, 4) for k, v in res.items()})
    return res


if __name__ == "__main__":
    main()
