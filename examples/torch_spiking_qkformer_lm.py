"""A spiking LM with on-the-fly QKFormer attention, on the PyTorch port:
the paper's C4 applied to language modelling.

  PYTHONPATH=src python examples/torch_spiking_qkformer_lm.py
      [--device cpu] [--steps 15] [--policy fused_dense]

Shows what the mechanism buys an LM:
  1. the spiking student trains with surrogate gradients and sequence KD
     from its softmax twin, its forward on the fused kernels of
     ``--policy`` (run with the gradient axis, ``+grad``);
  2. decode keeps no KV cache (the QK token mask is token-local);
  3. activations are binary events.
Runs on the card unless ``--device`` says otherwise.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.core.kd import KDConfig, sequence_kd_loss
from repro_torch.data import SyntheticTokenDataset
from repro_torch.models.layers import spike_log
from repro_torch.optim import adamw_init, adamw_update, constant_lr
from repro_torch.train import (make_grad_fn, make_train_step,
                               train_state_init)

KD = KDConfig(alpha=0.5, temperature=2.0)


def make_kd_loss(student, teacher, tparams, kd: KDConfig = KD):
    """``loss_fn(student_params, batch) -> (loss, metrics)``: the sequence
    KD of the student's next-token logits against the frozen teacher's
    (which runs without autograd), on ``batch["tokens"]`` [B, S]."""

    def logits(model, params, batch):
        x, _ = model._stack_train(params, *model._embed(params, batch))
        return model._logits(params, x[:, :-1, :])

    def loss_fn(sparams, batch):
        with torch.no_grad():
            t_logits = logits(teacher, tparams, batch)
        return sequence_kd_loss(logits(student, sparams, batch), t_logits,
                                batch["tokens"][:, 1:], kd)

    return loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--policy", default="fused_dense",
                    choices=["reference", "fused_dense", "fused_packed"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = get_config("qwen3-1.7b")
    ann_cfg = reduced(base)                                # the ANN teacher
    snn_cfg = reduced(base, spiking=True, attention_kind="qk_spiking",
                      policy=args.policy + "+grad")
    teacher, student = build_model(ann_cfg), build_model(snn_cfg)
    tparams = teacher.init(torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    sparams = student.init(torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    ds = SyntheticTokenDataset(snn_cfg.vocab_size, seq_len=48)

    def batch(i, b=8):
        return {"tokens": torch.tensor(ds.batch(i, b), device=dev)}

    # 1. a brief teacher pretrain, then sequence KD of the spiking student
    tstep = make_train_step(teacher, schedule=constant_lr(3e-3))
    tstate = train_state_init(tparams)
    for i in range(args.steps):
        tstate, tm = tstep(tstate, batch(i))
    tparams = tstate.params
    print(f"teacher loss after pretrain: {float(tm['loss']):.3f}")

    grad_fn = make_grad_fn(make_kd_loss(student, teacher, tparams))
    opt = adamw_init(sparams)
    for i in range(args.steps):
        loss, m, g = grad_fn(sparams, batch(i))
        sparams, opt = adamw_update(g, opt, sparams, lr=1e-3)
    print(f"spiking student KD loss: {float(loss):.3f} "
          f"(ce={float(m['ce']):.3f} kl={float(m['kl']):.3f}; "
          f"{args.policy}+grad)")

    # 2. cache-free decode: the attention cache really is empty
    k, _ = student.init_cache(1, 4096, device=dev)["layers"]
    softmax_k = teacher.init_cache(1, 4096, device=dev)["layers"][0]
    print(f"KV cache entries for a 4096-token context: {k.numel()} elements "
          f"(softmax equivalent: {softmax_k.numel()})")

    # 3. binary activations: the spike rate of the QK path
    with torch.no_grad(), spike_log() as log:
        student.loss(sparams, batch(0, 2))
    q = sum(float(t) for kind, t in log if kind == "q")
    n_q = 2 * 48 * snn_cfg.n_layers * snn_cfg.n_heads * \
        snn_cfg.resolved_head_dim
    print(f"Q spike rate {q / n_q:.3f}; pipeline OK: the spiking QKFormer "
          f"LM trains, decodes O(1) a token")
    return {"loss": float(loss), "cache_elements": k.numel(),
            "q_rate": q / n_q}


if __name__ == "__main__":
    main()
