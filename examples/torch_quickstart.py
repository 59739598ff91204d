"""Quickstart of the PyTorch port: the public API in about 60 lines.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      [--steps 10]

Builds a reduced qwen3-1.7b, trains it a few steps on synthetic bigram
data, then serves it (prefill + greedy decode), and runs the spiking
QKFormer form of the same architecture. Runs on the card unless
``--device`` says otherwise.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.data import SyntheticTokenDataset
from repro_torch.optim import constant_lr
from repro_torch.train import make_train_step, train_state_init
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. pick an architecture, shrink it
    cfg = reduced(get_config("qwen3-1.7b"))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} (reduced) params={n_params / 1e6:.2f}M")

    # 2. train a few steps on synthetic bigram data
    ds = SyntheticTokenDataset(cfg.vocab_size, seq_len=64)
    step = make_train_step(model, schedule=constant_lr(3e-3))
    state = train_state_init(params)
    for i in range(args.steps):
        batch = {"tokens": torch.tensor(ds.batch(i, 8), device=dev)}
        state, metrics = step(state, batch)
        if i % 3 == 0 or i == args.steps - 1:
            print(f"step {i}: loss={float(metrics['loss']):.3f}")

    # 3. serve: prefill a prompt, decode a few tokens greedily
    prompt = torch.tensor(ds.batch(999, 1)[:, :16], device=dev)
    logits, cache = model.prefill(state.params, {"tokens": prompt},
                                  max_len=32)
    out = [int(logits[0].argmax())]
    for _ in range(8):
        logits, cache = model.decode_step(
            state.params, torch.tensor([[out[-1]]], device=dev), cache)
        out.append(int(logits[0].argmax()))
    print("generated:", out)

    # 4. the paper's techniques are config flags on the same architecture
    spiking_cfg = reduced(get_config("qwen3-1.7b"), spiking=True,
                          attention_kind="qk_spiking")
    smodel = build_model(spiking_cfg)
    sparams = smodel.init(torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    with torch.no_grad():
        loss, _ = smodel.loss(sparams, {"tokens": torch.tensor(
            ds.batch(0, 4), device=dev)})
    print(f"spiking QKFormer mode: loss={float(loss):.3f} "
          "(binary activations, O(N*d) attention, cache-free decode)")
    return {"loss": float(metrics["loss"]), "spiking_loss": float(loss),
            "generated": out}


if __name__ == "__main__":
    main()
