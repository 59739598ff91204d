"""Continuous-batching serving demo of the PyTorch port (twin of
``examples/serve_lm.py``): more requests than slots, mixed prompt lengths,
greedy and sampled decoding, through the elastic-FIFO pipeline: chunked
prefill, a bounded admission FIFO with backpressure on ``submit``, and
streaming consumption from the per-slot output FIFOs.

How the model executes is one knob, the execution policy:
``--spiking --policy fused_packed`` serves the spiking QKFormer mode on the
fused kernels with bit-packed spike state, and ``stats()`` then reports
the measured sparsity and packed bytes in flight.

Self-healing knobs: ``--chaos`` replays the canned deterministic fault
plan (NaN injections and a fused-kernel fault, plus a replica kill with
``--replicas 2``) while streaming goes on; ``--integrity-every N`` runs
the numeric / packed-state guard; ``--deadline-ticks N`` bounds every
request's time in the engine. Runs on the card unless ``--device`` says
otherwise.

  PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen3-1.7b]
      [--replicas 2] [--spiking] [--policy fused_packed] [--chaos]
      [--deadline-ticks 64] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.serve import (Engine, EngineConfig, ReplicaRouter,
                               demo_chaos_plan)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--spiking", action="store_true",
                    help="serve the spiking QKFormer attention (token-local "
                         "masks: O(1) decode, no KV cache)")
    ap.add_argument("--policy", default=None,
                    choices=["reference", "fused_dense", "fused_packed"],
                    help="execution policy of this engine (default: the "
                         "model config's)")
    ap.add_argument("--deadline-ticks", type=int, default=0,
                    help="per-request deadline in engine ticks (0 = none); "
                         "late requests end 'deadline_miss'")
    ap.add_argument("--integrity-every", type=int, default=0,
                    help="integrity-guard period in decode ticks (0 = "
                         "off); poisoned slots are quarantined and replayed")
    ap.add_argument("--chaos", action="store_true",
                    help="replay the canned deterministic fault plan "
                         "against this trace (implies --integrity-every 1)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.policy and not args.spiking:
        # the engine applies its policy to qk_spiking models only
        ap.error("--policy requires --spiking (execution policies govern "
                 "the spiking qk_spiking path)")
    dev = resolve_device(args.device)

    overrides = ({"spiking": True, "attention_kind": "qk_spiking"}
                 if args.spiking else {})
    cfg = reduced(get_config(args.arch), **overrides)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    ecfg = EngineConfig(max_slots=4, max_len=96, prefill_pad=16,
                        prefill_chunk=16,     # elastic chunked prefill
                        max_queue=8,          # bounded admission FIFO
                        policy=args.policy,
                        deadline_ticks=args.deadline_ticks,
                        integrity_every=(args.integrity_every
                                         or (1 if args.chaos else 0)))
    faults = None
    if args.chaos:
        faults = demo_chaos_plan(0, n_replicas=args.replicas)
        print("chaos plan:", [e["kind"] for e in
                              faults.summary()["events"]])
    if args.replicas > 1:
        eng = ReplicaRouter(model, params, ecfg, n_replicas=args.replicas,
                            faults=faults)
    else:
        eng = Engine(model, params, ecfg, faults=faults)
    rng = np.random.default_rng(0)
    uids = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 32))
        # submit blocks (runs engine ticks) while the admission FIFO is
        # full: the elastic-FIFO backpressure
        uids.append(eng.submit(rng.integers(0, cfg.vocab_size, plen),
                               max_new=int(rng.integers(4, 12)),
                               temperature=0.0 if i % 2 else 0.8))
    # stream: drain the per-slot output FIFOs while the engine runs
    streamed = {u: [] for u in uids}
    while eng.step() or eng.pending():
        for u in uids:
            streamed[u].extend(eng.pop_output(u))
    for u in uids:
        streamed[u].extend(eng.pop_output(u))
    for u in uids[:4]:
        print(f"req {u}: streamed {len(streamed[u])} tokens -> "
              f"{streamed[u]}")
    stats = eng.stats()
    print("stats:", stats)
    return {"streamed": streamed, "stats": stats}


if __name__ == "__main__":
    main()
