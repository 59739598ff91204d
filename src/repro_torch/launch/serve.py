"""Serving entry point: batched requests through the continuous-batching
engine, optionally chunk-prefilled (twin of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --spiking --qk-attention --policy fused_packed [--reduced] \\
      [--prefill-chunk 64] [--replicas 2] [--chaos] [--device cpu]

Runs on the card unless ``--device`` says otherwise. The weights are
random, drawn from a ``torch.Generator`` seeded 0 on the run's device.
Every decoder-only family serves (a vlm on text alone); an encoder-decoder
(seamless-m4t-large-v2) raises, as the reference's engine cannot serve it
either. ``--replicas N`` serves through a least-loaded router of N engine
replicas (dealt over the visible cards; on one card they share it);
``--chaos`` runs the canned fault plan (a replica killed, two NaN
injections, one fused-kernel fault) against the trace and implies
``--integrity-every 1``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--spiking", action="store_true")
    ap.add_argument("--qk-attention", action="store_true")
    ap.add_argument("--policy", default=None,
                    help="execution policy of the engine (reference, "
                         "fused_dense, fused_packed); default: the model's")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: tokens per chunk interleaved "
                         "with decode ticks (0 = blocking prefill)")
    ap.add_argument("--chunks-per-tick", type=int, default=1)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission FIFO bound; submit applies "
                         "backpressure when full (0 = unbounded)")
    ap.add_argument("--deadline-ticks", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind a "
                         "least-loaded router")
    ap.add_argument("--integrity-every", type=int, default=0,
                    help="run the numeric / packed-state integrity guard "
                         "every N decode ticks; flagged slots are "
                         "quarantined and replayed (0 = off)")
    ap.add_argument("--chaos", action="store_true",
                    help="run the canned deterministic fault plan (replica "
                         "kill, NaN injections, a fused-kernel fault) "
                         "against the trace; implies --integrity-every 1")
    ap.add_argument("--chaos-seed", type=int, default=0)
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..configs import build_model, get_config, reduced as reduce_cfg
    from ..serve import (Engine, EngineConfig, ReplicaRouter,
                         demo_chaos_plan)

    dev = resolve_device(args.device)
    overrides = {}
    if args.spiking:
        overrides["spiking"] = True
    if args.qk_attention:
        overrides["attention_kind"] = "qk_spiking"
    cfg = get_config(args.arch, **overrides)
    if args.reduced:
        cfg = reduce_cfg(cfg, **overrides)
    if cfg.family == "encdec":
        raise ValueError(
            f"{args.arch} is an encoder-decoder: the engine serves the "
            f"decoder-only families (drive EncDecLM.prefill / decode_step "
            f"directly)")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    ecfg = EngineConfig(max_slots=args.slots, max_len=args.max_len,
                        prefill_chunk=args.prefill_chunk,
                        prefill_chunks_per_tick=args.chunks_per_tick,
                        max_queue=args.max_queue,
                        deadline_ticks=args.deadline_ticks,
                        integrity_every=(args.integrity_every
                                         or (1 if args.chaos else 0)),
                        policy=args.policy)
    faults = None
    if args.chaos:
        faults = demo_chaos_plan(args.chaos_seed, n_replicas=args.replicas)
        print(f"[serve] chaos plan: {faults.summary()['events']}")
    if args.replicas > 1:
        eng = ReplicaRouter(model, params, ecfg, n_replicas=args.replicas,
                            faults=faults)
    else:
        eng = Engine(model, params, ecfg, faults=faults)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 24))
        eng.submit(rng.integers(0, cfg.vocab_size, plen),
                   max_new=args.max_new, temperature=args.temperature)
    eng.run_until_drained()
    stats = eng.stats()
    print("[serve]", stats)
    return stats


if __name__ == "__main__":
    main()
