"""Serving entry point: batched requests through the continuous-batching
engine, optionally chunk-prefilled (twin of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --spiking --qk-attention --policy fused_packed [--reduced] \\
      [--prefill-chunk 64] [--device cpu]

Runs on the card unless ``--device`` says otherwise. The weights are
random, drawn from a ``torch.Generator`` seeded 0 on the run's device.
``--replicas`` above 1, ``--chaos`` and ``--integrity-every`` are still to
port (ROADMAP queue 1 item 5) and raise.
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
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--integrity-every", type=int, default=0)
    ap.add_argument("--chaos", action="store_true")
    args = ap.parse_args(argv)
    if args.replicas != 1 or args.chaos or args.integrity_every:
        raise NotImplementedError(
            "replica routing, the chaos plan and the integrity guard are "
            "still to port (ROADMAP queue 1 item 5)")

    from .. import resolve_device
    from ..configs import build_model, get_config, reduced as reduce_cfg
    from ..serve import Engine, EngineConfig

    dev = resolve_device(args.device)
    overrides = {}
    if args.spiking:
        overrides["spiking"] = True
    if args.qk_attention:
        overrides["attention_kind"] = "qk_spiking"
    cfg = get_config(args.arch, **overrides)
    if args.reduced:
        cfg = reduce_cfg(cfg, **overrides)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    ecfg = EngineConfig(max_slots=args.slots, max_len=args.max_len,
                        prefill_chunk=args.prefill_chunk,
                        prefill_chunks_per_tick=args.chunks_per_tick,
                        max_queue=args.max_queue,
                        deadline_ticks=args.deadline_ticks,
                        policy=args.policy)
    eng = Engine(model, params, ecfg)
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
