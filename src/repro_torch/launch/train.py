"""Training entry point (twin of ``repro.launch.train``): one process a
device on ``torch.distributed``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --spiking --qk-attention --policy fused_dense [--reduced] \\
      [--steps 50 --batch 8 --seq 128] [--simulate-failure 20] \\
      [--compress] [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --reduced --device cpu          # two ranks under gloo

Runs on the card unless ``--device`` says otherwise; under torchrun each
rank takes the card of its ``LOCAL_RANK``, and without torchrun the world
is this one process (``launch.mesh.init_distributed``). The weights are
random, drawn from a ``torch.Generator`` seeded 0 on the rank's device.

Wired in, as in the reference: microbatching, checkpoint / restart (async,
rank 0 writes), straggler monitoring, the elastic re-mesh on a failure
(``--simulate-failure`` drives the whole failure path: the mesh halves,
ranks outside it leave, the rest restore the last checkpoint and go on),
the spiking / QKFormer modes and their execution policy, and
``--compress``: int8 + error-feedback data-parallel gradients, without the
elastic runner. Every rank draws the same global batch and trains on its
rows of it, the gradients averaged over the data-parallel group.

Without ``--ckpt-dir`` the checkpoints go to a new directory of this run,
removed when it ends: a run resumes only from a ``--ckpt-dir`` it is given.

``main`` returns a ``TrainRun``: the final state, the runner's events, the
loss of each step (by step index; a replayed step's last value) and each
step's host-clock milliseconds from its start to the next step's start
(checkpoint and restore work included where it falls).
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import NamedTuple, Optional, Sequence


class TrainRun(NamedTuple):
    state: object
    events: list
    losses: list
    step_ms: list


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--spiking", action="store_true")
    ap.add_argument("--qk-attention", action="store_true",
                    help="paper C4: spiking QKFormer attention")
    ap.add_argument("--policy", default=None,
                    choices=["reference", "fused_dense", "fused_packed"],
                    help="execution policy for the spiking layers, resolved "
                         "through its gradient axis: --policy fused_dense "
                         "trains the forward on the event-driven kernels it "
                         "deploys on")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the checkpoints go, and where a run resumes "
                         "from (default: a new directory under the temporary "
                         "directory, removed when the run ends)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="inject a device failure at this step (elastic "
                         "path)")
    ap.add_argument("--compress", action="store_true",
                    help="int8+error-feedback DP gradient compression "
                         "(pure-DP path, no elastic runner)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from ..configs import build_model, get_config, reduced as reduce_cfg
    from ..data import ShardedLoader, SyntheticTokenDataset
    from ..models.sharding import param_shardings
    from ..optim import error_feedback_init, linear_warmup_cosine
    from ..train import (ElasticRunner, make_compressed_train_step,
                         make_train_step, train_state_init)
    from ..train.elastic import ElasticConfig
    from .mesh import (init_distributed, local_device, make_test_mesh,
                       shutdown_distributed, this_rank, world_size)

    overrides = {}
    if args.spiking:
        overrides["spiking"] = True
    if args.qk_attention:
        overrides["attention_kind"] = "qk_spiking"
    if args.policy:
        if not args.spiking:
            ap.error("--policy requires --spiking (execution policies "
                     "govern the spiking layers)")
        # a training driver always wants the gradient axis: the forward
        # runs the chosen kernels, the backward the surrogate gradients
        overrides["policy"] = args.policy + "+grad"
    cfg = get_config(args.arch, **overrides)
    if args.reduced:
        cfg = reduce_cfg(cfg, **overrides)

    made_group = init_distributed(args.device)
    own_ckpt_dir = None
    try:
        dev = local_device()
        model = build_model(cfg)
        schedule = linear_warmup_cosine(args.lr, args.warmup, args.steps)
        n_dev = world_size()

        def mesh_full():
            return make_test_mesh((n_dev,), ("data",))

        def mesh_half():
            return make_test_mesh((max(n_dev // 2, 1),), ("data",))

        ds = SyntheticTokenDataset(cfg.vocab_size, args.seq + 1)

        def make_np_batch(step, bs, shard, n_shards):
            return {"tokens": ds.batch(step, bs, shard, n_shards)}

        def init_params():
            return model.init(torch.Generator(device=dev).manual_seed(0),
                              device=dev)

        losses, starts = {}, []

        if args.compress:
            mesh = mesh_full()
            params = init_params()
            step_fn = make_compressed_train_step(model, mesh,
                                                 schedule=schedule)
            carry = (train_state_init(params), error_feedback_init(params))
            del params
            t0 = time.time()
            for i in range(args.steps):
                starts.append(time.perf_counter())
                batch = {"tokens": torch.from_numpy(make_np_batch(
                    i, args.batch, 0, 1)["tokens"]).to(dev)}
                carry, m = step_fn(carry, batch)
                losses[i] = float(m["loss"])
                if i % args.log_every == 0:
                    print(f"step {i}: loss={losses[i]:.4f} "
                          f"(int8+EF compressed DP)")
            starts.append(time.perf_counter())
            dt = time.time() - t0
            print(f"[train] compressed-DP done: {args.steps} steps in "
                  f"{dt:.1f}s")
            return TrainRun(carry[0], [], [losses[i] for i in sorted(losses)],
                            _step_ms(starts))

        def make_step(mesh):
            step = make_train_step(model, schedule=schedule,
                                   microbatch=args.microbatch,
                                   dp_group=mesh.get_group("data"))

            def timed(state, batch):
                starts.append(time.perf_counter())
                i = int(state.step)
                state, m = step(state, batch)
                losses[i] = m["loss"]
                return state, m

            return timed

        def make_state(mesh):
            return train_state_init(init_params())

        ckpt_dir = args.ckpt_dir
        if ckpt_dir is None:
            ckpt_dir = own_ckpt_dir = _fresh_dir(dev)
        loader = ShardedLoader(make_np_batch, args.batch, mesh_full())
        runner = ElasticRunner(
            [mesh_full, mesh_half], make_step, make_state, param_shardings,
            loader, ElasticConfig(ckpt_dir=ckpt_dir,
                                  ckpt_every=args.ckpt_every))
        if args.simulate_failure:
            runner.inject_failure(args.simulate_failure)

        t0 = time.time()
        state, events = runner.run(args.steps)
        starts.append(time.perf_counter())
        dt = time.time() - t0
        losses = [float(losses[i]) for i in sorted(losses)]
        if not runner.mesh.is_member():
            print(f"[train] rank {this_rank()} is outside the "
                  f"{runner.mesh.shape} mesh: it left the run at step "
                  f"{int(state.step)}")
        else:
            print(f"[train] {args.arch} done: {int(state.step)} steps in "
                  f"{dt:.1f}s ({int(state.step) / dt:.2f} steps/s)")
        for e in events:
            print("[event]", e)
        return TrainRun(state, events, losses, _step_ms(starts))
    finally:
        if own_ckpt_dir is not None and this_rank() == 0:
            shutil.rmtree(own_ckpt_dir, ignore_errors=True)
        if made_group:
            shutdown_distributed()


def _fresh_dir(dev) -> str:
    """A new directory under ``tempfile.gettempdir()`` (which honours
    ``TMPDIR``), made by rank 0 and its name sent to every rank, so that no
    two runs share checkpoints."""
    import torch.distributed as dist

    name = [tempfile.mkdtemp(prefix="repro_torch_ckpt_")
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(name, src=0, device=dev)
    return name[0]


def _step_ms(starts: list) -> list:
    """Milliseconds from each step's start to the next's."""
    return [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]


if __name__ == "__main__":
    main()
