"""Data parallelism in the port on the CPU: two gloo ranks on a
``FileStore`` (two processes, no network) drive ``launch.train.main`` on
the reduced spiking qwen3-1.7b (``fused_dense+grad``) through a
checkpoint, a failure and the remesh to one rank: rank 1 leaves there,
rank 0 restores and finishes, equal to a world-size-1 run at the LM
tolerances of ``tests/test_torch_lm_train.py`` (a mean of two half-batch
gradients is another sum). The same ranks run ``compressed_psum_grads``,
bit-equal to the mean of both ranks' dequantised values formed in one
process. ``compress_int8`` is bit-equal to the reference's (ties at .5
included), and the port's ``make_compressed_train_step`` at world size 1
matches the reference's on ``make_test_mesh((1,), ("data",))``.
"""
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import numpy as np
import pytest
import torch

from repro.configs import build_model as j_build_model
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch.mesh import make_test_mesh as j_make_test_mesh
from repro.optim import compression as jcomp
from repro.optim import error_feedback_init as j_error_feedback_init
from repro.optim.schedules import constant_lr as j_constant_lr
from repro.train import make_compressed_train_step as j_make_compressed
from repro.train import train_state_init as j_train_state_init
from repro_torch import convert
from repro_torch.configs import build_model, get_config, reduced
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import main
from repro_torch.optim import (compress_int8, compressed_psum_grads,
                               constant_lr, decompress_int8,
                               error_feedback_init)
from repro_torch.optim.compression import _compress_one
from repro_torch.train import (make_compressed_train_step, make_grad_fn,
                               train_state_init)
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
STATE_RTOL = 1e-4
DRIVER = ["--reduced", "--spiking", "--qk-attention", "--policy",
          "fused_dense", "--device", "cpu", "--steps", "4", "--batch", "4",
          "--seq", "16", "--ckpt-every", "2", "--simulate-failure", "3"]

RANK = textwrap.dedent("""
    import datetime, sys
    import torch, torch.distributed as dist
    rank, world, store, out, ckpt = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    from repro_torch.launch.train import main
    from repro_torch.optim import compressed_psum_grads
    from repro_torch.tree import tree_leaves
    run = main(sys.argv[6:] + ["--ckpt-dir", ckpt])
    gen = torch.Generator().manual_seed(100 + rank)
    grads = {"a": torch.randn((33, 7), generator=gen) * 3,
             "b": [torch.randn((5,), generator=gen), torch.zeros((4,))]}
    err = {"a": torch.randn((33, 7), generator=gen) * 0.01,
           "b": [torch.randn((5,), generator=gen) * 0.01, torch.zeros((4,))]}
    mean, new_err = compressed_psum_grads(grads, err)
    torch.save({"state": tree_leaves(run.state), "losses": run.losses,
                "events": run.events, "step": int(run.state.step),
                "mean": tree_leaves(mean), "err": tree_leaves(new_err)}, out)
    dist.destroy_process_group()
""")


def _rank_inputs(rank):
    gen = torch.Generator().manual_seed(100 + rank)
    grads = [torch.randn((33, 7), generator=gen) * 3,
             torch.randn((5,), generator=gen), torch.zeros((4,))]
    err = [torch.randn((33, 7), generator=gen) * 0.01,
           torch.randn((5,), generator=gen) * 0.01, torch.zeros((4,))]
    return grads, err


def _events(events):
    return [{k: v for k, v in e.items() if k != "path"} for e in events]


def _assert_close(got, want, rtol, what):
    want = want.numpy().astype(np.float64)
    atol = 1e-5 * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.numpy().astype(np.float64), want,
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_two_gloo_ranks_remesh_and_compress(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), "2", str(tmp_path / "store"),
         str(tmp_path / f"rank{r}.pt"), str(tmp_path / "ckpt2"), *DRIVER],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-2000:] + err[-4000:]
    assert "left the run at step 3" in outs[1][0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    solo = main(DRIVER + ["--ckpt-dir", str(tmp_path / "ckpt1")])
    assert not torch.distributed.is_initialized()   # main made its own
    want = [{"kind": "checkpoint", "step": 2}, {"kind": "failure", "step": 3},
            {"kind": "restore", "step": 2},
            {"kind": "remesh", "mesh": {"data": 1}, "resume_step": 3}]
    assert _events(solo.events) == _events(ranks[0]["events"]) == want
    assert _events(ranks[1]["events"]) == want[:2]
    assert ranks[1]["step"] == 3 and ranks[0]["step"] == 4
    np.testing.assert_allclose(ranks[0]["losses"], solo.losses, rtol=RTOL)
    assert len(ranks[1]["losses"]) == 3
    np.testing.assert_allclose(ranks[1]["losses"], solo.losses[:3],
                               rtol=RTOL)
    leaves = tree_leaves(solo.state)
    assert len(leaves) == len(ranks[0]["state"])
    for i, (a, b) in enumerate(zip(ranks[0]["state"], leaves)):
        assert a.dtype == b.dtype
        _assert_close(a, b, STATE_RTOL, f"state leaf {i}")

    # compressed_psum_grads: the mean of both ranks' dequantised values
    inputs = [_rank_inputs(r) for r in range(2)]
    for i in range(3):
        deq, errs = [], []
        for grads, err in inputs:
            g = grads[i] + err[i]
            d = decompress_int8(*compress_int8(g))
            deq.append(d)
            errs.append(g - d)
        mean = (deq[0] + deq[1]) / torch.tensor(2.0)
        for r in range(2):
            assert torch.equal(ranks[r]["mean"][i], mean), (r, i)
            assert torch.equal(ranks[r]["err"][i], errs[r]), (r, i)


def _ties():
    rng = np.random.default_rng(7)
    # amax 127 gives scale 1: every k + .5 is a tie, rounded to even
    tie = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                    3.49999, 0.0], np.float32)
    return [tie, rng.standard_normal((64, 33)).astype(np.float32) * 5,
            rng.standard_normal((7,)).astype(np.float32) * 1e-20,
            np.zeros((5,), np.float32),
            (rng.integers(-400, 400, (300,)) / 2.0).astype(np.float32),
            rng.standard_normal((4, 4)).astype(np.float32) * 3e4]


@pytest.mark.parametrize("i", range(6))
def test_compress_int8_bit_equal_to_the_reference(i):
    x = _ties()[i]
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    tq, ts = compress_int8(torch.from_numpy(x.copy()))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        decompress_int8(tq, ts).numpy(),
        np.asarray(jcomp.decompress_int8(jq, js)))
    if i == 0:
        np.testing.assert_array_equal(
            tq.numpy(), [127, 0, 2, 2, 0, -2, -2, 126, -126, 3, 0])


def test_stacked_layers_share_the_reference_scale():
    """The port's per-layer leaves of a ``blocks`` list are quantised at
    the scale of the reference's stacked leaf: the means are the
    reference's bit for bit (``shard_map`` over one device); its compiled
    residual g - q scale may fuse the product into the subtraction, so it
    is held to one rounding of the product."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 6, 5)).astype(np.float32)
    w[1] *= 9.0                              # one layer sets the scale
    e = rng.standard_normal((3, 6, 5)).astype(np.float32) * 1e-3
    emb = rng.standard_normal((7, 5)).astype(np.float32)
    jmesh = j_make_test_mesh((1,), ("data",))
    fn = jax.shard_map(
        lambda g, er: jcomp.compressed_psum_grads(g, er, "data"),
        mesh=jmesh, in_specs=(P(), P()), out_specs=(P(), P()),
        check_vma=False)
    jmean, jerr = jax.jit(fn)({"blocks": {"w": jnp.asarray(w)},
                               "emb": jnp.asarray(emb)},
                              {"blocks": {"w": jnp.asarray(e)},
                               "emb": jnp.zeros_like(jnp.asarray(emb))})
    made = tmesh.init_distributed("cpu")
    try:
        grads = {"blocks": [{"w": torch.from_numpy(w[i].copy())}
                            for i in range(3)],
                 "emb": torch.from_numpy(emb.copy())}
        errs = {"blocks": [{"w": torch.from_numpy(e[i].copy())}
                           for i in range(3)],
                "emb": torch.zeros((7, 5))}
        mean, new_err = compressed_psum_grads(grads, errs)
        one = _compress_one(grads["emb"], errs["emb"])
    finally:
        if made:
            tmesh.shutdown_distributed()
    for i in range(3):
        np.testing.assert_array_equal(mean["blocks"][i]["w"].numpy(),
                                      np.asarray(jmean["blocks"]["w"][i]))
        np.testing.assert_allclose(
            new_err["blocks"][i]["w"].numpy(),
            np.asarray(jerr["blocks"]["w"][i]), rtol=0,
            atol=float(np.finfo(np.float32).eps * np.abs(w + e).max()))
    np.testing.assert_array_equal(mean["emb"].numpy(),
                                  np.asarray(jmean["emb"]))
    assert torch.equal(one[0], mean["emb"]) and torch.equal(one[1],
                                                             new_err["emb"])


def test_compressed_step_matches_the_reference_at_world_size_one():
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (4, 17)).astype(np.int32)
    with warnings.catch_warnings():
        # the reference imports jax.experimental.shard_map, deprecated in
        # the installed jax
        warnings.simplefilter("ignore", DeprecationWarning)
        jstep = jax.jit(j_make_compressed(
            jm, j_make_test_mesh((1,), ("data",)),
            schedule=j_constant_lr(5e-3)))
        jcarry, jm_ = jstep((j_train_state_init(jp),
                             j_error_feedback_init(jp)),
                            {"tokens": jnp.asarray(tokens)})

    made = tmesh.init_distributed("cpu")
    try:
        tm = build_model(reduced(get_config("qwen3-1.7b")))
        tp = convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        mesh = tmesh.make_test_mesh((1,), ("data",), device="cpu")
        step = make_compressed_train_step(tm, mesh,
                                          schedule=constant_lr(5e-3))
        batch = {"tokens": torch.from_numpy(tokens)}
        (state, err), m = step((train_state_init(tp),
                                error_feedback_init(tp)), batch)
        _, _, g = make_grad_fn(tm.loss)(tp, batch)
    finally:
        if made:
            tmesh.shutdown_distributed()
    np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm_["grad_norm"]), rtol=1e-4)
    want = convert.train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jcarry[0]), device="cpu")
    for i, (a, b) in enumerate(zip(tree_leaves(state), tree_leaves(want))):
        _assert_close(a, b, STATE_RTOL, f"state leaf {i}")
    jerr = convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jcarry[1]), device="cpu")
    # the residual is g - q scale: q may differ by one quantum where
    # |g / scale| lies within rounding of a half (the packages' gradients
    # sum in other orders), elsewhere it differs as g does; a layer's
    # scale is that of the reference's stacked leaf
    scales = {}
    for path, gi in zip(_places(g), tree_leaves(g)):
        amax = gi.abs().max()
        scales[path] = torch.maximum(scales.get(path, amax), amax)
    for i, (a, b, gi, path) in enumerate(zip(
            tree_leaves(err), tree_leaves(jerr), tree_leaves(g), _places(g))):
        scale = scales[path] / torch.tensor(127.0)
        y = (gi / scale).abs()
        near = (y - torch.floor(y) - 0.5).abs() <= 4e-6 * y.clamp(min=1.0)
        assert int(near.sum()) <= max(1, gi.numel() // 1000), i
        np.testing.assert_allclose(
            a[~near].numpy(), b[~near].numpy(), rtol=STATE_RTOL,
            atol=1e-5 * float(gi.abs().max()), err_msg=f"err leaf {i}")


def _places(tree, key=()):
    """A leaf's place in the reference's stacked tree, per leaf."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _places(tree[k], key + (k,))]
    if isinstance(tree, list):
        return [p for v in tree for p in _places(v, key + ("*",))]
    return [key]
