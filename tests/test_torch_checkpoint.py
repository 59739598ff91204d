"""The port's checkpoints (``repro_torch.train.checkpoint``): the reference
cases of ``tests/test_checkpoint_data.py`` on torch trees (round trip,
latest and prune, the async writer, a tree mismatch, the per-leaf CRC32, a
corrupted, reshaped or retyped shard, a manifest without CRCs, a partial
directory); an asynchronous save that fails raises on ``wait`` and fails an
elastic run; the same dict / list / NamedTuple tree of numpy arrays saved by
both packages gives equal manifests (``time`` aside) and byte-equal
``.npy`` files; a bf16 leaf round-trips through its uint16 bits.
"""
import json
import zlib
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jck
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.train import (AsyncCheckpointer, ElasticRunner,
                               latest_checkpoint, restore_checkpoint,
                               save_checkpoint, train_state_init)
from repro_torch.train.checkpoint import CheckpointCorrupt, prune_checkpoints
from repro_torch.train.elastic import ElasticConfig
from repro_torch.tree import tree_leaves


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": (torch.zeros((2, 2)), torch.full((3,), 2.5))}}


def _like(tree):
    return {"a": torch.empty((3, 4), device="meta"),
            "b": {"c": torch.empty((5,), dtype=torch.int32, device="meta"),
                  "d": (torch.empty((2, 2), device="meta"),
                        torch.empty((3,), device="meta"))}}


def _assert_equal_trees(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 7, tree)
    restored, step = restore_checkpoint(latest_checkpoint(tmp_path),
                                        _like(tree), "cpu")
    assert step == 7
    _assert_equal_trees(restored, tree)
    assert isinstance(restored["b"]["d"], tuple)


def test_restore_onto_the_like_leaves_devices(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 1, tree)
    restored, _ = restore_checkpoint(latest_checkpoint(tmp_path), tree)
    _assert_equal_trees(restored, tree)
    assert all(t.device.type == "cpu" for t in tree_leaves(restored))


def test_latest_and_prune(tmp_path):
    for s in (1, 5, 9, 13):
        save_checkpoint(tmp_path, s, _tree())
    assert latest_checkpoint(tmp_path).name == "step_00000013"
    prune_checkpoints(tmp_path, keep=2)
    remaining = sorted(p.name for p in tmp_path.iterdir())
    assert remaining == ["step_00000009", "step_00000013"]


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(tmp_path, keep=2)
    tree = _tree()
    ck.save(3, tree)
    tree["a"].add_(1.0)       # the host copy was taken when save returned
    ck.wait()
    assert latest_checkpoint(tmp_path).name == "step_00000003"
    restored, _ = restore_checkpoint(ck.last_path, _like(tree), "cpu")
    assert torch.equal(restored["a"], torch.arange(12.0).reshape(3, 4))


def _unwritable(tmp_path):
    """A checkpoint directory that cannot be made: a file stands where its
    parent should be."""
    (tmp_path / "file").write_text("")
    return tmp_path / "file" / "ckpt"


def test_async_save_failure_raises_on_wait(tmp_path):
    ck = AsyncCheckpointer(_unwritable(tmp_path))
    ck.save(1, _tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                 # raised once; the checkpointer goes on


def test_a_failed_save_fails_the_elastic_run(tmp_path):
    def make_step(mesh):
        def step(state, batch):
            return state._replace(step=state.step + 1), {
                "loss": torch.zeros(())}
        return step

    runner = ElasticRunner(
        [lambda: make_test_mesh((1,), ("data",), device="cpu")], make_step,
        lambda mesh: train_state_init({"w": torch.ones(3)}),
        lambda shape, mesh: "cpu", lambda step: None,
        ElasticConfig(ckpt_dir=str(_unwritable(tmp_path)), ckpt_every=1))
    with pytest.raises(OSError):
        runner.run(3)


def test_restore_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 1, _tree())
    bad_like = {"only": torch.empty((2,), device="meta")}
    with pytest.raises(AssertionError):
        restore_checkpoint(latest_checkpoint(tmp_path), bad_like)


def test_manifest_carries_per_leaf_crc32(tmp_path):
    path = save_checkpoint(tmp_path, 2, _tree())
    manifest = json.loads((path / "manifest.json").read_text())
    n = len(manifest["paths"])
    assert len(manifest["crc32"]) == n
    for i in range(n):
        arr = np.load(path / f"{i:04d}.npy")
        assert manifest["crc32"][i] == \
            (zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF)


def test_corrupted_shard_raises_naming_leaf(tmp_path):
    tree = _tree()
    path = save_checkpoint(tmp_path, 3, tree)
    arr = np.load(path / "0000.npy")
    np.save(path / "0000.npy", arr + 1)
    with pytest.raises(CheckpointCorrupt, match=r"CRC32") as ei:
        restore_checkpoint(path, _like(tree), "cpu")
    assert "0000.npy" in str(ei.value)
    assert "['a']" in str(ei.value)


def test_wrong_shape_shard_raises(tmp_path):
    tree = _tree()
    path = save_checkpoint(tmp_path, 4, tree)
    np.save(path / "0001.npy", np.zeros((9, 9), np.float32))
    with pytest.raises(CheckpointCorrupt, match="shape"):
        restore_checkpoint(path, _like(tree), "cpu")


def test_wrong_dtype_shard_raises(tmp_path):
    tree = _tree()
    path = save_checkpoint(tmp_path, 5, tree)
    arr = np.load(path / "0000.npy")
    np.save(path / "0000.npy", arr.astype(np.float16))
    with pytest.raises(CheckpointCorrupt, match="dtype"):
        restore_checkpoint(path, _like(tree), "cpu")


def test_crc_less_manifest_still_restores(tmp_path):
    tree = _tree()
    path = save_checkpoint(tmp_path, 6, tree)
    manifest = json.loads((path / "manifest.json").read_text())
    del manifest["crc32"]
    (path / "manifest.json").write_text(json.dumps(manifest))
    restored, step = restore_checkpoint(path, _like(tree), "cpu")
    assert step == 6
    _assert_equal_trees(restored, tree)


def test_latest_checkpoint_warns_and_skips_partial_dirs(tmp_path):
    save_checkpoint(tmp_path, 7, _tree())
    (tmp_path / ".tmp_step_00000009").mkdir()
    with pytest.warns(RuntimeWarning, match="partial"):
        latest = latest_checkpoint(tmp_path)
    assert latest.name == "step_00000007"


# ------------------------------------------------- the reference's layout
class _Moments(NamedTuple):
    step: np.ndarray
    m: list
    v: dict


def _np_tree():
    rng = np.random.default_rng(0)
    return {"params": {"emb": rng.standard_normal((6, 4), np.float32),
                       "blocks": [{"w": rng.standard_normal((4, 4),
                                                            np.float32)},
                                  {"w": rng.standard_normal((4, 4),
                                                            np.float32)}]},
            "opt": _Moments(np.array(3, np.int32),
                            [rng.integers(-5, 5, (3,), np.int64),
                             np.arange(4, dtype=np.uint8)],
                            {"z": np.zeros((2, 3), np.float16),
                             "a": np.array([True, False])}),
            "step": np.array(7, np.int32)}


def test_same_tree_same_files_as_the_reference(tmp_path):
    tree = _np_tree()
    jp = jck.save_checkpoint(tmp_path / "jax", 11, tree, {"run": "x"})
    tp = save_checkpoint(tmp_path / "torch", 11, tree, {"run": "x"})
    jm = json.loads((jp / "manifest.json").read_text())
    tm = json.loads((tp / "manifest.json").read_text())
    jm.pop("time"), tm.pop("time")
    assert tm == jm
    assert tm["paths"][0] == "['opt'].step"
    assert sorted(p.name for p in tp.iterdir()) == \
        sorted(p.name for p in jp.iterdir())
    for i in range(len(jm["paths"])):
        assert (tp / f"{i:04d}.npy").read_bytes() == \
            (jp / f"{i:04d}.npy").read_bytes()
    # and each package restores the other's
    like = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)
    back, step = jck.restore_checkpoint(tp, like)
    assert step == 11
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    t_like = {"params": {"emb": torch.empty((6, 4)),
                         "blocks": [{"w": torch.empty((4, 4))},
                                    {"w": torch.empty((4, 4))}]},
              "opt": _Moments(torch.empty((), dtype=torch.int32),
                              [torch.empty((3,), dtype=torch.int64),
                               torch.empty((4,), dtype=torch.uint8)],
                              {"z": torch.empty((2, 3), dtype=torch.float16),
                               "a": torch.empty((2,), dtype=torch.bool)}),
              "step": torch.empty((), dtype=torch.int32)}
    got, _ = restore_checkpoint(jp, t_like)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_bf16_leaf_round_trips(tmp_path):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((5, 7), generator=gen).to(torch.bfloat16)
    tree = {"w": w, "s": torch.zeros((), dtype=torch.int32)}
    path = save_checkpoint(tmp_path, 1, tree)
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["dtypes"] == ["int32", "bfloat16"]
    raw = np.load(path / "0001.npy")
    assert raw.dtype == np.uint16
    assert manifest["crc32"][1] == \
        zlib.crc32(w.view(torch.int16).numpy().tobytes()) & 0xFFFFFFFF
    like = {"w": torch.empty((5, 7), dtype=torch.bfloat16, device="meta"),
            "s": torch.empty((), dtype=torch.int32, device="meta")}
    got, _ = restore_checkpoint(path, like, "cpu")
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)
    np.save(path / "0001.npy", raw ^ np.uint16(1))
    with pytest.raises(CheckpointCorrupt, match="CRC32"):
        restore_checkpoint(path, like, "cpu")
