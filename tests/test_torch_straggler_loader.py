"""The port's straggler monitor and sharded loader: the cases of
``tests/test_straggler_loader.py``; both packages' monitors give equal
EWMAs, flags and shard assignments on seeded step-time sequences; the
loader gives each rank of a data-parallel mesh its rows of the global
batch (ranks faked through ``launch.mesh``'s rank and world size), and the
reference's loader on a one-device mesh the same tokens as the port's.
"""
import numpy as np
import pytest
import torch

from repro.data import ShardedLoader as JShardedLoader
from repro.data import SyntheticTokenDataset as JTokens
from repro.launch.mesh import make_test_mesh as j_make_test_mesh
from repro.train.straggler import StragglerMonitor as JMonitor
from repro_torch.data import ShardedLoader, SyntheticTokenDataset
from repro_torch.data.loader import local_rows
from repro_torch.launch import mesh as tmesh
from repro_torch.train import StragglerMonitor


def _feed(mon, times_by_worker, steps=10):
    for s in range(steps):
        for w, t in enumerate(times_by_worker):
            mon.record(w, t * (1.0 + 0.01 * (s % 3)))


def test_no_stragglers_on_uniform_fleet():
    mon = StragglerMonitor(n_workers=8)
    _feed(mon, [1.0] * 8)
    assert mon.stragglers() == []
    assert mon.shard_assignment() == list(range(8))


def test_straggler_detected_and_shard_swapped():
    mon = StragglerMonitor(n_workers=8, threshold=1.5)
    times = [1.0] * 8
    times[3] = 2.5
    _feed(mon, times)
    assert mon.stragglers() == [3]
    assignment = mon.shard_assignment()
    assert assignment[3] != 3
    assert sorted(assignment) == list(range(8))


def test_assignment_deterministic():
    def build():
        m = StragglerMonitor(n_workers=6, threshold=1.4)
        _feed(m, [1.0, 1.0, 3.0, 1.0, 1.1, 0.9])
        return m.shard_assignment()
    assert build() == build()


def test_warmup_suppresses_flags():
    mon = StragglerMonitor(n_workers=4, warmup_steps=5)
    for w in range(4):
        mon.record(w, 10.0 if w == 0 else 1.0)
    assert mon.stragglers() == []


def test_summary_shape():
    mon = StragglerMonitor(n_workers=3)
    _feed(mon, [1.0, 1.0, 5.0])
    s = mon.summary()
    assert len(s["ewma"]) == 3 and s["stragglers"] == [2]


@pytest.mark.parametrize("seed,n_workers,threshold,slow", [
    (0, 8, 1.5, (3,)), (1, 6, 1.4, (0, 5)), (2, 5, 1.2, ()),
    (3, 16, 1.3, (2, 7, 11))])
def test_monitors_agree_with_the_reference(seed, n_workers, threshold,
                                           slow):
    rng = np.random.default_rng(seed)
    times = rng.uniform(0.8, 1.2, (12, n_workers))
    times[:, list(slow)] *= 2.0
    ours = StragglerMonitor(n_workers=n_workers, threshold=threshold)
    ref = JMonitor(n_workers=n_workers, threshold=threshold)
    for s, row in enumerate(times):
        for w, t in enumerate(row):
            ours.record(w, float(t))
            ref.record(w, float(t))
        assert ours.stragglers() == ref.stragglers(), s
        assert ours.shard_assignment() == ref.shard_assignment(), s
    np.testing.assert_array_equal(np.asarray(ours.summary()["ewma"]),
                                  np.asarray(ref.summary()["ewma"]))
    assert ours.summary() == ref.summary()
    assert sorted(ours.stragglers()) == sorted(slow)


def _as_rank(monkeypatch, rank, world):
    monkeypatch.setattr(tmesh, "this_rank", lambda: rank)
    monkeypatch.setattr(tmesh, "world_size", lambda: world)


def test_loader_reassign():
    ds = SyntheticTokenDataset(64, 8, seed=1)
    mesh = tmesh.Mesh((1,), ("data",), device="cpu")
    loader = ShardedLoader(
        lambda step, bs, shard, n: {"tokens": ds.batch(step, bs, shard, n)},
        global_batch=4, mesh=mesh, n_shards=4, shard=0)
    a = loader(3)["tokens"]
    loader.reassign(shard=2, n_shards=4)
    b = loader(3)["tokens"]
    assert not torch.equal(a, b)
    loader.reassign(shard=0, n_shards=4)
    assert torch.equal(a, loader(3)["tokens"])


def test_one_device_loader_matches_the_reference():
    jds, tds = JTokens(64, 9, seed=2), SyntheticTokenDataset(64, 9, seed=2)
    jl = JShardedLoader(
        lambda step, bs, shard, n: {"tokens": jds.batch(step, bs, shard, n)},
        global_batch=6, mesh=j_make_test_mesh((1,), ("data",)))
    tl = ShardedLoader(
        lambda step, bs, shard, n: {"tokens": tds.batch(step, bs, shard, n)},
        global_batch=6, mesh=tmesh.Mesh((1,), ("data",), device="cpu"))
    for step in (0, 5):
        got = tl(step)["tokens"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jl(step)["tokens"]))


@pytest.mark.parametrize("world,shape,axes", [
    (2, (2,), ("data",)), (4, (4,), ("data",)),
    (4, (2, 2, 1), ("pod", "data", "model"))])
def test_each_rank_gets_its_rows(monkeypatch, world, shape, axes):
    ds = SyntheticTokenDataset(64, 5, seed=0)
    whole = ds.batch(7, 8)
    got = []
    for rank in range(world):
        _as_rank(monkeypatch, rank, world)
        mesh = tmesh.make_test_mesh(shape, axes, device="cpu")
        loader = ShardedLoader(
            lambda step, bs, shard, n: {"tokens": ds.batch(step, bs, shard,
                                                           n)},
            global_batch=8, mesh=mesh)
        rows = loader(7)["tokens"].numpy()
        per = 8 // world
        np.testing.assert_array_equal(rows, whole[rank * per:
                                                  (rank + 1) * per])
        got.append(rows)
    np.testing.assert_array_equal(np.concatenate(got), whole)


def test_rows_must_split_evenly(monkeypatch):
    _as_rank(monkeypatch, 0, 3)
    mesh = tmesh.make_test_mesh((3,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        local_rows(np.zeros((8, 2)), mesh)


def test_meshes_need_enough_ranks(monkeypatch):
    _as_rank(monkeypatch, 0, 2)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        tmesh.make_test_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="elastic mesh"):
        tmesh.make_elastic_mesh(1, pod_shape=(2, 2), device="cpu")
    mesh = tmesh.make_elastic_mesh(1, pod_shape=(2, 1), device="cpu")
    assert mesh.shape == {"pod": 1, "data": 2, "model": 1}
    _as_rank(monkeypatch, 1, 2)
    half = tmesh.make_test_mesh((1,), ("data",), device="cpu")
    assert not half.is_member() and half.coordinate() is None
    assert half.get_group() is None
