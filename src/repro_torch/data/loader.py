"""Host-sharded batch loading (twin of ``repro.data.loader``): a numpy
batch -> this rank's rows of it on this rank's device.

Every rank draws the same global batch, ``make_np_batch(step,
global_batch, shard, n_shards)``, and keeps the rows its place on the
mesh's data-parallel axes owns: rank r of W keeps rows r B / W ... (r + 1)
B / W, as the reference's ``device_put`` onto a batch-sharded
``NamedSharding`` gives device r. So a change of world size leaves the
global batch as it was, and a resumed run replays the same data. The
shard-index plumbing is what the elastic runtime rewires on a failure.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..models.sharding import dp_axes
from ..tree import tree_map


def local_rows(x: Any, mesh) -> Any:
    """This rank's rows of ``x`` (numpy or a tensor): the leading
    dimension split over the mesh's data-parallel axes in equal blocks; a
    0-d leaf whole."""
    if not len(x.shape):
        return x
    place, count = mesh.axis_index(dp_axes(mesh))
    rows = x.shape[0]
    if rows % count:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{count} data-parallel ranks")
    per = rows // count
    return x[place * per:(place + 1) * per]


def shard_batch(batch: Any, mesh) -> Any:
    """numpy tree -> this rank's rows of each leaf, a tensor on the mesh's
    device (the numpy dtype kept)."""

    def put(x):
        x = np.array(local_rows(np.asarray(x), mesh))
        return torch.from_numpy(x).to(mesh.device)

    return tree_map(put, batch)


@dataclasses.dataclass
class ShardedLoader:
    """Deterministic per-step loader with elastic shard re-assignment.

    ``shard`` / ``n_shards`` name the data shard drawn; after a failure
    the elastic runtime calls ``reassign`` with the survivors' layout and
    sets ``mesh`` to the new mesh, and every batch from then on is drawn
    from the remapped shard: the same (step, shard) pairs always give the
    same data (replay-safe)."""
    make_np_batch: Callable[[int, int, int, int], Any]  # (step, bs, shard, n)
    global_batch: int
    mesh: Any
    n_shards: int = 1
    shard: int = 0

    def reassign(self, shard: int, n_shards: int) -> None:
        self.shard = shard
        self.n_shards = n_shards

    def __call__(self, step: int) -> Any:
        np_batch = self.make_np_batch(step, self.global_batch, self.shard,
                                      self.n_shards)
        return shard_batch(np_batch, self.mesh)
