"""Meshes of ranks over ``torch.distributed`` (twin of
``repro.launch.mesh``), and the process group they live in.

A mesh names a grid of ranks, one process a device: ``make_production_mesh``
(``data`` x ``model``, a ``pod`` axis in front on two pods),
``make_test_mesh`` over the first ranks of the world, and
``make_elastic_mesh`` after pods are lost. Each raises ``RuntimeError``
when the world has fewer ranks than its shape needs.

``Mesh`` is the port's own thin class, not ``torch.distributed``'s
``DeviceMesh``: a ``DeviceMesh`` smaller than the world makes its process
group with a ``new_group`` that every rank of the world must join, and a
rank that left the run after an elastic downgrade can join nothing. Here a
rank makes a group only when a collective first needs it, and only the
group's own ranks take part (``use_local_synchronization``). A mesh takes
the first ranks of the world, so rank 0 is in every mesh.

``init_distributed`` starts the process group: from torchrun's ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` where
they are set, else a group of one on an in-process ``HashStore`` (no
network): ``nccl`` on a CUDA device, ``gloo`` on the CPU.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device


def init_distributed(device: DeviceLike = None) -> bool:
    """Start this process's group on ``device`` (the card unless told
    otherwise; under torchrun the card of ``LOCAL_RANK``, made current)
    unless one is running. Returns True when it made the group, so that
    the caller destroys only a group it made itself
    (``shutdown_distributed``)."""
    dev = resolve_device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                          if launched else torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    bound = {"device_id": dev} if dev.type == "cuda" else {}
    if launched:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                **bound)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **bound)
    return True


def shutdown_distributed() -> None:
    """Destroy the process group and every group made in it."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def this_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device() -> torch.device:
    """The device this process runs on: under nccl the current card (the
    one ``init_distributed`` bound), under gloo the CPU, and without a
    group the card (``resolve_device``)."""
    if not dist.is_initialized():
        return resolve_device()
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """A named grid of the world's first ranks: ``axis_names``, ``shape``
    (axis name -> size, as a JAX mesh's), ``devices`` (the ranks as a numpy
    array of that shape) and ``device``, the torch device of this process.
    Made by any rank without a collective; ``get_group`` makes a process
    group when asked."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device: DeviceLike = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.device = (torch.device(device) if device is not None
                       else local_device())
        self._groups: dict = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def is_member(self) -> bool:
        """Whether this process's rank is in the mesh."""
        return this_rank() < self.size

    def coordinate(self) -> Optional[tuple]:
        """This rank's index on each axis; None outside the mesh."""
        if not self.is_member():
            return None
        return tuple(int(i) for i in
                     np.unravel_index(this_rank(), self.devices.shape))

    def axis_index(self, axes) -> tuple[int, int]:
        """(this rank's place, the count) along ``axes`` (a name or a
        tuple of names, the first the slowest), as ``shard_map`` numbers
        the shards of a dimension split over them."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        coord = self.coordinate()
        if coord is None:
            raise RuntimeError(f"rank {this_rank()} is outside the mesh "
                               f"{self.shape}")
        place, count = 0, 1
        for a in axes:
            i = self.axis_names.index(a)
            place = place * self.devices.shape[i] + coord[i]
            count *= self.devices.shape[i]
        return place, count

    def get_group(self, axes=None):
        """The process group of the ranks that share this rank's place on
        every axis but ``axes`` (None: all of them, the whole mesh); None
        outside the mesh. The world's own group where it is the world."""
        if not self.is_member():
            return None
        axes = (self.axis_names if axes is None else
                (axes,) if isinstance(axes, str) else tuple(axes))
        coord = self.coordinate()
        sel = tuple(slice(None) if a in axes else coord[i]
                    for i, a in enumerate(self.axis_names))
        ranks = sorted(int(r) for r in np.ravel(self.devices[sel]))
        if ranks == list(range(world_size())):
            return dist.group.WORLD
        key = tuple(ranks)
        if key not in self._groups:
            self._groups[key] = dist.new_group(
                ranks, use_local_synchronization=True)
        return self._groups[key]


def _make_mesh(shape, axes, device: DeviceLike = None) -> Mesh:
    need = math.prod(shape)
    have = world_size()
    if have < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} ranks, found {have} — "
            "launch one process a device (torchrun --nproc-per-node)")
    return Mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) on two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device: DeviceLike = None) -> Mesh:
    """A small mesh over the world's first ranks."""
    return _make_mesh(tuple(shape), tuple(axes), device)


def make_elastic_mesh(n_pods_alive: int, *, pod_shape=(16, 16),
                      device: DeviceLike = None) -> Mesh:
    """The degraded multi-pod mesh after pod failures: the same (data,
    model) inner shape, the pod axis shrunk to the surviving pods."""
    shape = (n_pods_alive, *pod_shape)
    need = math.prod(shape)
    if world_size() < need:
        raise RuntimeError(f"need {need} ranks for elastic mesh {shape}")
    return Mesh(shape, ("pod", "data", "model"), device)
