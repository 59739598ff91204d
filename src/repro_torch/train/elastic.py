"""Elastic training runtime (twin of ``repro.train.elastic``):
checkpoint/restart and re-meshing after a lost device.

When a pod or host drops, the job must (1) notice, (2) build a smaller mesh
from the surviving ranks, (3) restore the parameters and optimizer state
from the last checkpoint onto it, (4) re-assign the data shards, and (5)
continue, with no human in the loop. ``ElasticRunner`` is that loop, with
the reference's control flow and events. Failures are injected
(``inject_failure``); everything after the detection is the real
mechanism, on however many ranks exist.

It takes candidate mesh builders, largest first, and falls back down the
list as the rank set shrinks (``restore_capacity`` climbs back). Under
``torch.distributed`` every rank runs the loop: rank 0 writes the
checkpoints (each rank holds the whole state), the ranks of a dying mesh
meet at a barrier before anyone restores, and a rank outside the smaller
mesh leaves the run there: ``run`` returns its last state, its events
ending at the failure.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..models import sharding as shd
from ..tree import tree_map
from .checkpoint import (AsyncCheckpointer, latest_checkpoint,
                         restore_checkpoint)
from .straggler import StragglerMonitor
from .trainer import TrainState


@dataclasses.dataclass
class ElasticConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_threshold: float = 1.5


class ElasticRunner:
    """Drives (step_fn, state, loader) through failures.

    Parameters
    ----------
    mesh_builders : list of () -> Mesh (``launch.mesh``), largest first. On
        a failure the runner drops to the next buildable mesh.
    make_step : (mesh) -> step(state, batch) -> (state, metrics); rebuilt
        per mesh, because its process group differs.
    make_state : (mesh) -> a fresh TrainState on the mesh's device (used
        whole only when no checkpoint exists; else its shapes and dtypes
        are the restore's template).
    state_devices : (state template, mesh) -> the device of each leaf (a
        tree like the template, or one device) for the restore.
    """

    def __init__(self, mesh_builders: list, make_step, make_state,
                 state_devices, loader, cfg: ElasticConfig):
        self.mesh_builders = mesh_builders
        self.make_step = make_step
        self.make_state = make_state
        self.state_devices = state_devices
        self.loader = loader
        self.cfg = cfg
        self.level = 0                       # index into mesh_builders
        self._failed_at: Optional[int] = None
        self.events: list[dict] = []
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, cfg.keep)
        self._build()

    # ------------------------------------------------------------- plumbing
    def _build(self) -> None:
        while True:
            try:
                self.mesh = self.mesh_builders[self.level]()
                break
            except Exception as e:          # not enough ranks -> degrade
                self.events.append({"kind": "mesh_unavailable",
                                    "level": self.level, "err": str(e)})
                self.level += 1
                if self.level >= len(self.mesh_builders):
                    raise RuntimeError("no buildable mesh left") from e
        shd.set_global_mesh(self.mesh)
        self.step_fn = self.make_step(self.mesh)
        self.monitor = StragglerMonitor(
            n_workers=max(1, self.mesh.devices.size // 16),
            threshold=self.cfg.straggler_threshold)

    def _settle(self) -> None:
        """The pending save written, then every rank of the current mesh
        at a barrier, so that any of them may read the checkpoint."""
        self.ckpt.wait()
        if dist.is_initialized():
            dist.barrier(group=self.mesh.get_group())

    def _restore_or_init(self) -> TrainState:
        path = latest_checkpoint(self.cfg.ckpt_dir)
        if path is None:
            return self.make_state(self.mesh)
        fresh = self.make_state(self.mesh)   # the structure and dtypes
        shape = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                               device="meta"), fresh)
        del fresh
        devices = self.state_devices(shape, self.mesh)
        state, step = restore_checkpoint(path, shape, devices)
        self.events.append({"kind": "restore", "step": step,
                            "path": str(path)})
        return state

    # ------------------------------------------------------------- failures
    def inject_failure(self, at_step: int) -> None:
        """Simulate losing enough ranks that the current mesh dies."""
        self._failed_at = at_step

    def restore_capacity(self) -> None:
        """Ranks came back: climb to the largest buildable mesh."""
        if self.level > 0:
            self.level = 0
            self.events.append({"kind": "capacity_restored"})

    # ------------------------------------------------------------------ run
    def run(self, n_steps: int) -> tuple[TrainState, list[dict]]:
        state = self._restore_or_init()
        metrics = None
        while int(state.step) < n_steps:
            step = int(state.step)
            if self._failed_at is not None and step >= self._failed_at:
                # ---- failure path: degrade the mesh, restore from the
                # checkpoint
                self._settle()
                self.events.append({"kind": "failure", "step": step})
                self._failed_at = None
                self.level = min(self.level + 1, len(self.mesh_builders) - 1)
                self._build()
                if hasattr(self.loader, "reassign"):
                    self.loader.reassign(0, max(1, self.mesh.devices.size // 16))
                if hasattr(self.loader, "mesh"):
                    self.loader.mesh = self.mesh
                if not self.mesh.is_member():
                    return state, self.events   # this rank leaves the run
                state = None                    # free it before the restore
                state = self._restore_or_init()
                self.events.append({"kind": "remesh",
                                    "mesh": dict(zip(self.mesh.axis_names,
                                                     self.mesh.devices.shape)),
                                    "resume_step": int(state.step)})
                continue
            t0 = time.time()
            batch = self.loader(step)
            state, metrics = self.step_fn(state, batch)
            metrics["loss"].item()              # wait for the step
            self.monitor.record(0, time.time() - t0)
            if step > 0 and step % self.cfg.ckpt_every == 0:
                if not dist.is_initialized() or dist.get_rank() == 0:
                    self.ckpt.save(step, state)
                self.events.append({"kind": "checkpoint", "step": step})
        self._settle()
        return state, self.events
