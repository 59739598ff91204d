"""Straggler detection and deterministic work re-assignment (twin of
``repro.train.straggler``; numpy only).

One slow host throttles every synchronous step. The monitor keeps an EWMA
of step times per worker; a worker whose EWMA exceeds ``threshold`` x the
fleet median is flagged, and the data-shard permutation is rotated so that
its shard moves to a healthy host: deterministically, every host computes
the same permutation from the same flags, with no coordinator.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    n_workers: int
    ewma_alpha: float = 0.3
    threshold: float = 1.5          # x median EWMA
    warmup_steps: int = 5

    def __post_init__(self):
        self._ewma = np.zeros(self.n_workers)
        self._count = np.zeros(self.n_workers, np.int64)

    def record(self, worker: int, step_time_s: float) -> None:
        if self._count[worker] == 0:
            self._ewma[worker] = step_time_s
        else:
            a = self.ewma_alpha
            self._ewma[worker] = a * step_time_s + (1 - a) * self._ewma[worker]
        self._count[worker] += 1

    def stragglers(self) -> list[int]:
        if (self._count < self.warmup_steps).any():
            return []
        med = float(np.median(self._ewma))
        if med <= 0:
            return []
        return [int(i) for i in range(self.n_workers)
                if self._ewma[i] > self.threshold * med]

    def shard_assignment(self) -> list[int]:
        """worker -> shard permutation that parks the flagged workers'
        shards on the fastest workers: each straggler's shard swapped with
        that of the fastest healthy worker not yet used. Deterministic
        given the flags and the EWMAs."""
        order = np.argsort(self._ewma)          # fastest first
        bad = set(self.stragglers())
        shards = list(range(self.n_workers))
        if not bad:
            return shards
        healthy = [int(w) for w in order if int(w) not in bad]
        for s, h in zip(sorted(bad), healthy):
            shards[s], shards[h] = shards[h], shards[s]
        return shards

    def summary(self) -> dict:
        return {"ewma": self._ewma.tolist(),
                "stragglers": self.stragglers()}
