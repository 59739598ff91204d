"""Data-parallel multi-replica serving: a least-loaded router over N engine
replicas (twin of ``repro.serve.router``).

Each replica is a full ``Engine`` (its own slot pool and FIFOs) on one
device: the visible cards (or, for parameters on the CPU, their device)
are dealt round-robin over the replicas, so on one card every replica
shares it, and each replica reads the parameters moved to its device
(``.to`` makes no copy on the device they already hold).
Dispatch is least-loaded (queued + prefilling + active), lowest replica
index on ties, so an arrival trace routes deterministically and greedy
outputs equal a single engine's (a slot's rows are independent of the
others).

Failover: a replica whose ``step()`` raises (an injected
``ReplicaFailure``, or a crash of its step, such as a CUDA fault that a
kernel reported after its launch returned) is marked dead: ``submit`` stops routing to it, and
each of its unfinished requests (queued, prefilling or decoding) is
submitted again to the live replicas from its prompt. Greedy decoding
makes the replay the same stream, and the per-uid ledger of delivered
tokens drops the prefix the consumer already read: at-most-once delivery
end to end (tokens left undelivered in the dead replica's FIFOs are
discarded and made again). Requests that finished on a dead replica stay
readable. Only when the last replica dies does the failure reach the
caller.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..models.lm import param_device
from ..tree import tree_map
from .engine import (Engine, EngineConfig, QueueFull, Request, StalledEngine,
                     TERMINAL)
from .faults import FaultPlan, ReplicaFailure


class AllReplicasDead(RuntimeError):
    """Every replica has failed: nothing can serve the pending work."""


def _replica_devices(n: int, home: torch.device) -> list[torch.device]:
    """One device per replica, dealt round-robin from every visible card
    when the parameters are on one, else from their device."""
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if home.type == "cuda" else [home])
    return [devices[i % len(devices)] for i in range(n)]


class ReplicaRouter:
    def __init__(self, model, params: dict, cfg: EngineConfig,
                 n_replicas: int = 2, rng_seed: int = 0,
                 faults: Optional[FaultPlan] = None):
        assert n_replicas >= 1
        home = param_device(params)
        self.devices = _replica_devices(n_replicas, home)
        if faults is not None:
            faults.arm_kernel_faults()
        placed = {dev: params if dev == home else tree_map(
            lambda a, dev=dev: a.to(dev) if isinstance(a, torch.Tensor)
            else a, params) for dev in set(self.devices)}
        # per-replica seed offset: temperature sampling must not replay one
        # stream on every replica (greedy decoding ignores the seed)
        self.engines = [
            Engine(model, placed[dev], cfg, rng_seed=rng_seed + i,
                   faults=faults.view(i) if faults is not None else None)
            for i, dev in enumerate(self.devices)]
        self.faults = faults
        self.alive = [True] * n_replicas
        self._dispatch = np.zeros(n_replicas, np.int64)
        self._by_uid: dict[int, tuple[int, int]] = {}   # uid -> (replica, local)
        self._uid = 0
        self._meta: dict[int, dict] = {}       # uid -> the submit's arguments
        self._delivered: dict[int, int] = {}   # uid -> tokens the caller popped
        self._skip: dict[int, int] = {}        # uid -> replayed prefix to drop
        self._orphans: list[int] = []          # uids awaiting re-dispatch
        self._failures: list[dict] = []
        self._requeued = 0

    # ------------------------------------------------------------- dispatch
    def _order(self) -> list[int]:
        """Live replicas, least-loaded first (stable on ties)."""
        alive = [r for r in range(len(self.engines)) if self.alive[r]]
        return sorted(alive, key=lambda r: (self.engines[r].load(), r))

    def submit(self, prompt, max_new: int = 32, temperature: float = 0.0,
               eos_id=None, block: bool = True,
               deadline_ticks: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Least-loaded dispatch over the live replicas: where the chosen
        replica's admission FIFO is full, try the others before a blocking
        submit on the least-loaded one."""
        meta = dict(max_new=max_new, temperature=temperature, eos_id=eos_id,
                    deadline_ticks=deadline_ticks, deadline_s=deadline_s)
        order = self._order()
        if not order:
            raise AllReplicasDead("submit with no healthy replica")
        attempts = [(r, False) for r in order]
        if block:
            # every FIFO full: block on the least-loaded replica, whose
            # backpressure ticks free a place soonest
            attempts.append((order[0], True))
        for r, blocking in attempts:
            if not self.alive[r]:       # may have died mid-attempt list
                continue
            try:
                local = self.engines[r].submit(prompt, block=blocking,
                                               **meta)
            except QueueFull:
                continue
            except ReplicaFailure as exc:
                # a blocking submit donates engine ticks, which can reach
                # an injected death: fail over and keep trying
                self._fail_replica(r, f"submit backpressure: {exc}")
                continue
            uid = self._uid
            self._uid += 1
            self._by_uid[uid] = (r, local)
            self._meta[uid] = dict(meta, prompt=np.asarray(prompt, np.int32))
            self._dispatch[r] += 1
            return uid
        raise QueueFull("every replica's admission FIFO is full")

    # ------------------------------------------------------------- failover
    def _fail_replica(self, r: int, reason: str) -> None:
        """Mark replica ``r`` dead and orphan its unfinished requests for
        re-dispatch. The dead engine is never stepped again, so requests
        that finished there stay readable from its request map."""
        self.alive[r] = False
        dead = self.engines[r]
        self._failures.append({"replica": r, "tick": dead._tick,
                               "reason": reason, "t": time.time()})
        for uid, (rr, local) in sorted(self._by_uid.items()):
            if rr != r:
                continue
            req = dead.requests.get(local)
            if req is None or req.status in TERMINAL:
                continue                # served (or retired): keep
            # undelivered tokens in the dead FIFO are discarded and made
            # again by the replay; the skip ledger drops only what the
            # consumer read
            req.fifo.clear()
            self._skip[uid] = self._delivered.get(uid, 0)
            self._orphans.append(uid)
        self._dispatch_orphans()

    def _dispatch_orphans(self) -> None:
        """Submit orphaned requests again (from their original prompt) on
        the live replicas, without blocking: what does not fit now is
        tried again at the next ``step``."""
        still: list[int] = []
        for uid in self._orphans:
            placed = False
            for r in self._order():
                try:
                    local = self.engines[r].submit(block=False,
                                                   **self._meta[uid])
                except QueueFull:
                    continue
                self._by_uid[uid] = (r, local)
                self._dispatch[r] += 1
                self._requeued += 1
                placed = True
                break
            if not placed:
                still.append(uid)
        self._orphans = still

    # ------------------------------------------------------------ lifecycle
    def step(self) -> int:
        if self._orphans:
            self._dispatch_orphans()
        total = 0
        for r, e in enumerate(self.engines):
            if not self.alive[r]:
                continue
            others_alive = any(self.alive[i] for i in range(len(self.engines))
                               if i != r)
            try:
                total += e.step()
            except ReplicaFailure as exc:
                self._fail_replica(r, f"step raised: {exc}")
                continue
            except Exception as exc:
                if not others_alive:
                    raise       # nowhere to fail over to: surface the bug
                self._fail_replica(
                    r, f"step raised: {type(exc).__name__}: {exc}")
                continue
        return total

    def pending(self) -> bool:
        return bool(self._orphans) or any(
            e.pending() for r, e in enumerate(self.engines) if self.alive[r])

    def run_until_drained(self, max_ticks: int = 10_000,
                          stall_grace: int = 200) -> list[Request]:
        """Tick until drained. Raises ``StalledEngine`` when no replica
        progressed for ``stall_grace`` ticks with work pending, or the
        tick budget ran out, and ``AllReplicasDead`` when a failover
        leaves orphans and no live replica to take them."""
        last, idle = None, 0
        for _ in range(max_ticks):
            self.step()
            if not self.pending():
                return self.finished
            if self._orphans and not any(self.alive):
                raise AllReplicasDead(
                    f"{len(self._orphans)} requests orphaned and no "
                    f"healthy replica remains")
            sig = tuple(e._progress_signature() for e in self.engines) \
                + (len(self._orphans),)
            if sig == last:
                idle += 1
                if idle >= stall_grace:
                    reps = {r: e._stall_report()
                            for r, e in enumerate(self.engines)
                            if self.alive[r]}
                    raise StalledEngine(
                        f"router made no progress for {idle} ticks with "
                        f"work pending (alive={self.alive}, "
                        f"orphans={len(self._orphans)})",
                        {"replicas": reps, "orphans": list(self._orphans)})
            else:
                last, idle = sig, 0
        raise StalledEngine(
            f"max_ticks={max_ticks} exhausted with work still pending "
            f"(alive={self.alive})",
            {"replicas": {r: e._stall_report()
                          for r, e in enumerate(self.engines)},
             "orphans": list(self._orphans)})

    @property
    def finished(self) -> list[Request]:
        """Finished requests under their router uids (each engine numbers
        its own requests from 0, so a replica's uids collide with the
        others'), those that finished on a dead replica included; each uid
        appears once."""
        by_local = [{req.uid: req for req in e.finished}
                    for e in self.engines]
        out = []
        for uid, (r, local) in sorted(self._by_uid.items()):
            req = by_local[r].get(local)
            if req is not None:
                out.append(dataclasses.replace(req, uid=uid))
        return out

    def result(self, uid: int) -> Optional[Request]:
        entry = self._by_uid.get(uid)
        if entry is None:
            return None
        r, local = entry
        return self.engines[r].requests.get(local)

    def pop_output(self, uid: int) -> list[int]:
        r, local = self._by_uid[uid]
        toks = self.engines[r].pop_output(local)
        skip = self._skip.get(uid, 0)
        if skip:
            # failover replay: drop the regenerated prefix the consumer
            # already read from the dead replica
            drop = min(skip, len(toks))
            toks = toks[drop:]
            self._skip[uid] = skip - drop
        if toks:
            self._delivered[uid] = self._delivered.get(uid, 0) + len(toks)
        return toks

    def cancel(self, uid: int) -> bool:
        entry = self._by_uid.get(uid)
        if entry is None:
            return False
        if uid in self._orphans:
            self._orphans.remove(uid)
            return True
        r, local = entry
        return self.engines[r].cancel(local)

    def stats(self) -> dict:
        per = [e.stats() for e in self.engines]
        toks = sum(p.get("tokens", 0) for p in per)
        return {
            "replicas": len(self.engines),
            "alive": list(self.alive),
            "failovers": len(self._failures),
            "failures": [dict(f) for f in self._failures],
            "requeued": self._requeued,
            "orphans": len(self._orphans),
            "dispatch": self._dispatch.tolist(),
            "devices": [str(d) for d in self.devices],
            "tokens": toks,
            "n": sum(p.get("n", 0) for p in per),
            "queue_hwm": max((p.get("queue_hwm", 0) for p in per), default=0),
            "prefill_fifo_hwm": max((p.get("prefill_fifo_hwm", 0)
                                     for p in per), default=0),
            "per_replica": per,
        }
