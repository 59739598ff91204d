"""Deterministic fault injection for the serving stack (twin of
``repro.serve.faults``).

A ``FaultPlan`` is a seeded, replayable script of failures the engine and
the router must survive, wired into the engine's tick loop, so every run of
one plan against one trace takes the same failures and the same recovery:

  * ``nan_state(tick, slot)``   — NaN into a live slot's float state row
    (KV, ssm, conv); where a family keeps no float per-slot state (a
    spiking ``qk_spiking`` model) the slot's decode logits instead;
  * ``nan_logits(tick, slot)``  — poison one slot's decode logits;
  * ``corrupt_word(tick, slot)``— set one packed spike-state word to all
    ones, breaking the pad-lane invariant the integrity guard checks;
  * ``kill_replica(tick)``      — the engine raises ``ReplicaFailure`` at
    the top of tick N (the router fails over);
  * ``stall_consumer(tick, slot, ticks)`` — freeze one slot's output
    consumer for a window (the per-slot FIFO stall path);
  * ``fail_kernel(op, at_call)``— arm ``repro_torch.ops.fallback`` so one
    guarded fused call raises (the fused -> reference demotion).

Builders chain. Tick events fire at the first engine tick >= their tick;
slot ``-1`` resolves to the lowest live slot when the event fires (an
event waits for a live slot). ``plan.view(r)`` is replica ``r``'s slice;
kernel faults are process-global, as the ops registry is, and are armed
once by the plan's owner (the engine or the router).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class ReplicaFailure(RuntimeError):
    """A replica died mid-tick (injected, or a crash of its step). The
    ``ReplicaRouter`` catches it, marks the replica dead and requeues its
    unfinished work."""


KINDS = ("nan_state", "nan_logits", "corrupt_word", "die",
         "stall_consumer", "kernel_fault")


@dataclasses.dataclass
class FaultEvent:
    kind: str
    tick: int = 0
    slot: int = -1          # -1 = lowest live slot when the event fires
    replica: int = 0
    value: float = float("nan")
    op: str = "*"           # kernel_fault: target op ("*" = any fused op)
    at_call: int = 0        # kernel_fault: which guarded call raises
    ticks: int = 1          # stall_consumer: stall window length
    fired: bool = False

    def describe(self) -> dict:
        d = {"kind": self.kind, "tick": self.tick, "replica": self.replica,
             "fired": self.fired}
        if self.kind in ("nan_state", "nan_logits", "corrupt_word",
                         "stall_consumer"):
            d["slot"] = self.slot
        if self.kind == "stall_consumer":
            d["ticks"] = self.ticks
        if self.kind == "kernel_fault":
            d.update(op=self.op, at_call=self.at_call)
        return d


class FaultPlan:
    """A seeded, ordered script of ``FaultEvent``s. The seed is kept for
    provenance (and for a random plan generator); the built-in events are
    fully deterministic."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.events: list[FaultEvent] = []
        self.rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------- builders
    def nan_state(self, tick: int, slot: int = -1, replica: int = 0,
                  value: float = float("nan")) -> "FaultPlan":
        self.events.append(FaultEvent("nan_state", tick=tick, slot=slot,
                                      replica=replica, value=value))
        return self

    def nan_logits(self, tick: int, slot: int = -1, replica: int = 0,
                   value: float = float("nan")) -> "FaultPlan":
        self.events.append(FaultEvent("nan_logits", tick=tick, slot=slot,
                                      replica=replica, value=value))
        return self

    def corrupt_word(self, tick: int, slot: int = -1,
                     replica: int = 0) -> "FaultPlan":
        self.events.append(FaultEvent("corrupt_word", tick=tick, slot=slot,
                                      replica=replica))
        return self

    def kill_replica(self, tick: int, replica: int = 0) -> "FaultPlan":
        self.events.append(FaultEvent("die", tick=tick, replica=replica))
        return self

    def stall_consumer(self, tick: int, slot: int = -1, ticks: int = 4,
                       replica: int = 0) -> "FaultPlan":
        self.events.append(FaultEvent("stall_consumer", tick=tick,
                                      slot=slot, ticks=ticks,
                                      replica=replica))
        return self

    def fail_kernel(self, op: str = "*", at_call: int = 0) -> "FaultPlan":
        self.events.append(FaultEvent("kernel_fault", op=op,
                                      at_call=at_call))
        return self

    # ------------------------------------------------------------ consumers
    def view(self, replica: int) -> "FaultPlan":
        """Replica ``replica``'s slice. It shares the event objects (a
        fired flag shows in the whole plan) and leaves the kernel faults
        out: the plan's owner arms those."""
        sub = FaultPlan(self.seed)
        sub.events = [ev for ev in self.events
                      if ev.replica == replica and ev.kind != "kernel_fault"]
        return sub

    def due(self, kinds, tick: int) -> list[FaultEvent]:
        """Mark fired and return every unfired event of the given kind(s)
        whose tick has come. A consumer that cannot apply one yet (no live
        slot) hands it to ``defer`` to fire it next tick."""
        if isinstance(kinds, str):
            kinds = (kinds,)
        out = []
        for ev in self.events:
            if not ev.fired and ev.kind in kinds and ev.tick <= tick:
                ev.fired = True
                out.append(ev)
        return out

    @staticmethod
    def defer(ev: FaultEvent) -> None:
        ev.fired = False

    def die_due(self, tick: int) -> Optional[FaultEvent]:
        hits = self.due("die", tick)
        return hits[0] if hits else None

    def arm_kernel_faults(self) -> int:
        """Arm every kernel_fault event with ``repro_torch.ops.fallback``
        (each event arms once). Returns how many were armed."""
        from ..ops import fallback

        n = 0
        for ev in self.events:
            if ev.kind == "kernel_fault" and not ev.fired:
                ev.fired = True
                fallback.arm_kernel_fault(ev.op, ev.at_call)
                n += 1
        return n

    # ------------------------------------------------------------ reporting
    def summary(self) -> dict:
        return {
            "seed": self.seed,
            "events": [ev.describe() for ev in self.events],
            "fired": sum(ev.fired for ev in self.events),
            "pending": sum(not ev.fired for ev in self.events),
        }

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, events={len(self.events)}, "
                f"fired={sum(ev.fired for ev in self.events)})")


def demo_chaos_plan(seed: int = 0, *, n_replicas: int = 1,
                    kill_tick: int = 12, nan_ticks=(6, 9),
                    kernel_op: str = "dense_lif",
                    kernel_call: int = 0) -> FaultPlan:
    """The canned chaos scenario: kill the last replica mid-trace (with
    more than one), two NaN injections on replica 0, and one forced
    fused-kernel failure."""
    plan = FaultPlan(seed)
    for t in nan_ticks:
        plan.nan_state(t, replica=0)
    if n_replicas > 1:
        plan.kill_replica(kill_tick, replica=n_replicas - 1)
    plan.fail_kernel(kernel_op, at_call=kernel_call)
    return plan
