"""The continuous-batching serving engine, its fault plan and the
multi-replica router (twin of ``repro.serve``).

The reference also exports ``clear_jit_cache``, which drops its compiled
engine steps after a demotion is reset; the port runs eagerly and keeps
no compiled steps, so there is nothing to clear and no such function.
"""
from .engine import Engine, EngineConfig, QueueFull, Request, StalledEngine
from .faults import FaultPlan, ReplicaFailure, demo_chaos_plan
from .router import AllReplicasDead, ReplicaRouter

__all__ = [
    "Engine", "EngineConfig", "QueueFull", "Request", "StalledEngine",
    "FaultPlan", "ReplicaFailure", "demo_chaos_plan",
    "AllReplicasDead", "ReplicaRouter",
]
