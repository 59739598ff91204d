"""The continuous-batching serving engine (twin of ``repro.serve``). The
fault-injection plan, the integrity guard with quarantine and the
multi-replica router are still to port (ROADMAP queue 1 item 5): asking
the engine for them raises."""
from .engine import Engine, EngineConfig, QueueFull, Request, StalledEngine

__all__ = ["Engine", "EngineConfig", "QueueFull", "Request", "StalledEngine"]
