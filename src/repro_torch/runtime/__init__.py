"""repro_torch.runtime — the pluggable execution substrate.

Layering (see README.md in this directory):

    Session -> PilotManager -> Pilot -> Agent -> Executor backends
                                  |        |
                              Engine (SimEngine | RealEngine)

The same Agent pipeline (routing, retries, speculation, campaigns) runs over
either engine; executor backends are resolved through the registry, so new
backends plug in with ``@register_executor`` and no agent edits.
"""
from repro_torch.runtime.engine import Engine, RealEngine, SimEngine
from repro_torch.runtime.registry import (available_executors, create_executor,
                                          register_executor,
                                          unregister_executor)
from repro_torch.runtime.real_executors import (FuncPoolExecutor,
                                                RealExecutorBase,
                                                RealFunctionExecutor,
                                                RealPartitionExecutor,
                                                SubprocessExecutor)
from repro_torch.runtime.session import PilotManager, Session, TaskManager
from repro_torch.services import (LeastOutstandingBalancer, RoundRobinBalancer,
                                  Service)

__all__ = [
    "Engine", "SimEngine", "RealEngine",
    "register_executor", "unregister_executor", "create_executor",
    "available_executors",
    "RealExecutorBase", "RealFunctionExecutor", "RealPartitionExecutor",
    "SubprocessExecutor", "FuncPoolExecutor",
    "Session", "PilotManager", "TaskManager",
    "Service", "RoundRobinBalancer", "LeastOutstandingBalancer",
]
