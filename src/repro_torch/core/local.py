"""Backward-compatible local runtime — now a thin shim over the unified
substrate (``Session(mode="real")`` + the registry's real backends).

Historically this module carried its own thread-based task lifecycle
(duplicating the agent's retries/routing); that code is gone. Tasks
submitted here flow through the exact same Agent dispatch pipeline as the
simulator — routing policies, retries, speculation, and profiling included:

  * ``dragon`` — worker pool for in-process Python *function* tasks,
  * ``flux``   — co-scheduled *executable* tasks, one per device-mesh
    partition (callables declaring a ``mesh`` kwarg receive their
    partition's submesh). With ``mesh=make_local_mesh()`` (the cards of
    this process) and ``n_partitions=N``, min(N, cards) partitions run at
    once, each task on its own partition's card. A partition of several
    cards (``make_local_mesh(mp)``, or fewer partitions than cards) runs
    its task on a group of ranks spawned over its cards
    (``launch/ranks.py``), which the task's walltime, if it has one, kills.

Prefer the Session API (``repro_torch.runtime``) in new code.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.pilot import PilotDescription
from repro_torch.core.task import Task, TaskDescription
from repro_torch.runtime.session import PilotManager, Session, TaskManager


class LocalRuntime:
    """Thread-based agent for real payload execution (compat facade)."""

    def __init__(self, n_function_workers: int = 4, mesh=None,
                 n_partitions: int = 1):
        self.session = Session(mode="real")
        self._pmgr = PilotManager(self.session)
        self._tmgr = TaskManager(self.session)
        pilot = self._pmgr.submit_pilots(PilotDescription(
            nodes=max(1, n_partitions),
            backends={
                "dragon": {"workers": n_function_workers},
                "flux": {"partitions": n_partitions, "mesh": mesh},
            }))
        self._tmgr.add_pilots(pilot)
        self.pilot = pilot
        self.agent = pilot.agent

    # ---------------------------------------------------------------- compat
    @property
    def clock(self):
        return self.session.engine.clock

    @property
    def profiler(self):
        return self.session.engine.profiler

    @property
    def tasks(self) -> Dict[str, Task]:
        return self.agent.tasks

    @property
    def partitions(self):
        return self.agent.backends["flux"].partitions

    # ------------------------------------------------------------------- api
    def submit(self, descriptions: List[TaskDescription]) -> List[Task]:
        return self._tmgr.submit_tasks(list(descriptions))

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._tmgr.wait_tasks(timeout=timeout)

    def shutdown(self):
        self.session.close()
