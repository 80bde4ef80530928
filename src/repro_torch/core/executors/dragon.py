"""Dragon backend: flat, minimal-overhead dispatch (§3.2.2).

A single centralized runtime spanning its node set — high launch rate at small
scale, declining beyond ~16 nodes (§4.1.4), faster still for its native
in-memory Python-function mode. No internal partitioning (the paper notes
partitioned Dragon as future work — our beyond-paper extension
``SimDragonExecutor(n_partitions>1)`` implements exactly that and is
benchmarked separately in EXPERIMENTS.md §Perf-runtime).
"""
from __future__ import annotations

from collections import deque
from typing import List

from repro_torch.core import calibration as CAL
from repro_torch.core.executors.base import (BaseExecutor, CoordinationLimiter,
                                             QueueState, SimLaunchServer)
from repro_torch.core.resources import NodePool, NodeSpec, partition_nodes
from repro_torch.core.task import Task, TaskState
from repro_torch.runtime.registry import register_executor


class SimDragonExecutor(BaseExecutor):
    kind = "dragon"
    accepts_static = True
    supports_services = True     # single-node replicas (no co-scheduling)

    def __init__(self, engine, n_nodes: int, n_partitions: int = 1,
                 spec: NodeSpec = NodeSpec(cores=CAL.CORES_PER_NODE,
                                           gpus=CAL.GPUS_PER_NODE),
                 name: str = "dragon"):
        super().__init__(name)
        self.engine = engine
        self.n_nodes = n_nodes
        self.n_partitions = min(n_partitions, n_nodes)
        self.spec = spec
        self.instances: List[SimLaunchServer] = []
        self.backlog = deque()
        self._qstate = QueueState()          # shared backlog change counters
        self.coord = CoordinationLimiter(engine, n_nodes, self.n_partitions)
        pools = partition_nodes(n_nodes, self.n_partitions, spec)
        for i, pool in enumerate(pools):
            inst = SimLaunchServer(
                engine, f"{name}.inst{i}", pool,
                service_time_fn=self._service_time_fn(pool.n_nodes),
                queue=self.backlog, qstate=self._qstate)
            inst.on_complete = self._completed
            inst.on_failure = self._failed
            self.instances.append(inst)

    def _service_time_fn(self, nodes: int):
        def svc(task: Task) -> float:
            rate = CAL.dragon_rate(nodes, task.description.kind)
            return max(self.engine.noisy(1.0 / rate, sigma=0.15),
                       self.coord.reserve())
        return svc

    def start(self) -> float:
        self.alive = True
        return CAL.DRAGON_STARTUP_S

    def accepts(self, task: Task) -> bool:
        # dragon has no co-scheduling: reject multi-node MPI-like tasks
        return task.description.nodes == 0

    def submit(self, task: Task):
        task.backend = self.name
        self.backlog.append(task)
        self._qstate.tail += 1
        for inst in self.instances:
            if not inst.busy and not inst.dead:
                inst.pump()

    def submit_many(self, tasks: List[Task]):
        """Bulk path: enqueue the whole bulk, then fan launch attempts out
        across idle instances once."""
        name = self.name
        backlog = self.backlog
        qstate = self._qstate
        for task in tasks:
            task.backend = name
            backlog.append(task)
            qstate.tail += 1
        for inst in self.instances:
            if not inst.busy and not inst.dead:
                inst.pump()

    def cancel(self, task: Task):
        for inst in self.instances:
            if task.uid in inst.running:
                inst.cancel(task)
                return
        if task.state in (TaskState.QUEUED, TaskState.LAUNCHING):
            # lazy dequeue: the backlog entry is dropped in O(1) when an
            # instance's backfill scan reaches it
            task.advance(TaskState.CANCELED, self.engine.now(),
                         self.engine.profiler)

    def fail_instance(self, idx: int) -> List[Task]:
        orphans = self.instances[idx].kill()
        self.engine.profiler.record(self.engine.now(),
                                    f"{self.name}.inst{idx}",
                                    "executor:failure",
                                    {"orphans": len(orphans)})
        return orphans

    def _completed(self, task: Task):
        self.stats["completed"] += 1
        if self.on_complete:
            self.on_complete(task)

    def _failed(self, task: Task, err: str):
        self.stats["failed"] += 1
        if self.on_failure:
            self.on_failure(task, err)

    def cohort_model(self, kind: str) -> dict:
        """Launch-race parameters for the cohort planner (repro_torch.core.cohort):
        instances in pump order, per-instance mean launch service time for
        ``kind`` (the same ``1.0 / dragon_rate`` float the per-task service
        closure computes), the lognormal sigma, and the shared limiter."""
        return {"instances": self.instances,
                "means": [1.0 / CAL.dragon_rate(i.pool.n_nodes, kind)
                          for i in self.instances],
                "sigma": 0.15,
                "coord": self.coord}

    def nominal_rate(self, kind: str = "function") -> float:
        per = CAL.dragon_rate(self.n_nodes // self.n_partitions, kind)
        return min(per * self.n_partitions,
                   CAL.rp_coord_rate(self.n_nodes, self.n_partitions))

    @property
    def total_cores(self) -> int:
        return self.n_nodes * self.spec.cores


@register_executor("dragon", mode="sim")
def _build_sim_dragon(engine, nodes, spec, partitions=1, **_):
    return SimDragonExecutor(engine, nodes, partitions, spec)
