"""Flux backend: hierarchical, partition-aware scheduling (§3.2.1).

The RP Flux executor drives N concurrent Flux *instances*, each owning a
disjoint node partition with its own FCFS+backfill queue and launch pipeline
(brokers scale with partition size -> calibration.flux_instance_rate).
Instances bootstrap concurrently (~20 s each, Fig. 7) and each consumes one
srun slot for its lifetime (§4.1.3: flux_n is bounded by the 112-srun cap).
Instance failure is isolated: the agent reroutes its tasks to survivors.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

from repro_torch.core import calibration as CAL
from repro_torch.core.executors.base import (BaseExecutor, CoordinationLimiter,
                                             QueueState, SimLaunchServer)
from repro_torch.core.resources import NodePool, NodeSpec, partition_nodes
from repro_torch.core.task import Task, TaskState
from repro_torch.runtime.registry import register_executor


class SimFluxExecutor(BaseExecutor):
    kind = "flux"
    accepts_static = True
    supports_services = True     # replicas hold a partition allocation

    def __init__(self, engine, n_nodes: int, n_partitions: int = 1,
                 spec: NodeSpec = NodeSpec(cores=CAL.CORES_PER_NODE,
                                           gpus=CAL.GPUS_PER_NODE),
                 name: str = "flux", gang_reserve: bool = False):
        super().__init__(name)
        self.engine = engine
        self.n_nodes = n_nodes
        self.n_partitions = min(n_partitions, n_nodes)
        self.spec = spec
        self.gang_reserve = gang_reserve
        self.instances: List[SimLaunchServer] = []
        self.backlog = deque()               # shared: late binding across instances
        self._qstate = QueueState()          # shared backlog change counters
        self.coord = CoordinationLimiter(engine, n_nodes, self.n_partitions)
        pools = partition_nodes(n_nodes, self.n_partitions, spec)
        for i, pool in enumerate(pools):
            rate = CAL.flux_instance_rate(pool.n_nodes)
            inst = SimLaunchServer(
                engine, f"{name}.inst{i}", pool,
                service_time_fn=(lambda r: lambda t: max(
                    engine.noisy(1.0 / r, sigma=CAL.FLUX_RATE_SIGMA),
                    self.coord.reserve()))(rate),
                queue=self.backlog, qstate=self._qstate,
                gang_reserve=gang_reserve)
            inst.on_complete = self._completed
            inst.on_failure = self._failed
            self.instances.append(inst)
        self._live: List[SimLaunchServer] = list(self.instances)

    # ------------------------------------------------------------------ boot
    def start(self) -> float:
        """Instances bootstrap concurrently; each takes one srun slot."""
        self.alive = True
        for _ in self.instances:
            if self.engine.srun_slots_free > 0:
                self.engine.take_srun_slot()
        return CAL.FLUX_STARTUP_S

    # ---------------------------------------------------------------- routing
    def _live_instances(self) -> List[SimLaunchServer]:
        return self._live

    def _refresh_live(self):
        self._live = [i for i in self.instances if not i.dead]

    def submit(self, task: Task):
        task.backend = self.name
        live = self._live
        assert live, f"{self.name}: no live instances"
        if not self._enqueue(task, live):
            return
        # late binding: enqueue once on the shared backlog; the first
        # instance with free resources and a free launcher takes it (busy
        # launchers re-pump themselves on their next pipeline event)
        for inst in live:
            if not inst.busy:
                inst.pump()

    def submit_many(self, tasks: List[Task]):
        """Bulk path: enqueue the whole bulk, then fan launch attempts out
        across idle instances once (equivalent to per-task submission —
        no sim events fire between the appends)."""
        live = self._live
        assert live, f"{self.name}: no live instances"
        for task in tasks:
            task.backend = self.name
            self._enqueue(task, live)
        for inst in live:
            if not inst.busy:
                inst.pump()

    def _enqueue(self, task: Task, live) -> bool:
        if task.description.nodes and not any(
                i.pool.n_nodes >= task.description.nodes for i in live):
            task.error = (f"no partition with "
                          f">={task.description.nodes} nodes")
            task.advance(TaskState.FAILED, self.engine.now(),
                         self.engine.profiler)
            if self.on_failure:
                self.on_failure(task, task.error)
            return False
        self.backlog.append(task)
        self._qstate.tail += 1
        return True

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

    # ---------------------------------------------------------------- faults
    def fail_instance(self, idx: int) -> List[Task]:
        """Kill one instance; returns orphaned queued tasks (the agent
        reroutes them). Running tasks FAIL via on_failure."""
        orphans = self.instances[idx].kill()
        self._refresh_live()
        self.engine.release_srun_slot()
        self.engine.profiler.record(self.engine.now(),
                                    f"{self.name}.inst{idx}",
                                    "executor:failure",
                                    {"orphans": len(orphans)})
        return orphans

    def evacuate(self) -> List[Task]:
        """Pilot death: drain the shared backlog and kill every instance
        (base behavior), plus flux bookkeeping — each live instance held an
        srun slot, and the live list must empty."""
        n_live = len(self._live)
        orphans = super().evacuate()
        self._refresh_live()
        for _ in range(n_live):
            self.engine.release_srun_slot()
        return orphans

    def restart_instance(self, idx: int, delay: float = CAL.FLUX_STARTUP_S):
        """Failover: re-bootstrap a dead instance after ``delay``."""
        def _up():
            old = self.instances[idx]
            rate = CAL.flux_instance_rate(old.pool.n_nodes)
            pool = NodePool(old.pool.n_nodes, self.spec,
                            first_node=old.pool.first_node)
            inst = SimLaunchServer(
                self.engine, f"{self.name}.inst{idx}", pool,
                service_time_fn=lambda t: max(
                    self.engine.noisy(1.0 / rate, sigma=CAL.FLUX_RATE_SIGMA),
                    self.coord.reserve()),
                queue=self.backlog, qstate=self._qstate,
                # inherit the dead server's flag, not the constructor
                # option: a gated scheduler arms gang_reserve per server
                # after construction, and failover must not disarm it
                gang_reserve=old.gang_reserve)
            inst.on_complete = self._completed
            inst.on_failure = self._failed
            self.instances[idx] = inst
            self._refresh_live()
            inst.pump()
            if self.engine.srun_slots_free > 0:
                self.engine.take_srun_slot()
            self.engine.profiler.record(self.engine.now(),
                                        f"{self.name}.inst{idx}",
                                        "executor:restart", {})
        self.engine.schedule(delay, _up)

    def _completed(self, task: Task):
        self.stats["completed"] += 1
        if self.on_complete:
            self.on_complete(task)

    def _failed(self, task: Task, err: str):
        self.stats["failed"] += 1
        if self.on_failure:
            self.on_failure(task, err)

    def nominal_rate(self) -> float:
        live = self._live_instances()
        inst = sum(CAL.flux_instance_rate(i.pool.n_nodes) for i in live)
        return min(inst, CAL.rp_coord_rate(self.n_nodes, len(self.instances)))

    def cohort_model(self, kind: str) -> dict:
        """Launch-race parameters for the cohort planner (repro_torch.core.cohort):
        live instances in pump order, the per-instance mean launch service
        time (same float expression the per-task closure evaluates), the
        lognormal sigma, and the shared coordination limiter."""
        return {"instances": self._live,
                "means": [1.0 / CAL.flux_instance_rate(i.pool.n_nodes)
                          for i in self._live],
                "sigma": CAL.FLUX_RATE_SIGMA,
                "coord": self.coord}

    @property
    def total_cores(self) -> int:
        return self.n_nodes * self.spec.cores


@register_executor("flux", mode="sim")
def _build_sim_flux(engine, nodes, spec, partitions=1, gang_reserve=False,
                    **_):
    return SimFluxExecutor(engine, nodes, partitions, spec,
                           gang_reserve=gang_reserve)
