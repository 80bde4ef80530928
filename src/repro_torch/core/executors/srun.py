"""srun (Slurm) backend model — the paper's baseline.

One centralized launcher whose service rate degrades with allocation size
(calibration.srun_rate) and a platform-wide cap on concurrently active srun
processes (112 on Frontier, §4.1.1). Each task occupies one srun slot for its
whole lifetime, which is what caps utilization at 112/224 cores = 50% in
Fig. 4 — the cap is structural here, not fitted.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import calibration as CAL
from repro_torch.core.executors.base import BaseExecutor, SimLaunchServer
from repro_torch.core.resources import NodePool, NodeSpec
from repro_torch.core.task import Task
from repro_torch.runtime.registry import register_executor


class SimSrunExecutor(BaseExecutor):
    kind = "srun"
    accepts_static = True

    def __init__(self, engine, n_nodes: int,
                 spec: NodeSpec = NodeSpec(cores=CAL.CORES_PER_NODE,
                                           gpus=CAL.GPUS_PER_NODE),
                 gang_reserve: bool = False):
        super().__init__("srun")
        self.engine = engine
        self.n_nodes = n_nodes
        pool = NodePool(n_nodes, spec)
        rate = CAL.srun_rate(n_nodes)
        self.server = SimLaunchServer(
            engine, "srun", pool,
            service_time_fn=lambda t: engine.noisy(1.0 / rate, sigma=0.2),
            admission=lambda t: engine.srun_slots_free > 0,
            on_admit=lambda t: engine.take_srun_slot(),
            on_release=lambda t: engine.release_srun_slot(),
            gang_reserve=gang_reserve)
        self.server.on_complete = self._completed
        self.server.on_failure = self._failed

    def start(self) -> float:
        self.alive = True
        return 0.0                      # srun needs no bootstrap

    def submit(self, task: Task):
        task.backend = self.name
        self.server.submit(task)

    def cancel(self, task: Task):
        self.server.cancel(task)

    def _completed(self, task: Task):
        self.stats["completed"] += 1
        if self.on_complete:
            self.on_complete(task)

    def _failed(self, task: Task, err: str):
        self.stats["failed"] += 1
        if self.on_failure:
            self.on_failure(task, err)

    def nominal_rate(self) -> float:
        return CAL.srun_rate(self.n_nodes)

    @property
    def total_cores(self) -> int:
        return self.n_nodes * self.server.pool.spec.cores


@register_executor("srun", mode="sim")
def _build_sim_srun(engine, nodes, spec, gang_reserve=False, **_):
    return SimSrunExecutor(engine, nodes, spec, gang_reserve=gang_reserve)
