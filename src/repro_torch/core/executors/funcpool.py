"""funcpool backend (sim): Raptor/Dragon-style in-worker function execution.

The paper's headline throughput (rp+flux+dragon at 1,547 t/s where srun
peaks at 152) comes from *function dispatch inside persistent workers* — no
scheduler interaction, no process launch per task. The sim model is W
parallel workers sharing one backlog; each call costs
``noisy(1/FUNCPOOL_WORKER_RATE) + duration`` of worker time, so null-task
sweeps measure pure dispatch rate and the aggregate scales linearly in W
until the agent's RP dispatch ceiling (calibration.RP_DISPATCH_RATE) caps it
— the same structural flattening the paper attributes to RP's task
management subsystem (§4.1.5).

Unlike the launch-server backends there is no resource-pool first-fit and no
launch pipeline: a worker IS the resource, which is exactly the modality
difference the paper characterizes. ~1 scheduler event per call.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from repro_torch.core import calibration as CAL
from repro_torch.core.executors.base import BaseExecutor
from repro_torch.core.resources import NodeSpec
from repro_torch.core.task import Task, TaskState
from repro_torch.runtime.registry import register_executor


class _Worker:
    __slots__ = ("idx", "task", "event")

    def __init__(self, idx: int):
        self.idx = idx
        self.task: Optional[Task] = None       # call in service
        self.event = None                      # its completion event


class SimFuncPoolExecutor(BaseExecutor):
    kind = "funcpool"
    accepts_static = True
    # a service replica pins one pool worker for its whole lifetime
    # (Dragon-style in-pool service hosting) — provision/drain against the
    # live worker pool is what makes the pool a valid autoscaling target
    supports_services = True

    def __init__(self, engine, n_nodes: int,
                 spec: NodeSpec = NodeSpec(cores=CAL.CORES_PER_NODE,
                                           gpus=CAL.GPUS_PER_NODE),
                 workers: int = 0,
                 worker_rate: float = CAL.FUNCPOOL_WORKER_RATE,
                 name: str = "funcpool"):
        super().__init__(name)
        self.engine = engine
        self.n_nodes = n_nodes
        self.spec = spec
        self.worker_rate = worker_rate
        n = workers or max(1, n_nodes * CAL.FUNCPOOL_WORKERS_PER_NODE)
        self.workers: List[_Worker] = [_Worker(i) for i in range(n)]
        self._idle: List[_Worker] = list(self.workers)
        self.backlog: deque = deque()
        self._running: Dict[str, _Worker] = {}

    # ------------------------------------------------------------- lifecycle
    def start(self) -> float:
        self.alive = True
        return CAL.FUNCPOOL_STARTUP_S

    def accepts(self, task: Task) -> bool:
        d = task.description
        if d.kind == "service":
            return d.nodes == 0            # a worker is single-node by nature
        return d.kind == "function" and d.nodes == 0

    def submit(self, task: Task):
        task.backend = self.name
        self.backlog.append(task)
        self._pump()

    def submit_many(self, tasks: List[Task]):
        name = self.name
        backlog = self.backlog
        for task in tasks:
            task.backend = name
            backlog.append(task)
        self._pump()

    # --------------------------------------------------------------- serving
    def _pump(self):
        idle, backlog = self._idle, self.backlog
        while idle and backlog:
            task = backlog.popleft()
            if task.state is TaskState.CANCELED:
                continue                       # lazy-dropped queue entry
            self._start(idle.pop(), task)

    def _start(self, w: _Worker, task: Task):
        engine = self.engine
        now = engine.now()
        # in-worker dispatch has no separate placement stage: the worker
        # picks the call off the shared queue and executes it immediately
        task.advance(TaskState.LAUNCHING, now, engine.profiler)
        if task.description.kind == "service":
            # persistent replica: pin this worker, provision, then signal
            # readiness; the worker returns to the pool at stop/failure
            task.advance(TaskState.PROVISIONING, now, engine.profiler)
            self.stats["launched"] += 1
            w.task = task
            self._running[task.uid] = w
            svc = task.description.service
            startup = svc.startup if svc is not None else 0.0
            w.event = engine.schedule(max(startup, 1e-6),
                                      self._service_ready, w, task)
            return
        task.advance(TaskState.RUNNING, now, engine.profiler)
        task.attempt += 1
        self.stats["launched"] += 1
        w.task = task
        self._running[task.uid] = w
        if task.progress > 0.0:
            engine.profiler.record(now, task.uid, "task:resume",
                                   {"progress": task.progress,
                                    "cores": task.description.cores})
        # rng draw order matches the seed: dispatch noise before duration
        dispatch = engine.noisy(1.0 / self.worker_rate, sigma=0.1)
        dur = engine.actual_duration(task)
        wt = task.description.walltime
        if 0.0 < wt < dur:
            w.event = engine.schedule(max(dispatch + wt, 1e-6),
                                      self._timeout, w, task)
        else:
            w.event = engine.schedule(max(dispatch + dur, 1e-6),
                                      self._done, w, task)

    def _timeout(self, w: _Worker, task: Task):
        """Per-task walltime expired mid-call: kill and fail with reason."""
        if self._running.get(task.uid) is not w:
            return
        engine = self.engine
        engine.profiler.record(engine.now(), task.uid, "task:walltime",
                               {"limit": task.description.walltime,
                                "attempt": task.attempt})
        self.fail_task(task, "walltime exceeded")

    def _done(self, w: _Worker, task: Task):
        engine = self.engine
        self._running.pop(task.uid, None)
        w.task = None
        w.event = None
        if task.state is TaskState.RUNNING:
            task.advance(TaskState.DONE, engine.now(), engine.profiler)
            self.stats["completed"] += 1
            if self.on_complete:
                self.on_complete(task)
        # pull the next call directly — the worker stays hot
        backlog = self.backlog
        while backlog:
            nxt = backlog.popleft()
            if nxt.state is not TaskState.CANCELED:
                self._start(w, nxt)
                return
        self._idle.append(w)

    # --------------------------------------------------------------- services
    def _service_ready(self, w: _Worker, task: Task):
        if self._running.get(task.uid) is not w:
            return                         # killed or canceled mid-boot
        w.event = None
        if task.state is not TaskState.PROVISIONING:
            return
        engine = self.engine
        task.advance(TaskState.READY, engine.now(), engine.profiler)
        svc = task.description.service
        if svc is not None:
            svc._replica_ready(task)

    def _release_worker(self, w: _Worker):
        w.task = None
        w.event = None
        self._idle.append(w)
        self._pump()

    def stop_service(self, task: Task):
        """Complete a drained replica (DRAINING -> STOPPED) and return its
        pinned worker to the pool."""
        w = self._running.pop(task.uid, None)
        if w is None:
            return
        engine = self.engine
        if not task.done:
            task.advance(TaskState.STOPPED, engine.now(), engine.profiler)
            self.stats["completed"] += 1
            if self.on_complete:
                self.on_complete(task)
        self._release_worker(w)

    def fail_task(self, task: Task, reason: str = "executor kill") -> bool:
        """Fault injection: fail one in-worker task (call or replica) and
        free its worker through the normal on_failure path."""
        w = self._running.pop(task.uid, None)
        if w is None:
            return False
        if w.event is not None:
            w.event.cancel()
        task.save_progress(self.engine.now())
        task.error = f"{self.name}: {reason}"
        task.advance(TaskState.FAILED, self.engine.now(),
                     self.engine.profiler)
        self.stats["failed"] += 1
        if self.on_failure:
            self.on_failure(task, task.error)
        self._release_worker(w)
        return True

    def evacuate(self) -> List[Task]:
        """Pilot death: hand back the backlog, fail every in-worker call
        through on_failure (no launch servers here — the worker pool IS the
        resource, so the base kill path does not apply)."""
        orphans = [t for t in self.backlog if not t.done]
        self.backlog.clear()
        victims = [w.task for w in list(self._running.values())
                   if w.task is not None]
        for t in victims:
            self.fail_task(t, "executor failure")
        self.alive = False
        return orphans

    def running_tasks(self) -> List[Task]:
        return [w.task for w in self._running.values()
                if w.task is not None]

    # ---------------------------------------------------------------- control
    def cancel(self, task: Task):
        w = self._running.pop(task.uid, None)
        if w is not None:
            if w.event is not None:
                w.event.cancel()
            w.task = None
            w.event = None
            task.advance(TaskState.CANCELED, self.engine.now(),
                         self.engine.profiler)
            self._idle.append(w)
            self._pump()
        elif task.state in (TaskState.QUEUED, TaskState.LAUNCHING):
            # lazy dequeue: dropped in O(1) when it surfaces in _pump
            task.advance(TaskState.CANCELED, self.engine.now(),
                         self.engine.profiler)

    # ------------------------------------------------------------------ stats
    def nominal_rate(self, kind: str = "function") -> float:
        return len(self.workers) * self.worker_rate

    @property
    def queue_depth(self) -> int:
        return len(self.backlog)

    @property
    def free_cores(self) -> int:
        return len(self._idle)

    @property
    def total_cores(self) -> int:
        return len(self.workers)


@register_executor("funcpool", mode="sim")
def _build_sim_funcpool(engine, nodes, spec, **options):
    return SimFuncPoolExecutor(engine, nodes, spec, **options)
