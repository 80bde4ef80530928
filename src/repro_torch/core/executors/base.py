"""Executor interface + the shared discrete-event launch-server model.

A backend executor is, in queueing terms, one or more *launch servers*: a
FIFO-with-backfill queue in front of a single server whose service time is the
backend's measured per-task launch cost (calibration.py), gated by a resource
pool (and, for srun, the platform concurrency cap). Event-driven completions
re-pump the queue — no polling anywhere, matching §3.2's event-level
integration.
"""
from __future__ import annotations

import math
from abc import ABC, abstractmethod
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.core.resources import Allocation, NodePool
from repro_torch.core.task import Task, TaskState


class BaseExecutor(ABC):
    """Common executor surface for sim and real modes."""

    kind: str = "base"
    # Declares that accepts() is a pure function of the description fields
    # (backend, kind, executable, cores, gpus, nodes, coupling, fn) — the
    # agent only memoizes routing decisions when every backend declares
    # this. Deliberately False here: a registry-added executor with a
    # dynamic accepts() (queue state, other fields) stays correct by
    # default and pays a per-task route() instead.
    accepts_static: bool = False
    # Can this backend host persistent service tasks (kind="service")?
    # The routing policy only considers service-capable backends for them.
    supports_services: bool = False

    def __init__(self, name: str):
        self.name = name
        self.alive = False
        self.on_complete: Optional[Callable[[Task], None]] = None
        self.on_failure: Optional[Callable[[Task, str], None]] = None
        self.on_requeue: Optional[Callable[[Task], None]] = None
        self.stats: Dict[str, float] = {"launched": 0, "completed": 0,
                                        "failed": 0}

    @abstractmethod
    def start(self) -> float:
        """Bootstrap; returns the startup overhead in seconds."""

    @abstractmethod
    def submit(self, task: Task) -> None: ...

    def submit_many(self, tasks: List[Task]) -> None:
        """Bulk submission (RP's task-manager bulk path). Backends override
        to enqueue the whole bulk and fan out launch attempts once instead
        of per task."""
        for task in tasks:
            self.submit(task)

    @abstractmethod
    def cancel(self, task: Task) -> None: ...

    def accepts(self, task: Task) -> bool:
        # service replicas only fit service-capable backends; enforced here
        # (not just in the routing policy's special case) so dynamic
        # policies building eligibility from accepts() respect it too
        if task.description.kind == "service":
            return self.supports_services
        return True

    def stop_service(self, task: Task) -> None:
        """Finalize a drained service replica: release its allocation and
        complete it (DRAINING -> STOPPED). Called by the owning Service once
        no in-flight requests remain. Default: delegate to whichever launch
        server hosts the replica."""
        for s in self._servers():
            if task.uid in s.running:
                s.finish_service(task)
                return

    def fail_task(self, task: Task, reason: str = "executor kill") -> bool:
        """Fault injection: fail one running task in place (releasing its
        resources) through the normal on_failure path — the per-task
        analogue of a whole-instance ``kill()``. Returns True when the task
        was found and failed. Default: delegate to whichever launch server
        hosts it."""
        for s in self._servers():
            if task.uid in s.running:
                s.fail_task(task, reason)
                return True
        return False

    def fail_node(self, node: int, reason: str = "node failure"
                  ) -> Optional[List[Task]]:
        """Fault injection: permanently remove ``node`` from whichever
        launch server's pool owns it. Every task with an allocation touching
        the node fails through on_failure; the pool's capacity shrinks for
        good. Returns the failed tasks, or None when no live server owns
        the node (ids are per-backend — see NodePool.first_node)."""
        for s in self._servers():
            if not s.dead and node in s.pool.free_cores:
                victims = s.fail_node(node, reason)
                n = getattr(self, "n_nodes", None)
                if isinstance(n, int) and n > 0:
                    self.n_nodes = n - 1       # total_cores tracks the loss
                return victims
        return None

    def live_nodes(self) -> List[int]:
        """Node ids currently owned by live launch servers (chaos
        targeting). Backends without node pools return [] — the chaos
        controller falls back to their emulated node-loss path."""
        out: List[int] = []
        for s in self._servers():
            if not s.dead:
                out.extend(s.pool.free_cores.keys())
        return out

    def evacuate(self) -> List[Task]:
        """Pilot death: kill every launch server and hand back every
        non-terminal task this executor still held. Queued tasks return
        as-is (still QUEUED — the agent renormalizes them); running ones
        fail through on_failure like any kill. Shared backlogs are drained
        here because ``kill()`` deliberately leaves them for siblings —
        siblings that are now dying too."""
        orphans: List[Task] = []
        seen = set()
        for s in self._servers():
            if id(s.queue) not in seen:
                seen.add(id(s.queue))
                orphans.extend(t for t in s.queue if not t.done)
                s.queue.clear()
        for s in self._servers():
            if not s.dead:
                orphans.extend(s.kill())
        self.alive = False
        return orphans

    def running_tasks(self) -> List[Task]:
        """Snapshot of tasks currently holding resources (chaos targeting)."""
        out: List[Task] = []
        for s in self._servers():
            out.extend(s.running.values())
        return out

    def shutdown(self) -> None:
        """Release backend resources (thread pools, subprocesses)."""

    def _servers(self) -> List["SimLaunchServer"]:
        servers = getattr(self, "instances", None)
        if servers is None:
            server = getattr(self, "server", None)
            servers = [server] if server is not None else []
        return servers

    @property
    def queue_depth(self) -> int:
        """Tasks enqueued but not yet launched (shared backlogs counted
        once) — the adaptive router's load signal."""
        seen, depth = set(), 0
        for s in self._servers():
            if id(s.queue) not in seen:
                seen.add(id(s.queue))
                depth += len(s.queue)
        return depth

    @property
    def free_cores(self) -> int:
        """Currently idle cores across live launch servers (adaptive
        campaign sizing reads this through StageContext)."""
        return sum(sum(s.pool.free_cores.values())
                   for s in self._servers() if not s.dead)

    @property
    @abstractmethod
    def total_cores(self) -> int: ...


class QueueState:
    """Shared change counters for a (possibly shared) backlog: ``head``
    advances when an entry is permanently removed from the front region
    (launch or canceled-drop), ``tail`` when one is appended. Launch
    servers use them to skip backfill rescans that provably cannot launch
    anything (see SimLaunchServer.pump)."""

    __slots__ = ("head", "tail")

    def __init__(self):
        self.head = 0
        self.tail = 0


class SimLaunchServer:
    """Single launch server + resource pool + optional admission gate."""

    def __init__(self, engine, name: str, pool: NodePool,
                 service_time_fn: Callable[[Task], float],
                 admission: Optional[Callable[[Task], bool]] = None,
                 on_admit: Optional[Callable[[Task], None]] = None,
                 on_release: Optional[Callable[[Task], None]] = None,
                 queue: Optional[Deque[Task]] = None,
                 scan_limit: int = 64,
                 qstate: Optional[QueueState] = None,
                 gang_reserve: bool = False):
        self.engine = engine
        self.name = name
        self.pool = pool
        self.service_time_fn = service_time_fn
        self.admission = admission
        self.on_admit = on_admit
        self.on_release = on_release
        # late binding: multiple servers may share one backlog queue and pull
        # work as resources free (RP's pilot-level late binding, §3)
        self.owns_queue = queue is None
        self.queue: Deque[Task] = deque() if queue is None else queue
        self.scan_limit = scan_limit
        # conservative backfill for multi-node gangs: a blocked nodes>0 task
        # claims a draining node set (NodePool.claim) so the backfill stream
        # behind it cannot starve it; off by default for seed-equivalence
        self.gang_reserve = gang_reserve
        self._claim = None
        self._claim_task: Optional[Task] = None
        self.busy = False
        self.dead = False
        # the task between _launch and _launched: allocation already
        # assigned but not yet in ``running`` — kill()/fail_node() must
        # cover this limbo window or its resources leak
        self._launching: Optional[Task] = None
        # while a planned cohort wave (repro_torch.core.cohort) occupies this
        # server, pump() is a no-op until the wave's planned end time — an
        # event resets this to 0.0 and re-pumps
        self._cohort_until = 0.0
        self.running: Dict[str, Task] = {}
        self.on_complete: Optional[Callable[[Task], None]] = None
        self.on_failure: Optional[Callable[[Task, str], None]] = None
        self._completion_events: Dict[str, object] = {}
        self._qstate = qstate if qstate is not None else QueueState()
        # stall memo: (head, tail) snapshot of the last fruitless scan;
        # tail -1 means "full window examined, appends can't help"
        self._stall_head: Optional[int] = None
        self._stall_tail = -1
        # cached bound methods: the launch/complete callbacks are scheduled
        # once per task, so avoid re-binding them on every schedule() call
        self._launched_cb = self._launched
        self._complete_cb = self._complete
        self._walltime_cb = self._walltime

    # -------------------------------------------------------------- submit
    def submit(self, task: Task):
        assert not self.dead, f"{self.name}: submit to dead server"
        self.queue.append(task)
        self._qstate.tail += 1
        self.pump()

    def _release_claim(self):
        if self._claim is not None:
            self.pool.release_claim(self._claim)
            self._claim = None
            self._claim_task = None
            self._stall_head = None        # pool changed: rescan

    def pump(self):
        if self.busy or self.dead or self._cohort_until:
            return
        # a sibling server (shared backlog) may have launched — or the agent
        # canceled — the gang this claim was draining nodes for: release it
        ct = self._claim_task
        if ct is not None and ct.state is not TaskState.QUEUED:
            self._release_claim()
        q = self.queue
        if not q:
            return
        qs = self._qstate
        # Stall fast-exit: if the last scan launched nothing and neither
        # this server's pool nor the visible queue window changed since,
        # rescanning cannot succeed either — skip the O(scan_limit) pass.
        # Gated on `admission is None` because admission gates read state
        # (e.g. platform srun slots) that can change outside this server.
        if (self._stall_head == qs.head
                and (self._stall_tail == -1 or self._stall_tail == qs.tail)
                and self.admission is None):
            return
        # Bounded FIFO-with-backfill scan, O(1) queue ops: pop candidates
        # off the front, park the ones that don't fit, and splice the parked
        # prefix back in order afterwards. Canceled entries are dropped for
        # free as they surface. Launches proceed greedily until the launch
        # pipeline is busy, the backfill window is exhausted, or the queue
        # drains (the single-server model sets ``busy`` per launch, so the
        # launch *rate* is still governed by the service time).
        deferred: List[Task] = []
        scanned = 0
        launched = False
        limit = self.scan_limit
        admission = self.admission
        pool = self.pool
        alloc_fn = pool.alloc
        while q and scanned < limit and not self.busy:
            task = q.popleft()
            scanned += 1
            if task.state is TaskState.CANCELED:
                qs.head += 1               # dropped: window shifts for all
                if task is self._claim_task:
                    self._release_claim()
                continue
            if admission is not None and not admission(task):
                deferred.append(task)
                continue
            if task is self._claim_task:
                # the reserved gang launches atomically once its claimed
                # node set has drained; until then it parks without blocking
                # the backfill stream behind it (which can no longer touch
                # the claimed nodes)
                if pool.claim_ready(self._claim):
                    alloc = pool.alloc_claimed(task.description, self._claim)
                    self._claim = None
                    self._claim_task = None
                    qs.head += 1
                    launched = True
                    self._launch(task, alloc)
                else:
                    deferred.append(task)
                continue
            alloc = alloc_fn(task.description)
            if alloc is None:
                d = task.description
                if (self.gang_reserve and d.nodes and self._claim is None
                        and d.nodes <= pool.n_nodes):
                    c = pool.claim(d.nodes)
                    if c is not None:
                        self._claim = c
                        self._claim_task = task
                        self.engine.profiler.record(
                            self.engine.now(), task.uid, "gang:reserve",
                            {"server": self.name, "nodes": d.nodes})
                deferred.append(task)
                continue
            qs.head += 1                   # removed: window shifts for all
            launched = True
            self._launch(task, alloc)
        if deferred:
            q.extendleft(reversed(deferred))
        if launched:
            self._stall_head = None
        else:
            self._stall_head = qs.head
            self._stall_tail = -1 if scanned >= limit else qs.tail

    def _launch(self, task: Task, alloc: Allocation):
        engine = self.engine
        task.allocation = alloc
        task.attempt += 1
        if self.on_admit:
            self.on_admit(task)
        task.advance(TaskState.LAUNCHING, engine.now(), engine.profiler)
        self.busy = True
        self._launching = task
        svc = self.service_time_fn(task)
        engine.schedule(svc if svc > 1e-6 else 1e-6, self._launched_cb, task)

    def _launched(self, task: Task):
        self.busy = False
        if self._launching is task:
            self._launching = None
        if self.dead:
            return
        engine = self.engine
        if task.state is TaskState.CANCELED:
            self._release(task)
            self._stall_head = None        # pool changed: rescan
            self.pump()
            return
        if task.done:
            # failed mid-launch by fault injection; already released there
            self._stall_head = None
            self.pump()
            return
        if task.description.kind == "service":
            # persistent replica: provision, then signal readiness; it holds
            # its allocation (no completion event) until finish_service
            task.advance(TaskState.PROVISIONING, engine.now(),
                         engine.profiler)
            self.running[task.uid] = task
            svc = task.description.service
            startup = svc.startup if svc is not None else 0.0
            engine.schedule(max(startup, 1e-6), self._service_ready, task)
            self.pump()
            return
        task.advance(TaskState.RUNNING, engine.now(), engine.profiler)
        self.running[task.uid] = task
        if task.progress > 0.0:
            # checkpoint-aware restart: the prior attempt's saved progress
            # shortens this run (engine.actual_duration subtracts it)
            engine.profiler.record(engine.now(), task.uid, "task:resume",
                                   {"progress": task.progress,
                                    "cores": task.description.cores})
        dur = engine.actual_duration(task)
        wt = task.description.walltime
        if 0.0 < wt < dur:
            # walltime enforcement: the overrun kill preempts completion
            ev = engine.schedule(wt, self._walltime_cb, task)
        else:
            ev = engine.schedule(dur, self._complete_cb, task)
        self._completion_events[task.uid] = ev
        self.pump()

    def _service_ready(self, task: Task):
        if self.dead or task.uid not in self.running:
            return                         # killed or canceled mid-boot
        if task.state is not TaskState.PROVISIONING:
            return
        engine = self.engine
        task.advance(TaskState.READY, engine.now(), engine.profiler)
        svc = task.description.service
        if svc is not None:
            svc._replica_ready(task)

    def finish_service(self, task: Task):
        """Complete a drained replica: DRAINING -> STOPPED, release its
        allocation, and hand lifecycle control back through on_complete."""
        if self.running.pop(task.uid, None) is None:
            return
        self._release(task)
        self._stall_head = None            # pool changed: rescan
        engine = self.engine
        if not task.done:
            task.advance(TaskState.STOPPED, engine.now(), engine.profiler)
            if self.on_complete:
                self.on_complete(task)
        self.pump()

    def _complete(self, task: Task):
        if self.dead:
            return
        uid = task.uid
        if self.running.pop(uid, None) is None:
            return
        self._completion_events.pop(uid, None)
        self._release(task)
        self._stall_head = None            # pool changed: rescan
        if task.state is TaskState.RUNNING:
            engine = self.engine
            task.advance(TaskState.DONE, engine.now(), engine.profiler)
            if self.on_complete:
                self.on_complete(task)
        self.pump()

    def _release(self, task: Task):
        if task.allocation is not None:
            self.pool.free(task.allocation)
            task.allocation = None
        if self.on_release:
            self.on_release(task)

    # -------------------------------------------------------------- control
    def cancel(self, task: Task):
        if task.uid in self.running:
            del self.running[task.uid]
            ev = self._completion_events.pop(task.uid, None)
            if ev is not None:
                ev.cancel()
            self._release(task)
            self._stall_head = None        # pool changed: rescan
            task.advance(TaskState.CANCELED, self.engine.now(),
                         self.engine.profiler)
            self.pump()
        elif task.state in (TaskState.QUEUED, TaskState.LAUNCHING):
            # lazy dequeue: mark terminal now; pump drops the queue entry in
            # O(1) when it surfaces (deque.remove would be O(n) per cancel).
            # A mid-launch task is released by _launched on its CANCELED
            # state.
            task.advance(TaskState.CANCELED, self.engine.now(),
                         self.engine.profiler)

    def _walltime(self, task: Task):
        """Per-task walltime expired: kill the run and fail it with reason.
        Progress saved via the checkpoint contract survives into the retry."""
        if self.dead or self.running.get(task.uid) is not task:
            return
        engine = self.engine
        engine.profiler.record(engine.now(), task.uid, "task:walltime",
                               {"limit": task.description.walltime,
                                "attempt": task.attempt})
        self.fail_task(task, "walltime exceeded")

    def fail_task(self, task: Task, reason: str):
        """Fail one running task in place (targeted fault injection /
        replica chaos) — like ``kill()`` for a single task, without taking
        the server down. Its resources are released and ``on_failure``
        hands lifecycle control back to the agent."""
        if self.running.pop(task.uid, None) is None:
            return
        ev = self._completion_events.pop(task.uid, None)
        if ev is not None:
            ev.cancel()
        task.save_progress(self.engine.now())
        self._release(task)
        self._stall_head = None            # pool changed: rescan
        task.error = f"{self.name}: {reason}"
        task.advance(TaskState.FAILED, self.engine.now(),
                     self.engine.profiler)
        if self.on_failure:
            self.on_failure(task, task.error)
        self.pump()

    def fail_node(self, node: int, reason: str) -> List[Task]:
        """A node dies: its capacity leaves the pool permanently, every
        task whose allocation touches it fails through on_failure, and a
        gang claim holding the node is dropped (it can never drain)."""
        pool = self.pool
        if pool.remove_node(node) is None:
            return []
        if self._claim is not None and node in self._claim.nodes:
            self._release_claim()
        victims = [t for t in list(self.running.values())
                   if t.allocation is not None
                   and (node in t.allocation.node_cores
                        or node in t.allocation.node_gpus)]
        for t in victims:
            self.fail_task(t, reason)
        lt = self._launching
        if (lt is not None and lt.allocation is not None
                and (node in lt.allocation.node_cores
                     or node in lt.allocation.node_gpus)):
            # launch-limbo victim: allocation assigned, not yet running.
            # _launched sees the terminal state and just re-pumps.
            self._launching = None
            self._release(lt)
            lt.error = f"{self.name}: {reason}"
            lt.advance(TaskState.FAILED, self.engine.now(),
                       self.engine.profiler)
            if self.on_failure:
                self.on_failure(lt, lt.error)
            victims.append(lt)
        self._stall_head = None            # pool changed: rescan
        self.pump()
        return victims

    def kill(self) -> List[Task]:
        """Server dies: running tasks fail; queued tasks are handed back
        (fault isolation, §4.1.3). A shared backlog survives — siblings keep
        draining it."""
        self.dead = True
        self._release_claim()
        victims = list(self.running.values())
        lt = self._launching
        if lt is not None and not lt.done:
            victims.append(lt)             # mid-launch: holds an allocation
            self._launching = None
        for t in victims:
            ev = self._completion_events.pop(t.uid, None)
            if ev is not None:
                ev.cancel()
            t.save_progress(self.engine.now())
            self._release(t)
            t.error = f"{self.name}: executor failure"
            t.advance(TaskState.FAILED, self.engine.now(),
                      self.engine.profiler)
            if self.on_failure:
                self.on_failure(t, t.error)
        orphans = []
        if self.owns_queue:
            orphans = [t for t in self.queue if not t.done]
            self.queue.clear()
        self.running.clear()
        return orphans

class CoordinationLimiter:
    """Serialization stage modeling RP's per-executor coordination cost
    (calibration.rp_coord_rate). Reserving a slot returns the delay until the
    coordination pipeline has processed this launch."""

    def __init__(self, engine, nodes: int, n_instances: int):
        from repro_torch.core import calibration as CAL
        self.engine = engine
        self.interval = 1.0 / CAL.rp_coord_rate(nodes, n_instances)
        self._next = 0.0

    def reserve(self) -> float:
        now = self.engine.now()
        start = max(now, self._next)
        self._next = start + self.interval
        return self._next - now
