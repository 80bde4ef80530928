"""Real-mode executor backends: the same BaseExecutor surface the simulator's
backend models implement, but payloads actually execute on this host.

Backends mirror the simulation split:
  * ``dragon``   — a worker-thread pool for in-process Python *function* tasks
    (Dragon's native mode: no process spawn per task, shared interpreter
    state / device buffers). Also hosts persistent *service* replicas: a
    replica occupies one worker thread for its lifetime and serves requests
    from its queue (see ``repro_torch.services``).
  * ``flux``     — co-scheduled *executable* tasks; each partition maps to a
    device mesh (core/partition.py) and runs its tasks serially
    (co-scheduling: one tightly-coupled job owns the partition at a time).
    Task callables that declare a ``mesh`` keyword receive their partition's
    submesh, and every task runs inside its partition's placement
    (``Mesh.placement``): on a mesh over the local cards its card is the
    current device of the thread, as JAX places a step on its submesh. A
    partition of several local devices runs its task on a group of ranks
    spawned over them (``launch/ranks.RankGroup``), each calling the task
    with ``mesh=`` a mesh over the group, as JAX runs a step over its
    submesh's devices; the task's result is rank 0's.
  * ``popen``    — external executables launched as subprocesses
    (``TaskDescription.executable`` + ``arguments``); stdout becomes
    ``task.result``.
  * ``funcpool`` — Raptor/Dragon-style master/worker function execution:
    persistent OS worker processes pull pickled callables off a shared queue
    (no per-call process spawn, true multi-core parallelism); a collector
    thread commits completions back into the task pipeline.

Each payload runs inside a ``payload`` span (``core/spans.py``,
recorded only while a span trace is on; the thread-pool executors alone).
All task state transitions are committed under ``engine.lock`` and followed
by ``engine.notify()``, so the agent's single-threaded lifecycle logic
(retries, speculation, campaign stage release) runs unchanged on top.
"""
from __future__ import annotations

import inspect
import multiprocessing as mp
import os
import queue
import subprocess
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

from repro_torch.core import spans
from repro_torch.core.executors.base import BaseExecutor
from repro_torch.core.partition import carve_submeshes
from repro_torch.core.task import Task, TaskState
from repro_torch.runtime.registry import register_executor
from repro_torch.services.service import SVC_STOP


def _accepts_kw(fn, name: str) -> bool:
    if fn is None:
        return False
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class RealExecutorBase(BaseExecutor):
    """Thread-pool executor skeleton: queueing, cancellation, and locked
    state commits; subclasses provide ``_payload``."""

    def __init__(self, engine, name: str, workers: int,
                 thread_prefix: str = "worker"):
        super().__init__(name)
        self.engine = engine
        self.workers = workers
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                        thread_name_prefix=thread_prefix)
        self._futures: Dict[str, Future] = {}
        # submitted-but-not-yet-started tasks (parallel to _futures) and
        # tasks whose payload is executing — the chaos/evacuation surface
        self._pending_tasks: Dict[str, Task] = {}
        self._running_tasks: Dict[str, Task] = {}
        self._active = 0
        # request queues of hosted service replicas (uid -> Queue), so
        # shutdown can unblock their serve loops with a stop sentinel
        self._service_queues: Dict[str, "queue.Queue"] = {}

    # ------------------------------------------------------------- lifecycle
    def start(self) -> float:
        self.alive = True
        return 0.0

    def submit(self, task: Task):
        task.backend = self.name
        try:
            self._pending_tasks[task.uid] = task
            self._futures[task.uid] = self._pool.submit(self._run, task)
        except RuntimeError as e:       # pool shut down (session closed)
            self._pending_tasks.pop(task.uid, None)
            eng = self.engine
            task.error = f"{self.name}: {e}"
            task.advance(TaskState.FAILED, eng.now(), eng.profiler)
            self.stats["failed"] += 1
            if self.on_failure:
                self.on_failure(task, task.error)
            eng.notify()

    def _run(self, task: Task):
        if task.description.kind == "service":
            return self._run_service(task)
        eng = self.engine
        with eng.lock:
            self._futures.pop(task.uid, None)
            self._pending_tasks.pop(task.uid, None)
            if task.done:                         # canceled while queued
                return
            self._active += 1
            task.attempt += 1
            attempt = task.attempt
            self._running_tasks[task.uid] = task
            task.advance(TaskState.LAUNCHING, eng.now(), eng.profiler)
            task.advance(TaskState.RUNNING, eng.now(), eng.profiler)
            self.stats["launched"] += 1
            wt = task.description.walltime
            if wt > 0.0:
                eng.schedule(wt, self._enforce_walltime, task, attempt)
        try:
            with spans.span("payload", args={"uid": task.uid,
                                             "stage": task.description.stage,
                                             "backend": self.name}):
                result = self._payload(task)
        except Exception as e:                                # noqa: BLE001
            err = f"{type(e).__name__}: {e}"
            with eng.lock:
                self._active -= 1
                # the attempt guard discards a stale thread's commit: the
                # task may have been failed by chaos/walltime, requeued,
                # and relaunched as a newer attempt while this payload ran
                if not task.done and task.attempt == attempt:
                    self._running_tasks.pop(task.uid, None)
                    task.error = err
                    task.advance(TaskState.FAILED, eng.now(), eng.profiler)
                    self.stats["failed"] += 1
                    if self.on_failure:
                        self.on_failure(task, err)
            eng.notify()
            return
        with eng.lock:
            self._active -= 1
            if not task.done and task.attempt == attempt:
                self._running_tasks.pop(task.uid, None)
                task.result = result
                task.advance(TaskState.DONE, eng.now(), eng.profiler)
                self.stats["completed"] += 1
                if self.on_complete:
                    self.on_complete(task)
        eng.notify()

    def _enforce_walltime(self, task: Task, attempt: int):
        """Walltime timer fired: if that attempt is still running, fail the
        task with reason. The payload thread cannot be killed — its eventual
        commit is discarded by the done/attempt guards (cooperative
        enforcement; the worker slot frees when the payload returns)."""
        eng = self.engine
        with eng.lock:
            if (task.done or task.attempt != attempt
                    or task.uid not in self._running_tasks):
                return
            eng.profiler.record(eng.now(), task.uid, "task:walltime",
                                {"limit": task.description.walltime,
                                 "attempt": attempt})
            self.fail_task(task, "walltime exceeded")

    def _payload(self, task: Task):
        raise NotImplementedError

    def _resume_kwargs(self, task: Task, kwargs: dict) -> dict:
        """Checkpoint-restart contract: a task with ``checkpoint_dir`` gets
        a CheckpointManager injected as ``checkpoint`` and the step to
        resume from as ``resume_from`` (explicit ``description.resume_from``
        wins, else the latest checkpoint on disk; None on a cold start) —
        each only if the callable declares the keyword, mirroring the
        ``mesh`` injection. The manager is the port's
        (``repro_torch.checkpoint``), which writes the JAX package's on-disk
        format. Import is deferred: the checkpoint module pulls in torch at
        import time, which a runtime of CPU payloads need not load."""
        d = task.description
        if not d.checkpoint_dir or d.fn is None:
            return kwargs
        wants_mgr = _accepts_kw(d.fn, "checkpoint")
        wants_step = _accepts_kw(d.fn, "resume_from")
        if not (wants_mgr or wants_step):
            return kwargs
        from repro_torch.checkpoint.checkpoint import CheckpointManager
        mgr = CheckpointManager(d.checkpoint_dir, async_save=False)
        step = (d.resume_from if d.resume_from is not None
                else mgr.latest_step())
        if wants_mgr:
            kwargs["checkpoint"] = mgr
        if wants_step:
            kwargs["resume_from"] = step
        if step is not None:
            eng = self.engine
            with eng.lock:
                eng.profiler.record(eng.now(), task.uid, "task:resume",
                                    {"progress": step, "cores": d.cores})
        return kwargs

    # --------------------------------------------------------------- services
    def _run_service(self, task: Task):
        """Host a persistent service replica: this worker thread IS the
        replica for its whole lifetime — provision, signal readiness, then
        block on the replica's request queue executing ``handler(payload)``
        per request until the owning Service enqueues the stop sentinel
        (drain semantics: the sentinel is FIFO-ordered behind the queue)."""
        eng = self.engine
        svc = task.description.service
        with eng.lock:
            self._futures.pop(task.uid, None)
            self._pending_tasks.pop(task.uid, None)
            if task.done or svc is None:          # canceled while queued
                return
            self._active += 1
            self._running_tasks[task.uid] = task
            task.advance(TaskState.LAUNCHING, eng.now(), eng.profiler)
            task.advance(TaskState.PROVISIONING, eng.now(), eng.profiler)
            self.stats["launched"] += 1
            replica = svc._attach_replica(task)
            self._service_queues[task.uid] = replica.queue
        eng.notify()
        handler = svc.handler
        with eng.lock:
            if not task.done:
                task.advance(TaskState.READY, eng.now(), eng.profiler)
                svc._replica_ready(task)
        eng.notify()
        while True:
            item = replica.queue.get()
            if item is SVC_STOP:
                break
            rid, payload = item
            with eng.lock:
                if task.done:
                    # replica killed/canceled between dispatch and pickup:
                    # hand the request back for redispatch to survivors
                    # (the fault model requeues before failing)
                    svc._requeue_inflight(replica, rid,
                                          f"replica {task.uid} "
                                          f"{task.state.value}")
                    break
                svc._request_start(rid)
            try:
                result = handler(payload) if handler is not None else payload
                ok = True
            except Exception as e:                                # noqa: BLE001
                result = f"{type(e).__name__}: {e}"
                ok = False
            with eng.lock:
                svc._request_complete(replica, rid, result, ok)
            eng.notify()
        with eng.lock:
            self._active -= 1
            self._service_queues.pop(task.uid, None)
            self._running_tasks.pop(task.uid, None)
            if not task.done:
                if task.state in (TaskState.PROVISIONING, TaskState.READY,
                                  TaskState.SERVING):
                    task.advance(TaskState.DRAINING, eng.now(), eng.profiler)
                task.advance(TaskState.STOPPED, eng.now(), eng.profiler)
                self.stats["completed"] += 1
                if self.on_complete:
                    self.on_complete(task)
        eng.notify()

    def stop_service(self, task: Task):
        """Unblock a hosted replica's serve loop (the Service normally does
        this itself via the replica queue; this is the generic surface)."""
        q = self._service_queues.get(task.uid)
        if q is not None:
            q.put(SVC_STOP)

    def fail_task(self, task: Task, reason: str = "executor kill") -> bool:
        """Fault injection: fail one hosted task (batch payload or service
        replica) through the normal on_failure path. For a replica, the
        owning Service recovers its queued requests inside the on_failure
        callback (same lock acquisition), and the stop sentinel — enqueued
        after recovery so it is not swallowed by the queue drain — unblocks
        the serve loop."""
        eng = self.engine
        with eng.lock:
            if task.done:
                return False
            fut = self._futures.pop(task.uid, None)
            if fut is not None:
                fut.cancel()
            self._pending_tasks.pop(task.uid, None)
            self._running_tasks.pop(task.uid, None)
            task.error = f"{self.name}: {reason}"
            task.advance(TaskState.FAILED, eng.now(), eng.profiler)
            self.stats["failed"] += 1
            if self.on_failure:
                self.on_failure(task, task.error)
            q = self._service_queues.get(task.uid)
            if q is not None:              # unblock the replica's loop
                q.put(SVC_STOP)
        eng.notify()
        return True

    def running_tasks(self) -> List[Task]:
        with self.engine.lock:
            return list(self._running_tasks.values())

    def fail_node(self, node: int, reason: str = "node failure"
                  ) -> Optional[List[Task]]:
        """Real backends have no node pools (a worker thread stands in for
        a node): emulate a node loss by shrinking the worker pool by one
        and failing one running payload, if any. Node ids are nominal
        here; returns None once the pool is down to its last worker."""
        eng = self.engine
        with eng.lock:
            if self.workers <= 1:
                return None
            self.workers -= 1
            victims = list(self._running_tasks.values())[:1]
        for t in victims:
            self.fail_task(t, reason)
        return victims

    def evacuate(self) -> List[Task]:
        """Pilot death: cancel queued payloads (returned for requeue to
        surviving pilots) and fail running ones through on_failure. A
        future that refuses to cancel is already entering ``_run``; failing
        its task now means the worker thread sees a terminal state under
        the lock and returns without launching. Payload threads already
        executing cannot be killed — their eventual commits are discarded
        by the done/attempt guards."""
        eng = self.engine
        with eng.lock:
            orphans: List[Task] = []
            doomed: List[Task] = []
            for uid, task in list(self._pending_tasks.items()):
                fut = self._futures.get(uid)
                if fut is None or fut.cancel():
                    self._futures.pop(uid, None)
                    self._pending_tasks.pop(uid, None)
                    if not task.done:
                        orphans.append(task)
                else:
                    doomed.append(task)
            doomed.extend(self._running_tasks.values())
        for t in doomed:
            self.fail_task(t, "executor failure")
        self.alive = False
        self._pool.shutdown(wait=False, cancel_futures=True)
        eng.notify()
        return orphans

    # --------------------------------------------------------------- control
    def cancel(self, task: Task):
        eng = self.engine
        with eng.lock:
            fut = self._futures.pop(task.uid, None)
            if fut is not None:
                fut.cancel()
            self._pending_tasks.pop(task.uid, None)
            self._running_tasks.pop(task.uid, None)
            if not task.done:
                # a still-running payload sees the terminal state at commit
                # time and discards its result
                task.advance(TaskState.CANCELED, eng.now(), eng.profiler)
            q = self._service_queues.get(task.uid)
            if q is not None:                  # unblock the replica's loop
                q.put(SVC_STOP)
        eng.notify()

    def shutdown(self):
        # unblock hosted service replicas first: their threads block on
        # queue.get and would otherwise keep the interpreter alive
        for q in list(self._service_queues.values()):
            q.put(SVC_STOP)
        # cancel_futures: queued-but-unstarted payloads must not launch
        # after the session is closed
        self._pool.shutdown(wait=False, cancel_futures=True)

    # ----------------------------------------------------------------- stats
    @property
    def queue_depth(self) -> int:
        return len(self._futures)

    @property
    def free_cores(self) -> int:
        return max(0, self.workers - self._active)

    @property
    def total_cores(self) -> int:
        return self.workers


class RealFunctionExecutor(RealExecutorBase):
    """Dragon-style in-process function executor (thread pool). Also hosts
    service replicas (each occupies one worker thread for its lifetime —
    size ``workers`` above the replica count so batch tasks still flow)."""

    kind = "dragon"
    accepts_static = True
    supports_services = True

    def __init__(self, engine, nodes: int = 1, spec=None, workers: int = 4,
                 name: str = "dragon", **_):
        super().__init__(engine, name, workers, thread_prefix="dragon")

    def accepts(self, task: Task) -> bool:
        d = task.description
        if d.kind == "service":
            return d.nodes == 0
        return d.fn is not None and d.nodes == 0

    def _payload(self, task: Task):
        d = task.description
        if d.fn is None:
            return None
        kwargs = self._resume_kwargs(task, dict(d.kwargs))
        return d.fn(*d.args, **kwargs)


class RealPartitionExecutor(RealExecutorBase):
    """Flux-style co-scheduling executor: one task owns a partition (a
    device mesh) at a time; partitions run concurrently, each task inside
    its partition mesh's placement, or, on a partition of several local
    devices, on a group of ranks spawned over them (``_run_on_ranks``)."""

    kind = "flux"
    accepts_static = True

    def __init__(self, engine, nodes: int = 1, spec=None,
                 partitions: int = 1, mesh=None, name: str = "flux", **_):
        self.partitions = (carve_submeshes(mesh, partitions)
                           if mesh is not None else [None] * partitions)
        super().__init__(engine, name, len(self.partitions),
                         thread_prefix="flux")
        self._part_q: "queue.Queue" = queue.Queue()
        for p in self.partitions:
            self._part_q.put(p)
        self._groups: Dict[str, object] = {}     # uid -> its live RankGroup
        # uid -> the last rank group's summary (backend, spawn_s, wall_s,
        # pids, each rank's report: device, launches, peak memory)
        self.rank_groups: Dict[str, dict] = {}

    def accepts(self, task: Task) -> bool:
        return task.description.fn is not None

    def _payload(self, task: Task):
        part = self._part_q.get()        # co-schedule: own one partition
        try:
            d = task.description
            task.partition = getattr(part, "index", None)
            if (part is not None and part.mesh.devices is not None
                    and part.mesh.size > 1):
                return self._run_on_ranks(task, part)
            kwargs = dict(d.kwargs)
            if part is not None and _accepts_kw(d.fn, "mesh"):
                kwargs["mesh"] = part.mesh
            kwargs = self._resume_kwargs(task, kwargs)
            if not d.fn:
                return None
            if part is None:
                return d.fn(*d.args, **kwargs)
            with part.mesh.placement():
                return d.fn(*d.args, **kwargs)
        finally:
            # a rank group has ended every rank by now: the next task
            # never shares the partition's cards with a dying group
            self._part_q.put(part)

    def _run_on_ranks(self, task: Task, part):
        """The task on a group of ranks over the partition's devices: each
        rank calls it with ``mesh=`` the group's mesh and the checkpoint
        keywords (a picklable manager of ``checkpoint_dir``, the same
        ``resume_from`` on every rank); returns rank 0's value. A callable
        or argument that does not pickle, a rank's error or death, the
        walltime, ``fail_task`` and ``cancel`` fail the task; it never runs
        in this thread, on fewer devices or on another backend instead."""
        from repro_torch.launch.ranks import RankGroup
        d = task.description
        kwargs = self._resume_kwargs(task, dict(d.kwargs))
        group = RankGroup(part.mesh, d.fn, d.args, kwargs)
        eng = self.engine
        with eng.lock:
            if task.done:                 # failed or canceled meanwhile
                return None
            self._groups[task.uid] = group
        try:
            return group.run()        # the walltime kills it (fail_task)
        finally:
            with eng.lock:
                self._groups.pop(task.uid, None)
                self.rank_groups[task.uid] = group.summary()

    def _kill_group(self, task: Task, reason: str):
        with self.engine.lock:
            group = self._groups.get(task.uid)
        if group is not None:
            group.kill(reason)

    def fail_task(self, task: Task, reason: str = "executor kill") -> bool:
        """As the base's, and the task's rank group, if it has one, is
        killed (its partition frees once every rank has exited)."""
        failed = super().fail_task(task, reason)
        self._kill_group(task, reason)
        return failed

    def cancel(self, task: Task):
        super().cancel(task)
        self._kill_group(task, "canceled")

    def shutdown(self):
        with self.engine.lock:
            groups = list(self._groups.values())
        for group in groups:
            group.kill("session closed")
        super().shutdown()


class SubprocessExecutor(RealExecutorBase):
    """Launches ``TaskDescription.executable`` + ``arguments`` as a host
    subprocess — the real analogue of launching executable tasks through a
    batch runtime. Nonzero exit codes fail the task (and feed the agent's
    retry path); stdout becomes ``task.result``."""

    kind = "popen"
    accepts_static = True

    def __init__(self, engine, nodes: int = 1, spec=None, workers: int = 4,
                 timeout: Optional[float] = None, name: str = "popen", **_):
        super().__init__(engine, name, workers, thread_prefix="popen")
        self.timeout = timeout

    def accepts(self, task: Task) -> bool:
        return bool(task.description.executable)

    def _payload(self, task: Task):
        d = task.description
        argv: List[str] = [d.executable, *map(str, d.arguments)]
        # per-task walltime actually kills the subprocess (unlike pure
        # python payloads, which are only failed cooperatively)
        timeout = d.walltime if d.walltime > 0.0 else self.timeout
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"exit {proc.returncode}: {proc.stderr.strip()[:500]}")
        return proc.stdout


def _funcpool_worker(task_q, result_q):
    """Persistent worker loop: pull one pickled *batch* of
    (uid, attempt, fn, args, kwargs) jobs per queue op, execute them
    in-process, and push one pickled batch of
    (uid, attempt, ok, result, t0, t1) records back — the
    mp.Queue round-trip (lock, pipe write, feeder wakeup) is paid once per
    batch instead of once per call, which is what moves the pool from the
    ~1-2k calls/s queue-bound regime toward the 10k+/s on-node rate the
    Dragon paper reports. Runs until the ``None`` sentinel. Payloads cross
    the queues as explicit pickle blobs so serialization errors surface
    synchronously at the pickling site instead of dying in a queue feeder
    thread. Lives at module level so it pickles under any multiprocessing
    start method."""
    import pickle

    while True:
        item = task_q.get()
        if item is None:
            break
        jobs = pickle.loads(item)
        out = []
        for uid, attempt, fn, args, kwargs in jobs:
            t0 = time.monotonic()
            try:
                result = fn(*args, **(kwargs or {}))
                ok = True
            except BaseException as e:                            # noqa: BLE001
                result = f"{type(e).__name__}: {e}"
                ok = False
            t1 = time.monotonic()
            out.append((uid, attempt, ok, result, t0, t1))
        try:
            blob = pickle.dumps(out)
        except Exception:                  # unpicklable result   # noqa: BLE001
            safe = []
            for uid, attempt, ok, result, t0, t1 in out:
                try:
                    pickle.dumps(result)
                except Exception as e:                            # noqa: BLE001
                    result, ok = f"unpicklable result: {e}", False
                safe.append((uid, attempt, ok, result, t0, t1))
            blob = pickle.dumps(safe)
        result_q.put(blob)


class FuncPoolExecutor(BaseExecutor):
    """Raptor/Dragon-style master/worker function execution over persistent
    OS processes: workers are spawned once at ``start()`` and dispatch
    happens over shared queues — executing a call never forks, so throughput
    is queue-bound instead of process-spawn-bound (~100/s), which is exactly
    the paper's function-mode speedup. Jobs cross the queue as *batched*
    pickle blobs (one blob per ``batch`` jobs per mp.Queue op) and the
    collector thread sizes its commits adaptively, so at saturation the
    per-call cost is a slice of one queue round-trip rather than a whole
    one. The collector converts worker completion records into
    task-pipeline transitions (timestamps mapped from the workers'
    CLOCK_MONOTONIC stamps onto the engine clock), committed under
    ``engine.lock`` like every other real backend."""

    kind = "funcpool"
    accepts_static = True

    def __init__(self, engine, nodes: int = 1, spec=None,
                 workers: Optional[int] = None, start_method: str = "",
                 batch: int = 128, name: str = "funcpool", **_):
        super().__init__(name)
        self.engine = engine
        self.workers = workers or min(4, os.cpu_count() or 1)
        # jobs pickled per mp.Queue op (one blob per batch, not per call);
        # a batch executes on one worker, so very uneven payload durations
        # may warrant a smaller batch to rebalance
        self.batch = max(1, batch)
        methods = mp.get_all_start_methods()
        self._ctx = mp.get_context(
            start_method or ("fork" if "fork" in methods else "spawn"))
        self._inflight: Dict[str, Task] = {}
        self._procs: List[mp.Process] = []
        self._task_q = None
        self._result_q = None
        self._collector: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> float:
        # mp.Queue, not SimpleQueue: its feeder thread makes put()
        # non-blocking, which matters because submits happen under
        # engine.lock — a bounded-pipe put blocking there while the
        # collector needs the same lock to drain results would deadlock
        self._task_q = self._ctx.Queue()
        self._result_q = self._ctx.Queue()
        for _ in range(self.workers):
            p = self._ctx.Process(target=_funcpool_worker,
                                  args=(self._task_q, self._result_q),
                                  daemon=True)
            p.start()
            self._procs.append(p)
        self._collector = threading.Thread(target=self._collect,
                                           name=f"{self.name}-collector",
                                           daemon=True)
        self._collector.start()
        self.alive = True
        return 0.0

    def accepts(self, task: Task) -> bool:
        d = task.description
        return d.kind == "function" and d.fn is not None and d.nodes == 0

    # ---------------------------------------------------------------- submit
    def submit(self, task: Task):
        """Called under ``engine.lock`` (agent dispatch tick)."""
        self._submit_batch([task])

    def submit_many(self, tasks: List[Task]):
        """Bulk path: the whole dispatch-tick bulk is pickled in job
        batches, one blob per mp.Queue op, so the queue overhead amortizes
        across the batch. A blob executes serially on one worker, so the
        batch size is capped at bulk/workers — a bulk smaller than
        ``batch x workers`` still spreads across the whole pool. A batch
        containing an unpicklable payload falls back to per-task
        submission so only the offending task fails."""
        n = len(tasks)
        batch = min(self.batch,
                    max(1, (n + self.workers - 1) // self.workers))
        for i in range(0, n, batch):
            self._submit_batch(tasks[i:i + batch])

    def _submit_batch(self, tasks: List[Task]):
        eng = self.engine
        import pickle
        for task in tasks:
            task.backend = self.name
        try:
            # explicit dumps: an unpicklable payload fails here,
            # synchronously, instead of dying in a queue feeder thread
            for t in tasks:
                t.attempt += 1
            blob = pickle.dumps([(t.uid, t.attempt, t.description.fn,
                                  t.description.args, t.description.kwargs)
                                 for t in tasks])
        except Exception as e:                                    # noqa: BLE001
            if len(tasks) > 1:             # isolate the offending payload
                for t in tasks:
                    self._submit_batch([t])
                return
            task = tasks[0]
            task.error = f"{self.name}: unpicklable payload: {e}"
            task.advance(TaskState.FAILED, eng.now(), eng.profiler)
            self.stats["failed"] += 1
            if self.on_failure:
                self.on_failure(task, task.error)
            eng.notify()
            return
        self._task_q.put(blob)
        inflight = self._inflight
        now = eng.now()
        profiler = eng.profiler
        for t in tasks:
            inflight[t.uid] = t
            t.advance(TaskState.LAUNCHING, now, profiler)
        self.stats["launched"] += len(tasks)

    def _collect(self):
        import pickle

        eng = self.engine
        result_q = self._result_q
        from_monotonic = eng.clock.from_monotonic
        stop = False
        target = 64
        while not stop:
            # accumulate records (each queue item is a batch) up to an
            # adaptive per-commit target: it doubles while the queue stays
            # hot — fewer lock acquisitions per record under load — and
            # shrinks toward 32 when results trickle, keeping latency low
            item = result_q.get()
            records = []
            if item is None:
                stop = True
            else:
                records.extend(pickle.loads(item))
            while len(records) < target and not result_q.empty():
                item = result_q.get()
                if item is None:
                    stop = True
                    break
                records.extend(pickle.loads(item))
            target = (min(target * 2, 2048) if len(records) >= target
                      else max(target // 2, 32))
            if not records:
                continue
            with eng.lock:
                for uid, attempt, ok, result, t0, t1 in records:
                    task = self._inflight.get(uid)
                    # the attempt guard keeps a stale record (task failed by
                    # chaos, requeued, resubmitted here as a newer attempt)
                    # from committing against the live attempt
                    if (task is None or task.done
                            or task.attempt != attempt):
                        continue
                    self._inflight.pop(uid, None)
                    task.advance(TaskState.RUNNING, from_monotonic(t0),
                                 eng.profiler)
                    if ok:
                        task.result = result
                        task.advance(TaskState.DONE, from_monotonic(t1),
                                     eng.profiler)
                        self.stats["completed"] += 1
                        if self.on_complete:
                            self.on_complete(task)
                    else:
                        task.error = str(result)
                        task.advance(TaskState.FAILED, from_monotonic(t1),
                                     eng.profiler)
                        self.stats["failed"] += 1
                        if self.on_failure:
                            self.on_failure(task, task.error)
            eng.notify()

    # ---------------------------------------------------------------- control
    def cancel(self, task: Task):
        """A job already in the shared queue cannot be recalled; mark the
        task terminal and the collector discards its eventual result."""
        eng = self.engine
        with eng.lock:
            self._inflight.pop(task.uid, None)
            if not task.done:
                task.advance(TaskState.CANCELED, eng.now(), eng.profiler)
        eng.notify()

    def fail_task(self, task: Task, reason: str = "executor kill") -> bool:
        """Fault injection: an in-flight mp job cannot be recalled or
        killed individually, so fail the task through on_failure and let
        the collector's attempt guard discard the worker's eventual record.
        Per-task walltime is likewise unenforceable on this backend — use
        the thread-pool backends for walltime-sensitive payloads."""
        eng = self.engine
        with eng.lock:
            if task.done:
                return False
            self._inflight.pop(task.uid, None)
            task.error = f"{self.name}: {reason}"
            task.advance(TaskState.FAILED, eng.now(), eng.profiler)
            self.stats["failed"] += 1
            if self.on_failure:
                self.on_failure(task, task.error)
        eng.notify()
        return True

    def running_tasks(self) -> List[Task]:
        with self.engine.lock:
            return list(self._inflight.values())

    def evacuate(self) -> List[Task]:
        """Pilot death: the worker processes die with the pilot, so every
        in-flight job fails through on_failure (nothing is recallable from
        the shared mp queue — no orphans to hand back)."""
        eng = self.engine
        with eng.lock:
            victims = list(self._inflight.values())
        for t in victims:
            self.fail_task(t, "executor failure")
        self.shutdown()
        return []

    def shutdown(self):
        if not self.alive:
            return
        self.alive = False
        for _ in self._procs:
            self._task_q.put(None)
        self._result_q.put(None)           # collector exits; late results drop
        for p in self._procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
        if self._collector is not None:
            self._collector.join(timeout=1.0)

    # ------------------------------------------------------------------ stats
    @property
    def queue_depth(self) -> int:
        return len(self._inflight)

    @property
    def free_cores(self) -> int:
        return max(0, self.workers - len(self._inflight))

    @property
    def total_cores(self) -> int:
        return self.workers


@register_executor("dragon", mode="real")
def _build_real_dragon(engine, nodes=1, spec=None, **options):
    return RealFunctionExecutor(engine, nodes=nodes, spec=spec, **options)


@register_executor("funcpool", mode="real")
def _build_real_funcpool(engine, nodes=1, spec=None, **options):
    return FuncPoolExecutor(engine, nodes=nodes, spec=spec, **options)


@register_executor("flux", mode="real")
def _build_real_flux(engine, nodes=1, spec=None, **options):
    return RealPartitionExecutor(engine, nodes=nodes, spec=spec, **options)


@register_executor("popen", mode="real")
def _build_popen(engine, nodes=1, spec=None, **options):
    return SubprocessExecutor(engine, nodes=nodes, spec=spec, **options)
