"""The RP-style Agent: owns the pilot's resources, instantiates multiple
runtime backends concurrently, routes tasks by execution model, and handles
retries / failover / stragglers (§3).

The agent is engine-agnostic: it talks to an abstract ``Engine`` (clock +
scheduler + profiler + RNG — see ``repro_torch.runtime.engine``), so the same
dispatch pipeline drives the discrete-event ``SimEngine`` (paper-scale
simulation) and the wall-clock ``RealEngine`` (payloads execute on this
host). Backends are resolved through ``repro_torch.runtime.registry``; registering
a new executor requires no edits here.

The agent's dispatch pipeline is itself a service queue (RP's
task-management subsystem, ~1600 tasks/s ceiling — §4.1.5) and dispatches in
bulk per tick (RP's task-manager bulk path), so end-to-end throughput
saturates exactly where the paper measures it while the simulator spends
O(1/batch) events per task on dispatch.
"""
from __future__ import annotations

import dataclasses
import gc
import os
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import calibration as CAL
from repro_torch.core import cohort as _cohort
from repro_torch.core.executors.base import BaseExecutor
from repro_torch.core.resources import NodeSpec
from repro_torch.core.task import (DescriptionBatch, DescView, Task,
                                   TaskDescription, TaskState, _STATE_EVENT)
from repro_torch.runtime.engine import (Engine, RealEngine,  # noqa: F401
                                        SimEngine)
from repro_torch.runtime.registry import create_executor


class RoutingPolicy:
    """Task-type-aware backend selection (§3.1): explicit override first,
    then modality/coupling match, then fallback order, then any backend
    that accepts the task (covers registry-added custom backends)."""

    def __init__(self, order=("flux", "dragon", "srun")):
        self.order = order

    def route(self, task: Task, backends: Dict[str, BaseExecutor]) -> str:
        d = task.description
        if d.backend and d.backend in backends:
            return d.backend
        if d.kind == "service":
            # persistent replicas only run on service-capable backends
            for name in self.order:
                ex = backends.get(name)
                if (ex is not None and ex.supports_services
                        and ex.accepts(task)):
                    return name
            for name, ex in backends.items():
                if ex.supports_services and ex.accepts(task):
                    return name
            raise RuntimeError(
                f"no service-capable backend for task {task.uid}")
        if d.executable and "popen" in backends:
            return "popen"
        if (d.kind == "function" and "funcpool" in backends
                and backends["funcpool"].accepts(task)):
            # in-worker function execution beats per-task launch when a
            # function pool is configured (Raptor/Dragon function mode)
            return "funcpool"
        if d.kind == "function" and "dragon" in backends:
            return "dragon"
        if (d.nodes or d.coupling == "tight"):
            for name in ("flux", "srun"):
                if name in backends:
                    return name
        for name in self.order:
            if name in backends and backends[name].accepts(task):
                return name
        for name, ex in backends.items():
            if ex.accepts(task):
                return name
        raise RuntimeError(f"no backend accepts task {task.uid}")


class AdaptiveRoutingPolicy(RoutingPolicy):
    """Dynamic backend selection — the paper's §6 future work, implemented.

    For *loose* tasks that more than one backend could serve, route to the
    backend with the lowest estimated time-to-launch = queue depth /
    observed completion rate (EWMA over inter-completion gaps). Tight /
    multi-node / explicitly-routed tasks keep the static modality rules.
    The agent feeds observations via ``observe_completion``.
    """

    def __init__(self, order=("flux", "dragon", "srun"), ewma: float = 0.2):
        super().__init__(order)
        self.ewma = ewma
        self._rate: Dict[str, float] = {}
        self._last_done: Dict[str, float] = {}
        # static-fallback memo: super().route() walks the full modality
        # rule chain; on the hot dispatch path its result only depends on
        # these description fields, so compute it once per shape (only
        # when every backend declares accepts_static — see BaseExecutor)
        self._static_cache: Dict[tuple, str] = {}
        self._cache_backends_id: Optional[int] = None
        self._cacheable = False

    def observe_completion(self, backend: str, now: float):
        last = self._last_done.get(backend)
        self._last_done[backend] = now
        if last is None or now <= last:
            return
        inst = 1.0 / (now - last)
        prev = self._rate.get(backend, inst)
        self._rate[backend] = (1 - self.ewma) * prev + self.ewma * inst

    def route(self, task: Task, backends: Dict[str, BaseExecutor]) -> str:
        d = task.description
        if (d.backend or d.nodes or d.coupling == "tight"
                or len(backends) == 1):
            return super().route(task, backends)
        if self._cache_backends_id != id(backends):
            self._static_cache.clear()
            self._cache_backends_id = id(backends)
            self._cacheable = all(getattr(ex, "accepts_static", False)
                                  for ex in backends.values())
        if self._cacheable:
            key = (d.kind, bool(d.executable), d.fn is not None)
            default = self._static_cache.get(key)
            if default is None:
                default = self._static_cache[key] = super().route(task,
                                                                  backends)
        else:
            default = super().route(task, backends)
        eligible = [n for n, ex in backends.items() if ex.accepts(task)]
        if len(eligible) <= 1:
            return default

        def wait_estimate(name: str) -> float:
            ex = backends[name]
            rate = self._rate.get(name, 0.0)
            if rate <= 0.0:
                # no completions observed yet: seed with the nominal
                # service-model rate (refined online by the EWMA)
                nominal = getattr(ex, "nominal_rate", None)
                rate = nominal() if nominal is not None else 1.0
            est = ex.queue_depth / max(rate, 1e-9)
            if name == default:
                est *= 0.99          # tie-break toward the modality match
            return est

        return min(eligible, key=wait_estimate)


class Agent:
    """Pilot agent running over an Engine (simulated or real)."""

    def __init__(self, engine: Engine, n_nodes: int,
                 backends: Dict[str, Dict[str, Any]],
                 node_spec: NodeSpec = NodeSpec(cores=CAL.CORES_PER_NODE,
                                                gpus=CAL.GPUS_PER_NODE),
                 policy: Optional[RoutingPolicy] = None,
                 dispatch_rate: float = CAL.RP_DISPATCH_RATE,
                 dispatch_batch: int = CAL.RP_DISPATCH_BATCH,
                 speculation: bool = False,
                 speculation_factor: float = 3.0,
                 speculation_quantile: float = 0.95,
                 speculation_min_samples: int = 10,
                 cohort: bool = True,
                 cohort_min: int = 50_000,
                 retry_backoff: float = 0.0,
                 retry_backoff_max: float = 60.0,
                 retry_jitter: float = 0.0):
        self.engine = engine
        self.n_nodes = n_nodes
        self.node_spec = node_spec
        self.policy = policy or RoutingPolicy()
        self.dispatch_interval = 1.0 / dispatch_rate
        self.dispatch_batch = max(1, dispatch_batch)
        self.speculation = speculation
        self.speculation_factor = speculation_factor
        self.speculation_quantile = speculation_quantile
        self.speculation_min_samples = max(1, speculation_min_samples)
        # retry backoff: attempt n waits min(base * 2^(n-1), cap), plus a
        # uniform jitter fraction to decorrelate retry storms. base = 0
        # keeps the seed's immediate synchronous requeue bit-exactly (no
        # RNG draw, no scheduled event).
        self.retry_backoff = retry_backoff
        self.retry_backoff_max = retry_backoff_max
        self.retry_jitter = retry_jitter
        self._retry_pending: Dict[str, Task] = {}   # parked on a backoff timer
        # while evacuate() runs, failed tasks are collected here instead of
        # being retried/finished — the failing pilot must not advance them
        self._evacuating: Optional[List[Task]] = None

        # cohort fast path (repro_torch.core.cohort): eligible homogeneous bulks
        # of >= cohort_min tasks are planned closed-form instead of running
        # the object state machine; REPRO_COHORT=0 force-disables globally
        self._cohort = cohort and os.environ.get("REPRO_COHORT", "1") != "0"
        self._cohort_min = max(1, cohort_min)
        self.cohorts: List[Any] = []      # planned TaskCohort columns
        self._cohort_n = 0                # members across all cohorts
        self._cohort_done = 0             # terminal members (event-advanced)

        self.tasks: Dict[str, Task] = {}
        self._dispatch_q: deque = deque()
        self._dispatch_busy = False
        # exact count of tasks in a terminal state (DONE/FAILED/CANCELED):
        # maintained by _finish plus the cancel sites below, so completion
        # predicates are O(1) instead of scanning every task per event
        self._n_terminal = 0
        self.ready_at = 0.0
        # single-slot legacy hook; use add_done_callback for composable
        # listeners (campaigns, service readiness watchers, ...)
        self.on_task_done: Optional[Callable[[Task], None]] = None
        self._done_callbacks: List[Callable[[Task], None]] = []
        # parallel to _done_callbacks: each entry is a zero-arg probe
        # declaring the callback safe to skip for cohort members (or None
        # = never safe, which disables the cohort path while registered)
        self._cb_cohort_safe: List[Optional[Callable[[], bool]]] = []
        self._spec_watch: Dict[str, Any] = {}
        self._spec_clones: Dict[str, Task] = {}
        # duration-free speculation (ROADMAP: RealEngine stragglers): the
        # observed RUNNING->DONE durations feed a trace quantile that stands
        # in for the missing description.duration as the deadline base
        self._obs_durations: List[float] = []
        self._spec_pending: Dict[str, Task] = {}   # awaiting a quantile
        self._quantile_memo: Optional[tuple] = None  # (n_obs, deadline)
        self._observe_completion = getattr(self.policy, "observe_completion",
                                           None)

        self.backends: Dict[str, BaseExecutor] = {}
        self._build_backends(backends)
        # routing is memoizable per description shape only when the policy
        # is the static built-in AND every backend declares accepts() a
        # pure function of the keyed description fields (accepts_static);
        # dynamic policies / custom accepts() run route() per task
        self._route_cache: Optional[Dict[tuple, str]] = (
            {} if (type(self.policy) is RoutingPolicy
                   and all(ex.accepts_static
                           for ex in self.backends.values()))
            else None)

    # ------------------------------------------------------------ construction
    def _build_backends(self, cfg: Dict[str, Dict[str, Any]]):
        # resource split: explicit "nodes" per backend, else equal split
        unassigned = [n for n, c in cfg.items() if "nodes" not in c]
        assigned = sum(c.get("nodes", 0) for c in cfg.values())
        share = ((self.n_nodes - assigned) // len(unassigned)
                 if unassigned else 0)
        for name, c in cfg.items():
            options = dict(c)
            nodes = options.pop("nodes", share)
            ex = create_executor(name, self.engine, nodes=nodes,
                                 spec=self.node_spec, **options)
            ex.on_complete = self._task_completed
            ex.on_failure = self._task_failed
            self.backends[name] = ex

    def start(self):
        """Bootstrap all backends concurrently (overhead = max, not sum)."""
        t0 = self.engine.now()
        self.engine.profiler.record(t0, "agent", "agent:start", {})
        for name, ex in self.backends.items():
            overhead = ex.start()
            ex.ready_at = t0 + self.engine.startup_overhead_s + overhead
            self.engine.profiler.record(ex.ready_at, name, "executor:ready",
                                        {"overhead": overhead})
        self.ready_at = max(ex.ready_at for ex in self.backends.values())

    # ---------------------------------------------------------------- submit
    def submit(self, descriptions, cohort: Optional[bool] = None):
        """Submit a bulk of task descriptions — a ``List[TaskDescription]``
        or a columnar :class:`~repro_torch.core.task.DescriptionBatch`. Returns a
        list of ``Task`` objects — or, when the bulk is large and
        homogeneous enough for the vectorized cohort path (see
        ``repro_torch.core.cohort``), a :class:`repro_torch.core.task.CohortWave` (same
        iteration surface, lazy per-task views). Batches always try the
        cohort planner (a batch is an explicit bulk, like ``submit_wave``);
        lists only at ``cohort_min`` size. ``cohort=False`` forces the
        object path for this call."""
        use_cohort = self._cohort if cohort is None else (self._cohort
                                                          and cohort)
        if isinstance(descriptions, DescriptionBatch):
            if use_cohort:
                with self.engine.lock:
                    wave = _cohort.try_plan_batch(self, descriptions)
                if wave is not None:
                    return wave
            return self._submit_batch_objects(descriptions)
        if use_cohort and len(descriptions) >= self._cohort_min:
            with self.engine.lock:
                wave = _cohort.try_plan(self, descriptions)
            if wave is not None:
                return wave
        out = []
        engine = self.engine
        with engine.lock:
            # pause cyclic GC for the bulk ingestion storm: allocating n
            # tasks otherwise triggers O(n/threshold) generational
            # collections, each rescanning the growing live set
            gc_was_enabled = gc.isenabled()
            if gc_was_enabled:
                gc.disable()
            try:
                now = engine.now
                profiler = engine.profiler
                tasks = self.tasks
                append = self._dispatch_q.append
                for d in descriptions:
                    task = Task(d)
                    tasks[task.uid] = task
                    task.advance(TaskState.SCHEDULING, now(), profiler)
                    append(task)
                    out.append(task)
                self._pump_dispatch()
            finally:
                if gc_was_enabled:
                    gc.enable()
        return out

    def _submit_batch_objects(self, batch: DescriptionBatch) -> List[Task]:
        """Object-path ingestion of a batch: one ``Task`` per row over a
        lazy :class:`DescView` (no description objects), with the whole
        bulk's SCHEDULING transition stamped via one entity-block
        reservation plus one ``record_fast_many`` — no per-task trace
        appends, no per-task uid interning."""
        engine = self.engine
        n = batch.n
        out: List[Task] = []
        with engine.lock:
            gc_was_enabled = gc.isenabled()
            if gc_was_enabled:
                gc.disable()
            try:
                now = engine.now()
                profiler = engine.profiler
                tasks = self.tasks
                append = self._dispatch_q.append
                base = profiler.reserve_entities(n, batch.uid)
                st = TaskState.SCHEDULING
                nids = profiler.memo_nids
                nid = nids.get(st)
                if nid is None:
                    nid = nids[st] = profiler.name_id(_STATE_EVENT[st])
                profiler.reserve_rows(n)
                profiler.record_fast_many(
                    np.full(n, now),
                    np.arange(base, base + n, dtype=np.int64), nid)
                view = batch.view
                for i in range(n):
                    task = Task(view(i))
                    task.state = st
                    task.timestamps["SCHEDULING"] = now
                    task._trace_prof = profiler
                    task._trace_eid = base + i
                    tasks[task.uid] = task
                    append(task)
                    out.append(task)
                self._pump_dispatch()
            finally:
                if gc_was_enabled:
                    gc.enable()
        return out

    def submit_prepared(self, prepared) -> List[Task]:
        """Ingest Task objects built (and possibly held) by a campaign
        scheduler (repro_torch.sched). Tasks already advanced to SCHEDULING at
        scheduler admission keep that timestamp — their measured wait
        covers the scheduler hold, not just the dispatch queue. A
        :class:`DescriptionBatch` is accepted too: its rows enter as fresh
        object tasks (bulk-stamped SCHEDULING now), bypassing the cohort
        planner — prepared submission implies the caller already did
        admission."""
        if isinstance(prepared, DescriptionBatch):
            return self._submit_batch_objects(prepared)
        engine = self.engine
        with engine.lock:
            gc_was_enabled = gc.isenabled()
            if gc_was_enabled:
                gc.disable()
            try:
                now = engine.now
                profiler = engine.profiler
                tasks = self.tasks
                append = self._dispatch_q.append
                for task in prepared:
                    tasks[task.uid] = task
                    if task.state is TaskState.NEW:
                        task.advance(TaskState.SCHEDULING, now(), profiler)
                    append(task)
                self._pump_dispatch()
            finally:
                if gc_was_enabled:
                    gc.enable()
        return prepared

    def submit_wave(self, template: TaskDescription, n: int):
        """Submit ``n`` clones of ``template`` without materializing ``n``
        descriptions: the wave is one all-scalar ``DescriptionBatch``
        (every column a shared scalar, uids a reserved block), planned
        closed-form by the cohort planner when eligible and ingested as
        object tasks over lazy row views otherwise — O(1) memory per task
        at submit either way. Returns a ``CohortWave`` or a list of
        tasks."""
        if n <= 0:
            return []
        return self.submit(DescriptionBatch.from_template(template, n))

    def resubmit(self, descriptions: List[TaskDescription],
                 origin: str = "") -> List[Task]:
        """Resubmission hook for the service fault model: replica restarts
        and autoscale provisions re-enter the normal dispatch pipeline here
        (routing, placement, resource allocation — exactly like a first
        submission), with an ``agent:resubmit`` trace event carrying the
        lineage so recovery overhead is measurable per the RP
        characterization protocol."""
        tasks = self.submit(descriptions, cohort=False)
        self._record_resubmit(tasks, origin)
        return tasks

    def resubmit_prepared(self, prepared: List[Task],
                          origin: str = "") -> List[Task]:
        """`submit_prepared` + the ``agent:resubmit`` lineage trace — the
        scheduler-mediated variant of :meth:`resubmit`."""
        self.submit_prepared(prepared)
        self._record_resubmit(prepared, origin)
        return prepared

    def _record_resubmit(self, tasks: List[Task], origin: str):
        profiler = self.engine.profiler
        now = self.engine.now()
        for t in tasks:
            profiler.record(now, t.uid, "agent:resubmit",
                            {"origin": origin
                             or (t.description.restarted_from or "")})

    def _pump_dispatch(self):
        if self._dispatch_busy or not self._dispatch_q:
            return
        self._dispatch_busy = True
        # bulk dispatch: one tick serves up to dispatch_batch tasks and is
        # charged batch x interval, holding the RP rate while spending
        # O(1/batch) scheduler events per task
        budget = min(self.dispatch_batch, len(self._dispatch_q))
        self.engine.schedule(self.dispatch_interval * budget,
                             self._dispatch_tick, budget)

    def _dispatch_tick(self, budget: int):
        self._dispatch_busy = False
        dispatched = 0
        q = self._dispatch_q
        engine = self.engine
        profiler = engine.profiler
        backends = self.backends
        policy_route = self.policy.route
        route_cache = self._route_cache
        speculation = self.speculation
        # route the whole batch first, then hand each backend its bulk in
        # one submit_many (RP's bulk path); no sim events can fire between
        # the two passes, so this is equivalent to interleaved submission
        groups: Dict[str, List[Task]] = {}
        held = False
        while q and dispatched < budget:
            task = q.popleft()
            dispatched += 1
            if task.state is TaskState.CANCELED:
                continue
            if route_cache is not None:
                d = task.description
                # key covers every description field the static rule chain
                # and the built-in accepts() predicates read
                key = (d.backend, d.kind, bool(d.executable), d.cores,
                       d.gpus, d.nodes, d.coupling, d.fn is not None)
                name = route_cache.get(key)
                if name is None:
                    name = route_cache[key] = policy_route(task, backends)
            else:
                name = policy_route(task, backends)
            ex = backends[name]
            now = engine.now()
            wait = getattr(ex, "ready_at", 0.0) - now
            if wait > 0:
                # backend still bootstrapping: hold and retry at readiness
                q.appendleft(task)
                engine.schedule(wait, self._pump_dispatch)
                held = True
                break
            task.advance(TaskState.QUEUED, now, profiler)
            grp = groups.get(name)
            if grp is None:
                groups[name] = [task]
            else:
                grp.append(task)
        for name, bulk in groups.items():
            backends[name].submit_many(bulk)
            if speculation:
                for task in bulk:
                    if (task.speculative_of is not None       # no chains
                            or task.description.kind == "service"):
                        continue
                    if task.description.duration > 0:
                        self._arm_speculation(task)
                    else:
                        # duration-free: deadline from the trace quantile
                        deadline = self._quantile_deadline()
                        if deadline is not None:
                            self._arm_speculation(task, deadline)
                        else:
                            self._spec_pending[task.uid] = task
        if not held:
            self._pump_dispatch()

    # ------------------------------------------------------------- lifecycle
    def _task_completed(self, task: Task):
        if self._observe_completion is not None and task.backend:
            self._observe_completion(task.backend, self.engine.now())
        if self._spec_clones or task.speculative_of:
            self._resolve_speculation(task)
        if self.speculation:
            self._observe_duration(task)
        self._finish(task)

    def _observe_duration(self, task: Task):
        """Feed the speculation quantile; once enough samples exist, arm the
        duration-free tasks that were parked waiting for one."""
        ts = task.timestamps
        if task.state is TaskState.DONE and "RUNNING" in ts:
            self._obs_durations.append(ts["DONE"] - ts["RUNNING"])
        if (self._spec_pending
                and len(self._obs_durations) >= self.speculation_min_samples):
            deadline = self._quantile_deadline()
            pending, self._spec_pending = self._spec_pending, {}
            for t in pending.values():
                if not t.done:
                    self._arm_speculation(t, deadline)

    def _resolve_speculation(self, task: Task):
        clone = self._spec_clones.pop(task.uid, None)
        if clone is not None and not clone.done:
            if clone.backend in self.backends:
                self.backends[clone.backend].cancel(clone)
            else:
                # clone still in the dispatch queue: cancel it directly
                clone.advance(TaskState.CANCELED, self.engine.now(),
                              self.engine.profiler)
            if clone.done:          # canceled without reaching _finish
                self._n_terminal += 1
        orig_uid = task.speculative_of
        if orig_uid:
            orig = self.tasks.get(orig_uid)
            self._spec_clones.pop(orig_uid, None)
            if orig is not None and not orig.done:
                self.backends[orig.backend].cancel(orig)
                if orig.done:       # canceled without reaching _finish
                    self._n_terminal += 1
                orig.result = task.result

    @staticmethod
    def _failure_cause(err: str) -> str:
        err = err or ""
        if "walltime" in err:
            return "walltime"
        if "node failure" in err:
            return "node"
        if "pilot failure" in err or "executor failure" in err:
            return "pilot"
        return "task"

    def _retry_delay(self, n: int) -> float:
        base = self.retry_backoff
        if base <= 0.0:
            return 0.0
        delay = min(base * (2.0 ** (n - 1)), self.retry_backoff_max)
        if self.retry_jitter > 0.0:
            delay *= 1.0 + self.retry_jitter * self.engine.rng.random()
        return delay

    def _task_failed(self, task: Task, err: str):
        if self._evacuating is not None:
            # pilot teardown in progress: the task is requeued elsewhere by
            # the campaign scheduler, not retried on this dying pilot
            self._evacuating.append(task)
            return
        if task.retries < task.description.max_retries:
            task.retries += 1
            delay = self._retry_delay(task.retries)
            self.engine.profiler.record(self.engine.now(), task.uid,
                                        "agent:retry",
                                        {"n": task.retries, "delay": delay,
                                         "cause": self._failure_cause(err)})
            task.advance(TaskState.SCHEDULING, self.engine.now(),
                         self.engine.profiler)
            if delay > 0.0:
                self._retry_pending[task.uid] = task
                self.engine.schedule(delay, self._requeue_retry, task)
                return
            self._dispatch_q.append(task)
            self._pump_dispatch()
            return
        self._finish(task)

    def _requeue_retry(self, task: Task):
        """Backoff timer fired: re-enter the dispatch pipeline (unless the
        task was canceled or evacuated to another pilot meanwhile)."""
        if self._retry_pending.pop(task.uid, None) is None:
            return
        if task.done or task.state is not TaskState.SCHEDULING:
            return
        self._dispatch_q.append(task)
        self._pump_dispatch()

    def _finish(self, task: Task):
        self._n_terminal += 1
        if self._spec_pending:
            self._spec_pending.pop(task.uid, None)
        for cb in self._done_callbacks:
            cb(task)
        if self.on_task_done:
            self.on_task_done(task)

    def add_done_callback(self, cb: Callable[[Task], None],
                          cohort_safe: Optional[Callable[[], bool]] = None):
        """Register a terminal-state listener; all registered callbacks run
        (in registration order) plus the legacy ``on_task_done`` slot, so
        campaigns and service watchers compose instead of clobbering.

        Cohort members never invoke per-task callbacks, so any registered
        callback disables the cohort fast path — unless it declares a
        ``cohort_safe`` probe returning True when skipping it for a planned
        wave is currently semantics-preserving (e.g. the FIFO passthrough
        scheduler when it holds no admission/dependency state)."""
        self._done_callbacks.append(cb)
        self._cb_cohort_safe.append(cohort_safe)

    # --------------------------------------------------------------- cohorts
    def _release_cohort_dispatch(self):
        """Planned dispatch window over: reopen the pipeline for object-path
        submissions that queued behind the wave."""
        self._dispatch_busy = False
        self._pump_dispatch()

    def _cohort_chunk_done(self, cohort, ex: BaseExecutor, k: int,
                           final: bool):
        """Bucketed completion accounting for a planned cohort: one event
        advances ``k`` members to terminal (vs one event per task on the
        object path)."""
        cohort.n_terminal += k
        self._cohort_done += k
        ex.stats["completed"] += k
        if final:
            cohort.finalized = True

    def all_tasks(self) -> List[Any]:
        """Everything submitted, for analytics: object ``Task`` instances
        plus planned ``TaskCohort`` columns (``repro_torch.core.analytics``
        consumes both)."""
        out: List[Any] = list(self.tasks.values())
        out.extend(self.cohorts)
        return out

    # ----------------------------------------------------------- speculation
    def _quantile_deadline(self) -> Optional[float]:
        """Speculation deadline for duration-free tasks: the configured
        quantile of observed task durations times the speculation factor
        (None until enough completions have been traced)."""
        obs = self._obs_durations
        n = len(obs)
        if n < self.speculation_min_samples:
            return None
        if self._quantile_memo is not None and self._quantile_memo[0] == n:
            return self._quantile_memo[1]
        window = sorted(obs[-1024:])
        q = window[min(len(window) - 1,
                       int(self.speculation_quantile * len(window)))]
        deadline = max(q, 1e-3) * self.speculation_factor
        self._quantile_memo = (n, deadline)
        return deadline

    def _arm_speculation(self, task: Task, deadline: Optional[float] = None):
        if deadline is None:
            deadline = task.description.duration * self.speculation_factor

        def watchdog():
            if task.done or task.uid in self._spec_clones:
                return
            if task.state != TaskState.RUNNING:
                # not yet running: re-arm
                self.engine.schedule(deadline, watchdog)
                return
            d = task.description
            if isinstance(d, DescView):
                d = d.materialize()      # batch rows are read-only views
            d2 = dataclasses.replace(d, uid="")
            clone = Task(d2)
            clone.speculative_of = task.uid
            self.tasks[clone.uid] = clone
            self._spec_clones[task.uid] = clone
            self.engine.profiler.record(self.engine.now(), task.uid,
                                        "agent:speculate",
                                        {"clone": clone.uid})
            clone.advance(TaskState.SCHEDULING, self.engine.now(),
                          self.engine.profiler)
            self._dispatch_q.append(clone)
            self._pump_dispatch()

        self.engine.schedule(deadline * 1.5, watchdog)

    # ----------------------------------------------------------------- fault
    def fail_flux_instance(self, idx: int, backend: str = "flux",
                           restart: bool = True):
        ex = self.backends[backend]
        orphans = ex.fail_instance(idx)
        for t in orphans:
            t.advance(TaskState.SCHEDULING, self.engine.now(),
                      self.engine.profiler)
            self._dispatch_q.append(t)
        self._pump_dispatch()
        if restart and hasattr(ex, "restart_instance"):
            ex.restart_instance(idx)

    def evacuate(self, reason: str = "pilot failure") -> List[Task]:
        """Pilot death: pull every non-terminal object task out of this
        agent — dispatch queue, backend backlogs, running work, parked
        backoff retries — and return them normalized to SCHEDULING so a
        campaign scheduler can requeue them on surviving pilots. The dying
        pilot performs no retries of its own (the ``_evacuating`` intercept
        swallows the on_failure storm from the executor kills).

        Unsupported shapes fail loudly rather than silently losing work:
        a mid-flight cohort wave has no per-task objects to evacuate, and
        service replicas belong to their owning ``Service`` fault model."""
        if any(not c.finalized for c in self.cohorts):
            raise RuntimeError("cannot evacuate a pilot mid-cohort-wave")
        for ex in self.backends.values():
            for t in ex.running_tasks():
                if t.description.kind == "service":
                    raise RuntimeError(
                        "cannot evacuate a pilot hosting service replicas")
        engine = self.engine
        victims: Dict[str, Task] = {}
        self._evacuating = collected = []
        try:
            for ex in self.backends.values():
                for t in ex.evacuate():
                    victims[t.uid] = t
            for t in collected:     # running work, FAILED via on_failure
                victims[t.uid] = t
        finally:
            self._evacuating = None
        for t in self._dispatch_q:
            if not t.done:
                victims[t.uid] = t
        self._dispatch_q.clear()
        victims.update((t.uid, t) for t in self._retry_pending.values()
                       if not t.done)
        self._retry_pending.clear()
        now = engine.now()
        profiler = engine.profiler
        out: List[Task] = []
        for t in victims.values():
            # drop from the dead agent's table: it will never see the task
            # reach terminal, and n_unfinished must drain to zero here
            self.tasks.pop(t.uid, None)
            if t.state in (TaskState.FAILED, TaskState.QUEUED):
                t.advance(TaskState.SCHEDULING, now, profiler)
            t.error = None
            t.backend = None
            out.append(t)
        profiler.record(now, "agent", "agent:evacuate",
                        {"n": len(out), "reason": reason})
        return out

    # ------------------------------------------------------------------- run
    def _unfinished(self) -> List[Task]:
        return [t for t in self.tasks.values() if not t.done]

    @property
    def n_unfinished(self) -> int:
        """Tasks not yet in a terminal state — O(1) via the terminal
        counters (the drain predicate runs once per engine wakeup)."""
        return (len(self.tasks) + self._cohort_n
                - self._n_terminal - self._cohort_done)

    def run_until_complete(self, max_events: int = 50_000_000,
                           timeout: Optional[float] = None) -> float:
        # O(1) predicate via the terminal counters (the old per-wakeup task
        # list-scan made real-engine drains O(n^2) end-to-end)
        self.engine.drain(lambda: (self._n_terminal >= len(self.tasks)
                                   and self._cohort_done >= self._cohort_n),
                          timeout=timeout, max_events=max_events)
        with self.engine.lock:
            unfinished = self._unfinished()
            stuck_cohorts = [c for c in self.cohorts if not c.finalized]
        if unfinished or stuck_cohorts:
            raise RuntimeError(
                f"run drained with {len(unfinished)} unfinished tasks and "
                f"{len(stuck_cohorts)} unfinalized cohorts")
        return self.engine.now()

    @property
    def total_cores(self) -> int:
        return self.n_nodes * self.node_spec.cores

    # ------------------------------------------------------------ load signals
    # (the campaign scheduler's cross-pilot cost model reads these)
    @property
    def dispatch_depth(self) -> int:
        """Tasks waiting in the agent's own dispatch queue."""
        return len(self._dispatch_q)

    @property
    def backend_depth(self) -> int:
        """Tasks enqueued in backend executors, not yet launched."""
        return sum(ex.queue_depth for ex in self.backends.values())

    @property
    def free_cores(self) -> int:
        """Idle cores across all backends (funcpool counts idle workers)."""
        return sum(ex.free_cores for ex in self.backends.values())

    @property
    def dispatch_rate(self) -> float:
        return 1.0 / self.dispatch_interval
