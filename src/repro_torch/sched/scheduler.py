"""`CampaignScheduler` — the hierarchical campaign scheduling layer.

Sits between campaign/task-manager submission and the pilots' agents, the
way RADICAL-Pilot partitions a Slurm allocation and delegates placement to
per-partition sub-schedulers (the structure the paper credits for
1,500+ tasks/s and the 30-60% IMPECCABLE makespan cut vs srun):

    Campaign / TaskManager
          │  submit(descriptions)
    CampaignScheduler          ordering policy + admission + gang claims
          │  release → Agent.submit_prepared (per chosen pilot)
    Pilot → Agent              RP dispatch pipeline (routing, batching)
          │
    Executor launch servers    FCFS+backfill over NodePools (+ gang_reserve)

Two operating modes:

* **passthrough** (default, FIFO): submissions flow straight to the
  least-loaded pilot in submission order — bit-identical to the seed
  TaskManager path, O(1) per task, so million-task campaigns pay nothing.
* **admission-gated** (priority / fair-share / FIFO+admission): tasks are
  held in the policy queue and released only when the per-pilot placement
  view (a mirrored :class:`NodePool`) says they fit. Conservative backfill
  lets later tasks overtake a blocked head within a bounded window; a
  blocked multi-node gang claims a draining node set in the view (and,
  with ``gang_reserve`` backends, at the launch server too) so loose-task
  streams cannot starve it.

Both modes run identically over SimEngine (discrete events) and RealEngine
(threads): every entry point commits under ``engine.lock`` and deferred
passes go through ``engine.call_soon``. Every decision lands in the
columnar profiler — per-task ``sched:release:p<i>`` / ``sched:hold``
records via ``record_fast`` (two C appends), per-bulk records in
passthrough — so schedule latency stays O(1) amortized per task.

Per-task dependencies (``TaskDescription.after``: upstream uids) are
honored in both modes: a task enters the policy queue only once every
upstream it names has reached a terminal state, which is what lets a
campaign stage's ready tasks flow as their individual upstreams finish
instead of waiting on a whole-stage barrier.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.resources import NodeClaim, NodePool
from repro_torch.core.task import (DescriptionBatch, Task, TaskDescription,
                                   TaskState, _STATE_EVENT, new_uid)
from repro_torch.sched.policy import (FIFOPolicy, QueuePolicy, _Entry,
                                      make_policy)

# trace-name registry: every event this scheduler records, keyed by intent
# (entity = task uid unless noted). The observability decomposer resolves
# scheduler rows through this dict instead of hardcoding strings;
# ``release_name(i)`` builds the per-pilot release track name.
TRACE_NAMES: Dict[str, str] = {
    "hold": "sched:hold",                  # held by admission (first time)
    "dep_hold": "sched:dep_hold",          # parked on `after` upstreams
    "release": "sched:release",            # bulk passthrough (entity=sched)
    "release_pilot": "sched:release:p{i}", # per-task release to pilot i
    "requeue": "sched:requeue",            # pilot-death evacuation requeue
    "gang_reserve": "sched:gang_reserve",  # view claim armed for a gang
    "head_reserve": "sched:head_reserve",  # head-of-line 1-node claim
    "view_shrink": "sched:view_shrink",    # node loss shrank a view
    "pilot_fail": "chaos:pilot_fail",      # entity=sched uid
}


def release_name(index: int) -> str:
    """Trace name of the per-pilot release track for view ``index``."""
    return TRACE_NAMES["release_pilot"].format(i=index)


def _task_eid(profiler, task: Task) -> int:
    """The task's trace entity id: reuse the one its state rows use (set by
    ``advance`` or block-reserved by the batch paths) so hold/release rows
    join with the lifecycle rows; intern the uid only for tasks that never
    stamped through this profiler."""
    if task._trace_prof is profiler:
        return task._trace_eid
    return profiler.entity_id(task.uid)


class _PilotView:
    """Per-pilot placement model: a mirrored NodePool charged at release
    and credited at task completion. It is an *admission throttle* — the
    authoritative no-oversubscription guarantee stays with the backend
    pools — but it is what keeps backend queues shallow enough for the
    policy order to be the order that matters."""

    __slots__ = ("pilot", "agent", "pool", "index", "nid_release", "dead")

    def __init__(self, pilot: Any, index: int):
        agent = getattr(pilot, "agent", pilot)
        self.pilot = pilot
        self.agent = agent
        self.index = index
        self.pool = NodePool(agent.n_nodes, agent.node_spec)
        self.nid_release = -1            # interned per-pilot release name id
        self.dead = False                # failed pilot: excluded from placement

    def cost(self) -> float:
        """Estimated seconds of queueing ahead of a new release: the
        agent's dispatch backlog at its dispatch rate plus the backend
        backlog at the backends' nominal launch rates."""
        agent = self.agent
        est = agent.dispatch_depth / agent.dispatch_rate
        depth = agent.backend_depth
        if depth:
            rate = 0.0
            for ex in agent.backends.values():
                nominal = getattr(ex, "nominal_rate", None)
                if nominal is not None:
                    rate += nominal()
            est += depth / max(rate, 1.0)
        return est


class _BatchRef:
    """One admission-gated :class:`DescriptionBatch`: the policy queues
    hold row-index slices (:class:`repro_torch.sched.policy._Run`) against this
    handle, and rows materialize into ``Task`` + ``_Entry`` objects only
    when the placement pass pops them. The whole batch's SCHEDULING
    transition was bulk-stamped at admission over a reserved entity block,
    so a materialized task's trace entity is ``eid_base + row`` — no
    per-task trace work happens before release."""

    __slots__ = ("sched", "batch", "eid_base", "seq0", "t_submit", "origin",
                 "resubmit", "n_pending", "pending", "tasks", "_uid_rows",
                 "_uid_prefix", "_uid_start")

    def __init__(self, sched: "CampaignScheduler", batch: DescriptionBatch,
                 eid_base: int, seq0: int, t_submit: float,
                 origin: str = "", resubmit: bool = False):
        self.sched = sched
        self.batch = batch
        self.eid_base = eid_base
        self.seq0 = seq0
        self.t_submit = t_submit
        self.origin = origin
        self.resubmit = resubmit
        self.n_pending = batch.n
        self.pending = np.ones(batch.n, dtype=bool)
        self.tasks: List[Task] = []       # materialized rows, release order
        self._uid_rows: Optional[Dict[str, int]] = None
        if batch.has_explicit_uids():
            self._uid_prefix = None
            self._uid_start = -1
        else:
            self._uid_prefix, self._uid_start = batch.uid_block

    def materialize(self, row: int) -> _Entry:
        """Build the object task for one popped row (state/timestamp set
        directly — the trace row already exists from the admission bulk
        stamp) and register it as a live dependency target."""
        sched = self.sched
        task = Task(self.batch.view(row))
        task.state = TaskState.SCHEDULING
        task.timestamps["SCHEDULING"] = self.t_submit
        task._trace_prof = sched.engine.profiler
        task._trace_eid = self.eid_base + row
        self.pending[row] = False
        self.n_pending -= 1
        self.tasks.append(task)
        e = _Entry(task, self.seq0 + row, self.t_submit, self.origin,
                   self.resubmit)
        sched._entry_by_uid[task.uid] = e
        if self.n_pending == 0:
            sched._batch_refs.remove(self)
        return e

    def row_of(self, uid: str) -> Optional[int]:
        """Row index of ``uid`` in this batch, or None. Block-uid batches
        parse the suffix; explicit-uid batches build a lookup lazily on the
        first dependency query."""
        if self._uid_prefix is not None:
            pfx, _, num = uid.rpartition(".")
            if pfx != self._uid_prefix or not num.isdigit():
                return None
            row = int(num) - self._uid_start
            return row if 0 <= row < self.batch.n else None
        if self._uid_rows is None:
            self._uid_rows = {self.batch.uid(i): i
                              for i in range(self.batch.n)}
        return self._uid_rows.get(uid)

    @property
    def done(self) -> bool:
        """Every row released and terminal (the ``wait_tasks`` surface)."""
        return self.n_pending == 0 and all(t.done for t in self.tasks)

    def __len__(self) -> int:
        return self.batch.n

    def __iter__(self):
        return iter(self.tasks)

    def __repr__(self):
        return (f"<_BatchRef n={self.batch.n} pending={self.n_pending} "
                f"seq0={self.seq0}>")


class CampaignScheduler:
    """Hierarchical scheduler over one or more pilots (see module docs).

    Parameters
    ----------
    policy: ``"fifo"`` | ``"priority"`` | ``"fair"`` | QueuePolicy instance.
    admission: gate releases on the placement view. Default: enabled for
        every policy except plain FIFO (which stays seed-equivalent
        passthrough unless explicitly gated).
    backfill: in gated mode, let later candidates overtake a blocked head
        within ``window`` entries per pass (conservative: never onto nodes
        a gang claim is draining).
    gang_reserve: claim view nodes for blocked gangs (start the drain at
        the scheduler; pair with the backends' ``gang_reserve`` option to
        also reserve at the launch servers).
    """

    # campaigns may wire per-task `after` dependencies against this target
    supports_deps = True

    def __init__(self, policy="fifo", admission: Optional[bool] = None,
                 backfill: bool = True, window: int = 128,
                 gang_reserve: bool = True, uid: str = ""):
        self.uid = uid or new_uid("sched")
        self.policy: QueuePolicy = make_policy(policy)
        if admission is None:
            admission = not isinstance(self.policy, FIFOPolicy)
        self.admission = admission
        self.backfill = backfill
        self.window = max(1, window)
        self.gang_reserve = gang_reserve
        self.views: List[_PilotView] = []
        # placement only considers live views; rebuilt by fail_pilot (index
        # positions in self.views stay stable for trace name ids)
        self._live: List[_PilotView] = []
        self.engine = None
        self._seq = itertools.count()
        # gangs do not queue behind loose functions: nodes>0 entries wait in
        # their own FIFO served before the policy queue each pass, where
        # they place outright or claim a draining node set (gang_reserve)
        self._gangs: List[_Entry] = []
        self._batch_refs: List[_BatchRef] = []   # gated batches, rows pending
        self._entry_by_uid: Dict[str, _Entry] = {}
        self._dep_wait: Dict[str, List[_Entry]] = {}
        self._n_dep_held = 0
        self._released: Dict[str, Tuple[_PilotView, Any]] = {}
        # head-of-line reservation: the highest-ordered blocked non-gang
        # entry may claim one draining node so the backfill stream cannot
        # starve wide single-node tasks (8-GPU training etc.); one at a
        # time — claims idle capacity, so they are rationed
        self._head_claimed: Optional[_Entry] = None
        self._done_callbacks: List[Callable[[Task], None]] = []
        self._pass_pending = False
        self._in_pass = False
        self._agents_seen: set = set()
        # interned trace name ids (bound once the engine is known)
        self._nid_hold = -1
        self._nid_dep = -1

    # ------------------------------------------------------------------ wiring
    def add_pilot(self, *pilots) -> "CampaignScheduler":
        """Register pilots (or bare Agents). The first registration binds
        the scheduler to that agent's engine; all pilots must share it."""
        for pilot in pilots:
            agent = getattr(pilot, "agent", pilot)
            if id(agent) in self._agents_seen:
                continue
            self._agents_seen.add(id(agent))
            if self.engine is None:
                self.engine = agent.engine
                profiler = self.engine.profiler
                self._nid_hold = profiler.name_id(TRACE_NAMES["hold"])
                self._nid_dep = profiler.name_id(TRACE_NAMES["dep_hold"])
            elif agent.engine is not self.engine:
                raise RuntimeError(f"{self.uid}: pilots span engines")
            view = _PilotView(pilot, len(self.views))
            view.nid_release = self.engine.profiler.name_id(
                release_name(view.index))
            self.views.append(view)
            self._live.append(view)
            agent.add_done_callback(self._on_task_done,
                                    cohort_safe=self._cohort_safe)
            if self.admission and self.gang_reserve:
                # arm backend-level gang reservations: the launch servers
                # perform the authoritative drain for gangs this scheduler
                # releases on a claim (see _place_gang)
                for ex in agent.backends.values():
                    for server in ex._servers():
                        server.gang_reserve = True
        return self

    def add_done_callback(self, cb: Callable[[Task], None]):
        """Terminal-state listener across every registered pilot (the
        surface campaigns bind to)."""
        self._done_callbacks.append(cb)

    def _cohort_safe(self) -> bool:
        """Probe for the agent's cohort fast path: skipping per-task
        ``_on_task_done`` calls is semantics-preserving exactly when this
        scheduler holds no per-task state a completion would advance — no
        admission accounting, no allocations to credit, no dependency
        waiters, no held entries, no campaign listeners."""
        return (not self.admission and not self._released
                and not self._dep_wait and not self._entry_by_uid
                and not self._gangs and not len(self.policy)
                and not self._batch_refs and not self._done_callbacks)

    # ------------------------------------------------------------- properties
    @property
    def agents(self) -> List[Any]:
        return [v.agent for v in self.views]

    @property
    def pending(self) -> int:
        """Tasks held by the scheduler (policy + gang queues + dependency
        holds)."""
        return len(self.policy) + len(self._gangs) + self._n_dep_held

    @property
    def n_unfinished(self) -> int:
        return self.pending + sum(v.agent.n_unfinished for v in self.views)

    @property
    def free_cores(self) -> int:
        return sum(v.agent.free_cores for v in self.views)

    # ------------------------------------------------------------------ submit
    def submit(self, descriptions):
        """Submit a description list or a :class:`DescriptionBatch`. Lists
        return ``List[Task]``; batches return whatever the native batch
        path produces — a ``CohortWave`` / task list in passthrough, a
        :class:`_BatchRef` when admission-gated."""
        if isinstance(descriptions, DescriptionBatch):
            return self._submit_batch(descriptions)
        return self._submit(list(descriptions), origin="", resubmit=False)

    def _submit_batch(self, batch: DescriptionBatch):
        if not self.views:
            raise RuntimeError(f"{self.uid}: no pilots added")
        # fallback gates: rare-field rows (deps, services) and gangs keep
        # the per-entry object path — their handling is inherently per-row
        if (batch.has_field("after") or batch.has_field("service")
                or batch.has_field("nodes")):
            return self._submit(batch.to_descriptions(), origin="",
                                resubmit=False)
        engine = self.engine
        with engine.lock:
            if not self.admission:
                view = min(self._live, key=lambda v: v.agent.n_unfinished)
                tasks = view.agent.submit(batch)
                engine.profiler.record(engine.now(), self.uid,
                                       TRACE_NAMES["release"],
                                       {"n": batch.n, "pilot": view.index})
                return tasks
            return self._submit_batch_gated(batch)

    def _submit_batch_gated(self, batch: DescriptionBatch) -> _BatchRef:
        """Admission-gated batch: one entity-block reservation plus one
        ``record_fast_many`` stamps SCHEDULING for every row, a sequence
        block fixes the arrival order, and the policy queue holds only row
        indices (split on priority/tenant codes by ``push_batch``) —
        object tasks exist only for rows the placement pass releases."""
        engine = self.engine
        now = engine.now()
        profiler = engine.profiler
        n = batch.n
        base = profiler.reserve_entities(n, batch.uid)
        st = TaskState.SCHEDULING
        nids = profiler.memo_nids
        nid = nids.get(st)
        if nid is None:
            nid = nids[st] = profiler.name_id(_STATE_EVENT[st])
        profiler.reserve_rows(n)
        profiler.record_fast_many(
            np.full(n, now), np.arange(base, base + n, dtype=np.int64), nid)
        seq0 = next(self._seq)
        self._seq = itertools.count(seq0 + n)
        ref = _BatchRef(self, batch, base, seq0, now)
        self._batch_refs.append(ref)
        self.policy.push_batch(ref, np.arange(n, dtype=np.int64))
        self._pass()
        return ref

    def resubmit(self, descriptions, origin: str = "") -> List[Task]:
        """Scheduler-mediated resubmission (service restarts / scale-ups):
        same admission path, plus the ``agent:resubmit`` lineage trace on
        release."""
        return self._submit(list(descriptions), origin=origin,
                            resubmit=True)

    def _submit(self, descs: List[TaskDescription], origin: str,
                resubmit: bool) -> List[Task]:
        if not self.views:
            raise RuntimeError(f"{self.uid}: no pilots added")
        engine = self.engine
        with engine.lock:
            if not self.admission:
                return self._submit_passthrough(descs, origin, resubmit)
            now = engine.now()
            profiler = engine.profiler
            out: List[Task] = []
            # every uid of this bulk is a live dependency target, including
            # forward references to entries registered later in the loop
            # (only materialized when the bulk carries dependencies at all)
            bulk_uids = ({d.uid for d in descs}
                         if any(d.after for d in descs) else ())
            for d in descs:
                task = Task(d)
                task.advance(TaskState.SCHEDULING, now, profiler)
                e = _Entry(task, next(self._seq), now, origin, resubmit)
                self._entry_by_uid[task.uid] = e
                out.append(task)
                if d.service is not None:
                    # service replicas are routed + charged but never held:
                    # a queued restart/scale-up must not deadlock a
                    # draining service (liveness beats ordering here)
                    self._release_service(e)
                    continue
                if not self._park_on_deps(e, extra_live=bulk_uids):
                    if d.nodes:
                        self._gangs.append(e)
                    else:
                        self.policy.push(e)
            self._pass()
            return out

    def _submit_passthrough(self, descs: List[TaskDescription],
                            origin: str, resubmit: bool) -> List[Task]:
        """Seed-equivalent FIFO: the whole bulk goes to the least-loaded
        pilot immediately (dependency-carrying descriptions are still
        held until their upstreams finish)."""
        engine = self.engine
        ready: List[TaskDescription] = []
        out: List[Task] = []
        # every uid of this bulk is a live dependency target — including
        # forward references — even though their submission happens below
        # (only materialized when the bulk carries dependencies at all)
        bulk_uids = ({d.uid for d in descs}
                     if any(d.after for d in descs) else ())
        for d in descs:
            if d.after:
                task = Task(d)
                task.advance(TaskState.SCHEDULING, engine.now(),
                             engine.profiler)
                e = _Entry(task, next(self._seq), engine.now(),
                           origin, resubmit)
                self._entry_by_uid[task.uid] = e
                if self._park_on_deps(e, extra_live=bulk_uids):
                    out.append(task)
                    continue
                self._entry_by_uid.pop(task.uid, None)
                self._release_passthrough([e])
                out.append(task)
            else:
                ready.append(d)
                out.append(d)            # placeholder, replaced below
        if ready:
            view = min(self._live, key=lambda v: v.agent.n_unfinished)
            if resubmit:
                tasks = view.agent.resubmit(ready, origin)
            else:
                # allow the agent's cohort fast path only when the whole
                # bulk is dependency-free: a wave has no per-task objects
                # to splice into the placeholder slots
                tasks = view.agent.submit(ready,
                                          cohort=len(ready) == len(out))
            if not isinstance(tasks, list):
                # planned CohortWave: columnar, already in flight
                engine.profiler.record(engine.now(), self.uid,
                                       TRACE_NAMES["release"],
                                       {"n": len(tasks),
                                        "pilot": view.index})
                return tasks
            it = iter(tasks)
            for i, slot in enumerate(out):
                if isinstance(slot, TaskDescription):
                    out[i] = next(it)
            engine.profiler.record(engine.now(), self.uid,
                                   TRACE_NAMES["release"],
                                   {"n": len(tasks), "pilot": view.index})
        return out

    # ------------------------------------------------------------ dependencies
    def _dep_blocks(self, uid: str) -> bool:
        """An upstream uid blocks while it is held here (and not already
        terminal) or unfinished on a registered agent; unknown uids
        (already reaped, or never seen) count as satisfied."""
        e = self._entry_by_uid.get(uid)
        if e is not None:
            return not e.task.done
        for ref in self._batch_refs:
            row = ref.row_of(uid)
            if row is not None and ref.pending[row]:
                return True      # still held as a policy-queue row index
        for v in self.views:
            t = v.agent.tasks.get(uid)
            if t is not None:
                return not t.done
        return False

    def _park_on_deps(self, e: _Entry, extra_live=None) -> bool:
        """Hold ``e`` until every upstream uid it names is terminal.
        Unknown uids (never seen by this scheduler, or already finished)
        count as satisfied; ``extra_live`` adds uids that are about to be
        submitted (earlier entries of the same bulk)."""
        after = e.task.description.after
        if not after:
            return False
        deps = {u for u in after
                if u != e.task.uid
                and ((extra_live is not None and u in extra_live)
                     or self._dep_blocks(u))}
        if not deps:
            return False
        e.deps = deps
        for u in deps:
            self._dep_wait.setdefault(u, []).append(e)
        self._n_dep_held += 1
        self.engine.profiler.record_fast(
            e.t_submit, _task_eid(self.engine.profiler, e.task),
            self._nid_dep)
        return True

    def _resolve_deps(self, uid: str):
        waiters = self._dep_wait.pop(uid, None)
        if not waiters:
            return
        released: List[_Entry] = []
        for e in waiters:
            e.deps.discard(uid)
            if e.deps:
                continue
            self._n_dep_held -= 1
            if e.task.done:              # canceled while dependency-held:
                self._forget(e.task.uid)
                self._resolve_deps(e.task.uid)   # cascade to its waiters
                continue
            released.append(e)
        if not released:
            return
        if self.admission:
            for e in released:
                if e.task.description.nodes:
                    self._gangs.append(e)
                else:
                    self.policy.push(e)
            self._schedule_pass()
        else:
            self._release_passthrough(released)

    def _release_passthrough(self, entries: List[_Entry]):
        view = min(self._live, key=lambda v: v.agent.n_unfinished)
        for e in entries:
            self._entry_by_uid.pop(e.task.uid, None)
            if e.resubmit:
                view.agent.resubmit_prepared([e.task], e.origin)
            else:
                view.agent.submit_prepared([e.task])
            self.engine.profiler.record_fast(
                self.engine.now(),
                _task_eid(self.engine.profiler, e.task),
                view.nid_release)

    # ------------------------------------------------------------- lifecycle
    def _on_task_done(self, task: Task):
        uid = task.uid
        placed = self._released.pop(uid, None)
        if placed is not None:
            view, alloc = placed
            if isinstance(alloc, NodeClaim):
                view.pool.release_claim(alloc)
            elif alloc is not None:
                view.pool.free(alloc)
        if self._dep_wait:
            self._resolve_deps(uid)
        for cb in self._done_callbacks:
            cb(task)
        if self.admission and (len(self.policy) or placed is not None):
            self._schedule_pass()

    def cancel(self, task: Task):
        """Cancel a task still held by the scheduler (released tasks cancel
        through their backend as usual)."""
        with self.engine.lock:
            e = self._entry_by_uid.get(task.uid)
            if e is None or task.done:
                return
            if task.state is TaskState.SCHEDULING:
                task.advance(TaskState.CANCELED, self.engine.now(),
                             self.engine.profiler)
                self._drop_claim(e)
                # policy/dep-queue entries are dropped lazily at pop /
                # dependency resolution (task.done short-circuits them),
                # but downstream `after` waiters must be woken NOW — no
                # agent callback will ever fire for a never-released task
                self._forget(task.uid)
                self._resolve_deps(task.uid)
                for cb in self._done_callbacks:
                    cb(task)

    def _forget(self, uid: str):
        self._entry_by_uid.pop(uid, None)

    # ------------------------------------------------------------------ faults
    def _view_of(self, pilot) -> _PilotView:
        if isinstance(pilot, int):
            return self.views[pilot]
        agent = getattr(pilot, "agent", pilot)
        for v in self.views:
            if v.pilot is pilot or v.agent is agent:
                return v
        raise ValueError(f"{self.uid}: unknown pilot {pilot!r}")

    def fail_pilot(self, pilot, reason: str = "pilot failure") -> List[Task]:
        """Pilot death: the pilot's agent evacuates every non-terminal task
        (running work fails through the executors' kill path; queued work
        comes back as-is) and all of it requeues here onto surviving pilots
        — through the same admission/policy path as a first submission,
        with ``sched:requeue`` + ``agent:resubmit`` lineage per task.
        Requires at least one surviving pilot."""
        engine = self.engine
        with engine.lock:
            view = self._view_of(pilot)
            if view.dead:
                return []
            survivors = [v for v in self._live if v is not view]
            if not survivors:
                raise RuntimeError(
                    f"{self.uid}: no surviving pilot to requeue onto")
            view.dead = True
            self._live = survivors
            now = engine.now()
            profiler = engine.profiler
            p = view.pilot
            if p is not view.agent and hasattr(p, "advance"):
                from repro_torch.core.pilot import PilotState
                if p.state in (PilotState.LAUNCHING, PilotState.ACTIVE):
                    p.advance(PilotState.FAILED, now, profiler)
            victims = view.agent.evacuate(reason)
            profiler.record(now, self.uid, TRACE_NAMES["pilot_fail"],
                            {"pilot": view.index, "n_victims": len(victims)})
            # admission charges against the dead view can never be credited
            # back through _on_task_done — drop them
            for uid in [u for u, (v, _a) in self._released.items()
                        if v is view]:
                del self._released[uid]
            entries: List[_Entry] = []
            origin = getattr(p, "uid", f"pilot{view.index}")
            for t in victims:
                profiler.record(now, t.uid, TRACE_NAMES["requeue"],
                                {"pilot": view.index, "reason": reason})
                e = _Entry(t, next(self._seq), now, origin, True)
                self._entry_by_uid[t.uid] = e
                entries.append(e)
            if self.admission:
                for e in entries:
                    if e.task.description.nodes:
                        self._gangs.append(e)
                    else:
                        self.policy.push(e)
                self._pass()
            else:
                if entries:
                    self._release_passthrough(entries)
            return victims

    def on_node_failure(self, pilot, node: Optional[int] = None
                        ) -> Optional[int]:
        """Shrink a pilot's placement view after a node failure so
        admission respects the degraded capacity. The view mirrors
        *capacity*, not node identity (backend pools renumber per
        partition), so when ``node`` is not a view node id the most-idle
        stand-in is removed instead. The authoritative failure — pool
        shrink + task kills — happens in the backend via
        ``BaseExecutor.fail_node``; chaos drives both."""
        engine = self.engine
        with engine.lock:
            v = self._view_of(pilot)
            removed = v.pool.remove_node(
                node if node in v.pool.free_cores else None)
            engine.profiler.record(engine.now(), self.uid,
                                   TRACE_NAMES["view_shrink"],
                                   {"pilot": v.index,
                                    "view_node": -1 if removed is None
                                    else removed})
            if self.admission:
                self._schedule_pass()
            return removed

    # ------------------------------------------------------------------- pass
    def _schedule_pass(self):
        if self._pass_pending or self._in_pass:
            return
        self._pass_pending = True
        self.engine.call_soon(self._deferred_pass)

    def _deferred_pass(self):
        self._pass_pending = False
        with self.engine.lock:
            self._pass()

    def _pass(self):
        """One placement pass: consider up to ``window`` entries in policy
        order, release everything that fits its best pilot view, claim
        nodes for the first blocked gang, requeue the rest in order."""
        if self._in_pass:
            return
        self._in_pass = True
        try:
            policy = self.policy
            engine = self.engine
            profiler = engine.profiler
            now = engine.now()
            blocked: List[_Entry] = []
            groups: Dict[int, List[_Entry]] = {}
            scanned = 0
            if self._gangs:
                # serve the gang queue first: place outright or arm a
                # reservation — a gang never waits behind loose functions
                held_gangs: List[_Entry] = []
                for e in self._gangs:
                    task = e.task
                    if task.done:
                        self._forget(task.uid)
                        self._resolve_deps(task.uid)
                        continue
                    view = self._place_gang(e, task.description)
                    if view is None:
                        if not e.held_recorded:
                            e.held_recorded = True
                            profiler.record_fast(
                                now, _task_eid(profiler, task),
                                self._nid_hold)
                        held_gangs.append(e)
                        continue
                    policy.charge(e)
                    groups.setdefault(view.index, []).append(e)
                self._gangs = held_gangs
            # per-pass fit-failure memo: once a (view, resource-shape)
            # probe fails, identical shapes skip the alloc attempt — a
            # saturated pass costs O(window) queue ops + O(shapes x views)
            # placement probes, not O(window x nodes)
            no_fit: set = set()
            while scanned < self.window:
                e = policy.pop(now)
                if e is None:
                    break
                scanned += 1
                task = e.task
                if task.done:            # canceled while queued
                    self._drop_claim(e)
                    self._forget(task.uid)
                    self._resolve_deps(task.uid)
                    continue
                view = self._place(e, no_fit)
                if view is None:
                    if not e.held_recorded:
                        e.held_recorded = True
                        profiler.record_fast(
                            now, _task_eid(profiler, task),
                            self._nid_hold)
                    if not blocked:
                        self._maybe_claim_head(e)
                    blocked.append(e)
                    if not self.backfill:
                        break
                    continue
                policy.charge(e)
                groups.setdefault(view.index, []).append(e)
            if blocked:
                policy.requeue(blocked)
            for idx, entries in groups.items():
                self._hand_over(self.views[idx], entries, now)
        finally:
            self._in_pass = False

    def _hand_over(self, view: _PilotView, entries: List[_Entry],
                   now: float):
        profiler = self.engine.profiler
        bulk: List[Task] = []
        for e in entries:
            self._entry_by_uid.pop(e.task.uid, None)
            profiler.record_fast(now, _task_eid(profiler, e.task),
                                 view.nid_release)
            if e.resubmit:
                view.agent.resubmit_prepared([e.task], e.origin)
            else:
                bulk.append(e.task)
        if bulk:
            view.agent.submit_prepared(bulk)

    # -------------------------------------------------------------- placement
    def _place(self, e: _Entry,
               no_fit: Optional[set] = None) -> Optional[_PilotView]:
        """Charge the entry against the best pilot view, or return None if
        nothing fits now (gangs additionally claim a draining node set)."""
        d = e.task.description
        views = self._live
        if d.nodes:
            return self._place_gang(e, d, no_fit)
        shape = (d.cores, d.gpus)
        best = None
        best_cost = 0.0
        for v in views:
            if no_fit is not None and (v.index, *shape) in no_fit:
                continue
            if not v.pool.can_fit(d):
                if no_fit is not None:
                    no_fit.add((v.index, *shape))
                continue
            c = v.cost() if len(views) > 1 else 0.0
            if best is None or c < best_cost:
                best, best_cost = v, c
        if best is None:
            # a head-of-line claim launches once its node has drained
            if e.claim is not None:
                v = e.claim_view
                if v.pool.claim_ready(e.claim):
                    self._drop_claim(e)
                    alloc = v.pool.alloc(d)
                    if alloc is not None:
                        self._released[e.task.uid] = (v, alloc)
                        return v
            return None
        self._drop_claim(e)              # fit elsewhere: claim not needed
        alloc = best.pool.alloc(d)
        self._released[e.task.uid] = (best, alloc)
        return best

    def _place_gang(self, e: _Entry, d: TaskDescription,
                    no_fit: Optional[set] = None) -> Optional[_PilotView]:
        candidates = [v for v in self._live if v.pool.n_nodes >= d.nodes]
        if not candidates:
            # no pilot can ever host it: release unthrottled and let the
            # backend fail it with its usual diagnostic
            view = max(self._live, key=lambda v: v.pool.n_nodes)
            self._released[e.task.uid] = (view, None)
            return view
        for v in candidates:
            if no_fit is not None and (v.index, "gang", d.nodes) in no_fit:
                continue
            alloc = v.pool.alloc(d)
            if alloc is None:
                if no_fit is not None:
                    no_fit.add((v.index, "gang", d.nodes))
                continue
            self._released[e.task.uid] = (v, alloc)
            return v
        if self.gang_reserve:
            # nothing fits now: claim a draining node set in the view as
            # the gang's capacity charge — the backfill stream can no
            # longer touch those nodes — and release the gang to the
            # backend *immediately*, where the launch server's own
            # gang_reserve claim (armed at add_pilot) performs the one
            # real drain. A single drain gates the gang; the view claim
            # is released when the gang reaches a terminal state.
            view = max(candidates, key=lambda v: v.pool.free_whole_nodes)
            claim = view.pool.claim(d.nodes)
            if claim is not None:
                self._released[e.task.uid] = (view, claim)
                self.engine.profiler.record(
                    self.engine.now(), e.task.uid, TRACE_NAMES["gang_reserve"],
                    {"nodes": d.nodes, "pilot": view.index})
                return view
        return None

    def _release_service(self, e: _Entry):
        """Route a service replica: pin it to its owning service's agent
        (the service tracks replicas through that agent), charge the view
        if it fits, and release immediately."""
        d = e.task.description
        svc_agent = getattr(d.service, "agent", None)
        view = None
        for v in self._live:
            if v.agent is svc_agent:
                view = v
                break
        if view is None:
            view = min(self._live, key=lambda v: v.agent.n_unfinished)
        alloc = view.pool.alloc(d)       # None: backend queues it (uncharged)
        self._released[e.task.uid] = (view, alloc)
        self._hand_over(view, [e], self.engine.now())

    def _maybe_claim_head(self, e: _Entry):
        """Arm the head-of-line reservation: the highest-ordered blocked
        single-node entry claims one draining node, so continuous 1-core
        arrivals cannot starve wide tasks (conservative backfill: the
        stream only backfills capacity the head cannot use)."""
        if (not self.gang_reserve or self._head_claimed is not None
                or e.claim is not None):
            return
        d = e.task.description
        best = None
        for v in self._live:
            spec = v.pool.spec
            if d.cores <= spec.cores and d.gpus <= spec.gpus:
                best = v
                break
        if best is None:
            return
        claim = best.pool.claim(1)
        if claim is None:
            return
        e.claim = claim
        e.claim_view = best
        self._head_claimed = e
        self.engine.profiler.record(
            self.engine.now(), e.task.uid, TRACE_NAMES["head_reserve"],
            {"pilot": best.index})

    def _drop_claim(self, e: _Entry):
        if self._head_claimed is e:
            self._head_claimed = None
        if e.claim is not None:
            e.claim_view.pool.release_claim(e.claim)
            e.claim = None
            e.claim_view = None

    def __repr__(self):
        return (f"<CampaignScheduler {self.uid} policy={self.policy.name} "
                f"admission={self.admission} pilots={len(self.views)} "
                f"pending={self.pending}>")
