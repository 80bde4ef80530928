"""Persistent service tasks: N replicas + a routed request stream.

The paper's IMPECCABLE inference runs as long-lived *services* rather than
batch jobs, and RHAPSODY (arXiv:2512.20795) names service tasks as the task
modality that makes hybrid AI-HPC campaigns scale: provision once, then
amortize the launch cost over a stream of requests. A :class:`Service` owns
``replicas`` tasks with ``kind="service"`` that run the persistent lifecycle
added to the task state machine::

    NEW -> SCHEDULING -> QUEUED -> LAUNCHING -> PROVISIONING -> READY
                                                  -> SERVING -> DRAINING -> STOPPED

Replica tasks flow through the normal agent dispatch pipeline (routing,
placement, resource allocation); the hosting executor advances them to
PROVISIONING/READY and calls back into the service, which then routes
requests across ready replicas with a pluggable load balancer.

Engine duality, same as everywhere else in the substrate:

* **sim** — each replica is a single server with service time
  ``noisy(1/rate)`` per request (calibrated per-replica service-rate model);
  request completions are discrete events on the engine clock.
* **real** — each replica occupies one executor worker thread for its whole
  lifetime and blocks on a per-replica ``queue.Queue``; ``handler(payload)``
  executes in that persistent worker (no per-request dispatch through the
  task pipeline).

Fault model (the RP characterization paper, arXiv:2103.00091, measures
failure-recovery overhead as a first-order term at leadership scale):

* **request requeue** — in-flight and queued requests of a FAILED/CANCELED
  replica are re-dispatched to survivors through the balancer; a request
  fails only after ``max_retries`` requeues. Retry counts live in the
  columnar request log.
* **replica restart** — with a :class:`RestartPolicy`, a dead replica is
  replaced by resubmitting a fresh ``TaskDescription`` (``restarted_from``
  records the lineage) through the normal dispatch pipeline after a backoff,
  so ``n_replicas`` is a target the service converges back to, not a
  snapshot of the initial provisioning.
* **autoscaling** — with a :class:`ScalePolicy`, the ``least-outstanding``
  queue-depth signal provisions or drains replicas against the live
  allocation. Evaluation is purely event-driven (request submission,
  completion, readiness) so the sim engine sees it as discrete events and
  the real engine needs no poller thread.

All service entry points serialize on ``engine.lock``, so the same Service
code drives both engines and composes with campaigns (replica STOPPED is a
terminal task state; an elastic stage holds until ``Service.stopped``).
"""
from __future__ import annotations

import queue as _thread_queue
from array import array
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.task import Task, TaskDescription, TaskState, new_uid

# trace-name registry (entity = service name): restart / autoscale events
# recorded by the fault model, resolved by the observability layer instead
# of hardcoded strings
TRACE_NAMES: Dict[str, str] = {
    "restart": "service:restart",          # replica replacement scheduled
    "scale_up": "service:scale_up",        # autoscale provision
    "scale_down": "service:scale_down",    # autoscale drain
}

# sentinel handed to a real replica's request queue to end its serve loop
SVC_STOP = object()

# request status codes for the columnar ok-flags
_PENDING, _OK, _FAILED = 0, 1, 2


@dataclass(frozen=True)
class RestartPolicy:
    """Replica restart on failure: a FAILED/CANCELED replica is replaced by
    resubmitting a fresh ``TaskDescription`` through the agent's dispatch
    pipeline (``restarted_from`` records the lineage), bringing the live
    count back toward the ``n_replicas`` target. ``backoff`` delays the
    resubmission (engine-seconds) and grows by ``factor`` per restart
    already spent, bounding churn under a crash loop."""

    max_restarts: int = 4          # total replacement budget for the service
    backoff: float = 1.0
    factor: float = 2.0

    def delay(self, n_prior: int) -> float:
        return self.backoff * (self.factor ** n_prior)


@dataclass(frozen=True)
class ScalePolicy:
    """Elastic replica autoscaling from the ``least-outstanding`` queue
    signal: when the mean backlog per routable replica exceeds
    ``up_threshold`` requests, one replica is provisioned (until
    ``max_replicas``); when it falls below ``down_threshold``, one idle
    replica is drained (down to ``min_replicas``). Evaluated as discrete
    events on request submission / completion / readiness — never by
    polling — with ``cooldown`` engine-seconds between actions."""

    min_replicas: int = 1
    max_replicas: int = 8
    up_threshold: float = 4.0
    down_threshold: float = 0.25
    cooldown: float = 5.0


class RoundRobinBalancer:
    """Cycle through ready replicas in order. The cursor is clamped to the
    rotation length on every pick and compensated (``note_removed``) when
    the Service removes a replica ahead of it, so shrink/grow under replica
    death or autoscaling continues the rotation instead of skewing load
    onto whichever replica happened to fill the removed slot."""

    def __init__(self):
        self._i = 0

    def pick(self, replicas: List["Replica"]) -> "Replica":
        if self._i >= len(replicas):
            self._i = 0
        r = replicas[self._i]
        self._i += 1
        return r

    def note_removed(self, index: int):
        if index < self._i:
            self._i -= 1


class LeastOutstandingBalancer:
    """Route to the ready replica with the fewest in-flight requests."""

    def pick(self, replicas: List["Replica"]) -> "Replica":
        return min(replicas, key=lambda r: r.outstanding)


_BALANCERS = {"round-robin": RoundRobinBalancer,
              "least-outstanding": LeastOutstandingBalancer}


def make_balancer(spec) -> Any:
    """Resolve a balancer name ("round-robin" | "least-outstanding") or pass
    an instance through (anything with ``pick(replicas)``)."""
    if isinstance(spec, str):
        try:
            return _BALANCERS[spec]()
        except KeyError:
            raise KeyError(f"unknown balancer {spec!r} "
                           f"(available: {sorted(_BALANCERS)})") from None
    return spec


class Replica:
    """Per-replica runtime state: the hosting Task, its in-flight count, and
    its request queue (deque of rids in sim, thread Queue in real)."""

    __slots__ = ("task", "outstanding", "queue", "busy", "served",
                 "stop_sent", "current", "event", "draining")

    def __init__(self, task: Task, real: bool):
        self.task = task
        self.outstanding = 0           # dispatched, not yet completed
        self.queue = _thread_queue.Queue() if real else deque()
        self.busy = False              # sim: a request is in service
        self.served = 0
        self.stop_sent = False         # real: drain sentinel enqueued
        self.current = -1              # sim: rid in service (requeue on death)
        self.event = None              # sim: its scheduled completion event
        self.draining = False          # autoscale: leaving the rotation


class Service:
    """N persistent replicas + request routing; see module docstring.

    Parameters
    ----------
    agent : the pilot agent hosting the replicas (engine + backends).
    handler : real-mode request handler, called as ``handler(payload)`` in
        the replica's persistent worker; ``None`` echoes the payload.
    replicas : target number of service tasks (autoscaling moves it).
    cores/gpus/nodes : per-replica resource footprint (normal routing rules).
    startup : sim-mode provisioning time (s) per replica.
    rate : sim-mode per-replica request service rate (req/s); a request may
        override with an explicit ``duration``.
    balancer : "round-robin" | "least-outstanding" | instance with ``pick``.
    max_retries : requeues a request survives before failing (replica-death
        requeue; handler exceptions are application errors, never retried).
    restart : optional :class:`RestartPolicy` — replace dead replicas.
    scale : optional :class:`ScalePolicy` — elastic replica count.
    """

    def __init__(self, agent, handler: Optional[Callable] = None,
                 replicas: int = 2, cores: int = 1, gpus: int = 0,
                 nodes: int = 0, startup: float = 0.0, rate: float = 0.0,
                 rate_sigma: float = 0.15, balancer="round-robin",
                 backend: Optional[str] = None, name: str = "",
                 workflow: str = "", max_retries: int = 2,
                 restart: Optional[RestartPolicy] = None,
                 scale: Optional[ScalePolicy] = None,
                 submitter=None):
        assert replicas >= 1
        self.agent = agent
        # replica placement authority: restart replacements and scale-up
        # provisions resubmit through this (a repro_torch.sched.CampaignScheduler
        # routes/charges them against its placement views; default: the
        # agent's dispatch pipeline directly)
        self.submitter = submitter if submitter is not None else agent
        self.engine = agent.engine
        self.handler = handler
        self.n_replicas = replicas          # the *target* live-replica count
        self.startup = startup
        self.rate = rate
        self.rate_sigma = rate_sigma
        self.balancer = make_balancer(balancer)
        self.name = name or new_uid("service")
        self.max_retries = max_retries
        self.restart = restart
        self.scale = scale
        self.error: Optional[str] = None
        self._real = self.engine.mode == "real"
        self._descriptions: Optional[List[TaskDescription]] = None
        self._all_descs: List[TaskDescription] = []   # originals + replacements
        self._desc_kw = dict(cores=cores, gpus=gpus, nodes=nodes,
                             backend=backend, workflow=workflow)

        self._replicas: Dict[str, Replica] = {}      # uid -> Replica
        self._ready: List[Replica] = []              # live READY/SERVING
        self._n_marked = 0                           # draining/stop_sent in _ready
        self._n_submitted = 0                        # descriptions created
        self._n_terminal = 0                         # replica tasks finished
        self._buffer: deque = deque()                # rids awaiting readiness
        self._flushed = False
        self._stopping = False
        self._finalized = False
        self._ready_cbs: List[Callable[[], None]] = []
        self._stopped_cbs: List[Callable[[], None]] = []

        # fault/elasticity bookkeeping
        self.restarts = 0                            # replacements scheduled
        self._pending_restarts = 0                   # scheduled, not submitted
        self._scale_t = array("d")                   # scale-event times
        self._scale_delta = array("b")               # +1 provision / -1 drain
        self._last_scale = float("-inf")

        # columnar per-request log (events.py style): parallel arrays indexed
        # by rid; starts/ends are assigned out of order, so placeholders are
        # appended at submission and overwritten in place
        self._submit_ts = array("d")
        self._start_ts = array("d")
        self._end_ts = array("d")
        self._ok = bytearray()
        self._retries = bytearray()                  # requeues per rid
        self._payloads: List[Any] = []
        self._durations: List[Optional[float]] = []
        self.results: List[Any] = []
        self._n_done = 0
        # completion journal: rids in completion order — a streaming reader
        # (observability watch / ServiceLatencyRule) tails this in O(new)
        # via completed_since() instead of rescanning the whole log
        self._done_journal = array("q")

        agent.add_done_callback(self._replica_terminal)

    # ------------------------------------------------------------- replicas
    def descriptions(self) -> List[TaskDescription]:
        """The initial replica TaskDescriptions (memoized) — submit these
        through the agent/TaskManager, or return them from a campaign stage.
        Restart replacements and scale-ups are resubmitted internally and do
        not appear here (see ``all_descriptions``)."""
        if self._descriptions is None:
            self._descriptions = [self._new_desc()
                                  for _ in range(self.n_replicas)]
        return self._descriptions

    def all_descriptions(self) -> List[TaskDescription]:
        """Every replica description ever created: the initial set plus
        restart replacements and autoscale provisions, in creation order."""
        return list(self._all_descs)

    def _new_desc(self, restarted_from: Optional[str] = None
                  ) -> TaskDescription:
        self._n_submitted += 1
        d = TaskDescription(kind="service", service=self,
                            uid=new_uid(f"{self.name}.replica"),
                            restarted_from=restarted_from,
                            **self._desc_kw)
        self._all_descs.append(d)
        return d

    def submit(self) -> List[Task]:
        """Convenience: submit the replica tasks through the placement
        authority (the campaign scheduler when one was configured)."""
        return self.submitter.submit(self.descriptions())

    # executor callbacks ------------------------------------------------
    def _attach_replica(self, task: Task) -> Replica:
        """Idempotently create the Replica record for a provisioning task
        (real executors need the request queue before READY)."""
        r = self._replicas.get(task.uid)
        if r is None:
            r = self._replicas[task.uid] = Replica(task, self._real)
        return r

    def _replica_ready(self, task: Task):
        """Hosting executor reports the replica READY (under engine.lock)."""
        r = self._attach_replica(task)
        self._ready.append(r)
        self._maybe_flush()
        if self._flushed:
            self._rebalance()          # late joiner steals queued work
        if self._stopping:
            self._maybe_stop_all()
        if self.all_ready:
            for cb in self._ready_cbs:
                cb()
            self._ready_cbs.clear()
        self._maybe_scale()

    def _replica_terminal(self, task: Task):
        """Agent done-callback: drop dead replicas from the rotation,
        recover their requests, and (policy permitting) schedule a
        replacement. The back-reference check keeps this O(1) on the
        agent's completion hot path (the callback sees every task the
        agent finishes)."""
        if task.description.service is not self:
            return
        self._n_terminal += 1
        r = self._replicas.get(task.uid)
        if r is not None:
            self._remove_from_ready(r)
        if (task.state in (TaskState.FAILED, TaskState.CANCELED)
                and self.error is None):
            self.error = f"replica {task.uid}: {task.state.value}"
        if task.state is not TaskState.STOPPED:
            self._maybe_restart(task)
            if r is not None:
                self._recover_replica_requests(r, task)
        self._maybe_flush()                 # fewer live replicas to wait for
        if self._stopping:
            # a replica death can leave idle survivors undrained (their
            # earlier stop check was skipped while requests sat buffered)
            self._maybe_stop_all()
        self._check_stopped()

    def _remove_from_ready(self, r: Replica):
        try:
            idx = self._ready.index(r)
        except ValueError:
            return
        if r.draining or r.stop_sent:
            # already left the rotation (cursor compensated at mark time)
            self._n_marked = max(0, self._n_marked - 1)
        else:
            self._note_leaving_rotation(r)
        self._ready.pop(idx)

    def _note_leaving_rotation(self, r: Replica):
        """Tell the balancer a replica is leaving the *rotation* — in
        rotation coordinates, since the cursor indexes the filtered list,
        not ``_ready``. Called before the mark/removal takes effect."""
        note = getattr(self.balancer, "note_removed", None)
        if note is None:
            return
        rot_idx = 0
        for other in self._ready:
            if other is r:
                note(rot_idx)
                return
            if not (other.draining or other.stop_sent):
                rot_idx += 1

    def _rotation(self) -> List[Replica]:
        """Replicas eligible for new work: ready and not on their way out
        (a drain sentinel is FIFO-ordered — work behind it is never served)."""
        if self._n_marked == 0:
            return self._ready
        return [r for r in self._ready if not (r.draining or r.stop_sent)]

    @property
    def n_live(self) -> int:
        """Replica tasks submitted and not yet terminal (any state)."""
        return self._n_submitted - self._n_terminal

    # ---------------------------------------------------------------- faults
    def _maybe_restart(self, task: Task) -> bool:
        """Schedule a replacement for a dead replica (under engine.lock)."""
        rp = self.restart
        if rp is None:
            return False
        if self._stopping and self._n_done >= len(self._submit_ts):
            return False                   # nothing left to serve
        # draining replicas are leaving the rotation — they must not count
        # as target coverage, or a death during a drain goes unreplaced
        if (self.n_live - self._n_marked + self._pending_restarts
                >= self.n_replicas):
            return False                   # target already covered
        if self.restarts >= rp.max_restarts:
            return False
        n_prior = self.restarts
        self.restarts += 1
        self._pending_restarts += 1
        self.engine.profiler.record(self.engine.now(), self.name,
                                    TRACE_NAMES["restart"],
                                    {"of": task.uid, "n": self.restarts})
        self.engine.schedule(max(rp.delay(n_prior), 1e-6),
                             self._submit_replacement, task.uid)
        return True

    def _submit_replacement(self, failed_uid: str):
        with self.engine.lock:
            self._pending_restarts -= 1
            if self._stopping and self._n_done >= len(self._submit_ts):
                # the stream drained while the backoff ran: abandon
                self._check_stopped()
                return
            desc = self._new_desc(restarted_from=failed_uid)
            self.submitter.resubmit([desc], origin=failed_uid)

    def _recover_replica_requests(self, r: Replica, task: Task):
        """Requests still queued or in flight on a FAILED/CANCELED replica
        are re-dispatched to survivors through the balancer; a rid that has
        burned its ``max_retries`` requeues fails with the replica's
        epitaph instead."""
        reason = f"replica {task.uid} {task.state.value}"
        rids: List[int] = []
        if self._real:
            sentinel = False
            try:
                while True:
                    item = r.queue.get_nowait()
                    if item is SVC_STOP:
                        sentinel = True    # keep the serve loop's wakeup
                        continue
                    rids.append(item[0])
            except _thread_queue.Empty:
                pass
            if sentinel:
                r.queue.put(SVC_STOP)
        else:
            rids.extend(r.queue)
            r.queue.clear()
            if r.busy:
                # the in-flight request: cancel its completion event and
                # retry it first (it has waited longest)
                if r.event is not None:
                    r.event.cancel()
                r.event = None
                r.busy = False
                if r.current >= 0:
                    rids.insert(0, r.current)
                r.current = -1
        for rid in rids:
            r.outstanding -= 1
            self._requeue_or_fail(rid, reason)

    def _requeue_inflight(self, r: Replica, rid: int, reason: str):
        """A real replica popped ``rid`` but died before starting its
        handler (called from the worker thread, under engine.lock)."""
        r.outstanding -= 1
        self._requeue_or_fail(rid, reason)

    def _requeue_or_fail(self, rid: int, reason: str):
        if self._end_ts[rid] >= 0.0:
            return                         # already terminal
        if self._retries[rid] >= self.max_retries:
            self._fail_rid(rid, f"{reason} (after {self._retries[rid]} "
                                f"retries)")
            return
        self._retries[rid] += 1
        self._start_ts[rid] = -1.0         # back in queue: start stamp resets
        live = self._rotation()
        if live:
            self._dispatch(rid, live)
        elif self.n_live > 0 or self._pending_restarts > 0:
            self._buffer.append(rid)       # a replacement is on its way
        else:
            self._fail_rid(rid, f"{reason} (no replicas left)")

    def kill_replica(self, uid: Optional[str] = None,
                     reason: str = "chaos kill") -> Optional[str]:
        """Fault injection: fail one live replica through its hosting
        executor (the normal on_failure path), which triggers request
        requeue and — with a RestartPolicy — a replacement. Picks the first
        ready replica when ``uid`` is None (falling back to one still
        provisioning). Returns the uid killed, or None."""
        with self.engine.lock:
            task: Optional[Task] = None
            if uid is not None:
                t = self.agent.tasks.get(uid)
                # only this service's replicas are valid targets — a stale
                # or foreign uid must not kill an unrelated agent task
                task = (t if t is not None and not t.done
                        and t.description.service is self else None)
            else:
                for r in self._ready:
                    if not r.task.done:
                        task = r.task
                        break
                if task is None:           # chaos strikes before readiness
                    for d in self._all_descs:
                        t = self.agent.tasks.get(d.uid)
                        if t is not None and not t.done and t.state in (
                                TaskState.PROVISIONING, TaskState.READY,
                                TaskState.SERVING):
                            task = t
                            break
            if task is None:
                return None
            ex = self.agent.backends.get(task.backend)
            if ex is not None:
                ex.fail_task(task, reason)
            return task.uid if task.done else None

    # ----------------------------------------------------------- autoscaling
    def _maybe_scale(self):
        """Evaluate the ScalePolicy against the live queue signal (under
        engine.lock; called from request/completion/readiness events)."""
        sp = self.scale
        if sp is None or not self._flushed:
            return
        now = self.engine.now()
        if now - self._last_scale < sp.cooldown:
            return
        live = self._rotation()
        if not live:
            return
        backlog = len(self._submit_ts) - self._n_done   # in flight + buffered
        per_replica = backlog / len(live)
        target = self.n_live + self._pending_restarts
        # scale-up stays armed while stopping — a declared stop still owes
        # the submitted stream saturation; scale-down is redundant there
        # (the stop protocol drains idle replicas itself)
        if per_replica > sp.up_threshold and target < sp.max_replicas:
            self._last_scale = now
            self.n_replicas += 1
            self._scale_t.append(now)
            self._scale_delta.append(1)
            desc = self._new_desc()
            self.engine.profiler.record(now, self.name,
                                        TRACE_NAMES["scale_up"],
                                        {"target": self.n_replicas})
            self.submitter.resubmit([desc], origin="scale-up")
        elif (not self._stopping and per_replica < sp.down_threshold
                and len(live) > 1 and target > max(1, sp.min_replicas)):
            idle = [r for r in live if r.outstanding == 0]
            if idle:
                self._last_scale = now
                self.n_replicas = max(1, self.n_replicas - 1)
                self._scale_t.append(now)
                self._scale_delta.append(-1)
                self.engine.profiler.record(now, self.name,
                                            TRACE_NAMES["scale_down"],
                                            {"target": self.n_replicas})
                self._drain_replica(idle[-1])

    def _drain_replica(self, r: Replica):
        """Take one replica out of the rotation and stop it (scale-down)."""
        task = r.task
        if task.done or r.draining or r.stop_sent:
            return
        self._note_leaving_rotation(r)
        r.draining = True
        self._n_marked += 1
        if task.state in (TaskState.READY, TaskState.SERVING):
            task.advance(TaskState.DRAINING, self.engine.now(),
                         self.engine.profiler)
        if self._real:
            r.stop_sent = True
            r.queue.put(SVC_STOP)
        elif not r.busy and not r.queue and r.outstanding == 0:
            ex = self.agent.backends.get(task.backend)
            if ex is not None:
                ex.stop_service(task)
        # else: sim replica still loaded — _sim_done finalizes the drain
        # once its queue empties (finalizing now would strand queued rids:
        # STOPPED replicas skip request recovery)

    def scale_log(self) -> Dict[str, Any]:
        """Columnar autoscale trace: event times and +1/-1 deltas."""
        return {"t": self._scale_t, "delta": self._scale_delta}

    def replica_seconds(self) -> float:
        """Aggregate replica availability: READY -> terminal per replica
        task, summed over every replica ever provisioned. Exact under
        elasticity, where a `replicas x window` product has no meaning
        (the count varies over the window)."""
        total = 0.0
        now = self.engine.now()
        tasks = self.agent.tasks
        for d in self._all_descs:
            t = tasks.get(d.uid)
            if t is None:
                continue
            ts = t.timestamps
            r0 = ts.get("READY")
            if r0 is None:
                continue                   # died before serving anything
            end = ts.get("STOPPED")
            if end is None:
                end = ts.get("FAILED", ts.get("CANCELED", now))
            total += max(0.0, end - r0)
        return total

    # ---------------------------------------------------------- rebalancing
    def _queue_len(self, r: Replica) -> int:
        return r.queue.qsize() if self._real else len(r.queue)

    def _steal_queued(self, r: Replica) -> List[int]:
        """Take r's queued (not in-flight) rids back (under engine.lock)."""
        rids: List[int] = []
        if self._real:
            try:
                while True:
                    item = r.queue.get_nowait()
                    if item is SVC_STOP:   # defensive: keep the wakeup
                        r.queue.put(SVC_STOP)
                        break
                    rids.append(item[0])
            except _thread_queue.Empty:
                pass
        else:
            rids.extend(r.queue)
            r.queue.clear()
        r.outstanding -= len(rids)
        return rids

    def _rebalance(self):
        """Even out queued (not in-flight) requests across the rotation.
        Replicas own their queues, so without this a scale-up or restart
        joiner would idle until new arrivals while loaded survivors grind —
        work stealing is what turns provisioning into recovered throughput.
        No retry is charged: stealing is routing, not failure."""
        live = self._rotation()
        if len(live) < 2:
            return
        sizes = [self._queue_len(r) for r in live]
        if max(sizes) - min(sizes) <= 1:
            return                     # already balanced: skip the churn
        stolen: List[int] = []
        for r in live:
            stolen.extend(self._steal_queued(r))
        if not stolen:
            return
        stolen.sort()                  # oldest requests re-dispatch first
        for rid in stolen:
            self._dispatch(rid, live)

    # ------------------------------------------------------------- requests
    def request(self, payload: Any = None,
                duration: Optional[float] = None) -> int:
        """Enqueue one request; returns its rid. Buffered until replicas are
        ready. ``duration`` overrides the sim service time for this request."""
        with self.engine.lock:
            if self._stopping or self._finalized:
                # _finalized covers death-without-stop(): every replica is
                # gone and none is coming, so the rid could only strand
                raise RuntimeError(f"{self.name}: stopped — no new requests")
            rid = len(self._submit_ts)
            self._submit_ts.append(self.engine.now())
            self._start_ts.append(-1.0)
            self._end_ts.append(-1.0)
            self._ok.append(_PENDING)
            self._retries.append(0)
            self._payloads.append(payload)
            self._durations.append(duration)
            self.results.append(None)
            live = self._rotation() if self._flushed else None
            if live:
                self._dispatch(rid, live)
            else:
                self._buffer.append(rid)
            self._maybe_scale()
        return rid

    def submit_requests(self, payloads) -> List[int]:
        return [self.request(p) for p in payloads]

    def _maybe_flush(self):
        """Release buffered requests once every still-live replica is ready
        (keeps the balancer's spread deterministic for buffered bursts);
        replicas lost before readiness shrink the expectation instead of
        stranding the buffer."""
        if not self._flushed:
            if self._ready and len(self._ready) >= self.n_live:
                self._flushed = True
        if self._flushed and self._buffer:
            live = self._rotation()
            if live:
                while self._buffer:
                    self._dispatch(self._buffer.popleft(), live)

    def _dispatch(self, rid: int, live: Optional[List[Replica]] = None):
        r = self.balancer.pick(live if live is not None else self._rotation())
        r.outstanding += 1
        task = r.task
        if task.state is TaskState.READY:
            task.advance(TaskState.SERVING, self.engine.now(),
                         self.engine.profiler)
        if self._real:
            r.queue.put((rid, self._payloads[rid]))
        else:
            r.queue.append(rid)
            if not r.busy:
                self._sim_start(r)

    # sim request execution --------------------------------------------
    def _sim_start(self, r: Replica):
        rid = r.queue.popleft()
        r.busy = True
        r.current = rid
        self._start_ts[rid] = self.engine.now()
        dur = self._durations[rid]
        if dur is None:
            dur = (self.engine.noisy(1.0 / self.rate, self.rate_sigma)
                   if self.rate > 0 else 1e-6)
        r.event = self.engine.schedule(max(dur, 1e-6), self._sim_done, r, rid)

    def _sim_done(self, r: Replica, rid: int):
        r.busy = False
        r.event = None
        r.current = -1
        if r.task.done:
            # the replica died mid-request through a path that bypassed the
            # terminal callback's recovery (e.g. a direct executor cancel):
            # its allocation is gone, so hand the request to a survivor
            r.outstanding -= 1
            self._requeue_or_fail(rid,
                                  f"replica {r.task.uid} {r.task.state.value}")
            return
        self._end_ts[rid] = self.engine.now()
        self._ok[rid] = _OK
        self._n_done += 1
        self._done_journal.append(rid)
        r.outstanding -= 1
        r.served += 1
        self._maybe_scale()
        if r.queue:
            self._sim_start(r)
        elif r.draining and r.outstanding == 0:
            # deferred scale-down drain: the queue just emptied
            ex = self.agent.backends.get(r.task.backend)
            if ex is not None:
                ex.stop_service(r.task)
        elif self._stopping:
            self._maybe_stop_replica(r)

    def _fail_rid(self, rid: int, reason: str):
        if self._end_ts[rid] >= 0.0:
            return
        self._end_ts[rid] = self.engine.now()
        self._ok[rid] = _FAILED
        self.results[rid] = reason
        self._n_done += 1
        self._done_journal.append(rid)

    # real request execution (called by the replica's worker thread) ----
    def _request_start(self, rid: int):
        self._start_ts[rid] = self.engine.now()

    def _request_complete(self, r: Replica, rid: int, result: Any, ok: bool):
        self._end_ts[rid] = self.engine.now()
        self._ok[rid] = _OK if ok else _FAILED
        self._n_done += 1
        self._done_journal.append(rid)
        self.results[rid] = result
        r.outstanding -= 1
        r.served += 1
        self._maybe_scale()

    # ------------------------------------------------------------------ stop
    def stop(self):
        """Graceful stop: serve everything already submitted (including
        buffered requests), then drain and stop every replica. Replicas not
        yet READY finalize as soon as they get there; pending restarts are
        abandoned. Idempotent."""
        with self.engine.lock:
            if self._stopping:
                return
            self._stopping = True
            self._maybe_stop_all()
            self._check_stopped()

    def _flush_or_fail_buffer(self):
        """Stop protocol: the normal flush waits for *every* live replica to
        be ready, but while stopping that can deadlock — a replica stuck
        QUEUED behind a full pool only launches once the ready ones drain,
        and they will not drain while the buffer waits on it. So flush once
        every *launched* live replica (PROVISIONING or beyond, i.e. holding
        resources) is ready: provisioning replicas reach readiness in
        finite time (preserving the balanced spread), queued ones are not
        waited for. With no live or incoming replica left, buffered
        requests fail instead of stranding as PENDING forever."""
        if not self._buffer:
            return
        live = self._rotation()
        if live and self._stop_flush_ready():
            self._flushed = True
            while self._buffer:
                self._dispatch(self._buffer.popleft(), live)
        elif (self._n_submitted > 0 and self.n_live == 0
                and self._pending_restarts == 0):
            # every replica ever created is terminal and no replacement is
            # coming: the buffered requests can never be delivered
            while self._buffer:
                self._fail_rid(self._buffer.popleft(),
                               "service stopped before any replica was ready")
        # else: replicas are still progressing (or not yet submitted —
        # campaign stages declare stop() before submitting descriptions);
        # readiness flushes for us

    def _stop_flush_ready(self) -> bool:
        """May the stop protocol release the buffer now? Yes at full
        readiness, or once no live replica is *progressing* toward READY
        (SCHEDULING / LAUNCHING / PROVISIONING all have a scheduled event
        driving them there; QUEUED does not — it waits on resources the
        ready replicas may themselves be holding, which is the deadlock the
        early flush breaks)."""
        if len(self._ready) >= self.n_live:
            return True
        if self._pending_restarts:
            return False
        tasks = self.agent.tasks
        for d in self._all_descs:
            t = tasks.get(d.uid)
            if (t is not None and not t.done and t.state in
                    (TaskState.SCHEDULING, TaskState.LAUNCHING,
                     TaskState.PROVISIONING)):
                return False
        return True

    def _maybe_stop_all(self):
        self._flush_or_fail_buffer()
        for r in list(self._ready):
            self._maybe_stop_replica(r)

    def _maybe_stop_replica(self, r: Replica):
        task = r.task
        if task.done or self._buffer:
            # undelivered buffered requests: the flush must spread them
            # across replicas before any replica drains
            return
        if self._real:
            # DRAINING now; the serve loop works off what is already queued
            # (sentinel is FIFO-ordered behind it) and then stops itself
            if not r.stop_sent:
                self._note_leaving_rotation(r)
                r.stop_sent = True
                self._n_marked += 1
                if task.state in (TaskState.READY, TaskState.SERVING):
                    task.advance(TaskState.DRAINING, self.engine.now(),
                                 self.engine.profiler)
                r.queue.put(SVC_STOP)
        elif not r.busy and not r.queue and r.outstanding == 0:
            # sim: idle — but a loaded sibling may still hold queued work
            # this replica could take; draining it now would burn capacity
            # (and invite the scale-up/drain churn the rebalance avoids)
            self._rebalance()
            if r.busy or r.queue or r.outstanding:
                return                 # stole work: drain when truly done
            # drained — finalize through the hosting executor so the
            # allocation is released and on_complete reaches the agent
            if task.state in (TaskState.READY, TaskState.SERVING):
                task.advance(TaskState.DRAINING, self.engine.now(),
                             self.engine.profiler)
            ex = self.agent.backends.get(task.backend)
            if ex is not None:
                ex.stop_service(task)

    def _check_stopped(self):
        """Fire the shutdown edge exactly once: when the last replica goes
        terminal with nothing pending, fail any requests still buffered
        (they would otherwise strand as PENDING and skew ``outstanding``)
        and notify on_stopped listeners (campaign stage release)."""
        if self._finalized or not self.stopped:
            return
        self._finalized = True
        while self._buffer:
            self._fail_rid(self._buffer.popleft(),
                           "service stopped with request undelivered")
        for cb in self._stopped_cbs:
            cb()
        self._stopped_cbs.clear()

    # ------------------------------------------------------------------ state
    @property
    def n_ready(self) -> int:
        return len(self._ready)

    @property
    def all_ready(self) -> bool:
        return (self._flushed and self._ready
                and len(self._ready) == self.n_live)

    @property
    def n_requests(self) -> int:
        return len(self._submit_ts)

    @property
    def n_completed(self) -> int:
        return self._n_done

    @property
    def outstanding(self) -> int:
        return len(self._submit_ts) - self._n_done - len(self._buffer)

    @property
    def stopped(self) -> bool:
        """All replica tasks (including restart replacements and scale-ups)
        reached a terminal state, with no replacement pending."""
        return (self._n_submitted > 0
                and self._n_terminal >= self._n_submitted
                and self._pending_restarts == 0)

    def on_ready(self, cb: Callable[[], None]):
        """Run ``cb`` once every replica is READY (immediately if they are)."""
        with self.engine.lock:
            if self.all_ready:
                cb()
            else:
                self._ready_cbs.append(cb)

    def on_stopped(self, cb: Callable[[], None]):
        """Run ``cb`` once the service has fully shut down — every replica
        terminal, no restart pending (immediately if already stopped)."""
        with self.engine.lock:
            if self._finalized:
                cb()
            else:
                self._stopped_cbs.append(cb)

    # ------------------------------------------------------------------ waits
    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until every replica is READY (real engine; on the sim engine
        this drains the event heap first — prefer ``on_ready`` there)."""
        return self.engine.drain(lambda: self.all_ready or self.stopped,
                                 timeout=timeout)

    def wait_requests(self, timeout: Optional[float] = None) -> bool:
        return self.engine.drain(
            lambda: self._n_done >= len(self._submit_ts) or self.stopped,
            timeout=timeout)

    def wait_stopped(self, timeout: Optional[float] = None) -> bool:
        return self.engine.drain(lambda: self.stopped, timeout=timeout)

    # -------------------------------------------------------------- analytics
    def request_log(self) -> Dict[str, Any]:
        """Columnar request trace for analytics: parallel arrays of submit /
        start / end timestamps, status codes (0 pending, 1 ok, 2 failed),
        and per-request requeue counts."""
        return {"submit": self._submit_ts, "start": self._start_ts,
                "end": self._end_ts, "ok": self._ok,
                "retries": self._retries}

    def completed_since(self, pos: int):
        """``(rids, new_pos)``: request ids completed (ok or failed) since
        journal position ``pos``, in completion order — the O(new) cursor
        streaming consumers poll (e.g. the observability layer's rolling
        service-p99 health rule)."""
        hi = len(self._done_journal)
        if pos >= hi:
            return [], hi
        return list(self._done_journal[pos:hi]), hi

    def served_per_replica(self) -> Dict[str, int]:
        return {uid: r.served for uid, r in self._replicas.items()}

    def __repr__(self):
        return (f"<Service {self.name} target={self.n_replicas} "
                f"live={self.n_live} ready={self.n_ready} "
                f"requests={self.n_requests} done={self._n_done} "
                f"restarts={self.restarts}>")
