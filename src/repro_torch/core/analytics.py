"""Metrics from event traces — identical definitions to the paper §4:

* throughput  = tasks launched per second (execution start rate),
* utilization = busy core-seconds / (allocated cores x makespan),
* makespan    = first submission -> last completion,
* overhead    = agent+backend bootstrap before the first launch.

The public functions are numpy-vectorized (sorted-starts sliding window for
peak throughput, prefix-sum sweep for concurrency) so million-task traces
are analyzed in milliseconds. The seed pure-Python implementations are kept
as ``_reference_*`` and pinned by the golden-equivalence tests
(tests/test_analytics_golden.py): integer fields must match exactly, float
fields to <=1e-9 relative (numpy's pairwise summation may differ from
sequential ``sum`` in the last ulp).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.calibration import CORES_PER_NODE
from repro_torch.core.task import CohortWave, Task, TaskCohort, TaskState


def _split_cohorts(tasks: Sequence) -> tuple:
    """Partition an analytics input into object tasks and TaskCohort
    columns (CohortWaves unpack to their groups). Anything task-shaped
    stays in the object list."""
    objs: List[Task] = []
    cohorts: List[TaskCohort] = []
    for item in tasks:
        if isinstance(item, Task):
            objs.append(item)
        elif isinstance(item, TaskCohort):
            cohorts.append(item)
        elif isinstance(item, CohortWave):
            cohorts.extend(item.cohorts)
        else:
            objs.append(item)
    return objs, cohorts


@dataclass
class RunMetrics:
    n_tasks: int
    n_done: int
    n_failed: int
    makespan: float
    throughput_avg: float          # tasks/s over the launch window
    throughput_peak: float         # best 10-second window
    utilization: float             # core-seconds busy / available
    overhead: float                # bootstrap time before first launch
    concurrency_peak: int

    def as_dict(self) -> Dict[str, float]:
        return self.__dict__.copy()


def compute_metrics(tasks: Sequence[Task], total_cores: int,
                    window: float = 10.0,
                    t_submit0: Optional[float] = None,
                    mode: str = "sim") -> RunMetrics:
    """``mode="sim"`` (default, golden-pinned) interprets timestamps as
    virtual times and charges each task its *simulated* resource footprint
    (description cores/nodes). ``mode="real"`` interprets them as wall-clock
    seconds from a real run on this host, where the description footprint is
    fictional: each task occupied one local worker, so ``total_cores`` should
    be the worker count, busy-time is charged one worker per task, and the
    makespan extends to the last *terminal* event (failures included)."""
    real = mode == "real"
    objs, cohorts = _split_cohorts(tasks)
    n_total = len(objs) + sum(c.n for c in cohorts)
    n_failed = 0
    term_end = 0.0
    starts_raw: List[float] = []
    ends_raw: List[float] = []
    cores_raw: List[int] = []
    for t in objs:                        # single pass: extract columns
        state = t.state
        if state is TaskState.DONE:
            ts = t.timestamps
            starts_raw.append(ts.get("RUNNING", 0.0))
            ends_raw.append(ts["DONE"])
            if real:
                cores_raw.append(1)
            else:
                d = t.description
                cores_raw.append(d.nodes * CORES_PER_NODE if d.nodes
                                 else max(1, d.cores))
        elif state is TaskState.FAILED:
            n_failed += 1
            if real:
                term_end = max(term_end, t.timestamps.get("FAILED", 0.0))
        elif real and state in (TaskState.STOPPED, TaskState.CANCELED):
            term_end = max(term_end, t.timestamps.get(state.value, 0.0))
    # cohort columns feed in directly: members never fail, and their
    # completion times are fully determined at plan time
    starts_arrays = ([np.asarray(starts_raw)] if starts_raw else [])
    ends_arrays = ([np.asarray(ends_raw)] if ends_raw else [])
    cores_arrays = ([np.asarray(cores_raw)] if cores_raw else [])
    for c in cohorts:
        if c.run_t is None:
            continue
        starts_arrays.append(c.run_t)
        ends_arrays.append(c.done_t)
        cores_arrays.append(np.full(c.n, 1 if real else c.cores_per_task(),
                                    dtype=np.int64))
    n_done = sum(len(a) for a in starts_arrays)
    if not n_done:
        return RunMetrics(n_total, 0, n_failed, 0.0, 0.0, 0.0, 0.0,
                          0.0, 0)

    starts_unsorted = (starts_arrays[0] if len(starts_arrays) == 1
                       else np.concatenate(starts_arrays))
    ends = (ends_arrays[0] if len(ends_arrays) == 1
            else np.concatenate(ends_arrays))
    cores_col = (cores_arrays[0] if len(cores_arrays) == 1
                 else np.concatenate(cores_arrays))
    starts = np.sort(starts_unsorted)

    if t_submit0 is not None:
        t0 = t_submit0
    else:
        t0 = min((t.timestamps.get("SCHEDULING", 0.0) for t in objs),
                 default=float("inf"))
        for c in cohorts:
            if c.sched_t < t0:
                t0 = c.sched_t
    start_min = float(starts[0])
    start_max = float(starts[-1])
    end_max = float(ends.max())
    makespan = (max(end_max, term_end) if real else end_max) - t0

    # throughput over the launch window
    launch_span = start_max - start_min
    thr_avg = n_done / launch_span if launch_span > 0 else float(n_done)
    # peak over sliding windows: for each start i, the window tail j is the
    # first start with starts[i] - starts[j] <= window
    tail = np.searchsorted(starts, starts - window, side="left")
    thr_peak = float((np.arange(1, n_done + 1) - tail).max()) / window

    busy = float(((ends - starts_unsorted) * cores_col).sum())
    # utilization over the execution window (first launch -> last completion):
    # bootstrap is reported separately as `overhead`, matching the paper's
    # metric split (§4, Fig. 7).
    exec_window = end_max - start_min
    util = busy / (total_cores * exec_window) if exec_window > 0 else 0.0

    overhead = start_min - t0

    # peak concurrency: always attained right after a start event, and the
    # reference tuple ordering processes ends before starts at equal
    # timestamps — so running-after-start-i is (i+1) minus the ends that
    # sorted no later (side="right"). Two searchsorted passes instead of
    # the 2n-element lexsort + cumsum sweep.
    ends_sorted = np.sort(ends)
    running = (np.arange(1, n_done + 1)
               - np.searchsorted(ends_sorted, starts, side="right"))
    peak = int(running.max())

    return RunMetrics(n_total, n_done, n_failed, makespan,
                      thr_avg, thr_peak, min(1.0, util), overhead, peak)


def occupancy_utilization(tasks: Sequence[Task], total_cores: int) -> float:
    """Allocation-occupancy utilization: each completed task charges its
    core width from LAUNCHING (allocation bound) to DONE (allocation
    freed), over the first-launch -> last-completion window. Unlike the
    RUNNING->DONE execution utilization in :func:`compute_metrics` this is
    meaningful for zero-duration calibration waves (the paper's §4 null
    workloads), where execution busy-time is identically zero while the
    launch pipeline keeps every allocation occupied for its service time."""
    objs, cohorts = _split_cohorts(tasks)
    starts_raw: List[float] = []
    ends_raw: List[float] = []
    cores_raw: List[int] = []
    for t in objs:
        if t.state is not TaskState.DONE:
            continue
        ts = t.timestamps
        if "LAUNCHING" not in ts:
            continue
        starts_raw.append(ts["LAUNCHING"])
        ends_raw.append(ts["DONE"])
        d = t.description
        cores_raw.append(d.nodes * CORES_PER_NODE if d.nodes
                         else max(1, d.cores))
    starts_arrays = ([np.asarray(starts_raw)] if starts_raw else [])
    ends_arrays = ([np.asarray(ends_raw)] if ends_raw else [])
    cores_arrays = ([np.asarray(cores_raw)] if cores_raw else [])
    for c in cohorts:
        if c.launch_t is None:
            continue
        starts_arrays.append(c.launch_t)
        ends_arrays.append(c.done_t)
        cores_arrays.append(np.full(c.n, c.cores_per_task(), dtype=np.int64))
    if not starts_arrays:
        return 0.0
    starts = np.concatenate(starts_arrays)
    ends = np.concatenate(ends_arrays)
    cores = np.concatenate(cores_arrays)
    window = float(ends.max() - starts.min())
    if window <= 0.0 or total_cores <= 0:
        return 0.0
    busy = float(((ends - starts) * cores).sum())
    return min(1.0, busy / (total_cores * window))


def concurrency_series(tasks: Sequence[Task], dt: float = 10.0
                       ) -> List[tuple]:
    """(t, #running) samples — the paper's Fig. 4/8 green curves."""
    objs, cohorts = _split_cohorts(tasks)
    starts_raw: List[float] = []
    ends_raw: List[float] = []
    for t in objs:
        ts = t.timestamps
        if "RUNNING" in ts and ("DONE" in ts or "FAILED" in ts):
            starts_raw.append(ts["RUNNING"])
            ends_raw.append(ts.get("DONE", ts.get("FAILED")))
    starts_arrays = ([np.asarray(starts_raw)] if starts_raw else [])
    ends_arrays = ([np.asarray(ends_raw)] if ends_raw else [])
    for c in cohorts:
        if c.run_t is None:
            continue
        starts_arrays.append(c.run_t)
        ends_arrays.append(c.done_t)
    if not starts_arrays:
        return []
    starts_sorted = np.sort(starts_arrays[0] if len(starts_arrays) == 1
                            else np.concatenate(starts_arrays))
    ends_sorted = np.sort(ends_arrays[0] if len(ends_arrays) == 1
                          else np.concatenate(ends_arrays))
    # every end is >= its start, so the trace's last event is the last end
    t_last = float(ends_sorted[-1])

    # sample grid via the same repeated addition as the reference loop so
    # float accumulation matches bit-for-bit
    samples: List[float] = []
    s = 0.0
    while s <= t_last:
        samples.append(s)
        s += dt
    if samples:
        # concurrency at sample s = events strictly before s:
        # #starts < s minus #ends < s (strict, so tie order is moot) —
        # two searchsorted passes, no 2n lexsort/cumsum
        grid = np.asarray(samples)
        conc = (np.searchsorted(starts_sorted, grid, side="left")
                - np.searchsorted(ends_sorted, grid, side="left"))
        out = [(s, int(c)) for s, c in zip(samples, conc)]
    else:
        out = []
    out.append((t_last, 0))
    return out


# --------------------------------------------------------------------------
# Campaign-scheduler analytics (repro_torch.sched): per-class wait-time
# distributions and weighted fairness over the task trace.
# --------------------------------------------------------------------------

@dataclass
class ClassWait:
    """Wait-time distribution for one scheduling class (tenant / priority
    level / stage): scheduler admission (SCHEDULING) to execution start."""
    n: int
    n_started: int
    wait_mean: float
    wait_p50: float
    wait_p99: float
    wait_max: float
    served_core_s: float           # width x runtime actually delivered
    weight: float                  # fair-share weight (max share seen)

    def as_dict(self) -> Dict[str, float]:
        return self.__dict__.copy()


@dataclass
class SchedMetrics:
    by_class: Dict[str, ClassWait]
    fairness: float                # Jain index over served_core_s / weight

    def as_dict(self) -> Dict[str, object]:
        return {"by_class": {k: v.as_dict()
                             for k, v in self.by_class.items()},
                "fairness": self.fairness}


def _desc_class(d, by: str) -> str:
    if by == "tenant":
        return d.tenant or "default"
    if by == "priority":
        return str(d.priority)
    if by == "stage":
        return d.stage or "default"
    raise KeyError(f"unknown class key {by!r} (tenant|priority|stage)")


def _task_class(t: Task, by: str) -> str:
    return _desc_class(t.description, by)


def sched_metrics(tasks: Sequence[Task], by: str = "tenant"
                  ) -> SchedMetrics:
    """Scheduling-quality metrics per class: wait percentiles (admission to
    start — scheduler hold plus dispatch plus backend queueing) and the
    Jain fairness index over weighted served work, the quantity a
    fair-share policy equalizes. Services count PROVISIONING as their
    start; tasks that never started contribute to ``n`` only.

    Cohort-aware: ``TaskCohort``/``CohortWave`` inputs contribute their
    plan-time columns directly (waits = ``run_t - sched_t``, served from
    ``done_t - run_t`` times the member width), so gated-scheduler runs at
    cohort scale report fairness too instead of silently dropping the
    cohort members."""
    objs, cohorts = _split_cohorts(tasks)
    groups: Dict[str, List[Task]] = {}
    for t in objs:
        groups.setdefault(_task_class(t, by), []).append(t)
    coh_groups: Dict[str, List[TaskCohort]] = {}
    for c in cohorts:
        coh_groups.setdefault(_desc_class(c.template, by), []).append(c)
    by_class: Dict[str, ClassWait] = {}
    shares: List[float] = []
    for cls in sorted(set(groups) | set(coh_groups)):
        ts = groups.get(cls, ())
        n_cls = len(ts)
        waits: List[float] = []
        wait_parts: List[np.ndarray] = []
        served = 0.0
        weight = 0.0
        for t in ts:
            d = t.description
            weight = max(weight, d.share)
            stamps = t.timestamps
            start = stamps.get("RUNNING", stamps.get("PROVISIONING"))
            if start is None or "SCHEDULING" not in stamps:
                continue
            waits.append(start - stamps["SCHEDULING"])
            end = stamps.get("DONE", stamps.get("STOPPED"))
            if end is not None:
                width = (d.nodes * CORES_PER_NODE if d.nodes
                         else max(1, d.cores))
                served += width * (end - start)
        if waits:
            wait_parts.append(np.asarray(waits))
        for c in coh_groups.get(cls, ()):
            n_cls += c.n
            weight = max(weight, c.template.share)
            if c.run_t is None:
                continue
            wait_parts.append(c.run_t - c.sched_t)
            served += c.cores_per_task() * float((c.done_t - c.run_t).sum())
        if wait_parts:
            w = (wait_parts[0] if len(wait_parts) == 1
                 else np.concatenate(wait_parts))
            p50, p99 = np.percentile(w, (50.0, 99.0))
            by_class[cls] = ClassWait(n_cls, len(w), float(w.mean()),
                                      float(p50), float(p99),
                                      float(w.max()), served,
                                      weight or 1.0)
        else:
            by_class[cls] = ClassWait(n_cls, 0, 0.0, 0.0, 0.0, 0.0,
                                      served, weight or 1.0)
        shares.append(served / (weight or 1.0))
    x = np.asarray([s for s in shares if s > 0.0])
    if x.size:
        fairness = float((x.sum() ** 2) / (x.size * (x * x).sum()))
    else:
        fairness = 1.0
    return SchedMetrics(by_class, fairness)


# --------------------------------------------------------------------------
# Service-task analytics (repro_torch.services): request-latency percentiles
# and per-service utilization over the columnar request log.
# --------------------------------------------------------------------------

@dataclass
class ServiceMetrics:
    n_requests: int
    n_completed: int
    n_failed: int                  # handler raised / retries exhausted
    latency_mean: float            # submit -> completion, queueing included
    latency_p50: float
    latency_p90: float
    latency_p99: float
    service_time_mean: float       # start -> completion (handler only)
    throughput: float              # completed requests / serving window
    utilization: float             # busy replica-seconds / (replicas x window)
    window: float                  # first request start -> last completion
    # fault-model columns (requeue / restart / autoscale)
    n_retried: int                 # requests completed OK after >=1 requeue
    retries_total: int             # requeue dispatches across all requests
    n_restarts: int                # replica replacements scheduled
    n_scale_up: int                # autoscale provisions
    n_scale_down: int              # autoscale drains

    def as_dict(self) -> Dict[str, float]:
        return self.__dict__.copy()


def service_metrics(service) -> ServiceMetrics:
    """Request-level metrics for one :class:`repro_torch.services.Service`,
    from its columnar request log (vectorized; million-request streams are fine)."""
    log = service.request_log()
    submit = np.asarray(log["submit"])
    start = np.asarray(log["start"])
    end = np.asarray(log["end"])
    ok = np.frombuffer(bytes(log["ok"]), dtype=np.uint8)
    retries = np.frombuffer(bytes(log.get("retries", b"")), dtype=np.uint8)
    n = len(submit)
    if len(retries) != n:
        retries = np.zeros(n, dtype=np.uint8)
    retries_total = int(retries.sum())
    n_retried = int(((retries > 0) & (ok == 1)).sum())
    n_restarts = int(getattr(service, "restarts", 0))
    deltas = getattr(service, "scale_log", lambda: {"delta": ()})()["delta"]
    n_scale_up = int(sum(1 for d in deltas if d > 0))
    n_scale_down = int(sum(1 for d in deltas if d < 0))
    done = end >= 0.0                     # completed (ok or failed)
    n_done = int(done.sum())
    n_failed = int((ok == 2).sum())
    if not n_done:
        return ServiceMetrics(n, 0, n_failed, 0.0, 0.0, 0.0, 0.0, 0.0,
                              0.0, 0.0, 0.0, n_retried, retries_total,
                              n_restarts, n_scale_up, n_scale_down)
    started = done & (start >= 0.0)       # failed-in-buffer rids never start
    lat = end[done] - submit[done]
    svc_t = end[started] - start[started]
    p50, p90, p99 = np.percentile(lat, (50.0, 90.0, 99.0))
    window = (float(end[done].max() - start[started].min())
              if started.any() else 0.0)
    busy = float(svc_t.sum())
    # availability denominator: actual READY->terminal replica-seconds when
    # the service can report them (exact under autoscaling/restart, where
    # the replica count varies over the window); `replicas x window` is the
    # fallback for plain fixed-rotation services
    rs = getattr(service, "replica_seconds", None)
    avail = rs() if rs is not None else 0.0
    if avail <= 0.0:
        avail = max(1, service.n_replicas) * window
    util = busy / avail if avail > 0 else 0.0
    thr = n_done / window if window > 0 else float(n_done)
    svc_mean = float(svc_t.mean()) if started.any() else 0.0
    return ServiceMetrics(n, n_done, n_failed, float(lat.mean()),
                          float(p50), float(p90), float(p99),
                          svc_mean, thr, min(1.0, util), window,
                          n_retried, retries_total, n_restarts,
                          n_scale_up, n_scale_down)


# --------------------------------------------------------------------------
# Fault-model analytics (repro_torch.faults): failure/recovery accounting
# computed from the columnar event trace, not from task objects — requeued tasks
# carry only their final attempt's state, so the trace is the one place the
# full failure history lives.
# --------------------------------------------------------------------------

@dataclass
class FaultMetrics:
    node_failures: int             # chaos:node_fail injections
    pilot_failures: int            # chaos:pilot_fail injections
    tasks_killed: int              # tasks failed directly by chaos
    tasks_requeued: int            # sched:requeue (pilot-death evacuations)
    retries_total: int             # agent:retry dispatches
    retries_by_cause: Dict[str, int]   # task | node | pilot | walltime
    walltime_kills: int            # task:walltime enforcements
    checkpoint_resumes: int        # task:resume (restarts with progress)
    recovered_core_s: float        # sum(progress x cores) over resumes
    view_shrinks: int              # sched:view_shrink (admission degraded)

    def as_dict(self) -> Dict[str, object]:
        return self.__dict__.copy()


def fault_metrics(profiler) -> FaultMetrics:
    """Failure/recovery accounting for one run, from the engine profiler's
    columnar trace. ``recovered_core_s`` is the core-seconds of work that
    checkpoint-resume did *not* redo: each ``task:resume`` event carries
    the progress (seconds of work already banked) and core width of the
    resuming attempt. Event names resolve through the recording modules'
    trace-name registries (``repro_torch.faults.chaos.TRACE_NAMES``,
    ``repro_torch.sched.scheduler.TRACE_NAMES``), not hardcoded strings."""
    from repro_torch.faults.chaos import TRACE_NAMES as CHAOS
    from repro_torch.sched.scheduler import TRACE_NAMES as SCHED

    # the vectorized per-name scan (rows_np/iter_name), not rows_by_name:
    # the fault names have ~0..k rows, and extending the whole-trace list
    # index just to count them costs O(all rows) on million-task traces
    def count(name: str) -> int:
        return len(profiler.rows_np(name))

    killed = 0
    for ev in profiler.iter_name(CHAOS["node_fail"]):
        killed += int((ev.data or {}).get("n_victims", 0))
    for ev in profiler.iter_name(CHAOS["pilot_fail"]):
        killed += int((ev.data or {}).get("n_victims", 0))
    by_cause: Dict[str, int] = {}
    for ev in profiler.iter_name("agent:retry"):
        cause = (ev.data or {}).get("cause", "task")
        by_cause[cause] = by_cause.get(cause, 0) + 1
    recovered = 0.0
    n_resumes = 0
    for ev in profiler.iter_name("task:resume"):
        n_resumes += 1
        d = ev.data or {}
        recovered += float(d.get("progress", 0.0)) * max(
            1, int(d.get("cores", 1)))
    return FaultMetrics(
        node_failures=count(CHAOS["node_fail"]),
        pilot_failures=count(CHAOS["pilot_fail"]),
        tasks_killed=killed,
        tasks_requeued=count(SCHED["requeue"]),
        retries_total=sum(by_cause.values()),
        retries_by_cause=by_cause,
        walltime_kills=count("task:walltime"),
        checkpoint_resumes=n_resumes,
        recovered_core_s=recovered,
        view_shrinks=count(SCHED["view_shrink"]))


# --------------------------------------------------------------------------
# Seed pure-Python implementations, kept verbatim as the golden reference
# for the vectorized paths above (see tests/test_analytics_golden.py).
# --------------------------------------------------------------------------

def _reference_compute_metrics(tasks: Sequence[Task], total_cores: int,
                               window: float = 10.0,
                               t_submit0: Optional[float] = None
                               ) -> RunMetrics:
    done = [t for t in tasks if t.state == TaskState.DONE]
    failed = [t for t in tasks if t.state == TaskState.FAILED]
    starts = sorted(t.timestamps.get("RUNNING", 0.0) for t in done)
    ends = [t.timestamps["DONE"] for t in done]
    if not done:
        return RunMetrics(len(tasks), 0, len(failed), 0.0, 0.0, 0.0, 0.0,
                          0.0, 0)

    t0 = (t_submit0 if t_submit0 is not None
          else min(t.timestamps.get("SCHEDULING", 0.0) for t in tasks))
    makespan = max(ends) - t0

    launch_span = max(starts) - min(starts)
    thr_avg = len(starts) / launch_span if launch_span > 0 else float(len(starts))
    thr_peak = 0.0
    j = 0
    for i in range(len(starts)):
        while starts[i] - starts[j] > window:
            j += 1
        thr_peak = max(thr_peak, (i - j + 1) / window)

    def cores_of(t: Task) -> int:
        d = t.description
        return d.nodes * CORES_PER_NODE if d.nodes else max(1, d.cores)

    busy = sum((t.timestamps["DONE"] - t.timestamps["RUNNING"]) * cores_of(t)
               for t in done)
    exec_window = max(ends) - min(starts)
    util = busy / (total_cores * exec_window) if exec_window > 0 else 0.0

    overhead = min(starts) - t0

    events = sorted([(s, 1) for s in starts]
                    + [(t.timestamps["DONE"], -1) for t in done])
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)

    return RunMetrics(len(tasks), len(done), len(failed), makespan,
                      thr_avg, thr_peak, min(1.0, util), overhead, peak)


def _reference_concurrency_series(tasks: Sequence[Task], dt: float = 10.0
                                  ) -> List[tuple]:
    done = [t for t in tasks if "RUNNING" in t.timestamps and
            ("DONE" in t.timestamps or "FAILED" in t.timestamps)]
    if not done:
        return []
    events = []
    for t in done:
        end = t.timestamps.get("DONE", t.timestamps.get("FAILED"))
        events.append((t.timestamps["RUNNING"], 1))
        events.append((end, -1))
    events.sort()
    out = []
    cur = 0
    next_sample = 0.0
    for tm, d in events:
        while tm >= next_sample:
            out.append((next_sample, cur))
            next_sample += dt
        cur += d
    out.append((events[-1][0], 0))
    return out
