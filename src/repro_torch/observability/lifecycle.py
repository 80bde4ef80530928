"""Lifecycle decomposition: where did each task's time go?

The paper's characterization results (§4) are per-component time
decompositions — RADICAL-Analytics-style attribution of every task's
submit->done span to the runtime component that held it.  This module
derives the same decomposition closed-form from the transition timestamps
plus the scheduler's per-task release rows, with no per-event iteration:
object tasks contribute one extraction pass, cohort columns feed in as
numpy arrays directly (``TaskCohort.timestamp_columns``), so million-task
runs decompose in milliseconds.

Phases tile the ``SCHEDULING -> DONE`` span exactly (telescoping sums, so
per-task phase durations reconcile with ``compute_metrics`` makespan to
float precision):

========== ==================================================================
``hold``     scheduler admission hold: SCHEDULING -> ``sched:release:p<i>``
             row (0 for passthrough / unscheduled tasks — the release rows
             come from :data:`repro_torch.sched.scheduler.TRACE_NAMES`)
``dispatch`` agent dispatch queue: release -> QUEUED
``queue``    backend executor queue: QUEUED -> LAUNCHING
``launch``   launch delay: LAUNCHING -> RUNNING (placement + spawn)
``exec``     execution + collection: RUNNING -> DONE (the runtime stamps
             DONE at result collection, so collection is the tail of this
             phase; there is no separate post-exec transition)
========== ==================================================================

Grouping: ``by`` = ``backend`` | ``pilot`` | ``tenant`` | ``stage`` |
``None`` (one overall group).  Pilot attribution uses the scheduler's
per-pilot release tracks; tasks that never crossed a gated scheduler group
under ``"-"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analytics import _split_cohorts
from repro_torch.core.calibration import CORES_PER_NODE
from repro_torch.core.task import TaskState

PHASES: Tuple[str, ...] = ("hold", "dispatch", "queue", "launch", "exec")

_GROUP_KEYS = ("backend", "pilot", "tenant", "stage")


@dataclass
class PhaseStats:
    """Aggregate of one phase's per-task durations within one group."""

    n: int
    mean: float
    p50: float
    p99: float
    max: float
    sum: float

    def as_dict(self) -> Dict[str, float]:
        return self.__dict__.copy()


@dataclass
class GroupBreakdown:
    """Per-group phase decomposition plus span/width accounting."""

    n: int                               # tasks decomposed in this group
    phases: Dict[str, PhaseStats]
    span_sum: float                      # sum of SCHEDULING->DONE spans
    exec_core_s: float                   # sum of exec * core width

    def as_dict(self) -> Dict[str, Any]:
        return {"n": self.n, "span_sum": self.span_sum,
                "exec_core_s": self.exec_core_s,
                "phases": {k: v.as_dict() for k, v in self.phases.items()}}


@dataclass
class LifecycleBreakdown:
    """The full decomposition: overall + per-group phase aggregates, plus
    (when services are passed in) per-service request phase splits."""

    by: Optional[str]
    n_tasks: int                         # decomposed (DONE with full stamps)
    n_skipped: int                       # failed / incomplete / undone
    total: GroupBreakdown
    groups: Dict[str, GroupBreakdown] = field(default_factory=dict)
    services: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        out = {"by": self.by, "n_tasks": self.n_tasks,
               "n_skipped": self.n_skipped,
               "total": self.total.as_dict(),
               "groups": {k: v.as_dict() for k, v in self.groups.items()}}
        if self.services:
            out["services"] = self.services
        return out


def _stats(col: np.ndarray) -> PhaseStats:
    """PhaseStats aggregate of one duration column."""
    if not len(col):
        return PhaseStats(0, 0.0, 0.0, 0.0, 0.0, 0.0)
    p50, p99 = np.percentile(col, (50.0, 99.0))
    return PhaseStats(len(col), float(col.mean()), float(p50), float(p99),
                      float(col.max()), float(col.sum()))


def service_request_breakdown(service) -> Dict[str, Any]:
    """Queue-vs-service phase split of one service's request log: the log
    stamps submit/start/end per request, so each completed request's
    latency tiles into ``queue`` (submit -> start: replica wait) and
    ``service`` (start -> end: handler time). Requests that failed in the
    buffer (never started) are counted but not decomposed."""
    log = service.request_log()
    submit = np.asarray(log["submit"], dtype=np.float64)
    start = np.asarray(log["start"], dtype=np.float64)
    end = np.asarray(log["end"], dtype=np.float64)
    done = (end >= 0.0) & (start >= 0.0)
    return {"n_requests": len(submit),
            "n_decomposed": int(done.sum()),
            "phases": {
                "queue": _stats(start[done] - submit[done]).as_dict(),
                "service": _stats(end[done] - start[done]).as_dict()}}


def _release_map(profiler) -> Tuple[Dict[int, float], Dict[int, int]]:
    """eid -> (release time, pilot index) from the scheduler's per-pilot
    release tracks (``sched:release:p<i>``). Empty when no gated scheduler
    recorded releases."""
    from repro_torch.sched.scheduler import release_name
    rel_t: Dict[int, float] = {}
    rel_p: Dict[int, int] = {}
    i = 0
    while profiler.has_name(release_name(i)):
        name = release_name(i)
        eids = profiler.eids_np(name)
        if len(eids):
            times = profiler.times_np(name)
            rel_t.update(zip(eids.tolist(), times.tolist()))
            rel_p.update(zip(eids.tolist(), [i] * len(eids)))
        i += 1
    return rel_t, rel_p


def _cores_of(d) -> int:
    return d.nodes * CORES_PER_NODE if d.nodes else max(1, d.cores)


def lifecycle_breakdown(tasks: Sequence, profiler=None,
                        by: Optional[str] = "backend",
                        services: Sequence = (),
                        ) -> LifecycleBreakdown:
    """Decompose every completed task's lifecycle into the five phases and
    aggregate mean/p50/p99/max/sum per group (see module docs).

    ``tasks`` is anything ``Agent.all_tasks`` returns — object ``Task``
    instances, ``TaskCohort`` columns, ``CohortWave`` handles, mixed.
    ``profiler`` enables scheduler-hold attribution and pilot grouping
    (without it, holds fold into ``dispatch`` and every task's pilot is
    unattributed). ``services`` adds per-service request phase splits
    (:func:`service_request_breakdown`) under ``services``."""
    if by is not None and by not in _GROUP_KEYS:
        raise KeyError(f"unknown group key {by!r} (one of {_GROUP_KEYS})")
    objs, cohorts = _split_cohorts(tasks)

    rel_t: Dict[int, float] = {}
    rel_p: Dict[int, int] = {}
    if profiler is not None:
        rel_t, rel_p = _release_map(profiler)

    sched_cols: List[np.ndarray] = []
    rel_cols: List[np.ndarray] = []
    queued_cols: List[np.ndarray] = []
    launch_cols: List[np.ndarray] = []
    run_cols: List[np.ndarray] = []
    done_cols: List[np.ndarray] = []
    cores_cols: List[np.ndarray] = []
    label_cols: List[np.ndarray] = []     # int codes — a million-member
    label_names: List[str] = []           # object array would dominate agg
    label_codes: Dict[str, int] = {}
    n_skipped = 0

    def code(lbl: str) -> int:
        c = label_codes.get(lbl)
        if c is None:
            c = label_codes[lbl] = len(label_names)
            label_names.append(lbl)
        return c

    # ------------------------------------------------------- object tasks
    if objs:
        raw: List[Tuple[float, float, float, float, float, float]] = []
        labels: List[int] = []
        for t in objs:
            if t.state is not TaskState.DONE:
                n_skipped += 1
                continue
            ts = t.timestamps
            try:
                sched = ts["SCHEDULING"]
                queued = ts["QUEUED"]
                launch = ts["LAUNCHING"]
                run = ts["RUNNING"]
                done = ts["DONE"]
            except KeyError:
                n_skipped += 1
                continue
            eid = (t._trace_eid
                   if getattr(t, "_trace_prof", None) is profiler else None)
            release = rel_t.get(eid, sched) if eid is not None else sched
            # a retried task's final-attempt stamps can precede the (first)
            # release row; clamp so the tiling stays monotonic
            release = min(max(release, sched), queued)
            raw.append((sched, release, queued, launch, run, done))
            if by == "backend":
                labels.append(code(t.backend or "-"))
            elif by == "pilot":
                p = rel_p.get(eid) if eid is not None else None
                labels.append(code(f"p{p}" if p is not None else "-"))
            elif by == "tenant":
                labels.append(code(t.description.tenant or "default"))
            elif by == "stage":
                labels.append(code(t.description.stage or "default"))
            else:
                labels.append(code("all"))
            cores_cols.append(np.asarray([_cores_of(t.description)]))
        if raw:
            cols = np.asarray(raw, dtype=np.float64)
            sched_cols.append(cols[:, 0])
            rel_cols.append(cols[:, 1])
            queued_cols.append(cols[:, 2])
            launch_cols.append(cols[:, 3])
            run_cols.append(cols[:, 4])
            done_cols.append(cols[:, 5])
            label_cols.append(np.asarray(labels, dtype=np.int64))
            # collapse the per-task single-element core arrays into one
            cores_obj = np.fromiter(
                (c[0] for c in cores_cols), dtype=np.int64,
                count=len(cores_cols))
            cores_cols = [cores_obj]

    # ----------------------------------------------------- cohort columns
    for c in cohorts:
        tsc = c.timestamp_columns()
        if "DONE" not in tsc or "RUNNING" not in tsc:
            n_skipped += c.n
            continue
        sched_cols.append(np.asarray(tsc["SCHEDULING"], dtype=np.float64))
        rel_cols.append(sched_cols[-1])      # cohorts are passthrough-only
        queued_cols.append(np.asarray(tsc["QUEUED"], dtype=np.float64))
        launch_cols.append(np.asarray(tsc["LAUNCHING"], dtype=np.float64))
        run_cols.append(np.asarray(tsc["RUNNING"], dtype=np.float64))
        done_cols.append(np.asarray(tsc["DONE"], dtype=np.float64))
        cores_cols.append(np.full(c.n, c.cores_per_task(), dtype=np.int64))
        d = c.template
        if by == "backend":
            lbl = c.backend or "-"
        elif by == "pilot":
            lbl = "-"
        elif by == "tenant":
            lbl = d.tenant or "default"
        elif by == "stage":
            lbl = d.stage or "default"
        else:
            lbl = "all"
        label_cols.append(np.full(c.n, code(lbl), dtype=np.int64))

    svc_bd = {s.name: service_request_breakdown(s) for s in services}

    if not done_cols:
        empty = GroupBreakdown(0, {p: PhaseStats(0, 0.0, 0.0, 0.0, 0.0, 0.0)
                                   for p in PHASES}, 0.0, 0.0)
        return LifecycleBreakdown(by, 0, n_skipped, empty, {}, svc_bd)

    def cat(parts: List[np.ndarray]) -> np.ndarray:
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    sched = cat(sched_cols)
    release = cat(rel_cols)
    queued = cat(queued_cols)
    launch = cat(launch_cols)
    run = cat(run_cols)
    done = cat(done_cols)
    cores = cat(cores_cols)
    labels_all = cat(label_cols)

    phase_cols = {
        "hold": release - sched,
        "dispatch": queued - release,
        "queue": launch - queued,
        "launch": run - launch,
        "exec": done - run,
    }
    span = done - sched

    def agg(mask: Optional[np.ndarray]) -> GroupBreakdown:
        phases: Dict[str, PhaseStats] = {}
        for name in PHASES:
            col = phase_cols[name] if mask is None else phase_cols[name][mask]
            phases[name] = _stats(col)
        sp = span if mask is None else span[mask]
        ex = phase_cols["exec"] if mask is None else phase_cols["exec"][mask]
        cr = cores if mask is None else cores[mask]
        return GroupBreakdown(len(sp), phases, float(sp.sum()),
                              float((ex * cr).sum()))

    total = agg(None)
    groups: Dict[str, GroupBreakdown] = {}
    if by is not None:
        uniq = np.unique(labels_all)
        if len(uniq) == 1:
            groups[label_names[int(uniq[0])]] = total
        else:
            for c in uniq:
                groups[label_names[int(c)]] = agg(labels_all == c)
    return LifecycleBreakdown(by, len(span), n_skipped, total, groups,
                              svc_bd)
