"""Chrome trace-event export: load a run into Perfetto / chrome://tracing.

Emits the JSON Array Format of the trace-event spec — the least common
denominator every trace viewer accepts:

* one **process** per backend (``pid``), one **thread** per launch lane
  within it (``tid``) — task slices pack onto lanes greedily so
  overlapping executions render side by side instead of on top of each
  other;
* ``"X"`` (complete) events for task execution spans, RUNNING -> DONE,
  with ``ts``/``dur`` in microseconds as the spec requires (input
  timestamps are seconds, virtual or wall); passing ``services=`` adds
  one process per service whose completed request spans (submit -> end)
  render as ``req.{rid}`` slices under the same global slice cap;
* ``"C"`` (counter) tracks for the reconstructed timeseries — core
  occupancy, scheduler hold depth, completion throughput — so the gauge
  curves render under the slices;
* ``"i"`` (instant) events for chaos injections (``chaos:node_fail`` /
  ``chaos:pilot_fail`` / ``chaos:skip``) and streamed health alerts
  (``obs:alert``), so fault timing lines up visually with its impact;
* ``"M"`` (metadata) events naming every process and thread.

Slices are capped (``max_slices``, evenly strided so the whole run stays
visible) because viewers choke long before the runtime does — a 1M-task
trace is fine to *analyze* here but not to *render*. The cap is never
silent: the dropped count is recorded in ``otherData`` and returned.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.analytics import _split_cohorts
from repro_torch.core.task import TaskState

from repro_torch.observability.timeseries import (Series, occupancy,
                                                  sched_hold_depth, throughput)

_US = 1e6                     # seconds -> microseconds


def _slice_segments(tasks: Sequence, services: Sequence = ()) -> List[tuple]:
    """Completed-task slices as ``(process, starts, ends, label_fn)``
    segments — one per object-task backend plus one per cohort, plus one
    per service (completed request spans). Labels resolve lazily per
    local index, so a 1M-task wave never materializes uid strings (or a
    1M-element object array of backend names) for slices the
    ``max_slices`` cap will drop."""
    objs, cohorts = _split_cohorts(tasks)
    per_backend: Dict[str, List[List[Any]]] = {}
    for t in objs:
        if t.state is not TaskState.DONE:
            continue
        ts = t.timestamps
        run, done = ts.get("RUNNING"), ts.get("DONE")
        if run is None or done is None:
            continue
        cols = per_backend.setdefault(t.backend or "-", [[], [], []])
        cols[0].append(run)
        cols[1].append(done)
        cols[2].append(t.uid)
    segments: List[tuple] = []
    for b, (ss, ee, uu) in sorted(per_backend.items()):
        segments.append((b, np.asarray(ss), np.asarray(ee), uu.__getitem__))
    for c in cohorts:
        if c.run_t is None or c.done_t is None:
            continue
        segments.append((c.backend or "-", np.asarray(c.run_t),
                         np.asarray(c.done_t), c.uid))
    for svc in services:
        log = svc.request_log()
        submit = np.asarray(log["submit"], dtype=np.float64)
        end = np.asarray(log["end"], dtype=np.float64)
        if not len(submit):
            continue
        # completed requests only: pending / never-finished carry -1.0
        rids = np.flatnonzero((submit >= 0.0) & (end >= 0.0))
        if not len(rids):
            continue
        segments.append((f"service:{svc.name}", submit[rids], end[rids],
                         lambda i, r=rids: f"req.{int(r[i])}"))
    return segments


_INSTANT_NAMES = ("chaos:node_fail", "chaos:pilot_fail", "chaos:skip",
                  "obs:alert")


def _instant_events(profiler) -> List[Dict[str, Any]]:
    """``"i"`` rows for chaos injections and streamed health alerts, with
    scalar payload fields carried into ``args``."""
    events: List[Dict[str, Any]] = []
    for name in _INSTANT_NAMES:
        if not profiler.has_name(name):
            continue
        for ev in profiler.iter_name(name):
            args = {k: v for k, v in (ev.data or {}).items()
                    if isinstance(v, (str, int, float, bool))}
            events.append({"ph": "i", "name": name, "pid": 0, "tid": 0,
                           "ts": int(round(ev.time * _US)), "s": "g",
                           "cat": "fault" if name.startswith("chaos:")
                           else "alert", "args": args})
    return events


def _pack_lanes(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Greedy interval-graph coloring in start order: each slice takes the
    lowest lane whose previous slice already ended. Returns per-slice lane
    ids (the ``tid`` within the backend's process)."""
    import heapq
    order = np.argsort(starts, kind="stable")
    lanes = np.zeros(len(starts), dtype=np.int64)
    free: List[int] = []          # heap of reusable lane ids
    busy: List[tuple] = []        # heap of (end, lane)
    next_lane = 0
    for i in order:
        s = starts[i]
        while busy and busy[0][0] <= s:
            heapq.heappush(free, heapq.heappop(busy)[1])
        if free:
            lane = heapq.heappop(free)
        else:
            lane = next_lane
            next_lane += 1
        lanes[i] = lane
        heapq.heappush(busy, (ends[i], lane))
    return lanes


def chrome_trace(tasks: Sequence, profiler=None, total_cores: int = 0,
                 dt: float = 1.0, max_slices: int = 20000,
                 extra_counters: Optional[Dict[str, Series]] = None,
                 services: Sequence = ()) -> Dict[str, Any]:
    """Build the trace-event dict (``json.dump``-ready). See module docs;
    ``extra_counters`` adds caller-provided Series as counter tracks,
    ``services`` adds request-span processes (same ``max_slices`` cap)."""
    segments = _slice_segments(tasks, services)
    n_total = sum(len(s[1]) for s in segments)
    dropped = 0
    if n_total > max_slices:
        # even stride over the global slice order keeps the full run span
        # visible instead of truncating the tail
        sel = np.unique(np.linspace(0, n_total - 1,
                                    max_slices).astype(np.int64))
        dropped = n_total - len(sel)
    else:
        sel = None

    # gather kept (start, end, label) per backend, resolving labels only
    # for surviving slices
    gathered: Dict[str, List[tuple]] = {}
    lo = 0
    for b, s_seg, e_seg, label_fn in segments:
        hi = lo + len(s_seg)
        if sel is None:
            local = np.arange(len(s_seg), dtype=np.int64)
        else:
            local = sel[np.searchsorted(sel, lo):
                        np.searchsorted(sel, hi)] - lo
        if len(local):
            gathered.setdefault(b, []).append(
                (s_seg[local], e_seg[local],
                 [label_fn(int(i)) for i in local]))
        lo = hi

    events: List[Dict[str, Any]] = []
    backends = sorted(gathered)
    pid_of = {b: i + 1 for i, b in enumerate(backends)}
    for b in backends:
        pname = b if b.startswith("service:") else f"backend:{b}"
        events.append({"ph": "M", "name": "process_name", "pid": pid_of[b],
                       "tid": 0, "args": {"name": pname}})
    starts = np.empty(0)                  # run-wide, for the counter gate
    for b in backends:
        parts = gathered[b]
        b_starts = np.concatenate([p[0] for p in parts])
        b_ends = np.concatenate([p[1] for p in parts])
        b_labels = [u for p in parts for u in p[2]]
        starts = np.concatenate((starts, b_starts))
        lanes = _pack_lanes(b_starts, b_ends)
        pid = pid_of[b]
        for lane in range(int(lanes.max()) + 1 if len(lanes) else 0):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": lane,
                           "args": {"name": f"lane {lane}"}})
        s_us = np.round(b_starts * _US).astype(np.int64)
        d_us = np.round((b_ends - b_starts) * _US).astype(np.int64)
        for i in range(len(s_us)):
            events.append({"ph": "X", "name": b_labels[i],
                           "pid": pid, "tid": int(lanes[i]),
                           "ts": int(s_us[i]),
                           "dur": max(int(d_us[i]), 1), "cat": "task"})

    # counter tracks (pid 0 = the run-wide gauges process)
    counters: Dict[str, Series] = {}
    if len(starts):
        counters["throughput"] = throughput(profiler, tasks, dt)
        if total_cores > 0:
            counters["occupancy"] = occupancy(tasks, total_cores, dt)
    if profiler is not None:
        hold = sched_hold_depth(profiler, dt)
        if len(hold):
            counters["sched_hold_depth"] = hold
    if extra_counters:
        counters.update(extra_counters)
    if counters:
        events.append({"ph": "M", "name": "process_name", "pid": 0,
                       "tid": 0, "args": {"name": "gauges"}})
    for cname, series in counters.items():
        if not len(series):
            continue
        t_us = np.round(series.t * _US).astype(np.int64)
        for i in range(len(t_us)):
            events.append({"ph": "C", "name": cname, "pid": 0, "tid": 0,
                           "ts": int(t_us[i]),
                           "args": {cname: float(series.v[i])}})

    # instant markers: chaos injections + streamed health alerts
    instants = _instant_events(profiler) if profiler is not None else []
    if instants and not counters:
        events.append({"ph": "M", "name": "process_name", "pid": 0,
                       "tid": 0, "args": {"name": "gauges"}})
    events.extend(instants)

    # global ts sort: viewers require non-decreasing ts within a track;
    # sorting the whole array (metadata first via ts absence -> -1)
    # guarantees it per track too
    events.sort(key=lambda e: (e.get("ts", -1), e["pid"], e["tid"]))
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"generator": "repro_torch.observability",
                          "n_slices": int(n_total - dropped),
                          "n_slices_dropped": int(dropped),
                          "n_counter_tracks": len(counters),
                          "n_instants": len(instants)}}


def export_chrome_trace(path: str, tasks: Sequence, profiler=None,
                        total_cores: int = 0, dt: float = 1.0,
                        max_slices: int = 20000,
                        services: Sequence = ()) -> Dict[str, Any]:
    """Write the Chrome trace JSON to ``path``; returns the ``otherData``
    summary (including the dropped-slice count — never capped silently)."""
    doc = chrome_trace(tasks, profiler, total_cores=total_cores, dt=dt,
                       max_slices=max_slices, services=services)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc["otherData"]
