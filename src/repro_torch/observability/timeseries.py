"""Post-hoc timeseries reconstruction + opt-in live sampling.

Everything here is derived *after the fact* from the columnar trace and the
task columns — the runtime pays nothing at record time beyond the two array
appends it already makes per transition.  Reconstruction is windowed
(``dt``-second bins) and fully vectorized: a 1M-task trace turns into a
throughput curve with one ``np.histogram`` call, and the step-function
metrics (in-flight tasks, core occupancy, scheduler hold depth) are a
single +1/-1 event sweep (sort + cumsum) sampled onto the grid.

All grids are snapped to the absolute ``dt`` lattice so the streaming
aggregators in :mod:`repro_torch.observability.stream` — which fold the same
events incrementally, delta by delta — land on bit-identical bin edges
and (for the integer-weighted counts and levels here) bit-identical
values.  Live sampling of instantaneous gauges (executor queue depth,
free cores) lives in :mod:`repro_torch.observability.stream` too
(:class:`~repro_torch.observability.stream.LiveSampler`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.analytics import _split_cohorts
from repro_torch.core.calibration import CORES_PER_NODE
from repro_torch.core.task import STATE_EVENTS, TaskState

_DONE_EVENT = STATE_EVENTS[TaskState.DONE]
_RUN_EVENT = STATE_EVENTS[TaskState.RUNNING]

METRICS = ("throughput", "inflight", "occupancy", "sched_hold_depth",
           "backend_inflight", "service_queue_depth")


@dataclass
class Series:
    """One windowed timeseries: ``v[i]`` covers ``[t[i], t[i] + dt)``."""

    name: str
    t: np.ndarray
    v: np.ndarray
    dt: float

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "dt": self.dt,
                "t": self.t.tolist(), "v": self.v.tolist()}

    def __len__(self) -> int:
        return len(self.t)


def _grid(t_lo: float, t_hi: float, dt: float) -> np.ndarray:
    """Bin left edges covering ``[t_lo, t_hi]``, snapped to the absolute
    ``dt`` lattice (edge ``i`` is exactly ``dt * k`` for integer ``k``).
    Snapping makes the grid a pure function of (floor(t/dt), dt) rather
    than of the first event's float timestamp, so a streaming aggregator
    that has only seen a prefix of the events builds bit-identical edges
    to a post-hoc pass over the full series.  The last edge is > t_hi,
    so step series show the post-final-event level — e.g. a hold queue
    that drained to zero ends at zero."""
    k0 = int(np.floor(t_lo / dt))
    k1 = int(np.floor(t_hi / dt)) + 1
    return dt * np.arange(k0, k1 + 1, dtype=np.float64)


def _step_series(name: str, starts: np.ndarray, ends: np.ndarray,
                 weights: Optional[np.ndarray], dt: float) -> Series:
    """Sample the step function ``sum(w : start <= t < end)`` at bin edges
    via one merged +1/-1 sweep (ends are exclusive; a task ending exactly
    on an edge does not count in that bin)."""
    if not len(starts):
        return Series(name, np.empty(0), np.empty(0), dt)
    if weights is None:
        weights = np.ones(len(starts))
    times = np.concatenate((starts, ends))
    deltas = np.concatenate((weights, -weights))
    order = np.argsort(times, kind="stable")
    times = times[order]
    level = np.cumsum(deltas[order])
    grid = _grid(float(starts.min()), float(ends.max()), dt)
    # level after all events <= edge; ends sort after starts at equal time
    # (stable + starts first in the concat), so an interval [e, e) is flat
    idx = np.searchsorted(times, grid, side="right") - 1
    v = np.where(idx >= 0, level[np.clip(idx, 0, None)], 0.0)
    return Series(name, grid, v, dt)


def _start_end_cols(tasks: Sequence, per_backend: bool = False):
    """(starts, ends, cores, backends) columns of every completed task."""
    objs, cohorts = _split_cohorts(tasks)
    starts: List[np.ndarray] = []
    ends: List[np.ndarray] = []
    cores: List[np.ndarray] = []
    backends: List[np.ndarray] = []
    raw = []
    for t in objs:
        if t.state is not TaskState.DONE:
            continue
        ts = t.timestamps
        run, done = ts.get("RUNNING"), ts.get("DONE")
        if run is None or done is None:
            continue
        d = t.description
        c = d.nodes * CORES_PER_NODE if d.nodes else max(1, d.cores)
        raw.append((run, done, c))
        if per_backend:
            backends.append(t.backend or "-")
    if raw:
        cols = np.asarray([(r[0], r[1], r[2]) for r in raw])
        starts.append(cols[:, 0])
        ends.append(cols[:, 1])
        cores.append(cols[:, 2])
        if per_backend:
            backends = [np.asarray(backends, dtype=object)]
    elif per_backend:
        backends = []
    for c in cohorts:
        if c.run_t is None or c.done_t is None:
            continue
        starts.append(np.asarray(c.run_t, dtype=np.float64))
        ends.append(np.asarray(c.done_t, dtype=np.float64))
        cores.append(np.full(c.n, c.cores_per_task(), dtype=np.float64))
        if per_backend:
            backends.append(np.full(c.n, c.backend or "-", dtype=object))

    def cat(parts):
        if not parts:
            return np.empty(0)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    return cat(starts), cat(ends), cat(cores), cat(backends)


# ---------------------------------------------------------------------------
# reconstruction entry points
# ---------------------------------------------------------------------------

def throughput(profiler=None, tasks: Optional[Sequence] = None,
               dt: float = 1.0) -> Series:
    """Completion rate (tasks/s) per ``dt`` window. Prefers the trace
    (one histogram over the ``state:DONE`` column); falls back to task
    timestamps when no profiler is given."""
    if profiler is not None and profiler.has_name(_DONE_EVENT):
        done = profiler.times_np(_DONE_EVENT)
    elif tasks is not None:
        _, done, _, _ = _start_end_cols(tasks)
    else:
        done = np.empty(0)
    if not len(done):
        return Series("throughput", np.empty(0), np.empty(0), dt)
    # integer floor-binning on the absolute dt lattice (not np.histogram,
    # whose float edge comparisons can differ from floor(t/dt) at edges):
    # bin membership is then exact and order-independent, so a streaming
    # fold over arbitrary trace deltas reproduces these counts verbatim
    k = np.floor(done / dt).astype(np.int64)
    grid = _grid(float(done.min()), float(done.max()), dt)
    k0 = int(np.floor(float(done.min()) / dt))
    counts = np.bincount(k - k0, minlength=len(grid))
    return Series("throughput", grid, counts / dt, dt)


def inflight(tasks: Sequence, dt: float = 1.0) -> Series:
    """Concurrently-running task count sampled every ``dt`` seconds."""
    starts, ends, _, _ = _start_end_cols(tasks)
    return _step_series("inflight", starts, ends, None, dt)


def occupancy(tasks: Sequence, total_cores: int, dt: float = 1.0) -> Series:
    """Fraction of ``total_cores`` busy, core-weighted, per ``dt`` bin."""
    starts, ends, cores, _ = _start_end_cols(tasks)
    s = _step_series("occupancy", starts, ends, cores, dt)
    if total_cores > 0 and len(s.v):
        s.v = s.v / total_cores
    return s


def backend_inflight(tasks: Sequence, dt: float = 1.0) -> Dict[str, Series]:
    """Per-backend concurrently-running task counts."""
    starts, ends, _, backends = _start_end_cols(tasks, per_backend=True)
    out: Dict[str, Series] = {}
    if not len(starts):
        return out
    for name in np.unique(backends):
        m = backends == name
        out[str(name)] = _step_series(f"inflight:{name}", starts[m],
                                      ends[m], None, dt)
    return out


def sched_hold_depth(profiler, dt: float = 1.0) -> Series:
    """Campaign-scheduler hold-queue depth over time: +1 per ``sched:hold``
    row, -1 when a held entity appears on a per-pilot release track. A
    direct event sweep — no hold/release pairing — so unreleased holds
    (still pending at exit) keep the tail of the series elevated, which is
    the truthful reading. Entities released without ever being held (plain
    passthrough) don't contribute."""
    from repro_torch.sched.scheduler import TRACE_NAMES, release_name
    if not profiler.has_name(TRACE_NAMES["hold"]):
        return Series("sched_hold_depth", np.empty(0), np.empty(0), dt)
    hold_t = profiler.times_np(TRACE_NAMES["hold"])
    if not len(hold_t):        # name interned but never recorded
        return Series("sched_hold_depth", np.empty(0), np.empty(0), dt)
    hold_e = profiler.eids_np(TRACE_NAMES["hold"])
    rel_t_parts: List[np.ndarray] = []
    i = 0
    while profiler.has_name(release_name(i)):
        name = release_name(i)
        if len(profiler.rows_np(name)):
            held = np.isin(profiler.eids_np(name), hold_e)
            if held.any():
                rel_t_parts.append(profiler.times_np(name)[held])
        i += 1
    rel_t = (np.concatenate(rel_t_parts) if rel_t_parts else np.empty(0))
    times = np.concatenate((hold_t, rel_t))
    deltas = np.concatenate((np.ones(len(hold_t)), -np.ones(len(rel_t))))
    order = np.argsort(times, kind="stable")
    times = times[order]
    level = np.cumsum(deltas[order])
    grid = _grid(float(hold_t.min()), float(times.max()), dt)
    idx = np.searchsorted(times, grid, side="right") - 1
    v = np.where(idx >= 0, level[np.clip(idx, 0, None)], 0.0)
    # a task held once but released on re-entry too (requeue after its
    # first release) can push the sweep below zero; clamp — depth is a
    # queue length
    return Series("sched_hold_depth", grid, np.maximum(v, 0.0), dt)


def service_queue_depth(service, dt: float = 1.0) -> Series:
    """Pending-request depth of one service over time, from its columnar
    request log (submitted but not yet started)."""
    log = service.request_log()
    submit = np.asarray(log["submit"], dtype=np.float64)
    start = np.asarray(log["start"], dtype=np.float64)
    if not len(submit):
        return Series(f"qdepth:{service.name}", np.empty(0), np.empty(0), dt)
    # never-started requests carry a -1.0 start stamp (pending / service
    # stopped); close them at the horizon so the tail stays truthful
    horizon = float(max(submit.max(), start.max() if len(start) else 0.0)) + dt
    ends = start.copy()
    ends[ends < 0.0] = horizon
    ends = np.maximum(ends, submit)
    return _step_series(f"qdepth:{service.name}", submit, ends, None, dt)


def timeseries(profiler=None, tasks: Optional[Sequence] = None,
               metric: str = "throughput", dt: float = 1.0,
               total_cores: int = 0, service=None):
    """Dispatcher over the reconstruction metrics (see ``METRICS``)."""
    if metric == "throughput":
        return throughput(profiler, tasks, dt)
    if metric == "inflight":
        return inflight(tasks or (), dt)
    if metric == "occupancy":
        return occupancy(tasks or (), total_cores, dt)
    if metric == "backend_inflight":
        return backend_inflight(tasks or (), dt)
    if metric == "sched_hold_depth":
        if profiler is None:
            raise ValueError("sched_hold_depth needs a profiler")
        return sched_hold_depth(profiler, dt)
    if metric == "service_queue_depth":
        if service is None:
            raise ValueError("service_queue_depth needs a service")
        return service_queue_depth(service, dt)
    raise KeyError(f"unknown metric {metric!r} (one of {METRICS})")
