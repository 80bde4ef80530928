"""Streaming telemetry: live trace cursors, incremental aggregation,
online health alerts, and the self-refreshing ``watch`` dashboard.

The post-hoc layer (:mod:`~repro_torch.observability.lifecycle`,
:mod:`~repro_torch.observability.timeseries`) reconstructs everything after the
drain; this module derives the *same* numbers while the campaign runs,
which is how the runtimes the paper characterizes are actually operated —
you watch utilization and task-rate live, you do not wait for the run to
finish to learn it stalled an hour in.

Architecture — three layers, each usable alone:

* :class:`TraceCursor` — an O(Δ) poll over the columnar
  :class:`~repro_torch.core.events.Profiler`: each ``poll()`` copies only the
  rows appended since the previous poll (``Profiler.tail``) plus any newly
  interned event names, and splits the packed id column into name/entity
  ids once.  No scan, no index build, no per-row Python.
* streaming aggregators — :class:`StreamingThroughput`,
  :class:`StreamingLevel` (in-flight / occupancy / scheduler-hold depth)
  and :class:`StreamingBreakdown` (the five-phase lifecycle decomposition)
  fold each delta with a handful of vectorized passes.  All bin grids are
  snapped to the absolute ``dt`` lattice (see ``timeseries._grid``), so at
  drain the folded counts and sampled levels are **bit-identical** to the
  post-hoc reconstruction, and the breakdown sums/means agree to float
  summation order (<1e-9 relative at a million tasks);
  ``StreamingBreakdown.stats(exact_quantiles=True)`` even reproduces the
  post-hoc percentiles exactly with one O(n) gather at drain.
* :class:`Watcher` — the engine-driven orchestrator (absorbing the old
  ``LiveSampler``, still exported for compatibility): one scheduled
  callback per ``interval`` folds the delta, samples the instantaneous
  gauges the trace cannot reconstruct (executor queue depth, free cores),
  evaluates the health rules, and optionally appends a JSONL metric
  record (``emit=``) and rewrites an OpenMetrics text exposition
  (``promfile=``).  It re-arms itself only while the agent has unfinished
  work, so a ``SimEngine`` event loop is never held open, and
  ``finalize()`` folds whatever the last tick missed.

Health rules (:class:`StallRule`, :class:`ThroughputDropRule`,
:class:`QueueRunawayRule`, :class:`ServiceLatencyRule`) are evaluated by a
:class:`HealthMonitor` that edge-triggers: one ``obs:alert`` trace row per
breach episode (re-armed on recovery), consumable by ``RunReport`` and
``ChaosController.stats()``.

Exactness contract (tested): on a failure-free run the streamed
throughput/inflight/occupancy/hold-depth series equal the post-hoc ones
bit-for-bit, and the streamed breakdown equals ``lifecycle_breakdown`` to
1e-9.  Under chaos the streams stay truthful but diverge by construction:
levels count *attempts* as they happen (a killed task's span still
occupied cores), and a multi-release requeue resolves chronologically
last-wins rather than the post-hoc release-map's track-order quirk.
Late events (an out-of-order delta below an already-frozen bin edge) only
affect future edges and are counted in ``n_late`` — they cannot happen
through the engine-callback path, which always polls under the engine
lock.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.events import _NAME_BITS, _NAME_MASK
from repro_torch.core.task import STATE_EVENTS, TaskState
from repro_torch.observability.lifecycle import PHASES
from repro_torch.observability.timeseries import Series

# entity / event name under which HealthMonitor records alert rows
ALERT_ENTITY = "obs"
ALERT_EVENT = "obs:alert"

_SCHED = STATE_EVENTS[TaskState.SCHEDULING]
_QUEUED = STATE_EVENTS[TaskState.QUEUED]
_LAUNCH = STATE_EVENTS[TaskState.LAUNCHING]
_RUN = STATE_EVENTS[TaskState.RUNNING]
_DONE = STATE_EVENTS[TaskState.DONE]
_FAILED = STATE_EVENTS[TaskState.FAILED]
_CANCELED = STATE_EVENTS[TaskState.CANCELED]


# ---------------------------------------------------------------------------
# cursor
# ---------------------------------------------------------------------------

@dataclass
class TraceDelta:
    """Rows ``[lo, hi)`` of the trace, split into columns, plus any event
    names interned since the previous poll (``new_names`` is a list of
    ``(nid, name)``)."""

    lo: int
    hi: int
    times: np.ndarray                   # float64, row order (NOT time order)
    nids: np.ndarray                    # int64 name ids
    new_names: List[Tuple[int, str]]
    _packed: np.ndarray = field(repr=False, default=None)
    _eids: Optional[np.ndarray] = field(repr=False, default=None)

    @property
    def n(self) -> int:
        return self.hi - self.lo

    @property
    def eids(self) -> np.ndarray:
        """Entity ids, split lazily — the breakdown needs them, the pure
        counting aggregators do not."""
        if self._eids is None:
            self._eids = self._packed >> _NAME_BITS
        return self._eids


class TraceCursor:
    """Incremental reader over a :class:`~repro_torch.core.events.Profiler`.

    Contract: ``poll()`` returns every row appended since the previous
    ``poll()`` exactly once, in append order, at O(Δ) cost (one bounded
    copy of the two raw columns plus one mask/shift each).  Row order is
    append order, *not* time order — the cohort fast path bulk-stamps
    whole waves with future timestamps — so aggregators sort within each
    delta where order matters.  Polling an appending profiler is safe on
    both engines as long as the poll runs under ``engine.lock`` (the
    Watcher's callbacks do); the profiler never mutates published rows.

    ``copy=False`` borrows views of the trace columns instead of copying
    them — valid only until the next profiler append, so strictly for
    callers (like the Watcher) that fold the delta to completion under
    the engine lock before returning.
    """

    def __init__(self, profiler, start: int = 0, copy: bool = True):
        self.profiler = profiler
        self.pos = start
        self._copy = copy
        self._names_pos = 0

    def poll(self) -> TraceDelta:
        prof = self.profiler
        times, packed, hi = prof.tail(self.pos, copy=self._copy)
        lo, self.pos = self.pos, hi
        new_names: List[Tuple[int, str]] = []
        n_names = prof.n_names()
        if n_names > self._names_pos:
            new_names = [(nid, prof.name_of(nid))
                         for nid in range(self._names_pos, n_names)]
            self._names_pos = n_names
        return TraceDelta(lo, hi, times, packed & _NAME_MASK, new_names,
                          _packed=packed)


# ---------------------------------------------------------------------------
# streaming aggregators
# ---------------------------------------------------------------------------

_EMPTY_F = np.empty(0, dtype=np.float64)
_EMPTY_I = np.empty(0, dtype=np.int64)


def _sorted1d(a: np.ndarray) -> np.ndarray:
    """``a`` sorted ascending — returned as-is (no copy) when already
    sorted, which trace columns of a cohort wave always are."""
    if len(a) > 1 and bool(np.any(a[1:] < a[:-1])):
        return np.sort(a)
    return a

class StreamingThroughput:
    """Completion-count histogram on the absolute ``dt`` lattice, folded
    delta by delta.  Bin membership is ``floor(t / dt)`` — identical to the
    post-hoc :func:`~repro_torch.observability.timeseries.throughput`, so
    ``series()`` at drain is bit-equal to the post-hoc curve."""

    def __init__(self, dt: float = 1.0):
        self.dt = dt
        self._counts = np.empty(0, dtype=np.int64)
        self._k0: Optional[int] = None
        self.n_total = 0
        self.t_lo = float("inf")
        self.t_hi = float("-inf")

    def fold(self, times: np.ndarray) -> None:
        if not len(times):
            return
        k = np.floor(times / self.dt).astype(np.int64)
        kmin, kmax = int(k.min()), int(k.max())
        if self._k0 is None:
            self._k0 = kmin
        elif kmin < self._k0:
            self._counts = np.concatenate(
                (np.zeros(self._k0 - kmin, dtype=np.int64), self._counts))
            self._k0 = kmin
        need = kmax - self._k0 + 1
        if need > len(self._counts):
            grown = np.zeros(max(need, 2 * len(self._counts)),
                             dtype=np.int64)
            grown[:len(self._counts)] = self._counts
            self._counts = grown
        self._counts += np.bincount(k - self._k0,
                                    minlength=len(self._counts))
        self.n_total += len(times)
        self.t_lo = min(self.t_lo, float(times.min()))
        self.t_hi = max(self.t_hi, float(times.max()))

    def series(self) -> Series:
        if self._k0 is None:
            return Series("throughput", np.empty(0), np.empty(0), self.dt)
        k1 = int(np.floor(self.t_hi / self.dt)) + 1
        n = k1 - self._k0 + 1
        counts = np.zeros(n, dtype=np.int64)
        m = min(n, len(self._counts))
        counts[:m] = self._counts[:m]
        grid = self.dt * np.arange(self._k0, k1 + 1, dtype=np.float64)
        return Series("throughput", grid, counts / self.dt, self.dt)


class StreamingLevel:
    """Step-function level (``sum of +w/-w events``) sampled on the ``dt``
    lattice, folded incrementally: edges strictly below the newest event
    seen are *frozen* at the net sum of all events at-or-before them —
    which is exactly what the post-hoc ``_step_series`` sweep samples, and
    is independent of tie order, so frozen values are bit-identical to the
    post-hoc ones.  ``fold`` expects each delta's events pre-sorted by
    time (the caller merges starts and ends); deltas themselves must be
    chronologically nondecreasing for the frozen prefix to stay exact —
    violations are counted in ``n_late`` and only perturb already-frozen
    edges, never future ones."""

    def __init__(self, name: str, dt: float = 1.0, clamp0: bool = False):
        self.name = name
        self.dt = dt
        self.clamp0 = clamp0
        self._chunks: List[np.ndarray] = []      # frozen edge values
        self._k0: Optional[int] = None
        self._next_k = 0                         # next edge index to freeze
        self.level = 0.0
        self.peak = 0.0
        self.t_hi = float("-inf")
        self.n_events = 0
        self.n_late = 0

    def fold(self, times: np.ndarray, deltas: np.ndarray) -> None:
        if not len(times):
            return
        dt = self.dt
        if self._k0 is None:
            self._k0 = int(np.floor(float(times[0]) / dt))
            self._next_k = self._k0
        elif self._next_k > self._k0:
            last_frozen = dt * (self._next_k - 1)
            if float(times[0]) <= last_frozen:
                self.n_late += int(np.searchsorted(times, last_frozen,
                                                   side="right"))
        cum = self.level + np.cumsum(deltas)
        t_last = float(times[-1])
        k_hi = int(np.floor(t_last / dt))
        if dt * k_hi >= t_last:
            k_hi -= 1                  # freeze only edges strictly < t_last
        if k_hi >= self._next_k:
            edges = dt * np.arange(self._next_k, k_hi + 1, dtype=np.float64)
            idx = np.searchsorted(times, edges, side="right") - 1
            vals = np.where(idx >= 0, cum[np.clip(idx, 0, None)], self.level)
            self._chunks.append(vals)
            self._next_k = k_hi + 1
        self.level = float(cum[-1])
        self.peak = max(self.peak, float(cum.max()))
        self.t_hi = max(self.t_hi, t_last)
        self.n_events += len(times)

    def fold_counts(self, starts: np.ndarray, ends: np.ndarray) -> None:
        """Unit-weight fold from separate +1/-1 event arrays, without
        building the merged sweep: the frozen value at edge ``e`` is
        ``level + #starts<=e - #ends<=e`` — two ``searchsorted`` calls
        over each (sorted) array — which is exactly the net sum the
        generic :meth:`fold` samples, so the two paths are bit-identical
        on frozen values and ``level``.  Only ``peak`` coarsens: it is
        sampled at bin edges and delta boundaries rather than per event
        (display-only).  Arrays are sorted on entry if needed; cohort
        columns arrive sorted and skip the copy."""
        ns, ne = len(starts), len(ends)
        if not ns and not ne:
            return
        starts, ends = _sorted1d(starts), _sorted1d(ends)
        dt = self.dt
        t_first = min(float(starts[0]) if ns else float("inf"),
                      float(ends[0]) if ne else float("inf"))
        t_last = max(float(starts[-1]) if ns else float("-inf"),
                     float(ends[-1]) if ne else float("-inf"))
        if self._k0 is None:
            self._k0 = int(np.floor(t_first / dt))
            self._next_k = self._k0
        elif self._next_k > self._k0:
            last_frozen = dt * (self._next_k - 1)
            if t_first <= last_frozen:
                self.n_late += int(np.searchsorted(
                    starts, last_frozen, side="right"))
                self.n_late += int(np.searchsorted(
                    ends, last_frozen, side="right"))
        k_hi = int(np.floor(t_last / dt))
        if dt * k_hi >= t_last:
            k_hi -= 1                  # freeze only edges strictly < t_last
        if k_hi >= self._next_k:
            edges = dt * np.arange(self._next_k, k_hi + 1, dtype=np.float64)
            vals = self.level + (
                np.searchsorted(starts, edges, side="right")
                - np.searchsorted(ends, edges, side="right")
            ).astype(np.float64)
            self._chunks.append(vals)
            self._next_k = k_hi + 1
            if len(vals):
                self.peak = max(self.peak, float(vals.max()))
        self.level += float(ns - ne)
        self.peak = max(self.peak, self.level)
        self.t_hi = max(self.t_hi, t_last)
        self.n_events += ns + ne

    def series(self, divisor: float = 1.0, name: Optional[str] = None,
               ) -> Series:
        """The curve so far (callable mid-run; does not mutate state).
        Unfrozen edges — everything at or past the newest event — carry
        the current level, exactly as the post-hoc sweep samples them."""
        if self._k0 is None:
            return Series(name or self.name, np.empty(0), np.empty(0),
                          self.dt)
        k1 = int(np.floor(self.t_hi / self.dt)) + 1
        grid = self.dt * np.arange(self._k0, k1 + 1, dtype=np.float64)
        frozen = (np.concatenate(self._chunks) if self._chunks
                  else np.empty(0))
        frozen = frozen[:len(grid)]
        v = np.concatenate(
            (frozen, np.full(len(grid) - len(frozen), self.level)))
        if self.clamp0:
            v = np.maximum(v, 0.0)
        if divisor != 1.0:
            v = v / divisor
        return Series(name or self.name, grid, v, self.dt)


class StreamingBreakdown:
    """Incremental five-phase lifecycle decomposition.

    General path: transition timestamps are scattered into dense
    per-entity stamp columns as their rows arrive (first-wins for
    SCHEDULING/QUEUED, overwrite for LAUNCHING/RUNNING and scheduler
    releases — mirroring the runtime's own timestamp semantics); each
    ``state:DONE`` row then gathers its five stamps (:meth:`fold_done`),
    clamps the release into the ``[SCHEDULING, QUEUED]`` tiling exactly
    like :func:`~repro_torch.observability.lifecycle.lifecycle_breakdown`, and
    folds the phase durations into running n/sum/max.

    Aligned path (:meth:`fold_aligned`): when the caller can prove the
    five per-transition time arrays of one delta are column-aligned —
    same tasks, same order, full lifecycle in-delta, no holds/releases/
    retries, which is how the cohort fast path bulk-stamps whole waves —
    the join is elementwise and the scatter/gather is skipped entirely.

    The exact per-task phase durations are retained as chunk lists, so
    ``stats(exact_quantiles=True)`` reproduces the post-hoc percentiles
    bit-for-bit (same multiset) with one concatenate at drain.
    Everything is vectorized per delta; nothing iterates per task.

    ``weights_fn(eids) -> cores`` attributes core-seconds; without it
    every task counts one core (exact for the 1-core campaigns the
    benchmarks run; pass a mapping for heterogeneous shapes).
    """

    _FIRST = ("sched", "queued")        # first timestamp wins
    _LAST = ("launch", "run", "rel")    # overwrite (retry semantics)

    def __init__(self, weights_fn: Optional[Callable] = None):
        self.weights_fn = weights_fn
        self._col: Dict[str, np.ndarray] = {
            k: np.empty(0) for k in self._FIRST + self._LAST}
        self.n = 0
        self.n_skipped = 0
        self.span_sum = 0.0
        self.exec_core_s = 0.0
        self._sum = {p: 0.0 for p in PHASES}
        self._max = {p: 0.0 for p in PHASES}
        self._chunks: Dict[str, List[np.ndarray]] = {p: [] for p in PHASES}

    # ------------------------------------------------------------- folding
    def _arr(self, key: str, eids: np.ndarray) -> np.ndarray:
        arr = self._col[key]
        need = int(eids.max()) + 1 if len(eids) else 0
        if need > len(arr):
            grown = np.full(max(need, 2 * len(arr), 1024), np.nan)
            grown[:len(arr)] = arr
            self._col[key] = arr = grown
        return arr

    def fold_stamp(self, key: str, times: np.ndarray, eids: np.ndarray,
                   ) -> None:
        if not len(times):
            return
        arr = self._arr(key, eids)
        if key in self._FIRST:
            m = np.isnan(arr[eids])
            if m.all():
                arr[eids[::-1]] = times[::-1]
            else:
                # reversed scatter: on duplicate eids within one delta the
                # first occurrence is assigned last, so the first stamp wins
                arr[eids[m][::-1]] = times[m][::-1]
        else:
            arr[eids] = times

    def fold_done(self, times: np.ndarray, eids: np.ndarray) -> None:
        """Decompose freshly-completed tasks by gathering their stamps
        (call after the delta's stamps are folded)."""
        s = self._arr("sched", eids)[eids]
        q = self._arr("queued", eids)[eids]
        la = self._arr("launch", eids)[eids]
        ru = self._arr("run", eids)[eids]
        rel = self._arr("rel", eids)[eids]
        ok = ~(np.isnan(s) | np.isnan(q) | np.isnan(la) | np.isnan(ru))
        if not ok.all():
            self.n_skipped += int((~ok).sum())
            times, eids = times[ok], eids[ok]
            s, q, la, ru, rel = s[ok], q[ok], la[ok], ru[ok], rel[ok]
        if not len(times):
            return
        rel = np.where(np.isnan(rel), s, rel)
        rel = np.minimum(np.maximum(rel, s), q)
        cols = {"hold": rel - s, "dispatch": q - rel, "queue": la - q,
                "launch": ru - la, "exec": times - ru}
        self._fold_cols(cols, times - s, eids)

    def fold_aligned(self, s: np.ndarray, q: np.ndarray, la: np.ndarray,
                     ru: np.ndarray, done: np.ndarray,
                     eids: Optional[np.ndarray] = None) -> None:
        """Elementwise join: the five time arrays describe the same tasks
        in the same order, each lifecycle complete within this delta and
        untouched by holds, releases, or retries (the caller proves this
        — see ``Watcher._fold_delta``).  No release ⇒ release clamps to
        SCHEDULING, so ``hold`` is identically zero."""
        n = len(done)
        if not n:
            return
        cols = {"hold": np.zeros(n), "dispatch": q - s, "queue": la - q,
                "launch": ru - la, "exec": done - ru}
        self._fold_cols(cols, done - s, eids)

    def _fold_cols(self, cols: Dict[str, np.ndarray], span: np.ndarray,
                   eids: Optional[np.ndarray]) -> None:
        for name, col in cols.items():
            self._sum[name] += float(col.sum())
            self._max[name] = max(self._max[name], float(col.max()))
            self._chunks[name].append(col)
        self.n += len(span)
        self.span_sum += float(span.sum())
        ex = cols["exec"]
        if self.weights_fn is not None and eids is not None:
            ex = ex * np.asarray(self.weights_fn(eids), dtype=np.float64)
        self.exec_core_s += float(ex.sum())

    def phase_values(self, phase: str, cap: Optional[int] = None,
                     ) -> np.ndarray:
        """Per-task durations of one phase; ``cap`` keeps only the most
        recent ~cap values (whole trailing chunks)."""
        chunks = self._chunks[phase]
        if cap is not None:
            tail: List[np.ndarray] = []
            total = 0
            for c in reversed(chunks):
                tail.append(c)
                total += len(c)
                if total >= cap:
                    break
            chunks = tail[::-1]
        if not chunks:
            return _EMPTY_F
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    # --------------------------------------------------------------- stats
    def stats(self, exact_quantiles: bool = False) -> Dict[str, Any]:
        """The running decomposition in ``GroupBreakdown.as_dict`` shape.
        ``exact_quantiles=True`` ranks every completed task's durations —
        one O(n) concatenate + percentile per phase at drain, matching
        the post-hoc ``np.percentile`` bit-for-bit (same multiset) —
        while the default estimates p50/p99 over the most recent ~64k
        completions (a cheap rolling-window read for live ticks)."""
        cap = None if exact_quantiles else 65536
        phases: Dict[str, Any] = {}
        for p in PHASES:
            n = self.n
            if not n:
                phases[p] = {"n": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0,
                             "max": 0.0, "sum": 0.0}
                continue
            vals = self.phase_values(p, cap)
            if len(vals):
                p50, p99 = np.percentile(vals, (50.0, 99.0))
            else:
                p50 = p99 = 0.0
            phases[p] = {"n": n, "mean": self._sum[p] / n,
                         "p50": float(p50), "p99": float(p99),
                         "max": self._max[p], "sum": self._sum[p]}
        return {"n": self.n, "span_sum": self.span_sum,
                "exec_core_s": self.exec_core_s, "phases": phases,
                "n_skipped": self.n_skipped}


# ---------------------------------------------------------------------------
# health rules
# ---------------------------------------------------------------------------

@dataclass
class Alert:
    """One fired health-rule breach (also recorded as an ``obs:alert``
    trace row by the monitor)."""

    rule: str
    t: float
    message: str
    data: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "t": self.t, "message": self.message,
                **self.data}


@dataclass
class TickView:
    """What one Watcher tick saw — the input to every health rule."""

    t: float
    tick: int
    started_t: float
    n_unfinished: int
    n_done: int                 # completions so far (trace-folded)
    rate: float                 # completions/s since the previous tick
    inflight: float
    hold_depth: float
    backend_depth: int
    free_cores: int
    last_done_t: Optional[float]


class HealthRule:
    """One online invariant; ``check`` returns a breach message or None.
    Rules may keep internal state (baselines, cursors) — they are called
    once per tick in order."""

    name = "rule"

    def check(self, view: TickView) -> Optional[str]:
        raise NotImplementedError


class StallRule(HealthRule):
    """No completions for ``window`` seconds while work is outstanding."""

    name = "stall"

    def __init__(self, window: float = 10.0, min_unfinished: int = 1):
        self.window = window
        self.min_unfinished = min_unfinished

    def check(self, view: TickView) -> Optional[str]:
        if view.n_unfinished < self.min_unfinished:
            return None
        anchor = (view.last_done_t if view.last_done_t is not None
                  else view.started_t)
        gap = view.t - anchor
        if gap > self.window:
            return (f"no completions for {gap:.1f}s "
                    f"({view.n_unfinished} tasks outstanding)")
        return None


class ThroughputDropRule(HealthRule):
    """Per-tick completion rate fell below ``frac`` of its own rolling
    (EWMA) baseline after a warmup; guarded to stay quiet while the
    campaign tail legitimately drains (``min_unfinished``)."""

    name = "throughput_drop"

    def __init__(self, frac: float = 0.5, alpha: float = 0.2,
                 warmup_ticks: int = 5, min_unfinished: int = 1):
        self.frac = frac
        self.alpha = alpha
        self.warmup_ticks = warmup_ticks
        self.min_unfinished = min_unfinished
        self._baseline: Optional[float] = None
        self._ticks = 0

    def check(self, view: TickView) -> Optional[str]:
        self._ticks += 1
        base = self._baseline
        breach = (base is not None and base > 0.0
                  and self._ticks > self.warmup_ticks
                  and view.n_unfinished >= self.min_unfinished
                  and view.rate < self.frac * base)
        # the baseline tracks healthy ticks only, so a sustained drop
        # cannot talk the baseline down and mask itself
        if not breach:
            self._baseline = (view.rate if base is None
                              else (1 - self.alpha) * base
                              + self.alpha * view.rate)
        if breach:
            return (f"rate {view.rate:.4g}/s below {self.frac:.0%} of "
                    f"rolling baseline {base:.4g}/s")
        return None


class QueueRunawayRule(HealthRule):
    """A depth signal (``backend_depth`` or ``hold_depth``) exceeded a
    hard limit — backpressure is not reaching admission."""

    name = "queue_runaway"

    def __init__(self, limit: float, signal: str = "backend_depth"):
        self.limit = limit
        self.signal = signal

    def check(self, view: TickView) -> Optional[str]:
        depth = float(getattr(view, self.signal))
        if depth > self.limit:
            return f"{self.signal} {depth:.0f} over limit {self.limit:.0f}"
        return None


class ServiceLatencyRule(HealthRule):
    """Rolling p99 of one service's completed-request latency breached its
    SLO.  Tails the service's completion journal (``completed_since``) in
    O(new) per tick; the window is the last ``window`` completions."""

    name = "service_p99"

    def __init__(self, service, slo_p99: float, window: int = 256,
                 min_requests: int = 8):
        self.service = service
        self.slo_p99 = slo_p99
        self.window = window
        self.min_requests = min_requests
        self._pos = 0
        self._lat: List[float] = []

    def check(self, view: TickView) -> Optional[str]:
        svc = self.service
        rids, self._pos = svc.completed_since(self._pos)
        if rids:
            log = svc.request_log()
            sub, end = log["submit"], log["end"]
            self._lat.extend(end[r] - sub[r] for r in rids
                             if end[r] >= 0.0)
            if len(self._lat) > self.window:
                del self._lat[:len(self._lat) - self.window]
        if len(self._lat) < self.min_requests:
            return None
        p99 = float(np.percentile(np.asarray(self._lat), 99.0))
        if p99 > self.slo_p99:
            return (f"{svc.name} rolling p99 {p99:.4g}s over SLO "
                    f"{self.slo_p99:.4g}s (window {len(self._lat)})")
        return None


class HealthMonitor:
    """Evaluates the rules each tick and edge-triggers alerts: a rule
    fires once when it enters breach and re-arms when the breach clears,
    so a stalled hour produces one alert, not 3600.  Every fired alert is
    recorded as an ``obs:alert`` trace row (entity ``obs``) so the
    post-hoc report and the chaos harness see it."""

    def __init__(self, rules: Sequence[HealthRule] = (), profiler=None):
        self.rules = list(rules)
        self.profiler = profiler
        self.alerts: List[Alert] = []
        self._firing: Dict[str, bool] = {}

    def check(self, view: TickView) -> List[Alert]:
        fired: List[Alert] = []
        for rule in self.rules:
            msg = rule.check(view)
            if msg is None:
                self._firing[rule.name] = False
                continue
            if self._firing.get(rule.name):
                continue                       # still the same episode
            self._firing[rule.name] = True
            alert = Alert(rule.name, view.t, msg)
            self.alerts.append(alert)
            fired.append(alert)
            if self.profiler is not None:
                self.profiler.record(view.t, ALERT_ENTITY, ALERT_EVENT,
                                     {"rule": rule.name, "message": msg})
        return fired


# ---------------------------------------------------------------------------
# watcher (the orchestrator; absorbs the old LiveSampler)
# ---------------------------------------------------------------------------

@dataclass
class LiveSample:
    t: float
    n_unfinished: int
    queue_depth: int
    free_cores: int


class Watcher:
    """Engine-driven streaming telemetry over one agent's run.

    One scheduled callback per ``interval`` (sim: virtual seconds, real:
    wall seconds) polls the trace cursor, folds the delta into the
    streaming aggregators, samples the instantaneous gauges, evaluates
    health rules, and optionally emits.  Auto-stops when the agent drains
    (so a ``SimEngine`` heap is never held open) and then finalizes —
    folding rows recorded after the last tick — exactly once.

    Parameters beyond the obvious: ``dt`` is the aggregation bin width
    (defaults to ``interval``); ``aggregate=False`` keeps only the gauge
    samples (the old LiveSampler behavior, near-zero cost);
    ``emit`` appends one JSON line per tick (final line carries
    ``"final": true``); ``promfile`` atomically rewrites an
    OpenMetrics-style text exposition each tick; ``on_tick(watcher)``
    runs after each fold (the CLI's frame renderer).
    """

    def __init__(self, agent, profiler=None, interval: float = 1.0,
                 dt: Optional[float] = None, rules: Sequence = (),
                 services: Sequence = (), emit: Optional[str] = None,
                 promfile: Optional[str] = None, aggregate: bool = True,
                 weights_fn: Optional[Callable] = None,
                 on_tick: Optional[Callable] = None):
        self.agent = agent
        self.engine = agent.engine
        self.profiler = profiler if profiler is not None \
            else self.engine.profiler
        self.interval = interval
        self.dt = dt if dt is not None else interval
        self.aggregate = aggregate
        self.services = list(services)
        self.on_tick = on_tick
        # views, not copies: every fold runs under engine.lock, and all
        # real-engine trace appends take the same lock (see real_executors)
        self.cursor = TraceCursor(self.profiler, copy=False)
        self.throughput = StreamingThroughput(self.dt)
        self.inflight = StreamingLevel("inflight", self.dt)
        self.hold = StreamingLevel("sched_hold_depth", self.dt, clamp0=True)
        self._occ_weights = weights_fn
        self.occupancy_lvl = (StreamingLevel("occupancy", self.dt)
                              if weights_fn is not None else None)
        self.breakdown = StreamingBreakdown(weights_fn)
        self.monitor = HealthMonitor(rules, self.profiler)
        self.samples: List[LiveSample] = []
        self.backend_depths: Dict[str, List[int]] = {}
        self.tick_times: List[float] = []
        self.fold_wall_s = 0.0
        self.n_ticks = 0
        self.n_rows_folded = 0
        self.started_t = 0.0
        self.last_done_t: Optional[float] = None
        self._nids: Dict[str, Optional[int]] = {}
        self._rel_nids: List[int] = []
        self._held = np.zeros(0, dtype=np.uint8)
        # per-entity "occupies cores right now" flags — materialized lazily
        # on the first FAILED/CANCELED row (failure-free runs never pay
        # the scatter); None means "no failure seen yet"
        self._run_flags: Optional[np.ndarray] = None
        self._saw_retry = False
        self._hold_nid: Optional[int] = None
        self._rel_prefix: Optional[str] = None
        self._last_n_done = 0
        self._last_tick_t: Optional[float] = None
        self._emit_path = emit
        self._emit_fh = None
        self.promfile = promfile
        self._armed = False
        self._stopped = False
        self._finalized = False

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "Watcher":
        if not self._armed:
            self._armed = True
            self._stopped = False
            self.started_t = self.engine.now()
            self._last_tick_t = self.started_t
            self.engine.schedule(self.interval, self._tick)
        return self

    def stop(self) -> None:
        """Halt ticking (does not finalize — callers that want the tail
        folded call :meth:`finalize`)."""
        self._stopped = True
        self._armed = False

    def finalize(self) -> None:
        """Fold everything recorded since the last tick and emit the final
        record; idempotent. Called automatically when the agent drains.
        Runs under the engine lock so an explicit finalize cannot race a
        real-engine timer tick."""
        with self.engine.lock:
            if self._finalized:
                return
            self._finalized = True
            self.stop()
            self._fold()
            self._emit_record(final=True)
            self._write_promfile()
            if self._emit_fh is not None:
                self._emit_fh.close()
                self._emit_fh = None

    def _tick(self) -> None:
        if self._stopped:
            return
        self._fold()
        agent = self.agent
        now = self.engine.now()
        # read every gauge exactly once per tick; the sample, the view,
        # and the per-backend series all reuse the same reads
        n_unfinished = agent.n_unfinished
        free_cores = agent.free_cores
        backend_depth = 0
        for name, ex in agent.backends.items():
            d = int(getattr(ex, "queue_depth", 0))
            backend_depth += d
            self.backend_depths.setdefault(name, []).append(d)
        self.samples.append(LiveSample(now, n_unfinished, backend_depth,
                                       free_cores))
        self.tick_times.append(now)
        self.n_ticks += 1
        view = self._view(now, n_unfinished, backend_depth, free_cores)
        self.monitor.check(view)
        self._emit_record(final=False)
        self._write_promfile()
        if self.on_tick is not None:
            self.on_tick(self)
        self._last_n_done = self.throughput.n_total
        self._last_tick_t = now
        if n_unfinished > 0:
            self.engine.schedule(self.interval, self._tick)
        else:
            self._armed = False
            self.finalize()

    # ------------------------------------------------------------- folding
    def _nid(self, name: str) -> Optional[int]:
        nid = self._nids.get(name)
        if nid is None:
            nid = self.profiler.nid_of(name)
            if nid is not None:
                self._nids[name] = nid
        return nid

    def _register_names(self, new_names: List[Tuple[int, str]]) -> None:
        if self._rel_prefix is None:
            from repro_torch.sched.scheduler import TRACE_NAMES, release_name
            self._rel_prefix = release_name(0)[:-1]       # "sched:release:p"
            self._hold_name = TRACE_NAMES["hold"]
        for nid, name in new_names:
            if name.startswith(self._rel_prefix):
                self._rel_nids.append(nid)
            elif name == self._hold_name:
                self._hold_nid = nid

    def _flag(self, flags: np.ndarray, eids: np.ndarray) -> np.ndarray:
        need = int(eids.max()) + 1 if len(eids) else 0
        if need > len(flags):
            grown = np.zeros(max(need, 2 * len(flags), 1024),
                             dtype=np.uint8)
            grown[:len(flags)] = flags
            flags = grown
        return flags

    def _fold(self) -> None:
        t0 = time.perf_counter()
        delta = self.cursor.poll()
        if delta.new_names:
            self._register_names(delta.new_names)
        if delta.n and self.aggregate:
            self._fold_delta(delta)
            self.n_rows_folded += delta.n
        elif delta.n:
            # gauge-only mode still tracks completion counts for the rules
            nid = self._nid(_DONE)
            if nid is not None:
                done_t = delta.times[delta.nids == nid]
                if len(done_t):
                    self.throughput.n_total += len(done_t)
                    self.last_done_t = float(done_t.max())
        self.fold_wall_s += time.perf_counter() - t0

    def _fold_delta(self, delta: TraceDelta) -> None:
        times, nids, packed = delta.times, delta.nids, delta._packed
        n = delta.n
        # ---- segment index: rows arrive in append order, and the bulk
        # recorders (cohort waves) append long same-name runs — slice
        # those runs as views instead of running one full-width boolean
        # mask per watched event name.  Fragmented deltas (object-path
        # interleaving, many short runs) fall back to masks.
        segs: Optional[Dict[int, List[Tuple[int, int]]]] = None
        bounds = np.flatnonzero(nids[1:] != nids[:-1]) + 1
        if len(bounds) <= max(64, n >> 4):
            edges = np.empty(len(bounds) + 2, dtype=np.int64)
            edges[0] = 0
            edges[1:-1] = bounds
            edges[-1] = n
            seg_nids = nids[edges[:-1]]
            segs = {}
            for i in range(len(seg_nids)):
                segs.setdefault(int(seg_nids[i]), []).append(
                    (int(edges[i]), int(edges[i + 1])))

        def take(nid: Optional[int]):
            """(times, eids) of one event name's rows, or None."""
            if nid is None:
                return None
            if segs is not None:
                ps = segs.get(nid)
                if ps is None:
                    return None
                if len(ps) == 1:
                    lo, hi = ps[0]
                    return times[lo:hi], packed[lo:hi] >> _NAME_BITS
                return (np.concatenate([times[lo:hi] for lo, hi in ps]),
                        np.concatenate([packed[lo:hi] >> _NAME_BITS
                                        for lo, hi in ps]))
            m = nids == nid
            if not m.any():
                return None
            return times[m], delta.eids[m]

        def merge(a, b):
            if a is None or b is None:
                return a if b is None else b
            return (np.concatenate((a[0], b[0])),
                    np.concatenate((a[1], b[1])))

        sched = take(self._nid(_SCHED))
        queued = take(self._nid(_QUEUED))
        launch = take(self._nid(_LAUNCH))
        run = take(self._nid(_RUN))
        done = take(self._nid(_DONE))
        rel = None
        for nid in self._rel_nids:
            rel = merge(rel, take(nid))
        fail = merge(take(self._nid(_FAILED)), take(self._nid(_CANCELED)))
        if fail is not None:
            self._saw_retry = True
        if not self._saw_retry and (
                take(self._nid("agent:retry")) is not None
                or take(self._nid("sched:requeue")) is not None):
            # a re-dispatched lifecycle re-records its stamp rows; killed
            # attempts leave FAILED rows first, but *queued* casualties
            # (instance reroute, pilot evacuation) only leave these
            # markers — either way first-wins stamps now matter, so the
            # aligned elementwise join is off for the rest of the run
            self._saw_retry = True

        # ---- five-phase breakdown
        bd = self.breakdown
        aligned = (done is not None and rel is None and not self._saw_retry
                   and sched is not None and queued is not None
                   and launch is not None and run is not None
                   and np.array_equal(sched[1], done[1])
                   and np.array_equal(queued[1], done[1])
                   and np.array_equal(launch[1], done[1])
                   and np.array_equal(run[1], done[1]))
        if aligned:
            # every completed task's full lifecycle sits in this delta
            # with all five columns in the same task order (how the
            # cohort planner bulk-stamps a wave): join elementwise and
            # skip the stamp scatter/gather entirely
            bd.fold_aligned(sched[0], queued[0], launch[0], run[0],
                            done[0], done[1])
        else:
            for key, part in (("sched", sched), ("queued", queued),
                              ("launch", launch), ("run", run),
                              ("rel", rel)):
                if part is not None:
                    bd.fold_stamp(key, part[0], part[1])
            if done is not None:
                bd.fold_done(done[0], done[1])

        # ---- throughput + inflight/occupancy levels
        start_t = run[0] if run is not None else _EMPTY_F
        start_e = run[1] if run is not None else _EMPTY_I
        end_t = done[0] if done is not None else _EMPTY_F
        end_e = done[1] if done is not None else _EMPTY_I
        if done is not None:
            self.throughput.fold(end_t)
            self.last_done_t = float(end_t.max())
        if fail is not None or self._run_flags is not None:
            # chaos path: track which entities actually occupy cores so a
            # FAILED/CANCELED row ends a span only for running tasks
            # (queued casualties never occupied cores)
            self._materialize_run_flags(delta.lo)
            if run is not None:
                self._run_flags = self._flag(self._run_flags, start_e)
                self._run_flags[start_e] = 1
            if fail is not None:
                fail_t, fail_e = fail
                self._run_flags = self._flag(self._run_flags, fail_e)
                was = self._run_flags[fail_e] == 1
                end_t = np.concatenate((end_t, fail_t[was]))
                end_e = np.concatenate((end_e, fail_e[was]))
                self._run_flags[fail_e[was]] = 0
            if done is not None:
                self._run_flags = self._flag(self._run_flags, done[1])
                self._run_flags[done[1]] = 0
        if len(start_t) or len(end_t):
            if self.occupancy_lvl is not None:
                # core-weighted level needs the merged ±w sweep
                ev_t = np.concatenate((start_t, end_t))
                w = np.concatenate((
                    np.asarray(self._occ_weights(start_e),
                               dtype=np.float64),
                    -np.asarray(self._occ_weights(end_e),
                                dtype=np.float64)))
                order = np.argsort(ev_t, kind="stable")
                self.occupancy_lvl.fold(ev_t[order], w[order])
            self.inflight.fold_counts(start_t, end_t)

        # ---- scheduler hold depth
        hold = take(self._hold_nid)
        if hold is not None:
            h_e = hold[1]
            self._held = self._flag(self._held, h_e)
            self._held[h_e] = 1
        r_t = _EMPTY_F
        if rel is not None:
            self._held = self._flag(self._held, rel[1])
            was_held = self._held[rel[1]] == 1
            r_t = rel[0][was_held]
        if hold is not None or len(r_t):
            self.hold.fold_counts(
                hold[0] if hold is not None else _EMPTY_F, r_t)

    def _materialize_run_flags(self, lo: int) -> None:
        """First failure seen: rebuild the running-entity flags from the
        trace prefix (rows < ``lo``) — before the first FAILED/CANCELED
        row every entity has at most one RUNNING and one DONE row, so
        set-then-clear reconstructs the live set exactly."""
        if self._run_flags is not None:
            return
        flags = np.zeros(1024, dtype=np.uint8)
        prof = self.profiler
        for name, val in ((_RUN, 1), (_DONE, 0)):
            if prof.has_name(name):
                rows = prof.rows_np(name)
                e = prof.eids_np(name)[rows < lo]
                if len(e):
                    flags = self._flag(flags, e)
                    flags[e] = val
        self._run_flags = flags

    # -------------------------------------------------------------- views
    def _view(self, now: float, n_unfinished: int, backend_depth: int,
              free_cores: int) -> TickView:
        elapsed = now - (self._last_tick_t
                         if self._last_tick_t is not None else now)
        n_new = self.throughput.n_total - self._last_n_done
        return TickView(
            t=now, tick=self.n_ticks, started_t=self.started_t,
            n_unfinished=n_unfinished,
            n_done=self.throughput.n_total,
            rate=(n_new / elapsed) if elapsed > 0 else 0.0,
            inflight=self.inflight.level,
            hold_depth=max(self.hold.level, 0.0),
            backend_depth=backend_depth,
            free_cores=free_cores,
            last_done_t=self.last_done_t)

    def occupancy_series(self) -> Series:
        """Streamed occupancy: the core-weighted level when a
        ``weights_fn`` was given, else the in-flight level scaled by
        ``total_cores`` (exact for 1-core tasks)."""
        total = max(1, self.agent.total_cores)
        lvl = self.occupancy_lvl if self.occupancy_lvl is not None \
            else self.inflight
        return lvl.series(divisor=float(total), name="occupancy")

    def series(self, field_name: str = "n_unfinished") -> Series:
        """Gauge samples as a Series (LiveSampler-compatible)."""
        t = np.asarray([s.t for s in self.samples])
        v = np.asarray([getattr(s, field_name) for s in self.samples],
                       dtype=np.float64)
        return Series(f"live:{field_name}", t, v, self.interval)

    def metrics(self) -> Dict[str, Any]:
        """One machine-readable snapshot (the JSONL record shape)."""
        now = self.engine.now()
        agent = self.agent
        bd = self.breakdown
        out: Dict[str, Any] = {
            "t": round(now, 6), "tick": self.n_ticks,
            "n_unfinished": agent.n_unfinished,
            "n_done": self.throughput.n_total,
            "rate": round(self.throughput.n_total
                          / max(now - self.started_t, 1e-9), 4),
            "inflight": self.inflight.level,
            "inflight_peak": self.inflight.peak,
            "occupancy": round(self.inflight.level
                               / max(1, agent.total_cores), 6),
            "hold_depth": max(self.hold.level, 0.0),
            "backend_depth": agent.backend_depth,
            "free_cores": agent.free_cores,
            "fold_wall_s": round(self.fold_wall_s, 6),
            "rows_folded": self.n_rows_folded,
            "alerts_total": len(self.monitor.alerts),
        }
        if bd.n:
            out["phases"] = {p: {"mean": round(st["mean"], 9),
                                 "p99_est": st["p99"]}
                             for p, st in bd.stats()["phases"].items()}
        if self.services:
            out["services"] = {
                s.name: {"outstanding": s.outstanding,
                         "n_done": s.n_completed}
                for s in self.services}
        return out

    def alert_summary(self) -> List[Dict[str, Any]]:
        return [a.as_dict() for a in self.monitor.alerts]

    # ------------------------------------------------------------ emitting
    def _emit_record(self, final: bool) -> None:
        if self._emit_path is None:
            return
        if self._emit_fh is None:
            self._emit_fh = open(self._emit_path, "w")
        rec = self.metrics()
        if final:
            rec["final"] = True
            rec["alerts"] = self.alert_summary()
        self._emit_fh.write(json.dumps(rec) + "\n")
        self._emit_fh.flush()

    def openmetrics(self) -> str:
        """OpenMetrics-style text exposition of the current snapshot."""
        m = self.metrics()
        lines: List[str] = []
        for key, mtype in (("n_unfinished", "gauge"), ("n_done", "counter"),
                           ("rate", "gauge"), ("inflight", "gauge"),
                           ("occupancy", "gauge"), ("hold_depth", "gauge"),
                           ("backend_depth", "gauge"),
                           ("free_cores", "gauge"),
                           ("alerts_total", "counter")):
            name = f"repro_{key}"
            lines.append(f"# TYPE {name} {mtype}")
            lines.append(f"{name} {m[key]}")
        for p, st in (m.get("phases") or {}).items():
            lines.append(f"# TYPE repro_phase_mean_seconds gauge")
            lines.append(
                f'repro_phase_mean_seconds{{phase="{p}"}} {st["mean"]}')
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def _write_promfile(self) -> None:
        if self.promfile is None:
            return
        tmp = self.promfile + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.openmetrics())
        os.replace(tmp, self.promfile)


class LiveSampler(Watcher):
    """Back-compat shim: the PR 8 gauge-only sampler is now a Watcher
    with aggregation off (one cursor poll per tick to keep the stall
    bookkeeping honest, no series folding)."""

    def __init__(self, agent, interval: float = 1.0):
        super().__init__(agent, interval=interval, aggregate=False)


# ---------------------------------------------------------------------------
# dashboard rendering (shared by `watch` CLI and anything embedding it)
# ---------------------------------------------------------------------------

def render_frame(m: Dict[str, Any], throughput_v: Sequence[float] = (),
                 inflight_v: Sequence[float] = (),
                 alerts: Sequence[Dict[str, Any]] = ()) -> str:
    """One ASCII dashboard frame from a ``Watcher.metrics()`` record (or a
    JSONL line read back by ``watch --follow``)."""
    from repro_torch.observability.report import _sparkline
    lines = [
        f"=== watch t={m.get('t', 0.0):.1f}s  tick {m.get('tick', 0)} ===",
        f"  unfinished {m.get('n_unfinished', 0):>10,}   "
        f"done {m.get('n_done', 0):>10,}   "
        f"rate {m.get('rate', 0.0):>10.4g}/s",
        f"  inflight   {m.get('inflight', 0.0):>10.4g}   "
        f"occupancy {m.get('occupancy', 0.0):>6.1%}   "
        f"hold {m.get('hold_depth', 0.0):>6.4g}   "
        f"backend depth {m.get('backend_depth', 0):>6,}",
    ]
    if throughput_v:
        lines.append(f"  throughput {_sparkline(list(throughput_v))}")
    if inflight_v:
        lines.append(f"  inflight   {_sparkline(list(inflight_v))}")
    phases = m.get("phases") or {}
    if phases:
        row = "  ".join(f"{p}={st['mean']:.4g}s"
                        for p, st in phases.items())
        lines.append(f"  phase means: {row}")
    for a in alerts:
        lines.append(f"  ALERT [{a.get('rule')}] t={a.get('t', 0.0):.1f}: "
                     f"{a.get('message')}")
    if m.get("final"):
        lines.append(f"  -- final: {m.get('n_done', 0):,} done, "
                     f"{m.get('rows_folded', 0):,} rows folded in "
                     f"{m.get('fold_wall_s', 0.0):.3f}s over "
                     f"{m.get('tick', 0)} ticks")
    return "\n".join(lines)
