"""Event recording (RADICAL-Analytics style): every state transition and
runtime action is a timestamped event; the metrics pipeline (analytics.py)
derives throughput/utilization/makespan purely from the task/event trace.

The trace is **columnar** (struct-of-arrays): the hot path appends to two
parallel columns — a float64 time column and an int64 column packing the
interned entity id and name id of the event — and stores optional payloads
in a sparse side dict. Nothing else happens per event: no object
allocation, no secondary indexing. Million-task campaigns therefore pay two
C-level column writes per state transition instead of a heap-allocated
dataclass plus an eager by-name index insert.

Storage is a pair of preallocated numpy buffers grown geometrically (plus a
row counter), so bulk appends (``record_fast_many``) are two slice
assignments — ~40ms for 10M rows where the previous ``array.frombytes``
path paid a tobytes copy per column — and reads are zero-copy slice views
instead of ``np.frombuffer`` over an exported buffer. Writers that know a
bulk append is coming can call ``reserve_rows`` first to size the buffers
exactly and avoid transient doubling spikes at the 10M-task tier.

``record`` interns its strings per call; state machines on the hot path use
``entity_id`` once per entity plus ``record_fast`` per event to skip even
the interning lookups (see task.Task.advance).

Per-`Event` views and the by-name index are materialized lazily, on first
access, and only extended incrementally afterwards — pure-throughput runs
that never inspect the trace never build them.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

_NAME_BITS = 20                      # <=1M distinct event names
_NAME_MASK = (1 << _NAME_BITS) - 1


class Event:
    """Lightweight per-event view over one trace row (backward-compat
    surface; the authoritative storage is the Profiler's columns)."""

    __slots__ = ("time", "entity", "name", "data")

    def __init__(self, time: float, entity: str, name: str,
                 data: Optional[Dict[str, Any]] = None):
        self.time = time
        self.entity = entity
        self.name = name
        self.data = data

    def __eq__(self, other):
        return (isinstance(other, Event)
                and self.time == other.time and self.entity == other.entity
                and self.name == other.name and self.data == other.data)

    def __repr__(self):
        return (f"Event(time={self.time!r}, entity={self.entity!r}, "
                f"name={self.name!r}, data={self.data!r})")


class Profiler:
    """Append-only columnar event trace with lazy secondary indexing."""

    def __init__(self):
        # authoritative columns: preallocated, grown geometrically; only
        # the first _n rows are live
        self._times = np.empty(1024, dtype=np.float64)   # event timestamps
        self._ids = np.empty(1024, dtype=np.int64)       # (eid << 20) | nid
        self._n = 0
        self._entity_names: Dict[int, str] = {}   # entity id -> string
        self._names: List[str] = []       # name id -> string
        self._entity_ids: Dict[str, int] = {}
        self._name_ids: Dict[str, int] = {}
        self._next_eid = 0
        # lazily-named entity blocks (cohort waves): (base, count, name_fn),
        # sorted by base — entity_of resolves ids in a block through name_fn
        # without ever materializing the block's id->string map
        self._entity_blocks: List[tuple] = []
        self._data: Dict[int, Any] = {}   # sparse: row -> payload
        # generic memo for hot callers caching name ids keyed by their own
        # tokens (e.g. task.py keys it by TaskState)
        self.memo_nids: Dict[Any, int] = {}
        # lazy caches (built on demand, extended incrementally)
        self._by_name: Dict[int, List[int]] = {}   # name id -> row indices
        self._indexed_rows = 0
        self._events_view: List[Event] = []
        # name -> (rows int64 array, times float64 array|None, row count at
        # scan time); row-count keying makes appends extend the scan lazily
        self._np_cache: Dict[str, tuple] = {}

    # ------------------------------------------------------------ interning
    def entity_id(self, entity: str) -> int:
        eid = self._entity_ids.get(entity)
        if eid is None:
            eid = self._entity_ids[entity] = self._next_eid
            self._next_eid = eid + 1
            self._entity_names[eid] = entity
        return eid

    def reserve_entities(self, count: int,
                         name_fn: Callable[[int], str]) -> int:
        """Reserve ``count`` consecutive entity ids whose names resolve
        lazily: id ``base + i`` maps to ``name_fn(i)``. Nothing per entity
        is stored — cohort waves use this so a 10M-task trace does not
        intern 10M uid strings."""
        base = self._next_eid
        self._next_eid = base + count
        self._entity_blocks.append((base, count, name_fn))
        return base

    def name_id(self, name: str) -> int:
        nid = self._name_ids.get(name)
        if nid is None:
            nid = len(self._names)
            if nid > _NAME_MASK:
                raise OverflowError("Profiler: too many distinct event "
                                    "names (id space exhausted)")
            self._name_ids[name] = nid
            self._names.append(name)
        return nid

    # ------------------------------------------------------------- hot path
    def _grow(self, need: int) -> None:
        cap = len(self._times)
        new = max(need, cap * 2)
        times = np.empty(new, dtype=np.float64)
        ids = np.empty(new, dtype=np.int64)
        n = self._n
        times[:n] = self._times[:n]
        ids[:n] = self._ids[:n]
        self._times = times
        self._ids = ids

    def reserve_rows(self, extra: int) -> None:
        """Ensure capacity for ``extra`` more rows in one allocation. Bulk
        writers (cohort trace stamping) call this before a known-size run of
        appends so the buffers are sized exactly once instead of doubling
        through it — at 10M tasks that is the difference between an 800MB
        column and a transient 1.6GB spike."""
        need = self._n + extra
        if need > len(self._times):
            self._grow(need)

    def record_fast(self, time: float, eid: int, nid: int) -> None:
        """Append one payload-free event from pre-interned ids: two C-level
        column writes, nothing else."""
        n = self._n
        if n >= len(self._times):
            self._grow(n + 1)
        self._times[n] = time
        self._ids[n] = (eid << _NAME_BITS) | nid
        self._n = n + 1

    def record_fast_many(self, times, eids, nid) -> None:
        """Bulk append of payload-free events from pre-interned ids:
        ``times`` (float array-like) and ``eids`` (int array-like) must have
        equal length; ``nid`` is one name id for the whole batch or an
        array of per-event name ids (same length). Equivalent to a loop of
        ``record_fast`` (golden-pinned in tests/test_cohort_golden.py) but
        two slice assignments regardless of batch size."""
        times = np.ascontiguousarray(times, dtype=np.float64)
        eids = np.ascontiguousarray(eids, dtype=np.int64)
        if len(times) != len(eids):
            raise ValueError("record_fast_many: times/eids length mismatch")
        nid = np.asarray(nid, dtype=np.int64)
        if nid.ndim > 0 and len(nid) != len(times):
            # a short nid array would otherwise broadcast (len 1) or raise
            # deep inside numpy with an opaque shape error
            raise ValueError("record_fast_many: nid length mismatch "
                             f"({len(nid)} nids for {len(times)} events)")
        k = len(times)
        n = self._n
        if n + k > len(self._times):
            self._grow(n + k)
        self._times[n:n + k] = times
        self._ids[n:n + k] = (eids << _NAME_BITS) | nid
        self._n = n + k

    def record(self, time: float, entity: str, name: str,
               data: Optional[Dict[str, Any]] = None) -> int:
        """Append one event; returns its row index."""
        row = self._n
        self.record_fast(time, self.entity_id(entity), self.name_id(name))
        if data:
            self._data[row] = data
        return row

    # ------------------------------------------------------------- queries
    def _event_at(self, row: int) -> Event:
        packed = int(self._ids[row])
        return Event(float(self._times[row]),
                     self.entity_of(packed >> _NAME_BITS),
                     self._names[packed & _NAME_MASK],
                     self._data.get(row))

    def _name_index(self) -> Dict[int, List[int]]:
        """Extend the lazy name -> rows index to cover all recorded rows.

        Vectorized: the unindexed tail is masked and stably grouped in bulk
        (``& _NAME_MASK`` + stable argsort), so the first analytics touch on
        a 1M-row trace costs a few numpy passes instead of an O(rows)
        interpreter loop. Semantics are unchanged — plain lists of int rows
        in recording order per name (golden-pinned against the loop
        implementation in tests/test_observability.py)."""
        n = self._n
        lo = self._indexed_rows
        if lo < n:
            nids = self._ids[lo:n] & _NAME_MASK
            order = np.argsort(nids, kind="stable")
            grouped = nids[order]
            rows = order + lo
            cuts = np.flatnonzero(np.diff(grouped)) + 1
            starts = np.concatenate(([0], cuts))
            ends = np.concatenate((cuts, [len(grouped)]))
            index = self._by_name
            for s, e in zip(starts, ends):
                chunk = rows[s:e].tolist()
                cur = index.get(int(grouped[s]))
                if cur is None:
                    index[int(grouped[s])] = chunk
                else:
                    cur.extend(chunk)
            self._indexed_rows = n
        return self._by_name

    def rows_by_name(self, name: str) -> List[int]:
        nid = self._name_ids.get(name)
        if nid is None:
            return []
        return self._name_index().get(nid, [])

    def by_name(self, name: str) -> List[Event]:
        return [self._event_at(r) for r in self.rows_by_name(name)]

    def times(self, name: str) -> List[float]:
        times = self._times
        return [times[r] for r in self.rows_by_name(name)]

    # ------------------------------------------------- numpy fast accessors
    # These never touch the list-based by-name index: a vectorized masked
    # scan over the packed column finds a name's rows in one numpy pass
    # (~ms per name at 5M rows), where extending the list index would pay
    # an O(rows) tolist conversion. Caches are keyed by the row count at
    # scan time, so appends just extend the cached scan incrementally.

    def _rows_scan(self, name: str) -> tuple:
        nid = self._name_ids.get(name)
        n = self._n
        if nid is None:
            return np.empty(0, dtype=np.int64), n
        cached = self._np_cache.get(name)
        if cached is not None and cached[2] == n:
            return cached[0], n
        ids = self._ids[:n]
        if cached is not None:
            lo = cached[2]
            tail = np.flatnonzero((ids[lo:] & _NAME_MASK) == nid) + lo
            rows = (np.concatenate((cached[0], tail)) if len(tail)
                    else cached[0])
        else:
            rows = np.flatnonzero((ids & _NAME_MASK) == nid)
        self._np_cache[name] = (rows, None, n)
        return rows, n

    def rows_np(self, name: str) -> np.ndarray:
        """Row indices of ``name`` as an int64 array in recording order
        (cached; treat as read-only)."""
        return self._rows_scan(name)[0]

    def eids_np(self, name: str) -> np.ndarray:
        """Entity ids of every ``name`` row as an int64 array in recording
        order (decode through ``entity_of``)."""
        rows = self.rows_np(name)
        if not len(rows):
            return np.empty(0, dtype=np.int64)
        return self._ids[rows] >> _NAME_BITS

    def has_name(self, name: str) -> bool:
        """Whether ``name`` was ever interned (recorded or pre-registered)."""
        return name in self._name_ids

    def times_np(self, name: str) -> np.ndarray:
        """Timestamps of ``name`` as a float64 array in recording order
        (cached alongside ``rows_np``; treat as read-only)."""
        rows, n = self._rows_scan(name)
        cached = self._np_cache.get(name)
        if cached is not None and cached[1] is not None and cached[2] == n:
            return cached[1]
        if len(rows):
            out = self._times[rows]       # fancy indexing copies
        else:
            out = np.empty(0, dtype=np.float64)
        self._np_cache[name] = (rows, out, n)
        return out

    def iter_name(self, name: str):
        """Iterate ``name``'s rows as :class:`Event` views without building
        the whole-trace list index (rows come from the vectorized scan)."""
        for row in self.rows_np(name):
            yield self._event_at(int(row))

    # ------------------------------------------------------- cursor support
    # (the JAX package's repro.observability.stream.TraceCursor; not yet
    # ported): streaming readers poll the
    # trace in O(rows-appended-since-last-poll) — one bounded copy of the
    # raw columns per poll, never a whole-trace scan or index build.

    @property
    def n_rows(self) -> int:
        """Live row count (the high-water mark a cursor polls against)."""
        return self._n

    def n_names(self) -> int:
        """Count of interned event names; names are append-only, so a
        cursor detects newly-appearing names (e.g. per-pilot release
        tracks) by watching this grow and resolving ``name_of``."""
        return len(self._names)

    def nid_of(self, name: str) -> Optional[int]:
        """Interned id of ``name`` (None if never recorded) — streaming
        readers match delta rows against watched names by id, not string."""
        return self._name_ids.get(name)

    def tail(self, lo: int, copy: bool = True):
        """``(times, packed_ids, hi)`` for rows ``[lo, n)`` — the delta a
        ``TraceCursor`` (JAX package's observability) folds.  Copies by
        default: a later append may grow (and so orphan) the underlying
        buffers while the caller still holds the delta.  ``copy=False``
        returns views — valid only until the next append — for callers
        that consume the delta immediately under the engine lock."""
        n = self._n
        if lo >= n:
            return (np.empty(0, dtype=np.float64),
                    np.empty(0, dtype=np.int64), n)
        t, i = self._times[lo:n], self._ids[lo:n]
        return (t.copy(), i.copy(), n) if copy else (t, i, n)

    def payload_at(self, row: int):
        """Sparse payload of one row (None for payload-free events)."""
        return self._data.get(row)

    def window(self, name: str) -> Optional[tuple]:
        ts = self.times(name)
        return (min(ts), max(ts)) if ts else None

    def counts_by_name(self) -> Dict[str, int]:
        index = self._name_index()
        return {self._names[nid]: len(rows) for nid, rows in index.items()}

    def nbytes(self) -> int:
        """Storage footprint of the authoritative columns (live time +
        packed-id bytes; sparse payload dicts and slack capacity are
        excluded — the observability layer reports this as trace
        bytes/task)."""
        return self._n * (self._times.itemsize + self._ids.itemsize)

    # --------------------------------------------------- columnar accessors
    def time_column(self) -> np.ndarray:
        """The raw float64 time column as a zero-copy view of the live rows
        (do not mutate; a later append may grow the storage and orphan the
        view)."""
        return self._times[:self._n]

    def id_column(self) -> np.ndarray:
        """The raw packed id column as a zero-copy view of the live rows
        (do not mutate): each element is ``(entity_id << 20) | name_id``;
        decode through ``entity_of`` / ``name_of``."""
        return self._ids[:self._n]

    def name_of(self, nid: int) -> str:
        return self._names[nid]

    def entity_of(self, eid: int) -> str:
        name = self._entity_names.get(eid)
        if name is not None:
            return name
        blocks = self._entity_blocks
        i = bisect_right(blocks, eid, key=lambda b: b[0]) - 1
        if i >= 0:
            base, count, name_fn = blocks[i]
            if eid < base + count:
                return name_fn(eid - base)
        raise KeyError(f"unknown entity id {eid}")

    # ----------------------------------------------------------- view compat
    @property
    def events(self) -> List[Event]:
        """Per-`Event` view of the whole trace, materialized lazily and
        extended incrementally across calls."""
        view = self._events_view
        n = self._n
        if len(view) < n:
            view.extend(self._event_at(r) for r in range(len(view), n))
        return view

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def __len__(self):
        return self._n
