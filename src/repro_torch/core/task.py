"""Task abstraction: description + state machine, mirroring RADICAL-Pilot's
task lifecycle. Transitions are validated; every transition is timestamped
for the analytics pipeline.

``advance`` is the hottest call in a simulation (5-6 per task); everything
it needs per transition — the legal-transition table, the overwrite set,
the interned ``state:*`` event names — is precomputed at module load so the
steady state allocates nothing (the executing backend is recoverable from
``task.backend``; it is not duplicated into each trace event)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class TaskState(str, Enum):
    NEW = "NEW"
    SCHEDULING = "SCHEDULING"      # in the agent scheduler
    QUEUED = "QUEUED"              # in a backend executor queue
    LAUNCHING = "LAUNCHING"        # backend is placing/launching it
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELED = "CANCELED"
    # persistent service-task lifecycle (RHAPSODY/RP service tasks): after
    # LAUNCHING the replica provisions (loads its model / boots its server),
    # signals readiness, serves a request stream, then drains and stops
    PROVISIONING = "PROVISIONING"  # service boot on its allocation
    READY = "READY"                # accepting requests, none served yet
    SERVING = "SERVING"            # has served at least one request
    DRAINING = "DRAINING"          # no new requests; finishing in-flight ones
    STOPPED = "STOPPED"            # service terminal state


TERMINAL = {TaskState.DONE, TaskState.FAILED, TaskState.CANCELED,
            TaskState.STOPPED}

_LEGAL: Dict[TaskState, set] = {
    TaskState.NEW: {TaskState.SCHEDULING, TaskState.CANCELED},
    TaskState.SCHEDULING: {TaskState.QUEUED, TaskState.FAILED,
                           TaskState.CANCELED},
    TaskState.QUEUED: {TaskState.LAUNCHING, TaskState.SCHEDULING,
                       TaskState.FAILED, TaskState.CANCELED},
    TaskState.LAUNCHING: {TaskState.RUNNING, TaskState.PROVISIONING,
                          TaskState.FAILED, TaskState.CANCELED},
    TaskState.RUNNING: {TaskState.DONE, TaskState.FAILED, TaskState.CANCELED},
    TaskState.PROVISIONING: {TaskState.READY, TaskState.FAILED,
                             TaskState.CANCELED},
    TaskState.READY: {TaskState.SERVING, TaskState.DRAINING,
                      TaskState.FAILED, TaskState.CANCELED},
    TaskState.SERVING: {TaskState.DRAINING, TaskState.FAILED,
                        TaskState.CANCELED},
    TaskState.DRAINING: {TaskState.STOPPED, TaskState.FAILED,
                         TaskState.CANCELED},
    TaskState.DONE: set(),
    TaskState.FAILED: {TaskState.SCHEDULING},      # retry re-enters scheduling
    TaskState.CANCELED: set(),
    TaskState.STOPPED: set(),
}

# first-transition timestamp wins for stable metrics on retries, except
# RUNNING/LAUNCHING/PROVISIONING/terminal which reflect the final attempt
_TS_OVERWRITE = TERMINAL | {TaskState.RUNNING, TaskState.LAUNCHING,
                            TaskState.PROVISIONING}
_STATE_KEY = {s: s.value for s in TaskState}
_STATE_EVENT = {s: f"state:{s.value}" for s in TaskState}

# public registry of the per-transition trace event names (entity = task
# uid); the observability layer resolves state rows through this instead of
# re-deriving the "state:*" convention
STATE_EVENTS: Dict[TaskState, str] = dict(_STATE_EVENT)

_uid_counter = itertools.count()


def new_uid(prefix: str = "task") -> str:
    return "%s.%06d" % (prefix, next(_uid_counter))


def reserve_uid_block(count: int, prefix: str = "task") -> tuple:
    """Reserve ``count`` consecutive uids from the global counter without
    materializing the strings; returns ``(prefix, start)`` so member ``i``
    is ``"%s.%06d" % (prefix, start + i)`` — the exact ``new_uid`` format.
    Cohort waves use this to name 10M tasks in O(1) memory."""
    global _uid_counter
    start = next(_uid_counter)
    _uid_counter = itertools.count(start + count)
    return prefix, start


@dataclass(init=False, slots=True)
class TaskDescription:
    uid: str = ""
    kind: str = "executable"            # executable | function | service
    cores: int = 1
    gpus: int = 0
    nodes: int = 0                      # >0: whole-node co-scheduling (MPI-like)
    duration: float = 0.0               # sim-mode execution time
    fn: Optional[Callable] = None       # real-mode in-process payload
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    executable: str = ""                # real-mode subprocess payload
    arguments: Tuple = ()               # argv tail for ``executable``
    coupling: str = "loose"             # loose | tight | data
    backend: Optional[str] = None       # explicit routing override
    stage: str = ""
    workflow: str = ""
    max_retries: int = 0
    service: Optional[Any] = None       # owning repro_torch.services.Service for
                                        # kind="service" replicas (provides
                                        # startup/rate/handler + request queues)
    restarted_from: Optional[str] = None  # restart lineage: uid of the failed
                                          # replica this description replaces
                                          # (chains across generations)
    # campaign-scheduler fields (repro_torch.sched): ordering class, fair-share
    # tenant/weight, and per-task upstream dependencies (uids) released by
    # the scheduler as the upstreams reach a terminal state
    priority: int = 0
    tenant: str = ""
    share: float = 1.0
    after: Tuple[str, ...] = ()
    # fault-model fields (repro_torch.faults): per-task walltime limit (0 =
    # none;
    # overrunning tasks are killed and FAILED with reason "walltime"), and
    # the checkpoint-resume contract — checkpoint_dir names where the task
    # persists progress, checkpoint_period how often (sim: virtual seconds
    # of progress retained on failure; real: passed to the payload), and
    # resume_from pins an explicit step to restart from (None = latest)
    walltime: float = 0.0
    checkpoint_dir: str = ""
    checkpoint_period: float = 0.0
    resume_from: Optional[int] = None

    # hand-written __init__ (same signature/defaults as the generated one,
    # __post_init__ folded in): descriptions are created once per task, so
    # their construction is a measurable slice of million-task campaigns
    def __init__(self, uid: str = "", kind: str = "executable",
                 cores: int = 1, gpus: int = 0, nodes: int = 0,
                 duration: float = 0.0, fn: Optional[Callable] = None,
                 args: Tuple = (), kwargs: Optional[Dict[str, Any]] = None,
                 executable: str = "", arguments: Tuple = (),
                 coupling: str = "loose", backend: Optional[str] = None,
                 stage: str = "", workflow: str = "", max_retries: int = 0,
                 service: Optional[Any] = None,
                 restarted_from: Optional[str] = None,
                 priority: int = 0, tenant: str = "", share: float = 1.0,
                 after: Tuple[str, ...] = (), walltime: float = 0.0,
                 checkpoint_dir: str = "", checkpoint_period: float = 0.0,
                 resume_from: Optional[int] = None):
        self.uid = uid or new_uid()
        self.kind = kind
        self.cores = cores
        self.gpus = gpus
        self.nodes = nodes
        self.duration = duration
        self.fn = fn
        self.args = args
        self.kwargs = kwargs if kwargs is not None else {}
        self.executable = executable
        self.arguments = arguments
        self.coupling = "tight" if (nodes and coupling == "loose") else coupling
        self.backend = backend
        self.stage = stage
        self.workflow = workflow
        self.max_retries = max_retries
        self.service = service
        self.restarted_from = restarted_from
        self.priority = priority
        self.tenant = tenant
        self.share = share
        self.after = after
        self.walltime = walltime
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_period = checkpoint_period
        self.resume_from = resume_from

    @classmethod
    def to_batch(cls, descriptions: Sequence["TaskDescription"]
                 ) -> "DescriptionBatch":
        """Columnarize a description list into a :class:`DescriptionBatch`
        (uniform fields collapse to scalars, rare fields go sparse). The
        round-trip ``from_batch(to_batch(descs))`` returns the original
        objects, so batch submission of a converted list is byte-for-byte
        the same input as the list itself."""
        return DescriptionBatch.from_descriptions(descriptions)

    @staticmethod
    def from_batch(batch: "DescriptionBatch") -> List["TaskDescription"]:
        """Materialize a batch back into per-row description objects (the
        object-path fallback; inverse of :meth:`to_batch`)."""
        return batch.to_descriptions()


class InvalidTransition(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Columnar descriptions (struct-of-arrays submission path) — the batch type
# every layer of the submission path consumes natively; see
# src/repro/runtime/README.md "Columnar descriptions".
# ---------------------------------------------------------------------------

# dense column families with their TaskDescription defaults: a column whose
# value equals the default is simply absent from storage
_BATCH_FLOAT: Dict[str, float] = {"duration": 0.0, "walltime": 0.0,
                                  "checkpoint_period": 0.0, "share": 1.0}
_BATCH_INT: Dict[str, int] = {"cores": 1, "gpus": 0, "nodes": 0,
                              "priority": 0, "max_retries": 0}
_BATCH_STR: Dict[str, Optional[str]] = {
    "kind": "executable", "coupling": "loose", "backend": None,
    "stage": "", "workflow": "", "tenant": "", "executable": "",
    "checkpoint_dir": ""}
# rare fields: stored as row -> value dicts (or one broadcast scalar)
_BATCH_SPARSE: Dict[str, Any] = {
    "fn": None, "args": (), "kwargs": None, "arguments": (),
    "service": None, "restarted_from": None, "after": (),
    "resume_from": None}
_BATCH_FIELDS = (tuple(_BATCH_FLOAT) + tuple(_BATCH_INT)
                 + tuple(_BATCH_STR) + tuple(_BATCH_SPARSE))


class _SparseCol(dict):
    """Per-row overrides for one rare field: row -> value, with a
    batch-level default for unlisted rows."""

    __slots__ = ("default",)

    def __init__(self, *args, default=None):
        super().__init__(*args)
        self.default = default


class DescriptionBatch:
    """Struct-of-arrays container for N task descriptions.

    Dense numeric fields are one scalar (uniform across the batch — the
    ``from_template`` wave case, O(1) memory) or one numpy column; string
    fields are one scalar or interned ``(codes, pool)`` pairs; rare fields
    (``fn``/``after``/``service``/...) live in sparse row dicts. Rows
    materialize lazily as :class:`DescView` (description-shaped, read-only)
    or fully via :meth:`to_descriptions`. Uids are an explicit list (the
    ``from_descriptions`` round-trip) or a lazily reserved contiguous
    ``new_uid`` block."""

    __slots__ = ("n", "_num", "_str", "_sparse", "_uids", "_uid_prefix",
                 "_uid_start", "_descs")

    def __init__(self, n: int, uids: Optional[Sequence[str]] = None,
                 **fields: Any):
        if n < 0:
            raise ValueError("DescriptionBatch: negative length")
        self.n = n
        self._num: Dict[str, Any] = {}
        self._str: Dict[str, Any] = {}
        self._sparse: Dict[str, Any] = {}
        self._descs: Optional[List[TaskDescription]] = None
        self._uids = list(uids) if uids is not None else None
        if self._uids is not None and len(self._uids) != n:
            raise ValueError("DescriptionBatch: uids length mismatch")
        self._uid_prefix: Optional[str] = None
        self._uid_start = -1
        for name, val in fields.items():
            self.set_column(name, val)
        self._normalize_coupling()

    # ------------------------------------------------------------- building
    @classmethod
    def from_template(cls, template: TaskDescription, n: int
                      ) -> "DescriptionBatch":
        """O(1)-memory batch of ``n`` rows all shaped like ``template``
        (every column a scalar; ``template.uid`` is ignored — rows name
        themselves from a reserved uid block on first use)."""
        b = cls(n)
        for name in _BATCH_FLOAT:
            b.set_column(name, getattr(template, name))
        for name in _BATCH_INT:
            b.set_column(name, getattr(template, name))
        for name in _BATCH_STR:
            b.set_column(name, getattr(template, name))
        for name in _BATCH_SPARSE:
            b.set_column(name, getattr(template, name))
        return b

    @classmethod
    def from_descriptions(cls, descriptions: Sequence[TaskDescription]
                          ) -> "DescriptionBatch":
        """Columnarize existing description objects (uniform columns
        collapse to scalars; non-default rare fields go sparse). The source
        objects are retained so :meth:`to_descriptions` round-trips to the
        originals."""
        descs = list(descriptions)
        n = len(descs)
        b = cls(n, uids=[d.uid for d in descs])
        b._descs = descs
        if not n:
            return b
        d0 = descs[0]
        for name in _BATCH_FIELDS:
            first = getattr(d0, name)
            uniform = True
            for d in descs:
                if getattr(d, name) != first:
                    uniform = False
                    break
            if uniform:
                b.set_column(name, first)
            elif name in _BATCH_SPARSE:
                default = _BATCH_SPARSE[name]
                col = _SparseCol(default=default)
                for i, d in enumerate(descs):
                    v = getattr(d, name)
                    if v != default and not (name == "kwargs" and not v):
                        col[i] = v
                b._sparse[name] = col
            else:
                b.set_column(name, [getattr(d, name) for d in descs])
        return b

    def set_column(self, name: str, value: Any) -> None:
        """Set one whole column: a scalar (uniform) or a length-n sequence.
        Columns left at (or set to) the TaskDescription default are not
        stored."""
        n = self.n
        if name in _BATCH_FLOAT or name in _BATCH_INT:
            isfloat = name in _BATCH_FLOAT
            default = _BATCH_FLOAT[name] if isfloat else _BATCH_INT[name]
            if isinstance(value, (int, float, np.integer, np.floating)):
                v = float(value) if isfloat else int(value)
                if v == default:
                    self._num.pop(name, None)
                else:
                    self._num[name] = v
                return
            col = np.asarray(value,
                             dtype=np.float64 if isfloat else np.int64)
            if len(col) != n:
                raise ValueError(f"column {name!r}: length mismatch")
            self._num[name] = col
        elif name in _BATCH_STR:
            if value is None or isinstance(value, str):
                if value == _BATCH_STR[name]:
                    self._str.pop(name, None)
                else:
                    self._str[name] = value
                return
            vals = list(value)
            if len(vals) != n:
                raise ValueError(f"column {name!r}: length mismatch")
            self._str[name] = self._encode_str(vals)
        elif name in _BATCH_SPARSE:
            default = _BATCH_SPARSE[name]
            if isinstance(value, _SparseCol):
                self._sparse[name] = value
            elif isinstance(value, dict) and name != "kwargs":
                self._sparse[name] = _SparseCol(value, default=default)
            else:
                if value == default or (name == "kwargs" and not value):
                    self._sparse.pop(name, None)
                else:
                    self._sparse[name] = value      # broadcast scalar
        else:
            raise KeyError(f"unknown description field {name!r}")

    def set_sparse(self, name: str, row: int, value: Any) -> None:
        """Set one rare field for one row (e.g. campaign dep wiring writing
        into the ``after`` column)."""
        if name not in _BATCH_SPARSE:
            raise KeyError(f"not a sparse field: {name!r}")
        col = self._sparse.get(name)
        if not isinstance(col, _SparseCol):
            col = _SparseCol(default=(col if col is not None
                                      else _BATCH_SPARSE[name]))
            self._sparse[name] = col
        col[row] = value

    @staticmethod
    def _encode_str(vals: List[Optional[str]]):
        pool: List[Optional[str]] = []
        codes_map: Dict[Any, int] = {}
        codes = np.empty(len(vals), dtype=np.int64)
        for i, v in enumerate(vals):
            c = codes_map.get(v)
            if c is None:
                c = codes_map[v] = len(pool)
                pool.append(v)
            codes[i] = c
        if len(pool) == 1:
            return pool[0]
        return codes, pool

    def _normalize_coupling(self) -> None:
        # replicate TaskDescription.__init__: node-wide (gang) tasks default
        # to tight coupling
        nodes = self._num.get("nodes")
        if nodes is None:
            return
        coup = self._str.get("coupling", "loose")
        if not isinstance(nodes, np.ndarray):
            # every row is a gang
            if isinstance(coup, str):
                if coup == "loose":
                    self._str["coupling"] = "tight"
            else:
                codes, pool = coup
                self._str["coupling"] = self._encode_str(
                    ["tight" if pool[c] == "loose" else pool[c]
                     for c in codes.tolist()])
            return
        mask = nodes > 0
        if not mask.any():
            return
        vals = [self.get("coupling", i) for i in range(self.n)]
        for i in np.flatnonzero(mask).tolist():
            if vals[i] == "loose":
                vals[i] = "tight"
        self._str["coupling"] = self._encode_str(vals)

    # -------------------------------------------------------------- access
    def get(self, name: str, i: int) -> Any:
        """Python value of field ``name`` at row ``i``."""
        if name in _BATCH_FLOAT or name in _BATCH_INT:
            v = self._num.get(name)
            if v is None:
                return (_BATCH_FLOAT.get(name)
                        if name in _BATCH_FLOAT else _BATCH_INT[name])
            return v[i].item() if isinstance(v, np.ndarray) else v
        if name in _BATCH_STR:
            v = self._str.get(name, _BATCH_STR[name])
            if isinstance(v, tuple):
                codes, pool = v
                return pool[codes[i]]
            return v
        if name in _BATCH_SPARSE:
            v = self._sparse.get(name)
            if v is None:
                out = _BATCH_SPARSE[name]
            elif isinstance(v, _SparseCol):
                out = v.get(i, v.default)
            else:
                out = v
            if name == "kwargs" and out is None:
                return {}
            return out
        raise KeyError(f"unknown description field {name!r}")

    def scalar(self, name: str, varies: Any = None) -> Any:
        """The column's uniform value, or ``varies`` when it is per-row."""
        if name in _BATCH_FLOAT or name in _BATCH_INT:
            v = self._num.get(name)
            if v is None:
                return (_BATCH_FLOAT.get(name)
                        if name in _BATCH_FLOAT else _BATCH_INT[name])
            return varies if isinstance(v, np.ndarray) else v
        if name in _BATCH_STR:
            v = self._str.get(name, _BATCH_STR[name])
            return varies if isinstance(v, tuple) else v
        if name in _BATCH_SPARSE:
            v = self._sparse.get(name)
            if isinstance(v, _SparseCol):
                return varies
            if v is None:
                v = _BATCH_SPARSE[name]
            if name == "kwargs" and v is None:
                return {}
            return v
        raise KeyError(f"unknown description field {name!r}")

    def col(self, name: str) -> np.ndarray:
        """Dense numeric column broadcast to a full array (float64 for the
        float family, int64 for ints) — what the scheduler argsorts."""
        if name in _BATCH_FLOAT:
            v = self._num.get(name, _BATCH_FLOAT[name])
            if isinstance(v, np.ndarray):
                return v
            return np.full(self.n, v, dtype=np.float64)
        if name in _BATCH_INT:
            v = self._num.get(name, _BATCH_INT[name])
            if isinstance(v, np.ndarray):
                return v
            return np.full(self.n, v, dtype=np.int64)
        raise KeyError(f"not a dense numeric field: {name!r}")

    def str_codes(self, name: str):
        """String column as ``(codes int64[n], pool)`` — scheduler grouping
        and fair-share tenancy run on the codes, never the strings."""
        v = self._str.get(name, _BATCH_STR[name])
        if isinstance(v, tuple):
            return v
        return np.zeros(self.n, dtype=np.int64), [v]

    def sparse_rows(self, name: str) -> Dict[int, Any]:
        """The per-row override dict for a rare field (empty when the field
        is uniform/default)."""
        v = self._sparse.get(name)
        return v if isinstance(v, _SparseCol) else {}

    def has_field(self, name: str) -> bool:
        """Whether any row carries a non-default value for ``name`` (rare
        fields: conservative — presence of the column counts)."""
        if name in _BATCH_SPARSE:
            v = self._sparse.get(name)
            return v is not None and (not isinstance(v, _SparseCol)
                                      or len(v) > 0
                                      or v.default != _BATCH_SPARSE[name])
        if name in _BATCH_STR:
            return name in self._str
        return name in self._num

    # ---------------------------------------------------------------- uids
    def has_explicit_uids(self) -> bool:
        return self._uids is not None

    def assign_uid_block(self, prefix: str = "task") -> None:
        """Reserve the batch's contiguous uid block now (no-op when uids
        are explicit or a block is already assigned)."""
        if self._uids is None and self._uid_prefix is None:
            self._uid_prefix, self._uid_start = reserve_uid_block(
                self.n, prefix)

    @property
    def uid_block(self) -> tuple:
        """``(prefix, start)`` of the reserved uid block (assigning it on
        first use); only valid when uids are not explicit."""
        if self._uids is not None:
            raise ValueError("batch has explicit uids, not a block")
        self.assign_uid_block()
        return self._uid_prefix, self._uid_start

    def uid(self, i: int) -> str:
        if self._uids is not None:
            return self._uids[i]
        self.assign_uid_block()
        return "%s.%06d" % (self._uid_prefix, self._uid_start + i)

    # ------------------------------------------------------------ row views
    def view(self, i: int) -> "DescView":
        return DescView(self, i)

    def to_descriptions(self) -> List[TaskDescription]:
        """Materialize every row as a real TaskDescription (the object-path
        fallback). A ``from_descriptions`` batch returns its originals."""
        if self._descs is not None:
            return list(self._descs)
        return [self.view(i).materialize() for i in range(self.n)]

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterable["DescView"]:
        return (DescView(self, i) for i in range(self.n))

    def __repr__(self):
        cols = sorted(list(self._num) + list(self._str)
                      + list(self._sparse))
        return f"<DescriptionBatch n={self.n} cols={cols}>"


class DescView:
    """Lazy, read-only, description-shaped view of one batch row: every
    TaskDescription field is a property reading the batch columns, so
    executors/routing/policies consume batch rows without materializing
    objects. ``materialize()`` produces a real TaskDescription when one is
    needed (e.g. ``dataclasses.replace`` in retry/speculation paths)."""

    __slots__ = ("_b", "_i")

    def __init__(self, batch: DescriptionBatch, i: int):
        self._b = batch
        self._i = i

    @property
    def uid(self) -> str:
        return self._b.uid(self._i)

    def materialize(self) -> TaskDescription:
        b, i = self._b, self._i
        return TaskDescription(
            uid=b.uid(i), **{name: b.get(name, i) for name in _BATCH_FIELDS})

    def __repr__(self):
        return f"<DescView row={self._i} of {self._b!r}>"


def _mk_batch_field(name: str):
    def get(self):
        return self._b.get(name, self._i)
    return property(get)


for _f in _BATCH_FIELDS:
    setattr(DescView, _f, _mk_batch_field(_f))
del _f


class Task:
    __slots__ = ("description", "uid", "state", "timestamps", "retries",
                 "result", "error", "backend", "partition", "allocation",
                 "speculative_of", "progress", "attempt", "_trace_eid",
                 "_trace_prof")

    def __init__(self, description: TaskDescription):
        self.description = description
        self.uid = description.uid
        self.state = TaskState.NEW
        self.timestamps: Dict[str, float] = {}
        self.retries = 0
        self.result: Any = None
        self.error: Optional[str] = None
        self.backend: Optional[str] = None      # executor that ran it
        self.partition: Optional[int] = None
        self.allocation: Any = None              # resource bookkeeping handle
        self.speculative_of: Optional[str] = None
        self.progress = 0.0     # checkpointed virtual seconds (sim resume)
        self.attempt = 0        # execution attempt; guards stale real-mode
        self._trace_eid = -1                     # interned uid, per profiler
        self._trace_prof = None                  # payload threads on requeue

    def save_progress(self, now: float):
        """Record checkpointed progress for a task being killed mid-run:
        the floor of elapsed run time to the task's checkpoint period,
        accumulated across attempts and clamped to the full duration.
        No-op for tasks without a checkpoint contract or not yet RUNNING."""
        d = self.description
        period = d.checkpoint_period
        if period <= 0 or not d.checkpoint_dir:
            return
        if self.state is not TaskState.RUNNING:
            return      # e.g. killed in launch limbo: RUNNING ts is stale
        started = self.timestamps.get("RUNNING")
        if started is None or now <= started:
            return
        elapsed = self.progress + (now - started)
        saved = (elapsed // period) * period
        if saved > self.progress:
            self.progress = min(saved, d.duration)

    def advance(self, state: TaskState, t: float, profiler=None):
        if state not in _LEGAL[self.state]:
            raise InvalidTransition(
                f"{self.uid}: {self.state.value} -> {state.value}")
        self.state = state
        ts = self.timestamps
        key = _STATE_KEY[state]
        if state in _TS_OVERWRITE or key not in ts:
            ts[key] = t
        if profiler is not None:
            # columnar fast path: intern this task's uid and the profiler's
            # state:* name ids once, then each transition is two C appends
            if self._trace_prof is not profiler:
                self._trace_prof = profiler
                self._trace_eid = profiler.entity_id(self.uid)
            nids = profiler.memo_nids
            nid = nids.get(state)
            if nid is None:
                nid = nids[state] = profiler.name_id(_STATE_EVENT[state])
            profiler.record_fast(t, self._trace_eid, nid)

    @property
    def done(self) -> bool:
        return self.state in TERMINAL

    def __repr__(self):
        return f"<Task {self.uid} {self.state.value} backend={self.backend}>"


# ---------------------------------------------------------------------------
# Cohort execution path (struct-of-arrays waves) — see repro_torch.core.cohort for
# the planner that fills these columns and docs/eligibility rules in
# src/repro/runtime/README.md.
# ---------------------------------------------------------------------------

class TaskCohort:
    """Columnar representation of one homogeneous group of a task wave:
    every per-task quantity the object path would scatter across ``Task``
    instances lives in a numpy column (one float64 array per transition
    timestamp). All members share one route/backend and one resource shape;
    durations may vary per task. Individual members materialize lazily as
    :class:`CohortTaskView` (task-shaped, read-only) via ``task(i)``."""

    __slots__ = ("engine", "n", "template", "descs", "backend",
                 "uid_prefix", "uid_start", "sched_t", "queued_t",
                 "launch_t", "run_t", "done_t", "durations", "n_terminal",
                 "finalized", "rows", "src_batch")

    def __init__(self, engine, template: TaskDescription, n: int,
                 backend: str, descs: Optional[List[TaskDescription]] = None,
                 uid_prefix: str = "task", uid_start: int = 0,
                 rows=None, src_batch=None):
        self.engine = engine
        self.n = n
        self.template = template          # shape/kind source for analytics
        self.descs = descs                # per-member descriptions, or None
        self.backend = backend            # (wave API: template + uid block)
        self.uid_prefix = uid_prefix
        self.uid_start = uid_start
        self.rows = rows                  # member -> source-batch row, or
        self.src_batch = src_batch        # None (member i IS row i)
        self.sched_t = 0.0                # scalar: whole bulk stamped at once
        self.queued_t = None              # float64[n], filled by the planner
        self.launch_t = None
        self.run_t = None
        self.done_t = None
        self.durations = None             # None (all template.duration) or
        self.n_terminal = 0               # float64[n] per-member durations
        self.finalized = False

    # --------------------------------------------------------------- members
    def uid(self, i: int) -> str:
        if self.descs is not None:
            return self.descs[i].uid
        if self.src_batch is not None:
            return self.src_batch.uid(
                i if self.rows is None else int(self.rows[i]))
        return "%s.%06d" % (self.uid_prefix, self.uid_start + i)

    def description(self, i: int) -> TaskDescription:
        if self.descs is not None:
            return self.descs[i]
        if self.src_batch is not None:
            return self.src_batch.view(
                i if self.rows is None else int(self.rows[i]))
        return self.template

    def task(self, i: int) -> "CohortTaskView":
        return CohortTaskView(self, i)

    def member_done(self, i: int) -> bool:
        return self.finalized or (self.done_t is not None
                                  and self.done_t[i] <= self.engine.now())

    @property
    def done(self) -> bool:
        return self.finalized

    def cores_per_task(self) -> int:
        d = self.template
        return max(1, d.cores)            # nodes==0 is a cohort precondition

    def timestamp_columns(self) -> Dict[str, Any]:
        """Whole-cohort transition timestamps as float64 columns, keyed by
        the same state names as ``Task.timestamps`` — the zero-copy surface
        the lifecycle decomposer consumes (SCHEDULING, a scalar bulk stamp,
        is broadcast; unplanned transitions are omitted)."""
        import numpy as np
        out: Dict[str, Any] = {
            "SCHEDULING": np.full(self.n, self.sched_t)}
        for key, col in (("QUEUED", self.queued_t),
                         ("LAUNCHING", self.launch_t),
                         ("RUNNING", self.run_t),
                         ("DONE", self.done_t)):
            if col is not None:
                out[key] = col
        return out

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return (CohortTaskView(self, i) for i in range(self.n))

    def __repr__(self):
        return (f"<TaskCohort n={self.n} backend={self.backend} "
                f"done={self.n_terminal}/{self.n}>")


class CohortTaskView:
    """Read-only, task-shaped view of one cohort member, materialized on
    demand (``tm.wait`` predicates, analytics fallbacks, user inspection).
    State is derived from the precomputed transition times against the
    engine clock; after cohort finalization every member is DONE."""

    __slots__ = ("_cohort", "_i")

    def __init__(self, cohort: TaskCohort, i: int):
        self._cohort = cohort
        self._i = i

    @property
    def uid(self) -> str:
        return self._cohort.uid(self._i)

    @property
    def description(self) -> TaskDescription:
        return self._cohort.description(self._i)

    @property
    def backend(self) -> str:
        return self._cohort.backend

    @property
    def state(self) -> TaskState:
        c, i = self._cohort, self._i
        if c.finalized:
            return TaskState.DONE
        now = c.engine.now()
        if c.done_t is not None and c.done_t[i] <= now:
            return TaskState.DONE
        if c.run_t is not None and c.run_t[i] <= now:
            return TaskState.RUNNING
        if c.launch_t is not None and c.launch_t[i] <= now:
            return TaskState.LAUNCHING
        if c.queued_t is not None and c.queued_t[i] <= now:
            return TaskState.QUEUED
        return TaskState.SCHEDULING

    @property
    def done(self) -> bool:
        return self._cohort.member_done(self._i)

    @property
    def timestamps(self) -> Dict[str, float]:
        c, i = self._cohort, self._i
        ts = {"SCHEDULING": c.sched_t}
        if c.queued_t is not None:
            ts["QUEUED"] = float(c.queued_t[i])
        if c.launch_t is not None:
            ts["LAUNCHING"] = float(c.launch_t[i])
        if c.run_t is not None:
            ts["RUNNING"] = float(c.run_t[i])
        if c.done_t is not None:
            ts["DONE"] = float(c.done_t[i])
        return ts

    # object-path compatibility surface
    result = None
    error = None
    retries = 0
    partition = None
    allocation = None
    speculative_of = None
    progress = 0.0
    attempt = 0

    def __repr__(self):
        return (f"<CohortTaskView {self.uid} {self.state.value} "
                f"backend={self.backend}>")


class CohortWave:
    """The result of a cohort-path bulk submission: one or more
    :class:`TaskCohort` groups (one per route/shape) covering the whole
    wave. Iteration yields task views group by group (cheap, lazy);
    ``done`` is terminal-ness of the entire wave."""

    __slots__ = ("cohorts", "n")

    def __init__(self, cohorts: List[TaskCohort]):
        self.cohorts = cohorts
        self.n = sum(c.n for c in cohorts)

    @property
    def done(self) -> bool:
        return all(c.finalized for c in self.cohorts)

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        for c in self.cohorts:
            yield from c

    def __getitem__(self, i: int):
        if i < 0:
            i += self.n
        for c in self.cohorts:
            if i < c.n:
                return c.task(i)
            i -= c.n
        raise IndexError("CohortWave index out of range")

    def __repr__(self):
        return f"<CohortWave n={self.n} groups={len(self.cohorts)}>"
