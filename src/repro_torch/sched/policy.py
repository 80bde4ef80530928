"""Queue-ordering policies for the campaign scheduler.

A policy owns the *order* in which admitted work is considered for release;
placement (does it fit, which pilot) is the scheduler's job. Three built-ins
mirror the knobs batch systems expose above a pilot layer:

* :class:`FIFOPolicy` — submission order (the seed-equivalent baseline).
* :class:`PriorityPolicy` — integer priority classes with linear aging, so a
  starved low class eventually overtakes a stream of fresh high-priority
  arrivals (effective priority = class + aging_rate * wait).
* :class:`FairSharePolicy` — weighted fair share across tenants: the tenant
  with the lowest served-work / weight ratio goes next, where served work is
  charged on actual release (core-seconds for timed tasks, cores otherwise).

Policies only see :class:`_Entry` handles (task + arrival metadata); they
never touch resources, engines, or profilers, so they are trivially
deterministic and engine-agnostic.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.core import calibration as CAL
from repro_torch.core.task import Task


class _Entry:
    """One scheduler queue entry: the held task plus arrival metadata."""

    __slots__ = ("task", "seq", "t_submit", "deps", "origin", "resubmit",
                 "cost", "claim", "claim_view", "held_recorded")

    def __init__(self, task: Task, seq: int, t_submit: float,
                 origin: str = "", resubmit: bool = False):
        self.task = task
        self.seq = seq
        self.t_submit = t_submit
        self.deps: Optional[set] = None      # unresolved upstream uids
        self.origin = origin
        self.resubmit = resubmit
        d = task.description
        # fair-share work estimate: core-seconds when a duration is known,
        # plain width otherwise (gangs charge their whole-node footprint)
        width = d.nodes * CAL.CORES_PER_NODE if d.nodes else max(1, d.cores)
        self.cost = width * (d.duration if d.duration > 0 else 1.0)
        self.claim = None                    # view-pool NodeClaim (gangs)
        self.claim_view = None
        self.held_recorded = False

    @property
    def priority(self) -> int:
        return self.task.description.priority

    @property
    def tenant(self) -> str:
        return self.task.description.tenant

    @property
    def share(self) -> float:
        return self.task.description.share


class _Run:
    """A contiguous slice of one admitted :class:`DescriptionBatch`, held
    in a policy queue as row indices only: entries materialize one at a
    time from the head (``ref.materialize`` builds the Task + _Entry), so
    a held million-row batch costs the queue one object plus an index
    array. ``ref`` is the scheduler's _BatchRef (seq block, submit time,
    materialization hook)."""

    __slots__ = ("ref", "rows", "pos")

    def __init__(self, ref, rows):
        self.ref = ref
        self.rows = rows
        self.pos = 0

    def __len__(self) -> int:
        return len(self.rows) - self.pos

    @property
    def head_seq(self) -> int:
        return self.ref.seq0 + int(self.rows[self.pos])

    @property
    def head_t_submit(self) -> float:
        return self.ref.t_submit

    def pop_head(self) -> _Entry:
        row = int(self.rows[self.pos])
        self.pos += 1
        return self.ref.materialize(row)


def _head_key(item):
    """(seq, t_submit) of a queue head, entry or run alike."""
    if isinstance(item, _Run):
        return item.head_seq, item.head_t_submit
    return item.seq, item.t_submit


def _pop_front(q: Deque) -> Optional[_Entry]:
    """Pop the next entry from a deque of entries and runs, materializing
    from the head run when one is in front (empty runs are dropped)."""
    while q:
        head = q[0]
        if isinstance(head, _Run):
            if len(head) == 0:
                q.popleft()
                continue
            e = head.pop_head()
            if len(head) == 0:
                q.popleft()
            return e
        return q.popleft()
    return None


def _live_head(q: Deque):
    """The queue's first non-exhausted item, dropping spent runs."""
    while q:
        head = q[0]
        if isinstance(head, _Run) and len(head) == 0:
            q.popleft()
            continue
        return head
    return None


class QueuePolicy:
    """Ordering-policy interface: push entries (or whole batch row slices),
    pop the next candidate, requeue the ones the placement pass could not
    release (order preserved), and charge served work on actual release."""

    name = "fifo"

    def push(self, entry: _Entry) -> None:
        raise NotImplementedError

    def push_batch(self, ref, rows) -> None:
        """Admit ``rows`` (int64 row indices, submission order) of the
        batch behind ``ref`` without materializing entries; ordering
        policies split the slice on column codes (priority classes,
        tenants) and hold one :class:`_Run` per class."""
        raise NotImplementedError

    def pop(self, now: float) -> Optional[_Entry]:
        raise NotImplementedError

    def requeue(self, entries: List[_Entry]) -> None:
        raise NotImplementedError

    def charge(self, entry: _Entry) -> None:
        """Account released work (fair-share bookkeeping hook)."""

    def __len__(self) -> int:
        raise NotImplementedError


class FIFOPolicy(QueuePolicy):
    """Strict submission order — with admission disabled this reproduces the
    seed TaskManager path exactly."""

    name = "fifo"

    def __init__(self):
        self._q: Deque = deque()
        self._n = 0

    def push(self, entry: _Entry) -> None:
        self._q.append(entry)
        self._n += 1

    def push_batch(self, ref, rows) -> None:
        if len(rows):
            self._q.append(_Run(ref, rows))
            self._n += len(rows)

    def pop(self, now: float) -> Optional[_Entry]:
        e = _pop_front(self._q)
        if e is not None:
            self._n -= 1
        return e

    def requeue(self, entries: List[_Entry]) -> None:
        self._q.extendleft(reversed(entries))
        self._n += len(entries)

    def __len__(self) -> int:
        return self._n


class PriorityPolicy(QueuePolicy):
    """Priority classes with linear aging. Each class is FIFO internally;
    the head with the highest effective priority (class + aging_rate *
    wait) pops next, ties broken by arrival order. O(#classes) per pop."""

    name = "priority"

    def __init__(self, aging_rate: float = 0.0):
        self.aging_rate = aging_rate
        self._classes: Dict[int, Deque[_Entry]] = {}
        self._n = 0

    def push(self, entry: _Entry) -> None:
        q = self._classes.get(entry.priority)
        if q is None:
            q = self._classes[entry.priority] = deque()
        q.append(entry)
        self._n += 1

    def push_batch(self, ref, rows) -> None:
        """Split the slice into priority classes on the batch's priority
        column (rows stay in submission order within a class — argsort is
        implicit in the per-class masks)."""
        batch = ref.batch
        prio = batch.scalar("priority", None)
        if prio is None:
            col = batch.col("priority")[rows]
            classes = np.unique(col)
        else:
            col = None
            classes = (prio,)
        for p in classes:
            p = int(p)
            sub = rows if col is None else rows[col == p]
            if not len(sub):
                continue
            q = self._classes.get(p)
            if q is None:
                q = self._classes[p] = deque()
            q.append(_Run(ref, sub))
            self._n += len(sub)

    def pop(self, now: float) -> Optional[_Entry]:
        best_q = None
        best_key = None
        rate = self.aging_rate
        for prio, q in self._classes.items():
            head = _live_head(q)
            if head is None:
                continue
            seq, ts = _head_key(head)
            key = (prio + rate * (now - ts), -seq)
            if best_key is None or key > best_key:
                best_key = key
                best_q = q
        if best_q is None:
            return None
        self._n -= 1
        return _pop_front(best_q)

    def requeue(self, entries: List[_Entry]) -> None:
        classes = self._classes
        for e in reversed(entries):
            classes[e.priority].appendleft(e)
        self._n += len(entries)

    def __len__(self) -> int:
        return self._n


class FairSharePolicy(QueuePolicy):
    """Weighted fair share across tenants (``TaskDescription.tenant`` /
    ``share``): pop from the pending tenant with the smallest
    served-work/weight ratio; served work is charged when the scheduler
    actually releases the entry, so blocked-and-requeued candidates are not
    billed. O(#tenants) per pop."""

    name = "fair"

    def __init__(self):
        self._tenants: Dict[str, Deque[_Entry]] = {}
        self._served: Dict[str, float] = {}
        self._weights: Dict[str, float] = {}
        self._n = 0

    def push(self, entry: _Entry) -> None:
        t = entry.tenant
        q = self._tenants.get(t)
        if q is None:
            q = self._tenants[t] = deque()
            self._served.setdefault(t, 0.0)
        self._weights[t] = max(entry.share, 1e-9)
        q.append(entry)
        self._n += 1

    def push_batch(self, ref, rows) -> None:
        """Split the slice per tenant on the batch's interned tenant codes
        (rows stay in submission order within a tenant); each tenant's
        weight updates from its last row's share, matching the per-entry
        push semantics."""
        batch = ref.batch
        tenant = batch.scalar("tenant", None)
        if tenant is not None:
            groups = [(tenant, rows)]
        else:
            codes, pool = batch.str_codes("tenant")
            codes = codes[rows]
            groups = []
            for c in np.unique(codes):
                sub = rows[codes == c]
                if len(sub):
                    groups.append((pool[int(c)], sub))
        share_u = batch.scalar("share", None)
        share_col = None if share_u is not None else batch.col("share")
        for t, sub in groups:
            q = self._tenants.get(t)
            if q is None:
                q = self._tenants[t] = deque()
                self._served.setdefault(t, 0.0)
            last_share = (share_u if share_u is not None
                          else float(share_col[int(sub[-1])]))
            self._weights[t] = max(last_share, 1e-9)
            q.append(_Run(ref, sub))
            self._n += len(sub)

    def pop(self, now: float) -> Optional[_Entry]:
        best_t = None
        best_key = None
        for t, q in self._tenants.items():
            head = _live_head(q)
            if head is None:
                continue
            key = (self._served[t] / self._weights[t], _head_key(head)[0])
            if best_key is None or key < best_key:
                best_key = key
                best_t = t
        if best_t is None:
            return None
        self._n -= 1
        return _pop_front(self._tenants[best_t])

    def requeue(self, entries: List[_Entry]) -> None:
        tenants = self._tenants
        for e in reversed(entries):
            tenants[e.tenant].appendleft(e)
        self._n += len(entries)

    def charge(self, entry: _Entry) -> None:
        self._served[entry.tenant] = (self._served.get(entry.tenant, 0.0)
                                      + entry.cost)

    def served(self) -> Dict[str, float]:
        """Served work per tenant (inspection/metrics)."""
        return dict(self._served)

    def __len__(self) -> int:
        return self._n


_BUILTIN = {"fifo": FIFOPolicy, "priority": PriorityPolicy,
            "fair": FairSharePolicy}


def make_policy(spec) -> QueuePolicy:
    """Resolve a policy spec: an instance passes through, a name builds the
    matching built-in with defaults."""
    if isinstance(spec, QueuePolicy):
        return spec
    try:
        return _BUILTIN[spec]()
    except KeyError:
        raise KeyError(f"unknown scheduling policy {spec!r} "
                       f"(known: {sorted(_BUILTIN)})") from None
