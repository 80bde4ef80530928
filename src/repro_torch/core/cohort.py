"""Cohort planner: vectorized execution of homogeneous task waves.

Instead of pushing every task of a bulk submission through the object state
machine (one ``Task`` allocation plus ~5 ``advance()`` calls plus one sim
event per transition), an *eligible* wave is planned closed-form at submit
time: the agent's dispatch pipeline and the executors' launch race are
replayed with the same float operations in the same order — including the
per-launch lognormal noise draws, consumed from the engine RNG in global
launch-chronological order — filling per-transition timestamp columns
(:class:`repro_torch.core.task.TaskCohort`). Only O(n / bucket) sim events are
then scheduled to carry completion accounting forward. The result is
bit-identical transition timestamps to the object path (golden-pinned by
``tests/test_cohort_golden.py``) at a small fraction of the event count and
allocation volume.

Eligibility is conservative — anything not provably equivalent falls back
to the object path (see ``try_plan``):

* ``SimEngine`` exactly (no subclass), no ``duration_fn`` override;
* static routing (the agent's route cache is armed), no speculation, no
  per-task done callbacks other than ones declaring a truthy
  ``cohort_safe`` probe, an idle dispatch pipeline;
* every description: no services, deps, retries or multi-node gangs; a
  kind the static rule chain routes; a shape that fits one node;
* at most one description shape per routed backend, every routed backend
  exposes ``cohort_model()`` and is *quiescent* (no queued/running work,
  pools fully free);
* GPU shapes only with all-zero durations (the packed allocator may span
  nodes for gpu tasks, which the closed-form pool model does not cover).

While a planned wave is in flight the agent's dispatch pipeline and the
participating launch servers are held busy (``_dispatch_busy`` /
``SimLaunchServer._cohort_until``), so object-path submissions interleaved
mid-wave queue behind it instead of interleaving — conservative, and
released by scheduled events at the planned end times.
"""
from __future__ import annotations

import math
from heapq import heappop, heappush
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.task import (CohortWave, DescriptionBatch, Task,
                                   TaskCohort, TaskDescription, TaskState,
                                   _STATE_EVENT)
from repro_torch.runtime.engine import SimEngine

_INF = float("inf")
_BUCKET = 65536           # tasks per completion-accounting event
_MAX_GROUPS = 8           # distinct shapes per wave before giving up


# ---------------------------------------------------------------------------
# eligibility
# ---------------------------------------------------------------------------

def _agent_eligible(agent) -> bool:
    engine = agent.engine
    return (type(engine) is SimEngine
            and engine.duration_fn is None
            and not agent.speculation
            and agent._route_cache is not None
            and agent.on_task_done is None
            and not agent._dispatch_q
            and not agent._dispatch_busy
            and all(p is not None and p() for p in agent._cb_cohort_safe))


def _desc_key(d: TaskDescription) -> tuple:
    # the agent's route-cache key: every field the static rule chain and
    # the built-in accepts() predicates read
    return (d.backend, d.kind, bool(d.executable), d.cores, d.gpus,
            d.nodes, d.coupling, d.fn is not None)


def _executor_quiescent(ex) -> bool:
    """True when every launch server of ``ex`` is fully idle: alive, not
    mid-launch, nothing running, empty backlog, no claims, pool fully
    free, and not already executing a planned cohort."""
    instances = getattr(ex, "instances", None)
    if not instances:
        return False
    for inst in instances:
        if (inst.dead or inst.busy or inst.running or inst.queue
                or inst._claim is not None or inst._cohort_until):
            return False
        pool = inst.pool
        if pool.held:
            return False
        cores, gpus = pool.spec.cores, pool.spec.gpus
        fg = pool.free_gpus
        for nid, c in pool.free_cores.items():
            if c != cores or fg[nid] != gpus:
                return False
    return True


def _route_key(agent, key: tuple, rep: TaskDescription) -> Optional[str]:
    cache = agent._route_cache
    name = cache.get(key)
    if name is None:
        try:
            name = agent.policy.route(Task(rep), agent.backends)
        except RuntimeError:
            return None
        cache[key] = name
    return name


class _Group:
    """Planner state for one (shape, backend) slice of the wave."""

    __slots__ = ("key", "template", "backend", "ex", "descs", "idx",
                 "arr", "arrl", "gidx0", "n", "h", "launch", "run", "done",
                 "insts", "rs", "means", "sigma", "cnext", "civl",
                 "fins", "inflight", "caps", "maxdone", "durs", "dur0",
                 "all_zero", "cand", "tick_arr", "tick_gidx")

    def __init__(self, key, template):
        self.key = key
        self.template = template
        self.descs = None          # per-member descriptions (desc mode)
        self.idx = None            # global submission indices (multi-group)
        self.h = 0
        self.durs = None           # per-member durations, or None (uniform)
        self.dur0 = template.duration
        self.cand = None
        # dispatch-tick bulk order: within one tick every backend receives
        # its whole sub-bulk before the next backend's, in first-occurrence
        # order — so launch-time ties between groups resolve by the group's
        # first global index in the head's tick, tracked lazily here
        self.tick_arr = -1.0
        self.tick_gidx = 0


def _scan_groups(agent, descs) -> Optional[tuple]:
    """One pass over the bulk: per-description eligibility + grouping by
    route key. Returns ``(groups, gid, durs)`` — ``gid`` is None when one
    group covers the whole bulk, ``durs`` is None when every duration
    equals the first description's — or None when any description
    disqualifies the wave."""
    spec = agent.node_spec
    sc, sg = spec.cores, spec.gpus
    d0 = descs[0]
    k0 = _desc_key(d0)
    dur0 = d0.duration
    keys: Dict[tuple, int] = {k0: 0}
    groups: List[_Group] = [_Group(k0, d0)]
    gids: Optional[List[int]] = None
    durs: Optional[List[float]] = None
    i = 0
    for d in descs:
        if (d.service is not None or d.after or d.max_retries or d.nodes
                or d.walltime or d.checkpoint_dir):
            return None
        c = d.cores
        g = d.gpus
        if c < 1 or c > sc or g < 0 or g > sg:
            return None
        kind = d.kind
        if kind != "executable" and kind != "function":
            return None
        key = (d.backend, kind, bool(d.executable), c, g, 0,
               d.coupling, d.fn is not None)
        if key != k0:
            gnum = keys.get(key)
            if gnum is None:
                if len(keys) >= _MAX_GROUPS:
                    return None
                gnum = keys[key] = len(keys)
                groups.append(_Group(key, d))
            if gids is None:
                gids = [0] * i
            gids.append(gnum)
        elif gids is not None:
            gids.append(0)
        dur = d.duration
        if dur != dur0:
            if durs is None:
                durs = [dur0] * i
        if durs is not None:
            durs.append(dur)
        i += 1
    n = i
    gid = (np.fromiter(gids, dtype=np.uint8, count=n)
           if gids is not None else None)
    dur_arr = (np.fromiter(durs, dtype=np.float64, count=n)
               if durs is not None else None)
    return groups, gid, dur_arr


def _bind_backends(agent, groups: List[_Group]) -> bool:
    """Route each group and verify the cohort preconditions on the routed
    executors: distinct backends per group, cohort_model support,
    quiescence, and a pool shape the closed-form model covers exactly."""
    seen = set()
    for g in groups:
        name = _route_key(agent, g.key, g.template)
        if name is None or name in seen:
            return False
        seen.add(name)
        ex = agent.backends[name]
        if getattr(ex, "cohort_model", None) is None:
            return False
        if not _executor_quiescent(ex):
            return False
        g.all_zero = (g.durs is None and g.dur0 == 0.0) or (
            g.durs is not None and not g.durs.any())
        if g.template.gpus > 0 and not g.all_zero:
            # the packed allocator may span a gpu task's cores and gpus
            # across nodes; only the never-binding zero-duration case is
            # modeled exactly
            return False
        g.ex = ex
        g.backend = ex.name
    return True


# ---------------------------------------------------------------------------
# dispatch pipeline replay
# ---------------------------------------------------------------------------

def _replay_dispatch(agent, n: int, gid, groups: List[_Group],
                     t0: float) -> tuple:
    """Replay the agent's bulk dispatch ticks: per-task QUEUED times (the
    tick fire times), honoring the backend-readiness hold exactly (same
    float ops: ``wait = ready - t_tick`` then ``t_tick + wait``). Returns
    ``(queued_t, t_dispatch_end)``."""
    ivl = agent.dispatch_interval
    batch = agent.dispatch_batch
    ready = [getattr(g.ex, "ready_at", 0.0) for g in groups]
    max_ready = max(ready)
    qt = np.empty(n, dtype=np.float64)
    i = 0
    t = t0
    # phase A (python): ticks that may hold on a bootstrapping backend
    while i < n:
        budget = batch if n - i >= batch else n - i
        t_tick = t + ivl * budget
        if t_tick >= max_ready:
            break
        k = 0
        held = False
        wait = 0.0
        if gid is None:
            r0 = ready[0]
            if r0 - t_tick > 0.0:
                held = True
                wait = r0 - t_tick
            else:
                qt[i:i + budget] = t_tick
                k = budget
        else:
            while k < budget:
                w = ready[gid[i + k]] - t_tick
                if w > 0.0:
                    held = True
                    wait = w
                    break
                qt[i + k] = t_tick
                k += 1
        i += k
        t = t_tick + wait if held else t_tick
    # phase B (vectorized): no holds possible past max_ready; tick times
    # are the same sequential accumulation (np.cumsum adds left-to-right)
    rem = n - i
    if rem > 0:
        n_full, last = divmod(rem, batch)
        steps = np.empty(1 + n_full + (1 if last else 0), dtype=np.float64)
        steps[0] = t
        steps[1:] = ivl * batch
        if last:
            steps[-1] = ivl * last
        ticks = np.cumsum(steps)[1:]
        counts = np.full(len(ticks), batch, dtype=np.int64)
        if last:
            counts[-1] = last
        qt[i:] = np.repeat(ticks, counts)
        t_end = float(ticks[-1])
    else:
        t_end = t
    return qt, t_end


# ---------------------------------------------------------------------------
# launch-race merge
# ---------------------------------------------------------------------------

def _bind_launch_state(g: _Group):
    """Materialize per-instance launch-race state from the executor's
    cohort model: pipeline-free times, service-time means, the shared
    coordination limiter, and (for nonzero durations) per-instance
    finish-heaps with the exact per-instance concurrency cap."""
    model = g.ex.cohort_model(g.template.kind)
    insts = model["instances"]
    g.insts = insts
    g.means = model["means"]
    g.sigma = model["sigma"]
    coord = model["coord"]
    g.cnext = coord._next
    g.civl = coord.interval
    ni = len(insts)
    g.rs = [-1.0] * ni
    g.maxdone = [-1.0] * ni
    if g.all_zero:
        # a zero-duration task frees its allocation at launch end, which
        # is exactly when the instance pipeline frees: the pool can never
        # delay a launch, so skip finish-heap bookkeeping entirely
        g.fins = None
        g.inflight = None
        g.caps = None
    else:
        d = g.template
        c = d.cores if d.cores > 0 else 1
        g.fins = [[] for _ in range(ni)]
        g.inflight = [0] * ni
        caps = []
        for inst in insts:
            spec = inst.pool.spec
            per_node = spec.cores // c
            caps.append(inst.pool.n_nodes * per_node)
        g.caps = caps
    g.launch = np.empty(g.n, dtype=np.float64)
    g.run = np.empty(g.n, dtype=np.float64)
    g.done = g.run if (g.all_zero) else np.empty(g.n, dtype=np.float64)
    g.arrl = None        # lazily materialized by the generic merge; the
    #                      single-group fast path reads g.arr chunked instead
    #                      (a 10M-float list is ~320MB of boxed floats)


def _candidate(g: _Group) -> tuple:
    """Earliest possible next launch for group ``g``: over its instances,
    ``max(pipeline-free, head arrival, pool-ready)``; the first instance
    (pump order) achieving the minimum wins — which reproduces both the
    submit_many fan-out order for arrival-bound launches and the
    _launched re-pump for backlog-bound ones."""
    arr = g.arrl[g.h]
    rs = g.rs
    best_t = _INF
    best_j = 0
    if g.fins is None:
        for j in range(len(rs)):
            r = rs[j]
            t = arr if r <= arr else r
            if t < best_t:
                best_t = t
                best_j = j
    else:
        fins = g.fins
        inflight = g.inflight
        caps = g.caps
        for j in range(len(rs)):
            r = rs[j]
            t = arr if r <= arr else r
            fin = fins[j]
            infl = inflight[j]
            # free everything finished by t — safe to persist: this
            # instance's candidate base time is monotone across calls
            # (arrivals and rs[j] only grow), so anything finished by t
            # stays finished for every later query
            while fin and fin[0] <= t:
                heappop(fin)
                infl -= 1
            inflight[j] = infl
            if infl >= caps[j]:
                # pool full at t: this launch would wait for the next
                # finish — peek only, nothing is freed until a launch
                # actually commits on this instance (a persisted pop here
                # would hand the slot to a launch on another instance at
                # an earlier time, oversubscribing the pool)
                ft = fin[0]
                if ft > t:
                    t = ft
            if t < best_t:
                best_t = t
                best_j = j
    return best_t, best_j


def _gather_normals(engine, n: int) -> np.ndarray:
    """Draw ``n`` standard normals exactly as ``n`` sequential
    ``engine.noisy`` calls would: consume the live buffer's tail first,
    then whole 8192-draw refills, leaving the engine's buffer and cursor
    in the identical state to the sequential path — so noise consumed in
    bulk here and per-call elsewhere stays one interleaved stream."""
    parts = []
    buf = engine._normal_buf
    pos = engine._normal_pos
    take = 0
    if buf is not None and pos < 8192:
        take = 8192 - pos
        if take > n:
            take = n
        parts.append(buf[pos:pos + take])
        pos += take
    rem = n - take
    while rem > 0:
        buf = engine._np_rng.standard_normal(8192)
        k = 8192 if rem >= 8192 else rem
        parts.append(buf[:k])
        pos = k
        rem -= k
    engine._normal_buf = buf
    engine._normal_pos = pos
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


_CHUNK = 1 << 18          # fast-path read/write chunk (2MB of floats)


def _merge_single_zero(engine, g: _Group):
    """Specialized drain for the dominant wave shape — one group, all-zero
    durations (no finish-heap bookkeeping): the candidate scan is inlined
    with an early exit (the first instance whose pipeline is free by the
    head arrival wins outright, since no candidate can beat the arrival
    itself), noise is pre-gathered in bulk (same RNG stream and buffer
    state as per-call ``noisy``), and arrivals/results stream through
    bounded chunks of unboxed floats instead of whole-wave Python lists.
    Per-launch arithmetic is kept scalar (``math.exp``, same op order), so
    columns stay bit-identical to the object path."""
    n = g.n
    sigma = g.sigma
    zs = _gather_normals(engine, n) if sigma > 0.0 else None
    exp = math.exp
    arr_col = g.arr
    rs = g.rs
    k = len(rs)
    means = g.means
    cnext = g.cnext
    civl = g.civl
    inf = _INF
    rng = range(k)
    for c0 in range(0, n, _CHUNK):
        c1 = min(c0 + _CHUNK, n)
        arrs = arr_col[c0:c1].tolist()
        zl = zs[c0:c1].tolist() if zs is not None else None
        launch_l: List[float] = []
        run_l: List[float] = []
        lap = launch_l.append
        rap = run_l.append
        for h, arr in enumerate(arrs):
            best_t = inf
            best_j = 0
            for j in rng:
                r = rs[j]
                if r <= arr:
                    # arrival-bound: t == arr is the global minimum and
                    # this is its first index — the object path's pick
                    best_j = j
                    t_l = arr
                    break
                if r < best_t:
                    best_t = r
                    best_j = j
            else:
                t_l = best_t
            gg = (means[best_j] * exp(sigma * zl[h]) if zl is not None
                  else means[best_j])
            start = cnext if cnext > t_l else t_l
            cnext = start + civl
            dcoord = cnext - t_l
            svc = gg if gg > dcoord else dcoord
            if svc <= 1e-6:
                svc = 1e-6
            e = t_l + svc
            lap(t_l)
            rap(e)
            rs[best_j] = e
        g.launch[c0:c1] = launch_l
        g.run[c0:c1] = run_l
    g.cnext = cnext
    g.h = n
    # zero-duration launches on one instance strictly increase in end time
    # (arrival- and backlog-bound alike), so each final rs IS that
    # instance's max completion
    g.maxdone = list(rs)


def _merge_launches(engine, groups: List[_Group]):
    """Drain every group's backlog in global launch-chronological order,
    drawing the per-launch service noise from the engine RNG in exactly
    the order the object path would (launch event order), and stamping
    LAUNCHING / RUNNING / DONE columns."""
    noisy = engine.noisy
    live = [g for g in groups if g.n > 0]
    for g in live:
        if g.arrl is None:
            g.arrl = g.arr.tolist()
    single = live[0] if len(live) == 1 else None
    while live:
        if single is not None:
            g = single
        else:
            g = None
            best_t = _INF
            best_gidx = 0
            for cg in live:
                arr = cg.arrl[cg.h]
                if arr != cg.tick_arr:
                    cg.tick_arr = arr
                    cg.tick_gidx = int(cg.gidx0[cg.h])
                c = cg.cand
                if c is None:
                    c = cg.cand = _candidate(cg)
                t = c[0]
                # ties are arrival-bound launches from the same dispatch
                # tick: the backend whose sub-bulk starts earlier in the
                # tick got its submit_many (and so all its launches) first
                if g is None or t < best_t or (t == best_t
                                               and cg.tick_gidx < best_gidx):
                    g = cg
                    best_t = t
                    best_gidx = cg.tick_gidx
        if g.cand is None:
            g.cand = _candidate(g)
        t_l, j = g.cand
        g.cand = None
        h = g.h
        # exact object-path float sequence: noise draw, then the
        # coordination reservation, then max / clamp / schedule arithmetic
        gg = noisy(g.means[j], g.sigma)
        cnext = g.cnext
        start = cnext if cnext > t_l else t_l
        cnext = start + g.civl
        g.cnext = cnext
        dcoord = cnext - t_l
        svc = gg if gg > dcoord else dcoord
        if svc <= 1e-6:
            svc = 1e-6
        e = t_l + svc
        g.launch[h] = t_l
        g.run[h] = e
        g.rs[j] = e
        if g.fins is not None:
            fin = g.fins[j]
            infl = g.inflight[j]
            # commit the frees this launch's pool wait relied on: all
            # later queries on j run at t >= rs[j] > t_l, so these
            # finishes stay shed
            while fin and fin[0] <= t_l:
                heappop(fin)
                infl -= 1
            dur = g.dur0 if g.durs is None else g.durs[h]
            done = e + dur if dur > 0.0 else e
            g.done[h] = done
            heappush(fin, done)
            g.inflight[j] = infl + 1
            if done > g.maxdone[j]:
                g.maxdone[j] = done
        else:
            # done == run (zero duration): g.done aliases g.run
            if e > g.maxdone[j]:
                g.maxdone[j] = e
        g.h = h + 1
        if g.h >= g.n:
            live.remove(g)
            if single is not None:
                single = None
            elif len(live) == 1:
                single = live[0]


# ---------------------------------------------------------------------------
# state write-back: trace columns, busy holds, completion events
# ---------------------------------------------------------------------------

def _stamp_trace(engine, g: _Group, cohort: TaskCohort, t0: float):
    prof = engine.profiler
    if g.descs is not None:
        descs = g.descs
        name_fn = lambda i, _d=descs: _d[i].uid          # noqa: E731
    elif cohort.src_batch is not None:
        name_fn = cohort.uid          # resolves through the batch's uids
    else:
        fmt = cohort.uid_prefix + ".%06d"
        base_uid = cohort.uid_start
        name_fn = lambda i, _f=fmt, _b=base_uid: _f % (_b + i)  # noqa: E731
    base = prof.reserve_entities(g.n, name_fn)
    eids = np.arange(base, base + g.n, dtype=np.int64)
    nids = prof.memo_nids
    row_nids = []
    for state in (TaskState.SCHEDULING, TaskState.QUEUED,
                  TaskState.LAUNCHING, TaskState.RUNNING, TaskState.DONE):
        nid = nids.get(state)
        if nid is None:
            nid = nids[state] = prof.name_id(_STATE_EVENT[state])
        row_nids.append(nid)
    prof.reserve_rows(5 * g.n)
    prof.record_fast_many(np.full(g.n, t0), eids, row_nids[0])
    prof.record_fast_many(g.arr, eids, row_nids[1])
    prof.record_fast_many(g.launch, eids, row_nids[2])
    prof.record_fast_many(g.run, eids, row_nids[3])
    prof.record_fast_many(g.done, eids, row_nids[4])


def _release_instance(inst):
    inst._cohort_until = 0.0
    if not inst.dead:
        inst.pump()


def _schedule_events(agent, g: _Group, cohort: TaskCohort, t0: float):
    """Busy-holds on the instances until their planned schedules finish,
    plus bucketed completion-accounting events (one per _BUCKET tasks)
    that advance the terminal counters and finalize the cohort."""
    engine = agent.engine
    for j, inst in enumerate(g.insts):
        until = g.rs[j]
        if g.maxdone[j] > until:
            until = g.maxdone[j]
        if until > t0:
            inst._cohort_until = until
            engine.schedule(until - t0, _release_instance, inst)
    done_sorted = np.sort(g.done)
    marks = done_sorted[_BUCKET - 1::_BUCKET]
    n = g.n
    cum = 0
    ex = g.ex
    for m in marks:
        cum += _BUCKET
        engine.schedule(float(m) - t0, agent._cohort_chunk_done,
                        cohort, ex, _BUCKET, cum >= n)
    if cum < n:
        engine.schedule(float(done_sorted[-1]) - t0,
                        agent._cohort_chunk_done, cohort, ex, n - cum, True)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _plan(agent, groups: List[_Group], n: int, gid,
          descs: Optional[List[TaskDescription]],
          uid_prefix: str = "task", uid_start: int = 0,
          src_batch=None) -> CohortWave:
    engine = agent.engine
    t0 = engine.now()
    qt, t_disp_end = _replay_dispatch(agent, n, gid, groups, t0)
    if gid is None:
        g = groups[0]
        g.arr = qt
        g.idx = None
        g.gidx0 = None
        g.n = n
        g.descs = descs
    else:
        for gnum, g in enumerate(groups):
            idx = np.nonzero(gid == gnum)[0]
            g.idx = idx
            g.gidx0 = idx
            g.arr = qt[idx]
            g.n = len(idx)
            if descs is not None:
                g.descs = [descs[int(j)] for j in idx]
            if g.durs is not None:
                g.durs = g.durs[idx]
    for g in groups:
        _bind_launch_state(g)
    if (len(groups) == 1 and groups[0].fins is None and groups[0].n > 0):
        _merge_single_zero(engine, groups[0])
    else:
        _merge_launches(engine, groups)

    # hold the dispatch pipeline for the replayed window, so object-path
    # submissions landing mid-wave queue behind it (released by event)
    if t_disp_end > t0:
        agent._dispatch_busy = True
        engine.schedule(t_disp_end - t0, agent._release_cohort_dispatch)

    cohorts = []
    for g in groups:
        cohort = TaskCohort(engine, g.template, g.n, g.backend,
                            descs=g.descs, uid_prefix=uid_prefix,
                            uid_start=uid_start,
                            rows=(g.idx if src_batch is not None else None),
                            src_batch=src_batch)
        cohort.sched_t = t0
        cohort.queued_t = g.arr
        cohort.launch_t = g.launch
        cohort.run_t = g.run
        cohort.done_t = g.done
        cohort.durations = g.durs if g.durs is not None else g.dur0
        _stamp_trace(engine, g, cohort, t0)
        _schedule_events(agent, g, cohort, t0)
        # commit the coordination limiter where the object path would
        # leave it after the same launch sequence
        g.ex.coord._next = g.cnext
        agent.cohorts.append(cohort)
        agent._cohort_n += g.n
        cohorts.append(cohort)
    return CohortWave(cohorts)


def try_plan(agent, descriptions) -> Optional[CohortWave]:
    """Plan a bulk of per-task descriptions as a cohort wave; returns None
    (object path) when any eligibility condition fails."""
    descs = (descriptions if isinstance(descriptions, list)
             else list(descriptions))
    if not descs or not _agent_eligible(agent):
        return None
    scanned = _scan_groups(agent, descs)
    if scanned is None:
        return None
    groups, gid, durs = scanned
    if durs is not None:
        # distribute: groups resolve their slices in _plan; single-group
        # waves take the whole column
        for g in groups:
            g.durs = durs
    if not _bind_backends(agent, groups):
        return None
    return _plan(agent, groups, len(descs), gid, descs)


_VARIES = object()        # sentinel: column is per-row, not uniform


def _str_info(batch: DescriptionBatch, name: str):
    """``(codes, pool)`` for a string column without broadcasting uniform
    columns to arrays: codes is None when every row shares ``pool[0]``."""
    v = batch.scalar(name, _VARIES)
    if v is _VARIES:
        return batch.str_codes(name)
    return None, [v]


def try_plan_batch(agent, batch: DescriptionBatch) -> Optional[CohortWave]:
    """Plan a :class:`DescriptionBatch` as a cohort wave by reading its
    columns directly — eligibility is decided per column (O(1) for uniform
    columns, one vector op for per-row ones) and grouping runs on interned
    codes, so no description objects and no per-row python scan exist
    anywhere on this path. Returns None (object fallback) when any
    eligibility condition fails."""
    n = batch.n
    if n <= 0 or not _agent_eligible(agent):
        return None
    # column-level disqualifiers — the same per-description conditions the
    # object scan checks, expressed against whole columns
    if (batch.has_field("service") or batch.has_field("after")
            or batch.has_field("restarted_from")):
        return None
    for f in ("max_retries", "nodes", "walltime"):
        v = batch.scalar(f, _VARIES)
        if v is _VARIES:
            if batch.col(f).any():
                return None
        elif v:
            return None
    if any(_str_info(batch, "checkpoint_dir")[1]):
        return None
    spec = agent.node_spec
    cores_col = gpus_col = None
    v = batch.scalar("cores", _VARIES)
    if v is _VARIES:
        cores_col = batch.col("cores")
        if int(cores_col.min()) < 1 or int(cores_col.max()) > spec.cores:
            return None
    elif v < 1 or v > spec.cores:
        return None
    v = batch.scalar("gpus", _VARIES)
    if v is _VARIES:
        gpus_col = batch.col("gpus")
        if int(gpus_col.min()) < 0 or int(gpus_col.max()) > spec.gpus:
            return None
    elif v < 0 or v > spec.gpus:
        return None
    kd_codes, kd_pool = _str_info(batch, "kind")
    for k in kd_pool:
        if k != "executable" and k != "function":
            return None
    if batch.scalar("fn", _VARIES) is _VARIES:
        return None       # per-row fn would make the route key vary row-wise
    # grouping: one combined int code per row over the route-key fields
    # that actually vary (executable contributes only its truthiness, like
    # the object route key)
    parts: List[tuple] = []
    if kd_codes is not None:
        parts.append((kd_codes, len(kd_pool)))
    for name in ("backend", "coupling"):
        codes, pool = _str_info(batch, name)
        if codes is not None:
            parts.append((codes, len(pool)))
    ex_codes, ex_pool = _str_info(batch, "executable")
    if ex_codes is not None:
        flags = np.fromiter((1 if s else 0 for s in ex_pool),
                            dtype=np.int64, count=len(ex_pool))
        if flags.min() != flags.max():
            parts.append((flags[ex_codes], 2))
    for colv in (cores_col, gpus_col):
        if colv is not None:
            u, inv = np.unique(colv, return_inverse=True)
            if len(u) > 1:
                parts.append((inv.astype(np.int64, copy=False), len(u)))
    if not parts:
        gid = None
        reps = [0]
    else:
        combo = parts[0][0].astype(np.int64, copy=True)
        for codes, card in parts[1:]:
            combo *= card
            combo += codes
        uniq, first, inv = np.unique(combo, return_index=True,
                                     return_inverse=True)
        k = len(uniq)
        if k > _MAX_GROUPS:
            return None
        if k == 1:
            gid = None
            reps = [0]
        else:
            # renumber to first-occurrence order (the object scan's group
            # order), so dispatch replay and cohort creation match it
            order = np.argsort(first, kind="stable")
            remap = np.empty(k, dtype=np.uint8)
            remap[order] = np.arange(k, dtype=np.uint8)
            gid = remap[inv]
            reps = [int(first[j]) for j in order]
    groups = [_Group(_desc_key(batch.view(r)), batch.view(r)) for r in reps]
    if batch.scalar("duration", _VARIES) is _VARIES:
        dur_col = batch.col("duration")
        for g in groups:
            g.durs = dur_col
    if not _bind_backends(agent, groups):
        return None
    return _plan(agent, groups, n, gid, None, src_batch=batch)


def try_plan_wave(agent, template: TaskDescription,
                  n: int) -> Optional[CohortWave]:
    """Plan ``n`` clones of ``template`` as a single-group cohort without
    materializing descriptions (O(1) memory per task: the batch stores one
    scalar per column and rows name themselves from a reserved uid block).
    Returns None when ineligible."""
    if n <= 0 or not _agent_eligible(agent):
        return None
    return try_plan_batch(agent, DescriptionBatch.from_template(template, n))
