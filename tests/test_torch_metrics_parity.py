"""The port's campaign, analytics, chaos and observability layers against
the JAX package's, on the CPU: the same seed gives the same simulated run
and the same numbers in both packages, exactly (the same numpy runs on the
same trace).

* IMPECCABLE (``run_impeccable``) on srun, flux and flux+dragon at 128 and
  256 nodes, with and without the service-fed inference stage (flux and
  flux+dragon; srun hosts no services): the trace columns, every task's
  state and timestamps, ``compute_metrics``, ``lifecycle_breakdown`` (by
  backend and by stage), the timeseries, the Chrome trace's JSON and the
  ``RunReport`` payload.
* A ``ChaosController`` run (a node and a pilot killed under checkpointed
  tasks) watched by a ``Watcher``: the same artifacts, ``fault_metrics``,
  the controller's stats and the watcher's streamed breakdown.
* At 1,024 nodes, the twins of tests/test_campaign.py's two paper-scale
  tests: flux's makespan against srun's, equal in both packages, and the
  paper's claims on them.

Each run sets both packages' ``task._uid_counter`` to one start, so both
traces name the same entities.
"""
import importlib
import itertools
import json

import pytest

PKGS = ("repro", "repro_torch")


class Pkg:
    def __init__(self, name):
        self.name = name
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        self.task = mod("core.task")
        self.PD = mod("core.pilot").PilotDescription
        self.TD = self.task.TaskDescription
        self.A = mod("core.analytics")
        self.impeccable = mod("core.impeccable")
        self.faults = mod("faults")
        self.obs = mod("observability")
        self.rt = mod("runtime")
        self.sched = mod("sched")


def _aligned(fn, *args):
    """``fn(pkg, *args)`` in both packages from one uid start."""
    pkgs = [Pkg(n) for n in PKGS]
    start = max(next(p.task._uid_counter) for p in pkgs)
    out = []
    for p in pkgs:
        p.task._uid_counter = itertools.count(start)
        out.append(fn(p, *args))
    return out


def _artifacts(p, tasks, cores, prof, services=(), by_stage=False):
    """Everything the analytics and observability layers make of a run, as
    plain values."""
    obs = p.obs
    series = {m: obs.timeseries(prof, tasks, metric=m, dt=60.0,
                                total_cores=cores)
              for m in ("throughput", "inflight", "occupancy",
                        "sched_hold_depth")}
    out = {
        "trace": [(e.time, e.entity, e.name) for e in prof.events],
        "rows": sorted((t.uid, t.state.value, dict(t.timestamps))
                       for t in tasks),
        "metrics": p.A.compute_metrics(tasks, cores).__dict__,
        "concurrency": p.A.concurrency_series(tasks, dt=60.0),
        "occupancy_utilization": p.A.occupancy_utilization(tasks, cores),
        "breakdown": obs.lifecycle_breakdown(tasks, prof).as_dict(),
        "series": {k: s.as_dict() for k, s in series.items()},
        "backend_inflight": {
            k: s.as_dict() for k, s in obs.backend_inflight(
                tasks, dt=60.0).items()},
        "chrome": json.dumps(obs.chrome_trace(tasks, prof, total_cores=cores,
                                              dt=60.0, services=services),
                             sort_keys=True),
        "report": obs.RunReport.collect(tasks, cores, profiler=prof,
                                        services=services).to_json(),
        "services": [p.A.service_metrics(s).__dict__ for s in services],
    }
    if by_stage:
        out["breakdown_by_stage"] = obs.lifecycle_breakdown(
            tasks, prof, by="stage").as_dict()
    return out


def _same(want, got, pkg_name):
    """Equal key by key, but for what names the package or times the
    analysis itself: the Chrome trace's generator and the report's
    ``analysis_wall_s``."""
    assert set(want) == set(got)
    for key in want:
        w, g = want[key], got[key]
        if key == "chrome":
            g = g.replace('"repro_torch.observability"',
                          '"repro.observability"')
            assert f'"{pkg_name}.observability"' in got[key]
        if key == "report":
            w, g = dict(w), dict(g)
            w_cost, g_cost = dict(w.pop("cost")), dict(g.pop("cost"))
            w_cost.pop("analysis_wall_s"), g_cost.pop("analysis_wall_s")
            assert g_cost == w_cost, "report cost"
        assert g == w, f"{key} differs between the packages"


def _impeccable_run(p, backend, nodes, service):
    agent, camp = p.impeccable.run_impeccable(
        backend, nodes, iterations=2, seed=0, service_inference=service)
    tasks = camp.all_tasks()
    services = list(dict.fromkeys(
        t.description.service for t in tasks
        if t.description.service is not None))
    assert camp.complete and bool(services) == service
    return _artifacts(p, tasks, agent.total_cores, agent.engine.profiler,
                      services, by_stage=True)


# srun hosts no service replicas: its inference stage is batch tasks only
CASES = [(b, n, s) for b in ("srun", "flux", "flux+dragon")
         for n in (128, 256)
         for s in ((False,) if b == "srun" else (False, True))]


@pytest.mark.parametrize(
    "backend,nodes,service", CASES,
    ids=[f"{b}-{n}-{'service' if s else 'batch'}" for b, n, s in CASES])
def test_impeccable_same_in_both_packages(backend, nodes, service):
    want, got = _aligned(_impeccable_run, backend, nodes, service)
    assert want["metrics"]["n_done"] > 0 and want["trace"]
    _same(want, got, "repro_torch")


def _chaos_run(p):
    with p.rt.Session(mode="sim", seed=0) as session:
        pilots = p.rt.PilotManager(session).submit_pilots(
            [p.PD(nodes=4, backends={"flux": {"partitions": 1}}),
             p.PD(nodes=4, backends={"flux": {"partitions": 1},
                                     "dragon": {"nodes": 1}})],
            retry_backoff=1.0, retry_jitter=0.5)
        sched = p.sched.CampaignScheduler(policy="fifo", admission=True)
        tmgr = p.rt.TaskManager(session, scheduler=sched)
        tmgr.add_pilots(pilots)
        # TaskManager.watch binds one pilot: watch the survivor's agent
        watcher = p.obs.Watcher(pilots[0].agent, interval=2.0).start()
        plan = p.faults.FaultPlan([p.faults.FaultEvent(5.0, "node"),
                                   p.faults.FaultEvent(12.0, "pilot",
                                                       pilot=1)])
        chaos = p.faults.ChaosController(sched, plan, seed=1)
        chaos.arm()
        tasks = tmgr.submit_tasks(
            [p.TD(cores=28, duration=15.0, max_retries=4,
                  checkpoint_dir=f"ckpt://m{i}", checkpoint_period=4.0)
             for i in range(24)]
            + [p.TD(kind="function", duration=3.0, max_retries=2)
               for _ in range(16)])
        assert tmgr.wait_tasks(timeout=120)
        watcher.finalize()
        prof = session.profiler
        cores = sum(pl.agent.total_cores for pl in pilots)
        out = _artifacts(p, list(tasks), cores, prof)
        out["faults"] = p.A.fault_metrics(prof).as_dict()
        out["chaos"] = chaos.stats()
        out["streamed"] = watcher.breakdown.stats(exact_quantiles=True)
        return out


def test_chaos_run_same_in_both_packages():
    want, got = _aligned(_chaos_run)
    assert want["faults"]["node_failures"] == 1
    assert want["faults"]["pilot_failures"] == 1
    assert want["chaos"]["tasks_killed"] >= 1
    _same(want, got, "repro_torch")


def _scale_run(p, backend, nodes):
    agent, camp = p.impeccable.run_impeccable(backend, nodes, iterations=2,
                                              seed=3)
    return p.A.compute_metrics(camp.all_tasks(), agent.total_cores)


def test_impeccable_flux_beats_srun_at_scale():
    """Twin of the reference's paper §4.2 test: at 1,024 nodes flux cuts
    srun's makespan by more than 25% at a higher utilization; the port's
    metrics equal the JAX package's."""
    m = {}
    for backend in ("srun", "flux"):
        want, got = _aligned(_scale_run, backend, 1024)
        assert got.__dict__ == want.__dict__, backend
        m[backend] = got
    reduction = 1.0 - m["flux"].makespan / m["srun"].makespan
    assert reduction > 0.25, f"makespan reduction only {reduction:.0%}"
    assert m["flux"].utilization > m["srun"].utilization
    assert m["flux"].throughput_avg > 1.5 * m["srun"].throughput_avg


def test_impeccable_srun_degrades_with_scale():
    m = {}
    for nodes in (256, 1024):
        want, got = _aligned(_scale_run, "srun", nodes)
        assert got.__dict__ == want.__dict__, nodes
        m[nodes] = got
    assert m[1024].makespan > 1.3 * m[256].makespan
    assert m[1024].utilization < m[256].utilization
