"""Unified run report: one object composing every metric family the repo
derives — §4 run metrics, scheduling quality, service request metrics,
fault/recovery accounting — plus the observability layer's lifecycle
breakdown and reconstructed timeseries, with the layer's own cost measured
and reported alongside (events/bytes per task, analysis wall time: the
observability of the observability).

Two usage shapes:

* ``RunReport.collect(tasks, total_cores, profiler=...)`` analyzes a
  finished run end-to-end and times itself;
* ``RunReport(extra={...}, results=[...])`` wraps benchmark payloads so
  every ``BENCH_*.json`` flows through one serializer —
  ``to_json()`` stamps ``report_version`` and merges ``extra`` at the top
  level, keeping each benchmark's existing keys byte-compatible.

``python -m repro_torch.observability report FILE`` renders any saved payload
as the same ASCII report (see __main__.py).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.analytics import (compute_metrics, fault_metrics,
                                        sched_metrics, service_metrics)
from repro_torch.observability.lifecycle import PHASES, lifecycle_breakdown
from repro_torch.observability.timeseries import (inflight, occupancy,
                                                  throughput)

REPORT_VERSION = 1


def _auto_dt(makespan: float, bins: int = 60) -> float:
    """Window width giving ~``bins`` samples over the run (min 1e-3s)."""
    return max(makespan / bins, 1e-3) if makespan > 0 else 1.0


@dataclass
class RunReport:
    """Composed run analysis; every field is plain-JSON-serializable."""

    metrics: Optional[Dict[str, Any]] = None       # compute_metrics
    breakdown: Optional[Dict[str, Any]] = None     # lifecycle_breakdown
    series: Dict[str, Any] = field(default_factory=dict)
    sched: Optional[Dict[str, Any]] = None         # sched_metrics
    services: Dict[str, Any] = field(default_factory=dict)
    faults: Optional[Dict[str, Any]] = None        # fault_metrics
    alerts: List[Dict[str, Any]] = field(default_factory=list)
    cost: Optional[Dict[str, Any]] = None          # observability's own cost
    extra: Dict[str, Any] = field(default_factory=dict)
    results: Optional[List[Dict[str, Any]]] = None

    # ------------------------------------------------------------- collect
    @classmethod
    def collect(cls, tasks: Sequence, total_cores: int, profiler=None,
                services: Sequence = (), by: str = "backend",
                sched_by: Optional[str] = None, dt: Optional[float] = None,
                mode: str = "sim", with_series: bool = True,
                extra: Optional[Dict[str, Any]] = None) -> "RunReport":
        """Analyze a finished run: all four metric families plus the
        lifecycle breakdown and (optionally) the reconstructed timeseries.
        The elapsed analysis time and the trace's storage footprint land in
        ``cost`` — the report accounts for what it itself cost."""
        t0 = time.perf_counter()
        m = compute_metrics(tasks, total_cores, mode=mode)
        bd = lifecycle_breakdown(tasks, profiler, by=by, services=services)
        series: Dict[str, Any] = {}
        if with_series and m.n_done:
            step = dt if dt is not None else _auto_dt(m.makespan)
            series["throughput"] = throughput(profiler, tasks,
                                              step).as_dict()
            series["inflight"] = inflight(tasks, step).as_dict()
            if total_cores > 0:
                series["occupancy"] = occupancy(tasks, total_cores,
                                                step).as_dict()
        sched = None
        if sched_by is not None:
            # cohort-aware: TaskCohort/CohortWave columns contribute their
            # plan-time waits and served work alongside the object tasks
            sched = sched_metrics(tasks, by=sched_by).as_dict()
        svc = {s.name: service_metrics(s).as_dict() for s in services}
        faults = (fault_metrics(profiler).as_dict()
                  if profiler is not None else None)
        alerts: List[Dict[str, Any]] = []
        if profiler is not None:
            # streamed health alerts (obs:alert rows a Watcher recorded)
            from repro_torch.observability.stream import ALERT_EVENT
            if profiler.has_name(ALERT_EVENT):
                alerts = [{"t": round(ev.time, 6), **(ev.data or {})}
                          for ev in profiler.iter_name(ALERT_EVENT)]
        n = max(1, m.n_tasks)
        cost: Dict[str, Any] = {
            "analysis_wall_s": round(time.perf_counter() - t0, 6)}
        if profiler is not None:
            cost.update(
                trace_events=len(profiler),
                trace_bytes=profiler.nbytes(),
                events_per_task=round(len(profiler) / n, 3),
                trace_bytes_per_task=round(profiler.nbytes() / n, 1))
        return cls(metrics=m.as_dict(), breakdown=bd.as_dict(),
                   series=series, sched=sched, services=svc, faults=faults,
                   alerts=alerts, cost=cost, extra=dict(extra or {}))

    # ----------------------------------------------------------- serialize
    def to_json(self) -> Dict[str, Any]:
        """The payload dict: ``report_version`` + ``extra`` keys at top
        level (benchmark compatibility), then whichever families exist."""
        out: Dict[str, Any] = {"report_version": REPORT_VERSION}
        out.update(self.extra)
        if self.results is not None:
            out["results"] = self.results
        for key in ("metrics", "breakdown", "sched", "faults", "cost"):
            val = getattr(self, key)
            if val is not None:
                out[key] = val
        if self.series:
            out["series"] = self.series
        if self.services:
            out["services"] = self.services
        if self.alerts:
            out["alerts"] = self.alerts
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2)

    # -------------------------------------------------------------- render
    def render(self) -> str:
        return render_payload(self.to_json())


# ---------------------------------------------------------------------------
# ASCII rendering (shared by RunReport.render and the CLI's `report FILE`)
# ---------------------------------------------------------------------------

def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:,.4g}" if abs(v) < 1e6 else f"{v:,.0f}"
    if isinstance(v, int):
        return f"{v:,}"
    return str(v)


def _kv_lines(d: Dict[str, Any], indent: int = 2) -> List[str]:
    pad = " " * indent
    return [f"{pad}{k:<24} {_fmt(v)}" for k, v in d.items()
            if not isinstance(v, (dict, list))]


def _sparkline(values: List[float], width: int = 48) -> str:
    """Down-sampled unicode sparkline of one series."""
    blocks = "▁▂▃▄▅▆▇█"
    if not values:
        return ""
    if len(values) > width:
        stride = len(values) / width
        values = [max(values[int(i * stride):
                             max(int(i * stride) + 1,
                                 int((i + 1) * stride))])
                  for i in range(width)]
    hi = max(values) or 1.0
    return "".join(blocks[min(7, int(v / hi * 7.999))] if v > 0 else blocks[0]
                   for v in values)


def render_payload(payload: Dict[str, Any]) -> str:
    """ASCII report of any ``RunReport.to_json()`` / BENCH payload."""
    lines: List[str] = []
    title = payload.get("benchmark") or payload.get("title") or "run report"
    lines.append(f"=== {title} (report v{payload.get('report_version', '?')})"
                 f" ===")
    for k in ("config", "protocol", "nodes", "seed"):
        if k in payload:
            lines.append(f"  {k:<24} {_fmt(payload[k])}")

    m = payload.get("metrics")
    if m:
        lines.append("-- run metrics")
        lines.extend(_kv_lines(m))
    bd = payload.get("breakdown")
    if bd and bd.get("total"):
        lines.append(f"-- lifecycle breakdown (n={bd.get('n_tasks', 0):,}, "
                     f"by {bd.get('by')})")
        total = bd["total"]
        span = total.get("span_sum") or 0.0
        hdr = (f"  {'phase':<10}{'mean':>12}{'p50':>12}{'p99':>12}"
               f"{'sum':>14}{'share':>8}")
        lines.append(hdr)
        for name, ph in total.get("phases", {}).items():
            share = (ph["sum"] / span) if span > 0 else 0.0
            lines.append(f"  {name:<10}{ph['mean']:>12.4g}"
                         f"{ph['p50']:>12.4g}{ph['p99']:>12.4g}"
                         f"{ph['sum']:>14.4g}{share:>7.1%}")
        for gname, g in (bd.get("groups") or {}).items():
            lines.append(f"  [{gname}] n={g['n']:,} "
                         f"exec_core_s={g['exec_core_s']:.4g}")
    for sname, sp in ((bd or {}).get("services") or {}).items():
        lines.append(f"-- service {sname} request phases "
                     f"(n={sp.get('n_decomposed', 0):,}"
                     f"/{sp.get('n_requests', 0):,})")
        for pname, ph in (sp.get("phases") or {}).items():
            lines.append(f"  {pname:<10}{ph['mean']:>12.4g}"
                         f"{ph['p50']:>12.4g}{ph['p99']:>12.4g}"
                         f"{ph['sum']:>14.4g}")
    series = payload.get("series") or {}
    for name, s in series.items():
        v = s.get("v") or []
        if v:
            lines.append(f"-- {name} (dt={s.get('dt'):.4g}s, "
                         f"peak={max(v):.4g})")
            lines.append(f"  {_sparkline(v)}")
    sched = payload.get("sched")
    if sched:
        lines.append(f"-- scheduling (fairness={sched.get('fairness', 0):.4f})")
        for cls_name, cw in (sched.get("by_class") or {}).items():
            lines.append(f"  [{cls_name}] n={cw['n']:,} "
                         f"wait mean={cw['wait_mean']:.4g} "
                         f"p99={cw['wait_p99']:.4g}")
    for sname, sm in (payload.get("services") or {}).items():
        lines.append(f"-- service {sname}")
        lines.extend(_kv_lines(sm))
    faults = payload.get("faults")
    if faults and any(v for v in faults.values() if not isinstance(v, dict)):
        lines.append("-- faults")
        lines.extend(_kv_lines(faults))
    alerts = payload.get("alerts") or []
    if alerts:
        lines.append(f"-- alerts ({len(alerts)})")
        for a in alerts:
            lines.append(f"  [{a.get('rule', '?')}] t={a.get('t', 0.0):.1f}: "
                         f"{a.get('message', '')}")
    cost = payload.get("cost")
    if cost:
        lines.append("-- observability cost")
        lines.extend(_kv_lines(cost))
    results = payload.get("results")
    if results:
        lines.append(f"-- results ({len(results)})")
        for r in results:
            brief = {k: v for k, v in list(r.items())[:6]
                     if not isinstance(v, (dict, list))}
            lines.append("  " + "  ".join(f"{k}={_fmt(v)}"
                                          for k, v in brief.items()))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Cross-run diff (CLI: `report BASELINE.json CANDIDATE.json --tolerance`)
# ---------------------------------------------------------------------------

def diff_payloads(base: Dict[str, Any], cand: Dict[str, Any],
                  tolerance: float = 0.10,
                  ) -> "tuple[List[str], List[str]]":
    """Compare two saved run payloads: per-phase mean deltas over the
    lifecycle breakdown (hold/dispatch/queue/launch/exec), per-group exec
    means over the groups present in *both* runs (groups only one run has
    are listed as added/removed, never compared), plus the
    throughput/makespan deltas from ``metrics``. Returns the rendered diff
    lines and the list of violations — a phase mean that grew, or a
    throughput that shrank, by more than ``tolerance`` (relative). The CLI
    exits nonzero when violations is non-empty, so a committed baseline
    payload gates regressions in CI."""

    def rel(a: float, b: float) -> float:
        if a == 0.0:
            return float("inf") if b else 0.0
        return (b - a) / a

    def title(p: Dict[str, Any]) -> str:
        return str(p.get("benchmark") or p.get("title") or "run")

    lines: List[str] = [f"=== run diff: {title(base)} -> {title(cand)} "
                        f"(tolerance {tolerance:.0%}) ==="]
    viols: List[str] = []

    bp = (((base.get("breakdown") or {}).get("total") or {})
          .get("phases") or {})
    cp = (((cand.get("breakdown") or {}).get("total") or {})
          .get("phases") or {})
    if bp or cp:
        lines.append(f"  {'phase':<10}{'base mean':>12}{'cand mean':>12}"
                     f"{'delta':>9}")
        for name in PHASES:
            if name not in bp and name not in cp:
                continue
            a = (bp.get(name) or {}).get("mean", 0.0)
            b = (cp.get(name) or {}).get("mean", 0.0)
            d = rel(a, b)
            worse = d > tolerance
            mark = "  REGRESSION" if worse else ""
            lines.append(f"  {name:<10}{a:>12.4g}{b:>12.4g}{d:>+9.1%}"
                         f"{mark}")
            if worse:
                viols.append(f"phase {name} mean {a:.4g} -> {b:.4g} "
                             f"({d:+.1%} > {tolerance:.0%})")

    # per-group comparison: only groups present in BOTH runs are compared
    # (a run that added a backend should not "regress" against one that
    # never had it) — membership changes are reported explicitly instead
    bg = (base.get("breakdown") or {}).get("groups") or {}
    cg = (cand.get("breakdown") or {}).get("groups") or {}
    if bg or cg:
        added = sorted(set(cg) - set(bg))
        removed = sorted(set(bg) - set(cg))
        for name in sorted(set(bg) & set(cg)):
            a = (bg[name].get("phases") or {}).get("exec", {}).get("mean",
                                                                   0.0)
            b = (cg[name].get("phases") or {}).get("exec", {}).get("mean",
                                                                   0.0)
            d = rel(a, b)
            worse = d > tolerance
            mark = "  REGRESSION" if worse else ""
            lines.append(f"  [{name}] exec mean{a:>12.4g}{b:>12.4g}"
                         f"{d:>+9.1%}{mark}")
            if worse:
                viols.append(f"group {name} exec mean {a:.4g} -> {b:.4g} "
                             f"({d:+.1%} > {tolerance:.0%})")
        if added:
            lines.append(f"  groups added:   {', '.join(added)}")
        if removed:
            lines.append(f"  groups removed: {', '.join(removed)}")

    bm = base.get("metrics") or {}
    cm = cand.get("metrics") or {}
    for key, worse_when in (("throughput_avg", "down"),
                            ("throughput_peak", "down"),
                            ("makespan", "info")):
        if key not in bm and key not in cm:
            continue
        a = float(bm.get(key, 0.0))
        b = float(cm.get(key, 0.0))
        d = rel(a, b)
        worse = worse_when == "down" and d < -tolerance
        mark = "  REGRESSION" if worse else ""
        lines.append(f"  {key:<24}{a:>12.4g}{b:>12.4g}{d:>+9.1%}{mark}")
        if worse:
            viols.append(f"{key} {a:.4g} -> {b:.4g} "
                         f"({d:+.1%} < -{tolerance:.0%})")
    if viols:
        lines.append(f"  -> {len(viols)} violation(s) over tolerance")
    else:
        lines.append("  -> within tolerance")
    return lines, viols
