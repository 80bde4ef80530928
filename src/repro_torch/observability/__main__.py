"""CLI for the observability layer.

    python -m repro_torch.observability report BENCH_observability.json
        Render any saved RunReport / BENCH payload as the ASCII report.

    python -m repro_torch.observability report BASELINE.json CANDIDATE.json \\
            [--tolerance 0.1]
        Cross-run diff: per-phase lifecycle deltas and throughput delta of
        the candidate vs the baseline; exits nonzero when any phase mean
        grows (or throughput shrinks) by more than --tolerance, so a
        committed baseline payload gates regressions in CI.

    python -m repro_torch.observability demo [--tasks N] [--trace out.json]
        Run a small null campaign on the sim engine, print its report, and
        optionally export the Chrome trace JSON (load in Perfetto or
        chrome://tracing).

    python -m repro_torch.observability watch [--tasks N] [--interval S] \\
            [--emit metrics.jsonl] [--promfile metrics.prom] [--mode sim]
        Run a campaign with a live Watcher attached and refresh an ASCII
        dashboard each tick (throughput/inflight sparklines, phase means,
        fired alerts). --emit appends one JSONL metric record per tick;
        --promfile atomically rewrites an OpenMetrics text exposition.

    python -m repro_torch.observability watch --follow metrics.jsonl \\
            [--no-wait]
        Tail a metric stream another process is emitting and render the
        same dashboard from it; --no-wait exits at EOF instead of polling
        for more records.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from repro_torch.observability.report import (RunReport, diff_payloads,
                                              render_payload)


def _load(path: str):
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError) as exc:
        print(f"error: cannot read {path}: {exc}", file=sys.stderr)
        return None


def _cmd_report(args) -> int:
    if len(args.files) > 2:
        print("error: report takes one payload or a baseline/candidate "
              "pair", file=sys.stderr)
        return 1
    payloads = [_load(p) for p in args.files]
    if any(p is None for p in payloads):
        return 1
    if len(payloads) == 1:
        print(render_payload(payloads[0]))
        return 0
    lines, viols = diff_payloads(payloads[0], payloads[1],
                                 tolerance=args.tolerance)
    print("\n".join(lines))
    return 1 if viols else 0


def _cmd_demo(args) -> int:
    from repro_torch.core.pilot import PilotDescription
    from repro_torch.core.task import TaskDescription
    from repro_torch.runtime import PilotManager, Session, TaskManager
    from repro_torch.observability.export import export_chrome_trace

    with Session(mode="sim", seed=args.seed) as session:
        pilot = PilotManager(session).submit_pilots(
            PilotDescription(nodes=8, backends={"flux": {"partitions": 4}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        tmgr.submit_tasks([TaskDescription(cores=1, duration=args.duration)
                           for _ in range(args.tasks)])
        tmgr.wait_tasks()
        agent = pilot.agent
        report = RunReport.collect(
            agent.all_tasks(), agent.total_cores, profiler=session.profiler,
            extra={"title": f"demo null campaign ({args.tasks} tasks)"})
        print(report.render())
        if args.trace:
            summary = export_chrome_trace(
                args.trace, agent.all_tasks(), session.profiler,
                total_cores=agent.total_cores)
            print(f"\nwrote {args.trace}: {summary['n_slices']} slices, "
                  f"{summary['n_slices_dropped']} dropped, "
                  f"{summary['n_counter_tracks']} counter tracks")
    return 0


def _print_frame(txt: str, clear: bool) -> None:
    if clear and sys.stdout.isatty():
        print("\033[2J\033[H" + txt, flush=True)
    else:
        print(txt, flush=True)


def _cmd_watch(args) -> int:
    from repro_torch.observability.stream import render_frame

    if args.follow:
        return _watch_follow(args)

    from repro_torch.core.pilot import PilotDescription
    from repro_torch.core.task import TaskDescription
    from repro_torch.runtime import PilotManager, Session, TaskManager
    from repro_torch.observability.stream import StallRule, ThroughputDropRule

    with Session(mode=args.mode, seed=args.seed) as session:
        pilot = PilotManager(session).submit_pilots(
            PilotDescription(nodes=8, backends={"flux": {"partitions": 4}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)

        def frame(w):
            m = w.metrics()
            th = w.throughput.series().v[-48:].tolist()
            inf = w.inflight.series().v[-48:].tolist()
            alerts = [a.as_dict() for a in w.monitor.alerts[-3:]]
            _print_frame(render_frame(m, th, inf, alerts),
                         clear=not args.no_clear)

        rules = [StallRule(window=max(10.0, 10.0 * args.interval)),
                 ThroughputDropRule()]
        watcher = tmgr.watch(interval=args.interval, rules=rules,
                             emit=args.emit, promfile=args.promfile,
                             on_tick=frame)
        if args.mode == "real":
            descs = [TaskDescription(kind="function", fn=_noop)
                     for _ in range(args.tasks)]
        else:
            descs = [TaskDescription(cores=1, duration=args.duration)
                     for _ in range(args.tasks)]
        tmgr.submit_tasks(descs)
        tmgr.wait_tasks()
        watcher.finalize()
        m = watcher.metrics()
        print(f"done: {m['n_done']:,} tasks, "
              f"{watcher.n_rows_folded:,} rows folded in "
              f"{watcher.fold_wall_s:.3f}s over {watcher.n_ticks} ticks; "
              f"{len(watcher.monitor.alerts)} alert(s)")
        if args.emit:
            print(f"metric stream: {args.emit}")
    return 0


def _noop():
    return 0


def _watch_follow(args) -> int:
    """Tail a Watcher JSONL metric stream and render each record."""
    from repro_torch.observability.stream import render_frame

    try:
        fh = open(args.follow)
    except OSError as exc:
        print(f"error: cannot open {args.follow}: {exc}", file=sys.stderr)
        return 1
    with fh:
        buf = ""
        while True:
            chunk = fh.readline()
            if not chunk:
                if args.no_wait:
                    return 0
                time.sleep(0.2)
                continue
            buf += chunk
            if not buf.endswith("\n"):
                continue                   # partial line; writer mid-record
            line, buf = buf.strip(), ""
            if not line:
                continue
            try:
                m = json.loads(line)
            except ValueError:
                continue
            _print_frame(render_frame(m, alerts=m.get("alerts") or ()),
                         clear=not args.no_clear)
            if m.get("final"):
                return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.observability",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report",
                        help="render a saved payload, or diff two")
    rp.add_argument("files", nargs="+", metavar="FILE",
                    help="one payload to render, or BASELINE CANDIDATE")
    rp.add_argument("--tolerance", type=float, default=0.10,
                    help="relative regression tolerance for diffs "
                         "(default 0.10)")
    rp.set_defaults(fn=_cmd_report)
    dm = sub.add_parser("demo", help="run + report a small null campaign")
    dm.add_argument("--tasks", type=int, default=2000)
    dm.add_argument("--duration", type=float, default=0.5)
    dm.add_argument("--seed", type=int, default=0)
    dm.add_argument("--trace", default=None,
                    help="also export Chrome trace JSON here")
    dm.set_defaults(fn=_cmd_demo)
    wp = sub.add_parser("watch",
                        help="live dashboard over a running campaign, or "
                             "--follow an emitted metric stream")
    wp.add_argument("--tasks", type=int, default=2000)
    wp.add_argument("--duration", type=float, default=0.5)
    wp.add_argument("--seed", type=int, default=0)
    wp.add_argument("--mode", choices=("sim", "real"), default="sim")
    wp.add_argument("--interval", type=float, default=1.0,
                    help="tick period (virtual s on sim, wall s on real)")
    wp.add_argument("--emit", default=None,
                    help="append one JSONL metric record per tick here")
    wp.add_argument("--promfile", default=None,
                    help="atomically rewrite an OpenMetrics exposition "
                         "here each tick")
    wp.add_argument("--follow", default=None, metavar="JSONL",
                    help="render frames from an emitted metric stream "
                         "instead of running a campaign")
    wp.add_argument("--no-wait", action="store_true",
                    help="with --follow: exit at EOF instead of polling")
    wp.add_argument("--no-clear", action="store_true",
                    help="append frames instead of clearing the screen")
    wp.set_defaults(fn=_cmd_watch)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
