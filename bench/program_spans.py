"""The program's own spans (``repro_torch.core.spans``) read
against the card's activity (``bench/trace.DeviceTrace``): where a cell's
idle card time and its training step's time go.

    python3 bench/program_spans.py --workload <cell> --seed <n> \\
        --seconds <s> [--turns 0110]

from the root of a checkout, on the cards the cell asks for. It sets the
cell up as ``bench/run.py`` does, then runs one window of ``--seconds``
a character of ``--turns``, each under the profiler (``DeviceTrace``),
with the program's span recorder off (``0``) or on (``1``), and prints a
JSON line a window: the cell's end-to-end metrics as its readers give
them, the card's idle share, and with the recorder on the numbers below.
After the windows it prints the checks of ``correct``. Turns such as
``0110`` give the recorder's cost beside the profiler's, in one process.

The numbers, from the spans ``step``, ``step.forward``, ``step.backward``,
``step.update`` and ``payload`` (each clipped to the traced window):

* ``forward_ms``, ``backward_ms``, ``update_ms``: median over the window's
  steps of the device pairs' milliseconds, summed within a step;
* the card's idle time split three ways, each idle stretch counted where
  it lies: inside a ``step`` span (``in_step_s``), inside a ``payload``
  span and no ``step`` (``in_payload_s``, also by the payload's stage),
  inside no ``payload`` on any thread (``runtime_s``, also by the
  benchmark's own span that covers it). The three add up to the idle
  time of the window;
* ``step_idle_ms`` (``in_step_s`` a step), ``runtime_idle_ms`` (a Flux
  task, which is a campaign round; where the cell runs none, a task),
  ``payload_idle_ms`` (``in_payload_s`` a task).
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent

if str(ROOT) not in sys.path:                      # run as a script
    sys.path.insert(0, str(ROOT))

from bench.trace import gaps, merge  # noqa: E402

Intervals = List[Tuple[int, int]]
STEP_PARTS = ("step.forward", "step.backward", "step.update")


def overlap(a: Intervals, b: Intervals) -> int:
    """The length that two sorted, disjoint interval lists share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def subtract(a: Intervals, b: Intervals) -> Intervals:
    """The parts of sorted, disjoint ``a`` that sorted, disjoint ``b``
    leaves uncovered."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, t = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > t:
                out.append((t, b[k][0]))
            t = max(t, b[k][1])
            k += 1
        if t < e:
            out.append((t, e))
    return out


def on_wall(spans: Sequence, to_wall: Callable[[int], int], lo: int,
            hi: int, keep: Callable = lambda s: True) -> Intervals:
    """The finished spans ``keep`` accepts, on the wall clock, clipped to
    [lo, hi) and merged."""
    return _clipped(((to_wall(s.start_ns), to_wall(s.end_ns)) for s in spans
                     if s.end_ns is not None and keep(s)), lo, hi)


def _clipped(intervals, lo: int, hi: int) -> Intervals:
    return merge([(max(s, lo), min(e, hi)) for s, e in intervals
                  if min(e, hi) > max(s, lo)])


def step_parts(spans: Sequence) -> Dict[str, List[float]]:
    """For each ``step`` span, the device milliseconds of its
    ``step.forward``, ``step.backward`` and ``step.update`` spans, summed
    (a list a part, a step an entry; steps without a pair left out)."""
    steps = [i for i, s in enumerate(spans) if s.name == "step"]
    sums = {i: {"forward": None, "backward": None, "update": None}
            for i in steps}
    for s in spans:
        part = s.name[len("step."):] if s.name.startswith("step.") else None
        if part in ("forward", "backward", "update") and s.parent in sums \
                and s.device_ms is not None:
            cur = sums[s.parent][part]
            sums[s.parent][part] = s.device_ms + (cur or 0.0)
    return {p: [sums[i][p] for i in steps if sums[i][p] is not None]
            for p in ("forward", "backward", "update")}


def idle_split(busy: Intervals, lo: int, hi: int, spans: Sequence,
               to_wall: Callable[[int], int],
               named: Sequence[Tuple[str, int, int]] = (),
               pauses: Sequence[Tuple[str, int, int]] = ()) -> Dict:
    """The card's idle time over [lo, hi) (wall ns, ``busy`` merged)
    split by the program's spans (see the module docstring), in seconds;
    ``named`` (name, wall start, wall end) are the benchmark's own spans,
    which name the runtime's part; ``pauses`` (kind, wall start, wall end)
    the interpreter's garbage collections, whose idle time is given by
    kind and which name the longest idle stretches they cover."""
    idle = gaps(busy, lo, hi)
    step = on_wall(spans, to_wall, lo, hi, lambda s: s.name == "step")
    work = merge(on_wall(spans, to_wall, lo, hi,
                         lambda s: s.name == "payload") + step)
    outside_step = subtract(idle, step)
    runtime = subtract(outside_step, work)
    in_step = sum(e - s for s, e in idle) - sum(e - s for s, e in
                                                outside_step)
    total = sum(e - s for s, e in idle)
    out = {"window_s": (hi - lo) / 1e9, "idle_s": total / 1e9,
           "in_step_s": in_step / 1e9,
           "in_payload_s": (overlap(outside_step, work)) / 1e9,
           "runtime_s": sum(e - s for s, e in runtime) / 1e9}
    out["in_step_by_span_s"] = {
        part: overlap(idle, on_wall(spans, to_wall, lo, hi,
                                    lambda s, g=part: s.name == g)) / 1e9
        for part in STEP_PARTS}
    out["in_step_by_span_s"]["other"] = (
        out["in_step_s"] - sum(out["in_step_by_span_s"].values()))
    out["longest_idle"] = longest(idle, spans, to_wall, pauses)
    if pauses:
        out["in_gc_s"] = {kind: overlap(idle, _clipped(
            ((a, b) for k, a, b in pauses if k == kind), lo, hi)) / 1e9
            for kind in sorted({k for k, _, _ in pauses})}
    payloads = [s for s in spans if s.name == "payload"
                and s.end_ns is not None and lo <= to_wall(s.start_ns) < hi]
    out["in_payload_by_stage_s"] = {
        stage: overlap(outside_step, on_wall(
            spans, to_wall, lo, hi, lambda s, g=stage: s.name == "payload"
            and s.args.get("stage") == g)) / 1e9
        for stage in sorted({s.args.get("stage", "") for s in payloads})}
    if named:
        by: Dict[str, int] = {}
        for name in sorted({n for n, _, _ in named}):
            by[name] = overlap(runtime, _clipped(
                ((a, b) for n, a, b in named if n == name), lo, hi))
        by["none"] = (sum(e - s for s, e in runtime) - overlap(
            runtime, _clipped(((a, b) for _, a, b in named), lo, hi)))
        out["runtime_by_bench_span_s"] = {k: v / 1e9 for k, v in by.items()}
    out["steps"] = sum(1 for s in spans if s.name == "step"
                       and s.end_ns is not None
                       and lo <= to_wall(s.start_ns) < hi)
    out["tasks"] = len(payloads)
    out["flux_tasks"] = sum(1 for s in payloads
                            if s.args.get("backend") == "flux")
    return out


def longest(idle: Intervals, spans: Sequence, to_wall: Callable[[int], int],
            pauses: Sequence[Tuple[str, int, int]] = (), n: int = 5
            ) -> List[List]:
    """The ``n`` longest idle stretches, each as [seconds, the innermost
    finished span that covers its middle (``payload`` with its stage) or
    ``none``, the garbage collection that covers it or ``""``]."""
    out = []
    for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) // 2
        cover = [x for x in spans if x.end_ns is not None
                 and to_wall(x.start_ns) <= mid < to_wall(x.end_ns)]
        inner = min(cover, key=lambda x: x.end_ns - x.start_ns, default=None)
        name = ("none" if inner is None else inner.name
                + (f":{inner.args['stage']}" if "stage" in inner.args
                   else ""))
        gc = next((k for k, a, b in pauses if a <= mid < b), "")
        out.append([(e - s) / 1e9, name, gc])
    return out


def collections(events: Sequence[Tuple[str, int, int]]
                ) -> List[Tuple[str, int, int]]:
    """(``gc.gen<n>``, start, stop) of each collection, from the
    (phase, generation, perf_counter_ns) readings of ``gc.callbacks``."""
    out, began = [], None
    for phase, gen, t in events:
        if phase == "start":
            began = (gen, t)
        elif began is not None:
            out.append((f"gc.gen{began[0]}", began[1], t))
            began = None
    return out


def numbers(spans: Sequence, split: Dict) -> Dict[str, float]:
    """The per-step and per-task numbers of one window (milliseconds);
    a number whose spans the window lacks is left out."""
    out = {}
    for part, ms in step_parts(spans).items():
        if ms:
            out[f"{part}_ms"] = statistics.median(ms)
    if split["steps"]:
        out["step_idle_ms"] = 1e3 * split["in_step_s"] / split["steps"]
    rounds = split["flux_tasks"] or split["tasks"]
    if rounds:
        out["runtime_idle_ms"] = 1e3 * split["runtime_s"] / rounds
    if split["tasks"]:
        out["payload_idle_ms"] = 1e3 * split["in_payload_s"] / split["tasks"]
    return out


def steps_outside_flux(spans: Sequence) -> int:
    """The ``step`` spans that no Flux ``payload`` span of their thread
    holds: 0 where the program's spans share one axis."""
    flux = [s for s in spans if s.name == "payload"
            and s.args.get("backend") == "flux" and s.end_ns is not None]
    return sum(1 for s in spans if s.name == "step" and s.end_ns is not None
               and not any(f.thread == s.thread and f.start_ns <= s.start_ns
                           and s.end_ns <= f.end_ns for f in flux))


# ------------------------------------------------------------------- tool
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--turns", default="0110")
    args = ap.parse_args(argv)
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    import torch

    from bench import harness
    from bench.trace import DeviceTrace
    from repro_torch.core import spans as program
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    man = harness.manifest()
    gc_events: List[Tuple[str, int, int]] = []
    gc.callbacks.append(lambda phase, info: gc_events.append(
        (phase, info["generation"], time.perf_counter_ns())))
    loop, ctx, limits = harness.load_cell(args.workload, args.seed)
    cell = loop.Cell(ctx)
    cell.setup()
    torch.cuda.synchronize()
    e2e = [n for n in harness.cell_metrics(man, args.workload, "end_to_end")
           if n != "setup_s"]
    for turn, on in enumerate(args.turns):
        n_tasks, n_steps = len(cell.tasks), len(cell.steps)
        n_named, n_gc = len(ctx.spans.items), len(gc_events)
        tracer = DeviceTrace()
        tracer.start()
        trace = program.enable() if on == "1" else None
        t0, t1 = cell.window(args.seconds)
        tracer.stop()
        program.disable()
        run = harness.Run(
            workload=args.workload, m=ctx.m, ref=ctx.ref,
            traffic=ctx.traffic, setup_s=0.0, window_s=t1 - t0,
            tasks=cell.tasks[n_tasks:], steps=cell.steps[n_steps:], work={},
            trace=tracer, spans=ctx.spans)
        out = {"turn": turn, "program_spans": on == "1",
               "device": torch.cuda.get_device_name(0),
               "step_s": (statistics.median(run.steps) if run.steps
                          else None),
               "device_idle_pct": 100.0 * (1 - tracer.busy_s()
                                           / tracer.window_s())}
        out.update({n: harness.read_metric(n, run) for n in e2e})
        if trace is not None:
            got = trace.spans()
            named = [(n, tracer.to_wall(a), tracer.to_wall(b))
                     for n, a, b in ctx.spans.items[n_named:]]
            pauses = [(k, tracer.to_wall(a), tracer.to_wall(b))
                      for k, a, b in collections(gc_events[n_gc:])]
            split = idle_split(tracer.busy(), tracer.lo, tracer.hi, got,
                               trace.to_wall_ns, named, pauses)
            out["numbers"] = numbers(got, split)
            out["split"] = split
            out["steps_outside_flux"] = steps_outside_flux(got)
            out["spans"] = len(got)
        print(json.dumps(out), flush=True)
    cell.release()
    checks = cell.check()
    print(json.dumps({"checks": checks,
                      "over_limits": harness.over_limits(checks, limits)}),
          flush=True)
    harness.refuse_forbidden()
    return 0


if __name__ == "__main__":
    sys.exit(main())
