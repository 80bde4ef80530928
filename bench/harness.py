"""The benchmark's core: one run of one cell.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
  * ``bench/configs/<config>.json``   the model: its published keys, the
                                      port's name for each (``port_keys``),
                                      the port's own settings (``port``),
                                      its ``reference`` and a ``smoke`` size
  * ``bench/reference/<reference>.py`` the plain reference, ``ctx.ref``
  * ``bench/traffic/<traffic>.json``  the traffic's parameters; its
                                      ``loop`` names the generator,
                                      ``bench/loops/<loop>.py``
  * ``bench/limits/<workload>.json``  the limit of each number compared
  * ``bench/metrics/<metric>.py``     one reader a metric: ``read(run)``
                                      gives its value, or None where the
                                      run holds nothing to read
A new configuration, mix, cell or metric is new files and new entries.

A loop module's ``Cell(ctx)`` does the work: ``setup()`` makes the
program's objects from the seed and warms every shape up; ``window(s)``
runs the traffic for ``s`` seconds and returns (t0, t1), the window's
perf_counter bounds, once all work begun inside it is complete;
``release()`` frees the program's state; ``check()`` runs the plain
reference and returns the numbers it compares. After ``window`` the cell
holds ``tasks`` (one dict a task: its ``stage``, the runtime's state
timestamps ``t``, ``body_s``, ``tokens``), ``steps`` (the seconds of each
training step), ``work`` (what the readers' counts need) and
``attempted``/``failed``.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

from bench.trace import DeviceTrace, Spans

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
# top-level module names that may not be loaded in the process that
# prints a result: the JAX stack and the JAX package the port is made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def manifest() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(man: Dict, workload: str) -> Dict[str, Path]:
    """The files a cell is made of, by role."""
    cell = _named(man["workloads"], workload, "workload")
    conf = _named(man["configs"], cell["config"], "config")
    traffic = BENCH / "traffic" / f"{cell['traffic']}.json"
    loop = json.loads(traffic.read_text())["loop"]
    return {"config": ROOT / conf["file"], "traffic": traffic,
            "loop": BENCH / "loops" / f"{loop}.py",
            "limits": BENCH / "limits" / f"{workload}.json"}


def cell_metrics(man: Dict, workload: str, kind: str) -> List[str]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") a cell
    reports: those that list it, and those that list no cells (each
    per-layer metric lists its cells)."""
    return [m["name"] for m in man[kind]
            if workload in m.get("workloads", [workload])]


def port_config(conf: Dict) -> Dict:
    """The configuration as the program runs it: each published width
    under the port's name for it (``port_keys``), and the port's own
    settings (``port``). Each width is held once, under its published
    key."""
    m = {field: conf[key] for field, key in conf["port_keys"].items()}
    clash = set(m) & set(conf["port"])
    if clash:
        raise ValueError(f"{sorted(clash)} given both as published keys "
                         f"and in the port block")
    return {**m, **conf["port"]}


def reference_of(conf: Dict):
    """The configuration's plain reference module."""
    return importlib.import_module(f"bench.reference.{conf['reference']}")


def metric_unit(man: Dict, name: str) -> str:
    return next(m["unit"] for k in ("end_to_end", "per_layer")
                for m in man[k] if m["name"] == name)


def read_metric(name: str, run) -> Optional[float]:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(run)
    return None if value is None else float(value)


def over_limits(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> List[str]:
    """The numbers compared that are not within their limits (a number
    that is not a number is not within)."""
    return [k for k, lim in limits.items()
            if k in numbers and not numbers[k] <= lim]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN`` (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def refuse_forbidden():
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run loaded {bad}: the benchmark must not load "
                         f"JAX or the JAX package")


@dataclass
class Run:
    """What a metric reader reads."""
    workload: str
    m: Dict                      # the configuration as run (port_config)
    ref: Any                     # its reference module
    traffic: Dict
    setup_s: float
    window_s: float
    tasks: List[Dict]
    steps: List[float]
    work: Dict[str, Any]
    trace: Optional[DeviceTrace]
    spans: Spans


def load_cell(workload: str, seed: int, *, device: str = "cuda",
              overrides: Optional[Dict] = None,
              traffic_overrides: Optional[Dict] = None,
              fault: Optional[str] = None, log=None):
    """(the cell's loop module, its context, its limits). On the CPU
    (tests) ``overrides`` cut the configuration as run (``smoke`` in its
    file) and ``traffic_overrides`` the traffic (its ``smoke``); ``fault``
    breaks the timed path (the loop module's ``FAULTS``) to show that
    ``correct`` comes out false."""
    man = manifest()
    files = cell_files(man, workload)
    conf = json.loads(files["config"].read_text())
    m = dict(port_config(conf), **(overrides or {}))
    traffic = dict(json.loads(files["traffic"].read_text()),
                   **(traffic_overrides or {}))
    limits = json.loads(files["limits"].read_text())
    spec = importlib.util.spec_from_file_location(
        f"bench_loop_{traffic['loop']}", files["loop"])
    loop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop)
    if fault is not None and fault not in loop.FAULTS:
        raise ValueError(f"{workload} has no fault {fault!r}")

    import torch
    from repro_torch.configs.base import ModelConfig
    dev = torch.device(device)
    ctx = SimpleNamespace(
        workload=workload, m=m, cfg=ModelConfig(**m), ref=reference_of(conf),
        traffic=traffic, seed=int(seed), device=dev, spans=Spans(),
        fault=fault,
        log=log or (lambda msg: print(msg, file=sys.stderr, flush=True)))
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()          # loads them from build/kernels/ once built
    return loop, ctx, limits


def run_workload(workload: str, seed: int, seconds: float, trace: bool, *,
                 t_start: float, **kw) -> Dict:
    """One run of ``workload``; returns the result line's object. ``kw``
    go to ``load_cell``."""
    import torch
    loop, ctx, limits = load_cell(workload, seed, **kw)
    man, dev, spans, log = manifest(), ctx.device, ctx.spans, ctx.log
    m, traffic = ctx.m, ctx.traffic
    cell = loop.Cell(ctx)
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    tracer = DeviceTrace() if trace else None
    if tracer is not None:
        tracer.start()
    t0, t1 = cell.window(seconds)
    if tracer is not None:
        tracer.stop()
    refuse_forbidden()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    cell.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.check()

    run = Run(workload=workload, m=m, ref=ctx.ref, traffic=traffic,
              setup_s=setup_s, window_s=t1 - t0, tasks=cell.tasks,
              steps=cell.steps, work=cell.work, trace=tracer, spans=spans)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name in cell_metrics(man, workload, kind):
        value = read_metric(name, run)
        if value is None:
            log(f"[bench] {name}: nothing to read in this run")
        else:
            metrics[name] = {"value": value, "unit": metric_unit(man, name)}
    if trace:                       # beside the untraced runs' values:
        for name in cell_metrics(man, workload, "end_to_end"):  # its cost
            log(f"[bench] traced run's {name} = {read_metric(name, run)!r}")
    for name, value in numbers.items():
        if name not in limits:
            log(f"[bench] reading (not compared) {name} = {value!r}")
    checks = {name: {"value": numbers[name], "limit": lim}
              for name, lim in limits.items()}
    correct = not over_limits(numbers, limits)
    out = {"correct": correct, "attempted": cell.attempted,
           "failed": cell.failed, "metrics": metrics,
           "device": device_info(dev, peak, man, workload, tracer)}
    if tracer is not None:
        out["breakdown"] = {"device_ops": tracer.top_ops(),
                            "idle_gaps": tracer.idle_gaps(spans)}
    for name, c in checks.items():
        log(f"[check] {name} = {c['value']!r} (limit {c['limit']!r})")
    out["checks"] = checks
    refuse_forbidden()
    return out


def device_info(dev, peak: int, man: Dict, workload: str,
                tracer: Optional[DeviceTrace]) -> Dict:
    import torch
    chips = _named(man["workloads"], workload, "workload")["chips"]
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": chips, "memory_peak_bytes": int(peak)}
    if tracer is not None:
        info["busy_s"] = tracer.busy_s()
        info["window_s"] = tracer.window_s()
    return info
