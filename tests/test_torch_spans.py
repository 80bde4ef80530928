"""The port's span recorder (``repro_torch.core.spans``) on the
CPU: off it is one shared null context and touches no device; on it loses
no row under many threads, nests spans per thread, records the train
step's parts and each real-mode payload, and maps its stamps onto the
runtime's clock and the perf counter."""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.pilot import PilotDescription
from repro_torch.core.task import TaskDescription, TaskState
from repro_torch.distributed import train_step as TS
from repro_torch.models import model as M
from repro_torch.core import spans
from repro_torch.observability import chrome_trace
from repro_torch.optim import adamw
from repro_torch.runtime import PilotManager, Session, TaskManager


@pytest.fixture
def recorder():
    """Records spans for the test's length (device pairs off: no card)."""
    trace = spans.enable(device_timing=False)
    try:
        yield trace
    finally:
        spans.disable()


def _no_cuda(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA call while the recorder is off")
    for name in ("Event", "synchronize", "is_available", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def test_off_is_one_shared_null_context(monkeypatch):
    assert spans.disable() is None
    _no_cuda(monkeypatch)
    a = spans.span("step", device=True)
    b = spans.span("payload", args={"uid": "t"})
    assert a is b
    with a, spans.span("step.forward", device=True):
        pass
    trace = spans.enable(device_timing=False)
    spans.disable()
    assert trace.spans() == []


def test_hot_path_imports_no_observability():
    """The train step and the executors import the recorder alone: the
    observability package stays a layer the runtime loads on demand, and
    it exports the same recorder."""
    code = ("import sys, repro_torch.distributed.train_step, "
            "repro_torch.runtime.real_executors; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.observability')))")
    src = str(Path(spans.__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, env=env)
    assert out.stdout.strip() == "[]"
    import repro_torch.observability as obs
    assert obs.spans is spans and obs.SpanTrace is spans.SpanTrace


def test_enable_twice_refuses(recorder):
    with pytest.raises(RuntimeError, match="already"):
        spans.enable(device_timing=False)


def test_threads_lose_no_row_and_tear_none():
    """8 threads x 1,000 nested pairs of spans under a short switch
    interval: every row there, each with its own payload, its end after
    its start, and its parent the outer span of its own thread."""
    n_threads, n_spans = 8, 1000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace = spans.enable(device_timing=False)
    try:
        def work(k):
            for i in range(n_spans // 2):
                with spans.span("outer", args={"k": k, "i": i}):
                    with spans.span("inner", args={"k": k, "i": i}):
                        pass
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        spans.disable()
    got = trace.spans()
    assert len(got) == n_threads * n_spans
    seen = set()
    for s in got:
        assert s.end_ns is not None and s.end_ns >= s.start_ns
        key = (s.name, s.args["k"], s.args["i"])
        assert key not in seen
        seen.add(key)
        if s.name == "inner":
            p = got[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert (p.args["k"], p.args["i"]) == (s.args["k"], s.args["i"])
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        else:
            assert s.parent is None
    assert len({s.thread for s in got}) == n_threads


def test_parents_nest_per_thread(recorder):
    inner_done = threading.Event()

    def other():
        with spans.span("b"):
            inner_done.set()

    with spans.span("a"):
        with spans.span("a.1"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert inner_done.is_set()
        with spans.span("a.2"):
            with spans.span("a.2.x"):
                pass
    got = recorder.spans()
    by = {s.name: i for i, s in enumerate(got)}
    assert got[by["a"]].parent is None
    assert got[by["a.1"]].parent == by["a"]
    assert got[by["a.2"]].parent == by["a"]
    assert got[by["a.2.x"]].parent == by["a.2"]
    assert got[by["b"]].parent is None       # open on another thread
    assert got[by["b"]].thread != got[by["a"]].thread


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_records_its_parts(recorder, accum_steps):
    """One step: one ``step``, one ``step.update``, and a ``step.forward``
    and a ``step.backward`` a microbatch, each inside the step."""
    cfg = get_smoke_config("stablelm-3b", dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    step = TS.make_train_step(cfg, adamw.OptimizerConfig(total_steps=10,
                                                         warmup_steps=1),
                              accum_steps=accum_steps)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16),
                                         dtype=np.int32))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(4, 16)
    step(params, adamw.init(params),
         {"tokens": toks, "labels": toks, "positions": pos})
    got = recorder.spans()
    names = [s.name for s in got]
    assert names.count("step") == 1 and names.count("step.update") == 1
    assert names.count("step.forward") == accum_steps
    assert names.count("step.backward") == accum_steps
    root = names.index("step")
    for s in got:
        if s.name != "step":
            assert s.parent == root and s.device_ms is None
            assert got[root].start_ns <= s.start_ns <= s.end_ns <= \
                got[root].end_ns
    fwd = [s for s in got if s.name == "step.forward"]
    bwd = [s for s in got if s.name == "step.backward"]
    for f, b in zip(fwd, bwd):
        assert f.end_ns <= b.start_ns


def test_payload_span_lies_within_its_task_stamps(recorder):
    """A real-mode Dragon task's ``payload`` span, mapped by the engine
    clock's ``origin_ns``, lies between its RUNNING and DONE stamps."""
    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {"workers": 2}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        tasks = tmgr.submit_tasks([TaskDescription(
            kind="function", fn=time.sleep, args=(0.02,), stage="dock")
            for _ in range(4)])
        assert tmgr.wait_tasks(timeout=60)
        origin = session.engine.clock.origin_ns
    got = [s for s in recorder.spans() if s.name == "payload"]
    assert len(got) == 4
    by_uid = {s.args["uid"]: s for s in got}
    for t in tasks:
        assert t.state == TaskState.DONE
        s = by_uid[t.uid]
        assert s.args["stage"] == "dock" and s.args["backend"] == "dragon"
        start, end = ((s.start_ns - origin) / 1e9, (s.end_ns - origin) / 1e9)
        assert t.timestamps["RUNNING"] <= start
        assert end <= t.timestamps["DONE"]
        assert end - start >= 0.02


def test_anchor_maps_onto_the_perf_counter(recorder):
    for _ in range(100):
        before = time.perf_counter_ns()
        with spans.span("x"):
            pass
        after = time.perf_counter_ns()
        s = recorder.spans()[-1]
        assert before <= recorder.to_perf_ns(s.start_ns) <= after
        assert before <= recorder.to_perf_ns(s.end_ns) <= after


def test_anchor_maps_onto_the_wall_clock(recorder):
    before = time.time_ns()
    with spans.span("x"):
        pass
    after = time.time_ns()
    s = recorder.spans()[-1]
    # the wall clock may be slewed, never by a millisecond in a test
    assert before - 1_000_000 <= recorder.to_wall_ns(s.start_ns) <= \
        after + 1_000_000


def test_chrome_trace_puts_a_span_inside_its_task(recorder):
    """The Chrome trace's span slice of a payload lands inside its task's
    slice, on one axis, on a track of its own thread."""
    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {"workers": 1}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        task = tmgr.submit_tasks(TaskDescription(
            kind="function", fn=time.sleep, args=(0.05,), stage="dock"))
        assert tmgr.wait_tasks(timeout=60)
        origin = session.engine.clock.origin_ns
    with pytest.raises(ValueError, match="span_origin_ns"):
        chrome_trace([task], session.profiler, spans=recorder)
    doc = chrome_trace([task], session.profiler, spans=recorder,
                       span_origin_ns=origin)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    slice_, = [e for e in xs if e.get("cat") == "task"]
    span, = [e for e in xs if e.get("cat") == "span"]
    assert span["name"] == "payload" and span["args"]["uid"] == task.uid
    assert slice_["ts"] <= span["ts"]
    assert span["ts"] + span["dur"] <= slice_["ts"] + slice_["dur"] + 1
    assert span["pid"] != slice_["pid"]
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["pid"] == span["pid"]}
    assert "program spans" in names
    assert any(n.startswith("dragon") for n in names)
    assert doc["otherData"]["n_spans"] == 1
