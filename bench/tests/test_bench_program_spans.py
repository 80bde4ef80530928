"""``bench/program_spans.py`` on hand-placed spans against known busy
intervals of the card: each number as computed by hand, and the three
parts of the idle time adding up to the idle share times the window."""
import pytest

from bench import program_spans as P
from repro_torch.core.spans import Span

MS = 1_000_000                    # ns
OFF = 7 * MS                      # the wall clock less the monotonic one


def to_wall(ns):
    return ns + OFF


def span(name, a, b, parent=None, thread="flux_0", device_ms=None,
         **args):
    """A span from a to b ms on the wall clock, as the recorder returns it
    (monotonic stamps)."""
    return Span(name, thread, a * MS - OFF, b * MS - OFF, parent, args,
                device_ms)


def campaign():
    """A round in 100 ms: a Flux task of two steps (the second of two
    microbatches), then two docking tasks on another thread."""
    spans = [
        span("payload", 5, 65, stage="sst_train", backend="flux"),    # 0
        span("step", 8, 32, parent=0),                                 # 1
        span("step.forward", 9, 15, parent=1, device_ms=4.0),
        span("step.backward", 15, 28, parent=1, device_ms=10.0),
        span("step.update", 28, 31, parent=1, device_ms=2.0),
        span("step", 33, 58, parent=0),                                # 5
        span("step.forward", 34, 40, parent=5, device_ms=5.0),
        span("step.backward", 40, 45, parent=5, device_ms=4.0),
        span("step.forward", 45, 47, parent=5, device_ms=1.0),
        span("step.backward", 47, 55, parent=5, device_ms=5.0),
        span("step.update", 55, 57, parent=5, device_ms=2.0),
        span("payload", 66, 72, thread="dragon_1", stage="docking",
             backend="dragon"),
        span("payload", 73, 74, thread="dragon_2", stage="docking",
             backend="dragon"),
    ]
    busy = [(0, 10 * MS), (12 * MS, 30 * MS), (35 * MS, 60 * MS),
            (70 * MS, 95 * MS)]
    return busy, spans


def test_campaign_split_by_hand():
    busy, spans = campaign()
    split = P.idle_split(busy, 0, 100 * MS, spans, to_wall,
                         named=[("round.docking", 64 * MS, 75 * MS)],
                         pauses=[("gc.gen2", 61 * MS, 69 * MS),
                                 ("gc.gen0", 11 * MS, 13 * MS)])
    # idle: [10,12) [30,35) [60,70) [95,100) = 22 ms
    assert split["idle_s"] == pytest.approx(0.022)
    assert split["in_step_s"] == pytest.approx(0.006)     # 2 + 2 + 2
    assert split["in_payload_s"] == pytest.approx(0.010)  # 1 + 5 + 4
    assert split["runtime_s"] == pytest.approx(0.006)     # [65,66) [95,100)
    assert split["in_payload_by_stage_s"] == pytest.approx(
        {"docking": 0.004, "sst_train": 0.006})
    assert split["runtime_by_bench_span_s"] == pytest.approx(
        {"round.docking": 0.001, "none": 0.005})
    assert split["in_step_by_span_s"] == pytest.approx(
        {"step.forward": 0.003, "step.backward": 0.0, "step.update": 0.001,
         "other": 0.002})        # [10,12) [34,35); [30,31); [31,32) [33,34)
    assert [x[1:] for x in split["longest_idle"]] == [
        ["none", "gc.gen2"], ["payload:sst_train", ""], ["none", ""],
        ["step.forward", "gc.gen0"]]
    assert [x[0] for x in split["longest_idle"]] == pytest.approx(
        [0.010, 0.005, 0.005, 0.002])
    assert split["in_gc_s"] == pytest.approx({"gc.gen0": 0.001,
                                              "gc.gen2": 0.008})
    assert (split["steps"], split["tasks"], split["flux_tasks"]) == (2, 3, 1)
    got = P.numbers(spans, split)
    assert got == pytest.approx({
        "forward_ms": 5.0, "backward_ms": 9.5, "update_ms": 2.0,
        "step_idle_ms": 3.0, "runtime_idle_ms": 6.0,
        "payload_idle_ms": 10.0 / 3})
    assert P.steps_outside_flux(spans) == 0


def test_fanout_split_by_hand():
    """Two scoring tasks, the second past the window's end (clipped)."""
    spans = [span("payload", 0, 41, thread="dragon_0", stage="inference",
                  backend="dragon"),
             span("payload", 43, 120, thread="dragon_0", stage="inference",
                  backend="dragon")]
    busy = [(0, 40 * MS), (42 * MS, 90 * MS)]
    split = P.idle_split(busy, 0, 100 * MS, spans, to_wall)
    assert split["idle_s"] == pytest.approx(0.012)
    assert split["in_step_s"] == 0
    assert split["in_payload_s"] == pytest.approx(0.011)
    assert split["runtime_s"] == pytest.approx(0.001)
    assert P.numbers(spans, split) == pytest.approx(
        {"payload_idle_ms": 5.5, "runtime_idle_ms": 0.5})


@pytest.mark.parametrize("cell", ["campaign", "fanout", "none"])
def test_parts_add_up_to_the_idle_share(cell):
    busy, spans = campaign()
    if cell == "fanout":
        spans = [s for s in spans if s.name == "payload"]
    elif cell == "none":
        spans = []
    lo, hi = 3 * MS, 97 * MS
    split = P.idle_split(busy, lo, hi, spans, to_wall)
    busy_ns = sum(min(e, hi) - max(s, lo) for s, e in busy
                  if min(e, hi) > max(s, lo))
    idle = (1 - busy_ns / (hi - lo)) * (hi - lo) / 1e9
    assert (split["in_step_s"] + split["in_payload_s"] + split["runtime_s"]
            == pytest.approx(idle, rel=1e-12))


def test_collections_pair_each_start_with_its_stop():
    events = [("stop", 0, 1), ("start", 2, 10), ("stop", 2, 30),
              ("start", 0, 40), ("stop", 0, 41), ("start", 1, 50)]
    assert P.collections(events) == [("gc.gen2", 10, 30),
                                     ("gc.gen0", 40, 41)]


def test_intervals():
    a = [(0, 10), (20, 30)]
    b = [(5, 22), (25, 26), (40, 50)]
    assert P.overlap(a, b) == 5 + 2 + 1
    assert P.subtract(a, b) == [(0, 5), (22, 25), (26, 30)]
    assert P.subtract(a, []) == a and P.subtract([], b) == []


def test_a_step_outside_its_flux_task_is_counted():
    busy, spans = campaign()
    spans.append(span("step", 80, 90, thread="flux_0"))
    assert P.steps_outside_flux(spans) == 1


def test_open_spans_and_no_pairs_are_left_out():
    spans = [span("step", 0, 10),
             Span("step", "flux_0", 20 * MS, None, None, {}, None),
             span("step.forward", 1, 2, parent=0)]
    split = P.idle_split([], 0, 30 * MS, spans, to_wall)
    assert split["steps"] == 1
    assert P.numbers(spans, split) == pytest.approx({"step_idle_ms": 10.0})
