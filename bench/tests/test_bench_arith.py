"""The readers' arithmetic over every task of a window, on made-up runs:
rates over the whole window, the tail over all tasks, the runtime's share,
and the device's idle share and gaps from a made-up trace."""
import numpy as np
import pytest

from bench import harness
from bench.reference import dense_lm
from bench.trace import DeviceTrace, Spans, gaps, merge

M = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
     "head_dim": 16, "d_ff": 128, "vocab_size": 256, "dtype": "bfloat16"}


def infer_task(i, submit, done, L=64):
    return {"stage": "inference", "index": i, "tokens": 128,
            "shape": (128 // L, L), "body_s": 0.01,
            "t": {"SCHEDULING": submit, "QUEUED": submit + 0.002 * (i % 3),
                  "RUNNING": submit + 0.01, "DONE": done}}


def run_of(tasks, window_s, trace=None, steps=(), traffic=None, work=None):
    return harness.Run(workload="x", m=M, ref=dense_lm,
                       traffic=traffic or {},
                       setup_s=12.5, window_s=window_s, tasks=tasks,
                       steps=list(steps), work=work or {}, trace=trace,
                       spans=Spans())


def test_rate_and_tail_over_every_task():
    rng = np.random.default_rng(0)
    lat = rng.exponential(0.2, size=200)
    tasks = [infer_task(i, i * 0.05, i * 0.05 + lat[i]) for i in range(200)]
    run = run_of(tasks, window_s=10.7)
    assert harness.read_metric("scored_tokens_per_s", run) == \
        pytest.approx(200 * 128 / 10.7)
    assert harness.read_metric("infer_task_p95_s", run) == \
        pytest.approx(np.percentile(lat, 95))
    assert harness.read_metric("dispatch_ms.infer", run) == \
        pytest.approx(1e3 * np.median([0.002 * (i % 3) for i in range(200)]))
    assert harness.read_metric("setup_s", run) == 12.5
    from bench import counts
    assert harness.read_metric("mfu.infer", run) == pytest.approx(
        100 * 200 * counts.forward_flops(dense_lm, M, 2, 64) / 10.7 / 989e12)
    # no inference task: nothing to read
    assert harness.read_metric("scored_tokens_per_s", run_of([], 1.0)) is None


def test_training_rate_cost_and_mfu():
    tasks = [{"stage": "sst_train", "tokens": 4 * 8 * 1024, "body_s": 4.0,
              "t": {"RUNNING": 10.0 * r, "DONE": 10.0 * r + 4.0 + 1e-3 * r}}
             for r in range(1, 4)] + [infer_task(0, 0.0, 0.1)]
    run = run_of(tasks, 13.0, steps=[1.0, 1.1, 1.2, 0.9],
                 work={"train_steps": [(8, 1024)] * 12})
    assert harness.read_metric("train_tokens_per_s", run) == \
        pytest.approx(3 * 4 * 8 * 1024 / 13.0)
    assert harness.read_metric("runtime_cost_ms.train", run) == \
        pytest.approx(2.0)
    assert harness.read_metric("step_s.train", run) == pytest.approx(1.05)
    from bench import counts
    assert harness.read_metric("mfu.train", run) == pytest.approx(
        100 * 12 * counts.train_flops(dense_lm, M, 8, 1024) / 13.0 / 989e12)


def made_up_trace():
    t = DeviceTrace()
    t.lo, t.hi = 1_000, 11_000
    t._anchor = (0, 1_000)            # perf_counter 0 is wall 1,000
    t.kernels = [("flash_fwd_wgmma<80, 80>", 1_500, 2_500),
                 ("gemm", 2_000, 4_000), ("flash_fwd_wgmma<80, 80>",
                                          6_000, 7_000),
                 ("gemm", 10_500, 12_000)]
    return t


def test_merge_and_gaps():
    assert merge([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]
    assert gaps([(1, 4), (5, 8)], 0, 10) == [(0, 1), (4, 5), (8, 10)]


def test_device_idle_and_gaps_named_by_spans():
    t = made_up_trace()
    # busy: 1,500-4,000, 6,000-7,000, 10,500-11,000 = 4,000 of 10,000 ns
    assert t.busy_s() == pytest.approx(4e-6)
    run = run_of([], 1.0, trace=t)
    assert harness.read_metric("device_idle.infer", run) == \
        pytest.approx(60.0)
    spans = Spans()
    spans.items = [("loop.wait", 3_000, 9_000), ("infer.forward", 4_000, 5_500)]
    got = t.idle_gaps(spans)
    # gaps 7,000-10,500 (middle in loop.wait), 4,000-6,000 (middle 5,000
    # in infer.forward, the innermost), 1,000-1,500 (no span)
    assert got == [["loop.wait", 3.5e-6], ["infer.forward", 2e-6],
                   ["host-other", 5e-7]]
    assert t.top_ops()[0] == ["gemm", pytest.approx(3.5e-6)]


def test_flash_roofline_reads_only_a_whole_count():
    from bench import counts
    t = made_up_trace()
    shapes = [(2, 64), (2, 64)]
    run = run_of([], 1.0, trace=t, work={"flash_fwd": shapes})
    one = counts.bound_s(*counts.flash_fwd_work(2, 64, 4, 4, 16))
    assert harness.read_metric("flash_roofline.infer", run) == \
        pytest.approx(100 * 2 * one / 2e-6)
    run.work["flash_fwd"] = shapes * 2          # the trace missed half
    assert harness.read_metric("flash_roofline.infer", run) is None
    run.work["flash_fwd"] = shapes[:1]          # more launches than made
    assert harness.read_metric("flash_roofline.infer", run) is None
    t.kernels += [("flash_fwd_wgmma<80, 80>", 8_000, 8_500)] * 197
    run.work["flash_fwd"] = [(2, 64)] * 200     # one of 200 dropped
    assert harness.read_metric("flash_roofline.infer", run) == \
        pytest.approx(100 * 200 * one / ((2e-6 + 197 * 5e-7) * 200 / 199))
    run.trace = None
    assert harness.read_metric("flash_roofline.train", run) is None
