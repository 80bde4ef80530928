"""Model FLOPs of the window's training steps over the window and the
card's bf16 peak (989 TFLOP/s), in percent: 6 N T plus three times the
causal attention forward, recomputation not counted (``bench/counts.py``,
the model's counts from its reference module)."""
from bench import counts


def read(run):
    steps = run.work.get("train_steps")
    if not steps:
        return None
    flops = sum(counts.train_flops(run.ref, run.m, b, s) for b, s in steps)
    return 100.0 * flops / run.window_s / counts.PEAK_FLOPS["bfloat16"]
