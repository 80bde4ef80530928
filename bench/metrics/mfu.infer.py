"""Forward model FLOPs of the window's inference tasks over the window and
the card's bf16 peak (989 TFLOP/s), in percent: 2 N T plus the causal
attention term (``bench/counts.py``, the model's counts from its reference
module)."""
from bench import counts


def read(run):
    flops = sum(counts.forward_flops(run.ref, run.m, *t["shape"])
                for t in run.tasks if t["stage"] == "inference"
                and "shape" in t)
    if not flops:
        return None
    return 100.0 * flops / run.window_s / counts.PEAK_FLOPS["bfloat16"]
