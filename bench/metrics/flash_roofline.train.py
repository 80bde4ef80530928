"""The causal flash-attention forward kernel's share of its roofline over
the window's launches: the sum of each launch's least time (the larger of
its bytes over 3.35 TB/s and its operations over 989 TFLOP/s, from its
shape) over the launches' device time in the profiler's trace."""
from bench.metrics._roofline import flash_roofline


def read(run):
    return flash_roofline(run)
