"""Shared by the flash-attention roofline readers."""
from bench import counts

KERNEL = "flash_fwd"
# the profiler may drop a few of a long window's launches: a trace that
# holds at least this share of the window's launches is read, its device
# time taken per launch
MIN_SEEN = 0.99


def flash_roofline(run):
    """The flash forward launches' least time (``counts.bound_s`` of each
    launch's shape) over their device time in the trace, in percent; where
    the trace dropped a few launches, over the mean time of those it holds
    times the window's launches. None without a trace, or where it holds
    more launches than the window made or too few."""
    if run.trace is None or not run.work.get("flash_fwd"):
        return None
    seconds, seen = run.trace.device_time(KERNEL)
    shapes = run.work["flash_fwd"]
    if seconds <= 0 or not MIN_SEEN * len(shapes) <= seen <= len(shapes):
        return None
    m = run.m
    bound = sum(counts.bound_s(*counts.flash_fwd_work(
        b, s, m["num_heads"], m["num_kv_heads"], m["head_dim"], m["dtype"]),
        m["dtype"]) for b, s in shapes)
    return 100.0 * bound / (seconds * len(shapes) / seen)
