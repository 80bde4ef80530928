"""Median, over the window's inference tasks, of their dispatch: from
SCHEDULING to QUEUED in the task's state history (the scheduler's hold
and the agent's dispatch of ``observability/lifecycle.py``, which tile
that span). Milliseconds."""
import numpy as np


def read(run):
    d = [t["t"]["QUEUED"] - t["t"]["SCHEDULING"] for t in run.tasks
         if t["stage"] == "inference"]
    return 1e3 * float(np.median(d)) if d else None
