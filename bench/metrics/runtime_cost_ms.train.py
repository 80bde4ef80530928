"""Median, over the window's Flux training tasks, of the runtime's time
around the payload: RUNNING to DONE in the task's state history less the
payload's own body, timed by the benchmark's wrapper (its device work
synchronised). Milliseconds."""
import numpy as np


def read(run):
    cost = [t["t"]["DONE"] - t["t"]["RUNNING"] - t["body_s"]
            for t in run.tasks if t["stage"] == "sst_train"]
    return 1e3 * float(np.median(cost)) if cost else None
