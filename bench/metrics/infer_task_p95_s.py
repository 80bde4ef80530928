"""95th percentile, over every inference task of the window, of the
seconds from its submission (SCHEDULING) to DONE in the runtime's own
state history."""
import numpy as np


def read(run):
    spans = [t["t"]["DONE"] - t["t"]["SCHEDULING"] for t in run.tasks
             if t["stage"] == "inference"]
    return float(np.percentile(spans, 95)) if spans else None
