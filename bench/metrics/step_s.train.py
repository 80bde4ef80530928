"""Median seconds of a training step inside the Flux task, the device's
work synchronised (forward, backward and the AdamW update)."""
import numpy as np


def read(run):
    return float(np.median(run.steps)) if run.steps else None
