"""Seconds from the start of the process to the start of the window:
imports, the kernels' build or load, weights, the runtime's start and the
warm-up, as the host's clock reads them."""


def read(run):
    return run.setup_s
