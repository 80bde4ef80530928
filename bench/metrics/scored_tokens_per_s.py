"""Tokens of every inference task of the window, over the window (which
ends when the last task begun inside it is done)."""


def read(run):
    tokens = sum(t["tokens"] for t in run.tasks if t["stage"] == "inference")
    return tokens / run.window_s if tokens else None
