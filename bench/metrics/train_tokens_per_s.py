"""Tokens of every training step of the window's rounds, over the window
(which ends when the last round begun inside it is done)."""


def read(run):
    tokens = sum(t["tokens"] for t in run.tasks if t["stage"] == "sst_train")
    return tokens / run.window_s if tokens else None
