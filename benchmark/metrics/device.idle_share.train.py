"""1 - the device's busy time (the union of its operations' intervals)
over the profiled window's wall time, in training."""

from harness.trace import busy_s


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return 100.0 * (1.0 - busy_s(ctx["trace"]) / ctx["trace"].window_s)
