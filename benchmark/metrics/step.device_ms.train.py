"""The device's busy time in the profiled window (the union of its
operations' intervals) over the training steps run there."""

from harness.trace import busy_s


def read(ctx):
    if not ctx.get("units"):
        return None
    return 1e3 * busy_s(ctx["trace"]) / ctx["units"]
