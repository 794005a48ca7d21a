"""The device's busy time of the operations that the program's own
`eval.topk` ranges launched (each block's masked top-k: the mask and the
sort), wherever they ran, summed, over the profiled passes."""

from harness.trace import launched_busy_s


def read(ctx):
    times = launched_busy_s(ctx["trace"], "eval.topk")
    if not times or not ctx.get("units"):
        return None
    return 1e3 * sum(times) / ctx["units"]
