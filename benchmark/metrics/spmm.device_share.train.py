"""The device's busy time (the union of the intervals) of the program's
sparse-product kernels, the operations whose name holds `segment_spmm`
(the dedup layout's `sum_parts` pass among them), over the device's busy
time in the profiled window of training."""

from harness.trace import Trace, busy_s

KERNEL = "segment_spmm"


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "train" or trace is None:
        return None
    busy = busy_s(trace)
    spmm = [op for op in trace.device if KERNEL in op[0]]
    if not busy or not spmm:
        return None
    return 100.0 * busy_s(Trace(trace.window_s, spmm, [])) / busy
