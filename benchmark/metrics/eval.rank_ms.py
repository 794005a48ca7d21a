"""The device's busy time of the operations that each pass's ranking
(`Trainer.evaluate()` with the encode cached: the scoring, the masked
top-k and the metrics) launched, the mean over the profiled passes."""

from harness.trace import launched_busy_s


def read(ctx):
    if not ctx.get("rank_span"):
        return None
    times = launched_busy_s(ctx["trace"], ctx["rank_span"])
    return 1e3 * sum(times) / len(times) if times else None
