"""The device's busy time of the operations that each pass's encode
(`Trainer.encode()` after a restore, so the encode runs) launched, the
mean over the profiled passes."""

from harness.trace import launched_busy_s


def read(ctx):
    if not ctx.get("encode_span"):
        return None
    times = launched_busy_s(ctx["trace"], ctx["encode_span"])
    return 1e3 * sum(times) / len(times) if times else None
