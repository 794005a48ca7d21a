"""The mean host time of the trainer's own `train_step:<phase>` ranges in
the profiled window: a replay's launch and the trainer's bookkeeping."""


def read(ctx):
    ranges = ctx["trace"].ranges(ctx.get("step_prefix", "train_step:"))
    if not ranges:
        return None
    return 1e3 * sum(e - s for _, s, e, _ in ranges) / len(ranges)
