"""The device's idle time (the window less the union of its operations'
intervals) that lies inside the trainer's `train_step:` ranges, over the
profiled window: the idle while a step is launched (a replay's launch,
the trainer's bookkeeping).

Idle inside a set S of ranges is |S u busy| - |busy|."""

from harness.trace import _merged, busy_intervals


def _length(spans) -> float:
    return sum(e - s for s, e in _merged(spans))


def read(ctx):
    trace = ctx["trace"]
    steps = [(max(s, 0.0), min(e, trace.window_s)) for _, s, e, _ in trace.ranges("train_step:")]
    if not steps:
        return None
    busy = busy_intervals(trace)
    return 100.0 * (_length(steps + busy) - _length(busy)) / trace.window_s
