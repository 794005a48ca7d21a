"""The device's idle time (the window less the union of its operations'
intervals) that lies inside the trainer's `trainer.epoch` ranges and
outside every `train_step:` range, over the profiled window: the idle of
the epoch's boundary (sampling, epoch hooks, the wait for the loss).

Idle inside a set X of ranges is |X u busy| - |busy|, so the idle inside
the epochs and outside the steps is |E u S u busy| - |S u busy|."""

from harness.trace import _merged, busy_intervals


def _length(spans) -> float:
    return sum(e - s for s, e in _merged(spans))


def read(ctx):
    trace = ctx["trace"]
    w = trace.window_s
    epochs = [(max(s, 0.0), min(e, w)) for _, s, e, _ in trace.ranges("trainer.epoch")]
    if not epochs:
        return None
    steps = [(max(s, 0.0), min(e, w)) for _, s, e, _ in trace.ranges("train_step:")]
    busy = busy_intervals(trace)
    return 100.0 * (_length(epochs + steps + busy) - _length(steps + busy)) / w
