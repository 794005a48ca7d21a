"""CUDA events around a call. It needs a CUDA card; nothing here falls
back to a host clock.

A frozen copy of `cuda_ms` from the port's `bench/timing.py`, so that
later changes to the program leave the yardstick as it is. The profiler's
device time is read by `trace.py`, which takes a window again when the
profiler lost a unit's work, as the port's `device_profile` does."""

from __future__ import annotations

import statistics


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of one call of `fn` in ms between two CUDA events: the
    device's time for the call plus any gap the host leaves while it
    launches. The L2 stays warm between calls."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
