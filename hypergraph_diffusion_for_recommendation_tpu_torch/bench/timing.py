"""Device timers for the card: torch.profiler's device time, and CUDA
events around a call. Both need a CUDA card; nothing here falls back to
a host clock."""

from __future__ import annotations

import statistics
import time


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


def device_ms(fn, iters: int = 20, attempts: int = 10,
              log=print) -> tuple[float, dict[str, float]]:
    """Device time per call of `fn` in ms, summed over every kernel, copy
    and fill it runs (torch.profiler's CUPTI trace, the mean of `iters`
    calls after one warm call), and the same split by kernel name. Host
    launch gaps are left out: `cuda_ms` keeps them. A trace that comes
    back without device events (it happens now and then, two in a row
    seen) is taken again after a pause; after `attempts` such traces this
    raises, so that every device time has this one definition."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        total = sum(by_name.values())
        if total > 0:
            return total, by_name
        log(f"[timer] trace {attempt} of {attempts} recorded no device time")
        time.sleep(0.2)
    raise RuntimeError(f"torch.profiler recorded no device time in {attempts} traces")
