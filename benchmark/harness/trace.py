"""A profiled window, and what the per-layer readers read of it.

`profile_window` runs a function under torch.profiler (host and CUDA
activity) inside a `bench.window` range, writes the Chrome trace to a
temporary file, and reads it back into a `Trace`: the device's operations
(kernels, copies, fills) with the host time of the call that launched each,
and the host's ranges and calls. Times are seconds from the window's
start.

The profiler can lose device events (a trace of a replayed step graph has
come back one kernel short, and now and then with none): a window in which
a unit of work (a `train_step:` range, an evaluation pass) launched no
device operation is taken again, and after `attempts` such windows the
run fails, so that no metric is read from a trace that lost a unit's work.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    window_s: float
    # (name, start, end, launch): a device operation and the host time of
    # the runtime call that launched it (None when the trace lacks it)
    device: list
    # (name, start, end, category): host ranges (`user_annotation`) and calls
    host: list

    def ranges(self, prefix: str) -> list:
        """The host ranges whose name starts with `prefix`."""
        return [h for h in self.host if h[3] == "user_annotation" and h[0].startswith(prefix)]


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    window = [e for e in spans if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} '{WINDOW}' ranges, not 1")
    t0, t1 = float(window[0]["ts"]), float(window[0]["ts"]) + float(window[0]["dur"])
    sec = lambda us: (float(us) - t0) * 1e-6  # noqa: E731
    launch = {}
    for e in spans:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = sec(e["ts"])
    device = [(e["name"], sec(e["ts"]), sec(float(e["ts"]) + float(e["dur"])),
               launch.get(e.get("args", {}).get("correlation")))
              for e in spans if e.get("cat") in DEVICE_CATS]
    host = [(e["name"], sec(e["ts"]), sec(float(e["ts"]) + float(e["dur"])), e["cat"])
            for e in spans if e.get("cat") in HOST_CATS and e["name"] != WINDOW]
    return Trace(window_s=(t1 - t0) * 1e-6, device=device, host=host)


def _merged(spans) -> list:
    """Sorted disjoint (start, end) pairs covering `spans`."""
    merged = []
    for s, e in sorted(spans):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_intervals(trace: Trace) -> list:
    """The union of the device operations' intervals, clipped to the window,
    as sorted disjoint (start, end) pairs."""
    return _merged((max(s, 0.0), min(e, trace.window_s)) for _, s, e, _ in trace.device)


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def launched_busy_s(trace: Trace, prefix: str) -> list:
    """For each `prefix` range, the device's busy time (the union of the
    intervals) of the operations launched inside it, wherever they ran."""
    ops = sorted((l, s, e) for _, s, e, l in trace.device if l is not None)
    launches = [o[0] for o in ops]
    out = []
    for _, s, e, _ in trace.ranges(prefix):
        inside = ops[bisect.bisect_left(launches, s):bisect.bisect_right(launches, e)]
        out.append(sum(b - a for a, b in _merged((a, b) for _, a, b in inside)))
    return out


def units_without_device_work(trace: Trace, prefix: str) -> int:
    """How many `prefix` ranges launched no device operation."""
    launches = sorted(l for *_, l in trace.device if l is not None)
    empty = 0
    for _, s, e, _ in trace.ranges(prefix):
        k = bisect.bisect_left(launches, s)
        if k == len(launches) or launches[k] > e:
            empty += 1
    return empty


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the innermost host range or call that spans each."""
    by_name: dict[str, float] = {}
    for name, s, e, _ in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace)
    edges = [0.0] + [x for iv in busy for x in iv] + [trace.window_s]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [h for h in trace.host if h[1] <= mid <= h[2]]
        name = min(inside, key=lambda h: h[2] - h[1])[0] if inside else "(no host activity)"
        named.append([name, e - s])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def profile_window(fn, unit_prefix: str, attempts: int, log):
    """(Trace, fn's result) of `fn()` run under torch.profiler; retaken
    while a `unit_prefix` range holds no device work, and RuntimeError
    after `attempts` such windows (or windows without any device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                out = fn()
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = read_chrome_trace(path)
        finally:
            os.remove(path)
        units = len(trace.ranges(unit_prefix))
        empty = units_without_device_work(trace, unit_prefix)
        if units and not empty and busy_s(trace) > 0:
            return trace, out
        log(f"[trace] window {attempt} of {attempts}: {empty} of {units} '{unit_prefix}' "
            f"ranges without device work, {len(trace.device)} device events: taken again")
    raise RuntimeError(f"the profiler lost a unit's device work in {attempts} windows")
