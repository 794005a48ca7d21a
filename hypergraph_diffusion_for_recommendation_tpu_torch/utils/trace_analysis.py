"""Measured (trace-derived) roofline numbers from a torch.profiler
capture — the port of the JAX package's `utils/trace_analysis.py`.

The JAX module reads an xplane trace: per-program device time from its
"XLA Modules" line and per-op durations and bytes from its "XLA Ops"
line. Here the trace is the Chrome-trace JSON that `torch.profiler`
writes (`Trainer.profile_epoch`, train/trainer.py), and a "program" is a
`record_function` annotation (the trainer's is `STEP_ANNOTATION` and its
phase). Its device operations are the kernel, memcpy and memset events
whose launching runtime call (`cudaLaunchKernel`, `cudaMemcpyAsync`, ...)
lies inside one of the annotation's ranges on the same thread, matched
through `args.correlation`; a replayed CUDA graph's kernels carry the
correlation of its `cudaGraphLaunch` call. An execution is one range of
the annotation. The names:

    JAX                          port
    newest_xplane                newest_trace (the newest *.pt.trace.json)
    XLA module                   annotation
    OpStat, ProgramStats         same fields
    device_program_stats,        same names; `trace_roofline` returns the
    main_program, trace_roofline same keys

A torch trace holds no per-op FLOPs or bytes (only a copy's or fill's
bytes). So `trace_roofline` takes the work of one execution from
`utils.profiling.cost_analysis` of the same step (`cost=`: its FLOPs,
and its dispatch-counted bytes as `xla_bytes_per_exec`), plus
`extra_bytes_per_exec` for the port's CUDA kernels, which the dispatcher
does not see, as the JAX caller adds the Pallas kernels' bytes.

The profiler now and then loses kernel events: the counts here are what
the trace holds, and the caller decides what a short count means.

Usage:
    tr.profile_epoch(d, epoch)
    stats = trace_roofline(d, extra_bytes_per_exec=..., cost=cost_analysis(step))
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field

from .spans import EPOCH

# device events (Chrome-trace categories) and the host calls that launch them
_DEVICE_CATEGORIES = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the port's own CUDA kernels (csrc/): the counterpart of XLA's custom calls
CUSTOM_KERNELS = ("segment_spmm", "resident_row_gather", "fused_window_spmm",
                  "dequantise_kernel", "column_amax_kernel", "quantise_kernel")


@dataclass
class OpStat:
    name: str
    category: str
    dur_s: float = 0.0
    bytes: int = 0
    flops: int = 0
    count: int = 0
    is_async: bool = False


@dataclass
class ProgramStats:
    program_id: str
    n_executions: int = 0
    module_dur_s: float = 0.0  # sum over executions of the device span (first op start to last op end)
    ops_dur_s: float = 0.0  # sum of the device ops' durations on the main stream
    bytes: int = 0  # the copies' and fills' bytes, summed over executions
    flops: int = 0
    ops: dict = field(default_factory=dict)  # name -> OpStat


def newest_trace(trace_dir: str) -> str:
    files = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"), recursive=True)
    if not files:
        raise FileNotFoundError(f"no .pt.trace.json under {trace_dir}")
    return max(files, key=os.path.getmtime)


def _load_events(path: str) -> list[dict]:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X"]


def _category(ev: dict) -> str:
    cat = _DEVICE_CATEGORIES[ev["cat"]]
    if cat == "kernel" and any(k in ev["name"] for k in CUSTOM_KERNELS):
        return "custom-call"
    return cat


def device_program_stats(trace_dir: str) -> dict[str, ProgramStats]:
    """Aggregate the trace's device events per annotation.

    Returns {annotation name: ProgramStats} with per-op sums over all
    executions in the capture. A device op belongs to every annotation
    range that holds its launching call (nested annotations each count
    it). Ops on a stream other than the program's busiest one are
    `is_async`: their bytes count, their time does not add to
    `ops_dur_s`."""
    events = _load_events(newest_trace(trace_dir))
    annotations = [e for e in events if e.get("cat") == "user_annotation"]
    launches: dict[int, dict] = {}
    device: dict[int, list[dict]] = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if e.get("cat") in _LAUNCH_CATEGORIES:
            launches[corr] = e
        elif e.get("cat") in _DEVICE_CATEGORIES:
            device.setdefault(corr, []).append(e)
    # launching calls by thread, in time order
    by_thread: dict[tuple, list[tuple[float, int]]] = {}
    for corr, e in launches.items():
        if corr in device:
            by_thread.setdefault((e["pid"], e["tid"]), []).append((float(e["ts"]), corr))
    for calls in by_thread.values():
        calls.sort()

    out: dict[str, ProgramStats] = {}
    executions: dict[str, list[list[dict]]] = {}
    for a in annotations:
        ps = out.setdefault(a["name"], ProgramStats(program_id=a["name"]))
        ps.n_executions += 1
        t0 = float(a["ts"])
        t1 = t0 + float(a["dur"])
        ops = [d for ts, corr in by_thread.get((a["pid"], a["tid"]), ())
               if t0 <= ts <= t1 for d in device[corr]]
        executions.setdefault(a["name"], []).append(ops)
    for name, runs in executions.items():
        ps = out[name]
        stream_time: dict = {}
        for ops in runs:
            for d in ops:
                s = (d.get("args") or {}).get("stream")
                stream_time[s] = stream_time.get(s, 0.0) + float(d["dur"])
        main_stream = max(stream_time, key=stream_time.get) if stream_time else None
        for ops in runs:
            if ops:
                start = min(float(d["ts"]) for d in ops)
                end = max(float(d["ts"]) + float(d["dur"]) for d in ops)
                ps.module_dur_s += (end - start) / 1e6
            for d in ops:
                args = d.get("args") or {}
                is_async = args.get("stream") != main_stream
                op = ps.ops.setdefault(d["name"], OpStat(name=d["name"], category=_category(d),
                                                         is_async=is_async))
                dur = float(d["dur"]) / 1e6
                byt = int(args.get("bytes", 0) or 0)
                op.dur_s += dur
                op.bytes += byt
                op.count += 1
                if not is_async:
                    ps.ops_dur_s += dur
                ps.bytes += byt
    return out


def main_program(stats: dict[str, ProgramStats]) -> ProgramStats:
    """The dominant program in the capture = the one with the largest
    total device span (the training step under `profile_epoch`). The
    trainer's epoch range (`utils.spans.EPOCH`) holds every step of the
    epoch, so it is no program."""
    programs = [p for name, p in stats.items() if name != EPOCH]
    if not programs:
        raise ValueError("no annotated programs in trace")
    return max(programs, key=lambda p: p.module_dur_s)


def trace_roofline(trace_dir: str, top_k: int = 8, extra_bytes_per_exec: float = 0.0,
                   cost=None, program: str | None = None) -> dict:
    """Measured roofline of the dominant traced program (or `program`).

    Returns per-EXECUTION device seconds (the ops' summed device time, as
    `bench.timing.device_ms` sums it; `module_dur_s` keeps the spans), the
    GB/s and MFU of the work of one execution over that time, and the top
    ops by device time. The work: `cost` (`utils.profiling.cost_analysis`
    of one execution: its "flops" and "bytes accessed") plus
    `extra_bytes_per_exec` for the port's CUDA kernels, whose bytes the
    dispatcher does not see; their bandwidth (those bytes over the
    kernels' measured time) is `pallas_gbps`, under the JAX key."""
    from .profiling import roofline

    stats = device_program_stats(trace_dir)
    ps = stats[program] if program is not None else main_program(stats)
    n = max(ps.n_executions, 1)
    per_exec_s = ps.ops_dur_s / n
    cost = cost or {}
    xla_bytes = float(cost.get("bytes accessed", 0.0))
    flops = float(cost.get("flops", 0.0))
    bytes_per_exec = xla_bytes + extra_bytes_per_exec
    r = roofline(flops, bytes_per_exec, per_exec_s)
    sync_ops = [o for o in ps.ops.values() if not o.is_async]
    cc_s = sum(o.dur_s for o in sync_ops if o.category == "custom-call") / n
    top = sorted(sync_ops, key=lambda o: -o.dur_s)[:top_k]
    return {
        "program_id": ps.program_id,
        "n_executions": ps.n_executions,
        "device_s_per_exec": per_exec_s,
        "measured_gbps": r["achieved_gbps"],
        "measured_hbm_util": r["hbm_util"],
        "measured_tflops": r["achieved_tflops"],
        "measured_mfu": r["mfu"],
        "bytes_per_exec": bytes_per_exec,
        "xla_bytes_per_exec": xla_bytes,
        "extra_bytes_per_exec": extra_bytes_per_exec,
        "flops_per_exec": flops,
        "custom_call_s_per_exec": cc_s,
        "pallas_gbps": (extra_bytes_per_exec / cc_s) / 1e9 if cc_s > 0 else None,
        # the main stream's ops cover this share of the executions' device spans (the rest:
        # gaps between launches)
        "op_time_coverage": ps.ops_dur_s / max(ps.module_dur_s, 1e-12),
        "top_ops": [
            {
                "name": o.name[:60],
                "category": o.category,
                "dur_ms_per_exec": o.dur_s * 1e3 / n,
                "gbps": (o.bytes / max(o.dur_s, 1e-12)) / 1e9,
                "share": o.dur_s / max(ps.module_dur_s, 1e-12),
            }
            for o in top
        ],
    }
