"""One run of one cell: set-up, the window (or the profiled window of a
`--trace 1` run), the device's peak memory, then, with the program's state
freed, the reference's check. Returns the result line's fields.

The cell's traffic names its loop (`loops/<loop>.py`), which makes the
weights, sets the program up for the window, runs the window or the
profiled window, and checks what the program produced against the
reference; nothing here knows one loop from another.

`setup_s` runs from the process's start to the first timed operation: the
imports, the data, the program's device data and model (and, in a
checkout's first run, the kernels' build), the benchmark's weights, the
trainer and its first steps (which capture its step graph) or its first
pass (which captures its encode graph).

Controls (`control`): "program_env" builds the program with the
configuration's `control.env` set (the program's own lower-precision
path); any other is one of the loop's `CONTROLS`, which it puts in the
program's place: the reference at `control.precision`, or the reference
with a fault planted. Each must come out not correct.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import program, spec, timing
from .costs import OPERAND_BYTES, PEAKS, products_bound_s, products_cost
from .trace import breakdown, busy_s

SPMM_ROUNDS, SPMM_ITERS = 7, 20


@dataclass
class Run:
    cell: spec.Cell
    seed: int
    device: torch.device
    log: object
    precision: str
    ref: object = None
    counts: object = None
    graph: object = None
    sizes: dict = None
    gen: torch.Generator = None
    weights: dict = None
    latent: dict = None  # the generator's planted structure, by raw id
    bundle: object = None
    device_name: str = ""


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, log,
             t_start: float, control: str | None = None, precision: str | None = None) -> dict:
    """The result of one run (`correct`, `attempted`, `failed`, `metrics`,
    `device`, [`breakdown`], `checks`). `precision` overrides the
    configuration's sparse precision (a CPU run of the program has no
    bf16 products)."""
    device = torch.device(device)
    cfg = cell.config
    run = Run(cell, seed, device, log, precision or cfg["precision"]["sparse"])
    run.ref = spec.model_module("reference", cfg)
    run.counts = spec.model_module("counts", cfg)
    run.device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    generator = importlib.import_module("generators." + cfg["data"]["generator"])
    loops = spec.loop(cell.traffic["loop"])

    stamp = _stamps(log, t_start)
    stamp("imports")
    train, test, kg, run.latent = generator.generate(cfg["data"], seed, device)
    stamp("data generated")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.graph = run.ref.derive(train, test, kg)
    run.sizes = run.ref.sizes(run.graph, cfg["settings"])
    run.gen = torch.Generator(device).manual_seed(seed)
    loop = loops.Loop(run, cell.traffic)
    run.weights = loop.weights()
    log(f"[data] {run.sizes['n_users']} users, {run.sizes['n_items']} items, "
        f"{run.sizes['n_train']} training pairs, {len(test)} test pairs"
        + (f", {len(kg)} item-attribute triples" if kg is not None else ""))

    env = cfg["control"]["env"] if control == "program_env" else {}
    stamp("ids and weights")
    with _environ(env):
        run.bundle, _, inter = program.build(cfg, train, test, kg, device, log)
    stamp("program built")
    if not (np.array_equal(inter.id2user, run.graph.cf.user_raw)
            and np.array_equal(inter.id2item, run.graph.cf.item_raw)):
        raise RuntimeError("the program numbers users or items otherwise than by first appearance")
    program.load_weights(run.bundle, run.weights)
    loop.setup()
    sync(device)
    stamp("trainer set up")
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s")

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": _device(device, cell.chips)}
    if trace:
        tr, ctx = loop.traced(min(seconds, cell.traffic["trace_seconds"]))
        ctx.update(trace=tr, kind=loops.KIND, peak_flops=None)
        result["device"].update(busy_s=busy_s(tr), window_s=tr.window_s)
        result["breakdown"] = breakdown(tr)
    else:
        result["metrics"] = {k: {"value": v, "unit": _unit(cell, k)}
                             for k, v in loop.window(seconds).items()}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    result["attempted"] = loop.attempted
    if device.type == "cuda":
        result["device"]["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        result["device"]["power_limit"] = _power_limit()
    run.ref.attach(run.graph, device)
    run.sizes = run.ref.sizes(run.graph, cfg["settings"])
    if trace:
        ctx["spmm"] = spmm_timing(run, loops.BACKWARD) if device.type == "cuda" else None
    loop.collect()
    run.bundle = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, after the window, with the program's state freed
    limits = cfg["limits"][loops.KIND]
    flops = {} if trace else None
    values, failed = loop.check(limits, None if control == "program_env" else control, flops)
    checks = {k: {"value": values[k], "limit": v} for k, v in limits.items()}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["failed"] = int(failed)
    if trace:
        ctx.update(_work(run, loop, loops.BACKWARD, flops))
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    result["checks"] = checks
    return result


def _unit(cell: spec.Cell, name: str) -> str:
    return next(m["unit"] for m in cell.end_to_end if m["name"] == name)


def _device(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": 0}


@contextlib.contextmanager
def _environ(env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def counting(flops: dict | None):
    """A FLOP counter into `flops['mode']`, or nothing where `flops` is None."""
    if flops is None:
        return contextlib.nullcontext()
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    flops["mode"] = mode
    return mode


def _stamps(log, t_start: float):
    """A logger of the seconds since the process started, by phase."""
    last = [t_start]

    def stamp(what: str) -> None:
        now = time.perf_counter()
        log(f"[setup] {what}: {now - last[0]:.3f} s (at {now - t_start:.3f} s)")
        last[0] = now

    return stamp


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read: {exc}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"not read: rc {out.returncode}"


def _work(run: Run, loop, backward: bool, flops: dict) -> dict:
    """The FLOPs of one unit of the window (a step, a pass), as the loop adds
    them up from the dense ones counted on the reference and the sparse
    products' from the shapes (with their backward), and the card's peak at
    the configuration's matmul precision."""
    s, counts = run.sizes, run.counts
    dense = flops["mode"].get_total_flops() if "mode" in flops else 0
    sparse = products_cost(counts.products(s), counts.width(s), OPERAND_BYTES[run.precision],
                           backward)[0] + counts.other_sparse_flops(s, backward)
    peaks = PEAKS.get(run.device_name)
    return {"unit_flops": float(loop.unit_flops(dense, sparse)),
            "peak_flops": peaks[run.cell.config["precision"]["matmul"]] if peaks else None}


def spmm_timing(run: Run, backward: bool) -> dict:
    """The public `spmm_pair` on each adjacency a step (with `backward`) or
    an encode multiplies, at the configuration's width: one of each,
    captured as a CUDA graph so that the host's launches do not set the
    time, replayed `SPMM_ITERS` times in each of `SPMM_ROUNDS` rounds
    between CUDA events; the median round's time of one, and the sum of
    their bounds."""
    fn_pair = program.spmm_pair()
    prods = run.counts.products(run.sizes)
    d = run.counts.width(run.sizes)
    calls = []
    gen = torch.Generator(run.device).manual_seed(run.seed + 7)
    for adj, direction, rows, cols, nnz, _ in prods:
        part, field = run.counts.ADJACENCIES[adj]
        pair = getattr(getattr(run.bundle, part), field)
        a, a_t = (pair.fwd, pair.bwd) if direction == "fwd" else (pair.bwd, pair.fwd)
        if (a.nrows, a.ncols, a.nnz) != (rows, cols, nnz):
            raise RuntimeError(f"{adj}.{direction}: the program's {a.nrows}x{a.ncols} with {a.nnz} "
                               f"entries, the count's {rows}x{cols} with {nnz}")
        x = torch.randn(cols, d, generator=gen, device=run.device).requires_grad_(backward)
        g = torch.randn(rows, d, generator=gen, device=run.device)
        calls.append((a, a_t, x, g))

    def once():
        for a, a_t, x, g in calls:
            if backward:
                torch.autograd.grad(fn_pair(a, a_t, x), x, g)
            else:
                with torch.no_grad():
                    fn_pair(a, a_t, x)

    side = torch.cuda.Stream(run.device)
    side.wait_stream(torch.cuda.current_stream(run.device))
    with torch.cuda.stream(side):
        for _ in range(3):
            once()
    torch.cuda.current_stream(run.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        once()
    rounds = [timing.cuda_ms(graph.replay, iters=SPMM_ITERS, warmup=1)
              for _ in range(SPMM_ROUNDS)]
    run.log("[spmm] one of each product, ms a round: " + " ".join(f"{t!r}" for t in rounds))
    del graph
    peaks = PEAKS.get(run.device_name)
    once_each = [p[:5] + (1,) for p in prods]
    bound = products_bound_s(once_each, d, OPERAND_BYTES[run.precision], backward, peaks) \
        if peaks else None
    return {"time_s": sorted(rounds)[len(rounds) // 2] * 1e-3, "bound_s": bound}
