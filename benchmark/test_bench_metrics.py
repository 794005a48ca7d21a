"""The per-layer readers and the trace reading, on small synthetic traces
whose numbers are worked out by hand."""

import json

import pytest

from harness import spec
from harness.trace import (
    Trace,
    breakdown,
    busy_s,
    read_chrome_trace,
    units_without_device_work,
)

EVAL_PASS, EVAL_ENCODE, EVAL_RANK = "bench.eval.pass", "bench.eval.encode", "bench.eval.rank"


def _trace():
    """A 1 s window: two train steps (host ranges 0.0-0.2 and 0.5-0.6), three
    kernels (0.1-0.3 and 0.25-0.4 overlapping, 0.7-0.8), launched at 0.05,
    0.1 and 0.55."""
    device = [("k1", 0.1, 0.3, 0.05), ("k2", 0.25, 0.4, 0.1), ("k1", 0.7, 0.8, 0.55)]
    host = [("train_step:cf", 0.0, 0.2, "user_annotation"),
            ("train_step:cf", 0.5, 0.6, "user_annotation"),
            ("aten::copy_", 0.45, 0.65, "cpu_op")]
    return Trace(window_s=1.0, device=device, host=host)


def _eval_trace():
    """Four passes of 0.25 s, each with an encode range of 0.05 s and a
    ranking range of 0.15 s; the encode launches one operation (0.04 s on
    the device, running past its range), the ranking two that overlap (0.11
    s of busy time)."""
    host, device = [], []
    for k in range(4):
        s = 0.25 * k
        host += [(EVAL_PASS, s, s + 0.25, "user_annotation"),
                 (EVAL_ENCODE, s, s + 0.05, "user_annotation"),
                 (EVAL_RANK, s + 0.05, s + 0.2, "user_annotation")]
        device += [("spmm", s + 0.02, s + 0.06, s + 0.01),
                   ("gemm", s + 0.07, s + 0.15, s + 0.06),
                   ("sort", s + 0.12, s + 0.18, s + 0.07)]
    return Trace(window_s=1.0, device=device, host=host)


def read(name, ctx):
    return spec.reader(name)(ctx)


def test_busy_time_is_the_union_of_device_intervals():
    assert busy_s(_trace()) == pytest.approx(0.3 + 0.1)
    bd = breakdown(_trace())
    assert bd["device_ops"][0] == ["k1", pytest.approx(0.3)]
    # 0.4 - 0.7, named by the innermost host span over its middle
    assert bd["idle_gaps"][0] == ["train_step:cf", pytest.approx(0.3)]
    assert [g[1] for g in bd["idle_gaps"]] == pytest.approx([0.3, 0.2, 0.1])


def test_train_readers():
    ctx = {"trace": _trace(), "units": 2, "kind": "train", "step_prefix": "train_step:",
           "unit_flops": 1e12, "peak_flops": 67e12, "spmm": {"bound_s": 0.001, "time_s": 0.004}}
    assert read("trainer.host_ms_per_step.train", ctx) == pytest.approx(150.0)
    assert read("step.device_ms.train", ctx) == pytest.approx(200.0)
    assert read("step.mfu.train", ctx) == pytest.approx(100 * 2e12 / 67e12)
    assert read("spmm.roofline.train", ctx) == pytest.approx(25.0)
    assert read("spmm.roofline.eval", ctx) is None
    assert read("device.idle_share.train", ctx) == pytest.approx(60.0)
    assert read("device.idle_share.eval", ctx) is None
    assert read("step.mfu.train", dict(ctx, peak_flops=None)) is None


def test_eval_readers():
    ctx = {"trace": _eval_trace(), "units": 4, "kind": "eval", "unit_flops": 67e9,
           "peak_flops": 67e12, "spmm": {"bound_s": 0.002, "time_s": 0.01},
           "pass_span": EVAL_PASS, "encode_span": EVAL_ENCODE, "rank_span": EVAL_RANK}
    assert read("eval.encode_ms", ctx) == pytest.approx(40.0)
    assert read("eval.rank_ms", ctx) == pytest.approx(110.0)
    assert read("eval.mfu", ctx) == pytest.approx(100 * 67e9 / 0.25 / 67e12)
    assert read("spmm.roofline.eval", ctx) == pytest.approx(20.0)
    assert read("device.idle_share.eval", ctx) == pytest.approx(40.0)
    assert read("eval.encode_ms", {"trace": _trace()}) is None
    assert read("eval.rank_ms", {"trace": _trace()}) is None
    assert read("eval.mfu", {"trace": _trace(), "peak_flops": 1.0, "unit_flops": 1.0}) is None


def test_a_unit_without_device_work_is_found():
    t = _trace()
    assert units_without_device_work(t, "train_step:") == 0
    lost = Trace(t.window_s, t.device[:2], t.host)  # the second step's kernel lost
    assert units_without_device_work(lost, "train_step:") == 1


def test_chrome_trace_reading(tmp_path):
    """Kernels tied to the runtime call that launched them by correlation id;
    times in seconds from the window's start; the window's own range and the
    device-side annotations left out."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 1000.0, "dur": 2e6},
        {"ph": "X", "cat": "user_annotation", "name": "train_step:cf", "ts": 1100.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1110.0, "dur": 5.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1200.0, "dur": 30.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 1300.0, "dur": 10.0,
         "args": {}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train_step:cf", "ts": 1200.0,
         "dur": 40.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1200.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = read_chrome_trace(str(path))
    assert t.window_s == pytest.approx(2.0)
    assert t.device == [("k", pytest.approx(200e-6), pytest.approx(230e-6), pytest.approx(110e-6)),
                        ("Memset", pytest.approx(300e-6), pytest.approx(310e-6), None)]
    assert [h[0] for h in t.host] == ["train_step:cf", "cudaGraphLaunch"]
    assert units_without_device_work(t, "train_step:") == 0
