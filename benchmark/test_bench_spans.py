"""The readers of the program's own spans, on small synthetic traces whose
numbers are worked out by hand, and which cells may list the metrics that
read them."""

import json

import pytest

from harness import spec
from harness.trace import Trace

SPAN_METRICS = ("trainer.sample_ms.train", "trainer.boundary_idle_share.train",
                "trainer.step_idle_share.train", "eval.topk_ms")


def _train_trace():
    """A 1 s window of two epochs, 0.05-0.45 and 0.50-0.95: each samples,
    steps twice and waits for its loss. The device is busy 0.00-0.02,
    0.16-0.40 and 0.60-0.92, so it idles 0.02-0.16, 0.40-0.60 (a gap across
    the first epoch's end and the second's start) and 0.92-1.00."""
    ann = "user_annotation"
    host = [("trainer.epoch", 0.05, 0.45, ann), ("trainer.epoch", 0.50, 0.95, ann),
            ("trainer.sample:cf", 0.05, 0.15, ann), ("trainer.sample:cf", 0.50, 0.55, ann),
            ("train_step:cf", 0.15, 0.25, ann), ("train_step:cf", 0.25, 0.35, ann),
            ("train_step:cf", 0.55, 0.75, ann), ("train_step:cf", 0.75, 0.90, ann),
            ("trainer.loss_to_host:cf", 0.35, 0.45, ann),
            ("trainer.loss_to_host:cf", 0.90, 0.95, ann),
            ("cudaGraphLaunch", 0.26, 0.27, "cuda_runtime")]
    device = [("fill", 0.00, 0.02, None), ("k1", 0.16, 0.24, 0.15), ("k2", 0.24, 0.40, 0.26),
              ("k3", 0.60, 0.80, 0.56), ("k4", 0.78, 0.92, 0.76)]
    return Trace(window_s=1.0, device=device, host=host)


def _eval_trace():
    """Two passes of 0.5 s, each ranking two blocks. A block's top-k range
    launches the sort, which runs past the range's end; the first block's
    two sorts overlap (0.12-0.28: 0.16 s busy), the second's one runs
    0.36-0.40. The scoring GEMM, launched before each top-k range, is not
    the top-k's."""
    host, device = [], []
    for k in range(2):
        t = 0.5 * k
        host += [("eval.score", t + 0.05, t + 0.10, "user_annotation"),
                 ("eval.topk", t + 0.10, t + 0.15, "user_annotation"),
                 ("eval.topk", t + 0.30, t + 0.35, "user_annotation")]
        device += [("gemm", t + 0.06, t + 0.12, t + 0.05),
                   ("sort", t + 0.12, t + 0.25, t + 0.11),
                   ("sort", t + 0.20, t + 0.28, t + 0.14),
                   ("sort", t + 0.36, t + 0.40, t + 0.31)]
    return Trace(window_s=1.0, device=device, host=host)


def read(name, ctx):
    return spec.reader(name)(ctx)


def test_the_sampling_time_an_epoch():
    # 0.10 s and 0.05 s of sampling over 2 epochs
    assert read("trainer.sample_ms.train", {"trace": _train_trace()}) == pytest.approx(75.0)


def test_idle_inside_and_outside_the_step_ranges():
    ctx = {"trace": _train_trace(), "kind": "train"}
    # in the steps: 0.15-0.16 and 0.55-0.60
    step = read("trainer.step_idle_share.train", ctx)
    assert step == pytest.approx(6.0)
    # in the epochs, outside the steps: 0.05-0.15 (sampling), 0.40-0.45 (the
    # wait for the loss, the gap's first part), 0.50-0.55 (sampling, its
    # last part but one) and 0.92-0.95
    boundary = read("trainer.boundary_idle_share.train", ctx)
    assert boundary == pytest.approx(23.0)
    # the rest of the idle lies outside every epoch: 0.02-0.05, 0.45-0.50
    # (the gap between the epochs) and 0.95-1.00
    total = read("device.idle_share.train", ctx)
    assert total == pytest.approx(42.0)
    assert total - step - boundary == pytest.approx(13.0)


def test_ranges_past_the_window_are_clipped():
    t = _train_trace()
    longer = [(n, s, e + 0.2 if e == 0.95 else e, c) for n, s, e, c in t.host]
    ctx = {"trace": Trace(t.window_s, t.device, longer)}
    # the second epoch now ends at 1.15: the idle 0.95-1.00 joins its boundary
    assert read("trainer.boundary_idle_share.train", ctx) == pytest.approx(28.0)


def test_the_topk_time_counts_its_operations_past_the_range():
    ctx = {"trace": _eval_trace(), "units": 2, "kind": "eval"}
    # a pass: 0.16 s and 0.04 s of the top-k's operations
    assert read("eval.topk_ms", ctx) == pytest.approx(200.0)


@pytest.mark.parametrize("metric,kept", [
    ("trainer.sample_ms.train", ("train_step:cf", "trainer.sample:cf")),
    ("trainer.boundary_idle_share.train", ("train_step:cf", "trainer.sample:cf")),
    ("trainer.step_idle_share.train", ("trainer.epoch", "trainer.sample:cf")),
    ("eval.topk_ms", ("eval.score",)),
])
def test_a_missing_span_reads_none(metric, kept):
    # a program without the span the metric reads (the parent of the spans
    # reads no epoch or top-k range), and a window with none of the program's
    trace = _eval_trace() if metric.startswith("eval.") else _train_trace()
    lacking = Trace(trace.window_s, trace.device, [h for h in trace.host if h[0] in kept])
    assert read(metric, {"trace": lacking, "units": 2}) is None
    empty = Trace(trace.window_s, trace.device, [])
    assert read(metric, {"trace": empty, "units": 2}) is None


# the loop whose runs record the ranges that each family of metrics reads:
# the Trainer's spans (`trainer.*`) in `train_epochs`, the evaluation's
# (`eval.*`: the program's and the benchmark's pass ranges) in `eval_passes`
SPAN_LOOPS = {"trainer.": "train_epochs", "eval.": "eval_passes"}


def misdeclared(bench: dict) -> list:
    """(metric, cell) for each cell that a `trainer.*` or `eval.*` metric
    lists and that is not in `bench`, or whose traffic runs another loop
    than the one that records the metric's ranges."""
    workloads = {w["name"] for w in bench["workloads"]}
    bad = []
    for m in bench["per_layer"]:
        loop = next((v for k, v in SPAN_LOOPS.items() if m["name"].startswith(k)), None)
        if loop is None:
            continue
        for cell in m["workloads"]:
            if cell not in workloads or spec.resolve(cell, bench).traffic["loop"] != loop:
                bad.append((m["name"], cell))
    return bad


def test_the_span_metrics_are_declared_for_the_cells_that_record_the_spans():
    bench = spec.load_spec()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span" and spec.metric_file(name).exists()
        assert m["workloads"]
    assert misdeclared(bench) == []


def _listed(bench: dict, prefix: str, cell: str, workload: dict | None = None) -> dict:
    """`bench` with `cell` added to every `prefix` metric's list (and
    `workload` to its cells)."""
    new = json.loads(json.dumps(bench))
    if workload is not None:
        new["workloads"].append(workload)
    for m in new["per_layer"]:
        if m["name"].startswith(prefix):
            m["workloads"].append(cell)
    return new


NEW_TRAIN = {"name": "khgrec-ml1m.train-b", "config": "khgrec-ml1m", "traffic": "train",
             "chips": 1, "why": "x"}


@pytest.mark.parametrize("prefix,cell,workload,refused", [
    ("trainer.", "khgrec-ml1m.train-b", NEW_TRAIN, False),  # a new train cell
    ("trainer.", "lightgcn-amazonbook.eval", None, True),  # its loop runs no Trainer epoch
    ("eval.", "lightgcn-amazonbook.train", None, True),  # its loop runs no evaluation pass
    ("trainer.", "no-such.train", None, True),  # no such cell
])
def test_a_new_cell_joins_the_span_metrics_by_its_loop(prefix, cell, workload, refused):
    bench = spec.load_spec()
    names = [m["name"] for m in bench["per_layer"] if m["name"].startswith(prefix)]
    bad = misdeclared(_listed(bench, prefix, cell, workload))
    assert bad == ([(name, cell) for name in names] if refused else [])
