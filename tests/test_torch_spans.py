"""The program's spans (`utils/spans.py`) on the CPU: a tiny LightGCN (and
KGAT, whose epoch alternates) `Trainer` runs an epoch and an evaluation
under torch.profiler, and the exported Chrome trace is read back. The
spans nest and count as the trainer's layers do; without a profiler a span
makes no `record_function` call; a profiled epoch and evaluation give the
unprofiled ones' numbers bit for bit; the names are those the benchmark's
readers read; a captured graph carries its wrappers' launches.
"""

import contextlib
import json
from pathlib import Path

import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import gather_fusion
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer, graphs
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import spans
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import trace_analysis as TA

METRICS = Path(__file__).resolve().parents[1] / "benchmark" / "metrics"
CONFIGS = {
    "LightGCN": dict(embedding_size=16, batch_size=128, eval_user_batch=32, item_ranking=(5, 10)),
    "KGAT": dict(embedding_size=16, relation_dim=16, n_layers=2, conv_dim_list=(16, 8),
                 batch_size=128, batch_size_kg=512, eval_user_batch=32, item_ranking=(5, 10)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: several CPU threads sum KGAT's backward in an order
    that changes from run to run, and a profiled epoch is held to an
    unprofiled one bit for bit (on the card every sum has one fixed order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recs():
    out = {}
    for model, kw in CONFIGS.items():
        rec = Recommender(make_config(model, **kw), device="cpu")
        rec.build(synthetic_dataset(n_users=80, n_items=120, mean_degree=10.0, seed=3,
                                    with_kg=model == "KGAT"))
        rec.init_weights(0)
        out[model] = rec
    return out


def _trainer(rec):
    return Trainer(rec.bundle, seed=0, extras=rec.extras)


def _profiled(fn, path):
    """(fn's result, the trace's host ranges as (name, start, end), by start)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(Path(path).read_text())["traceEvents"]
    ranges = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, sorted(ranges, key=lambda r: r[1])


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


@pytest.mark.parametrize("model,phases", [("LightGCN", ("cf",)), ("KGAT", ("cf", "kg"))])
def test_an_epoch_records_one_epoch_range_holding_its_phases(recs, tmp_path, model, phases):
    tr = _trainer(recs[model])
    _, ranges = _profiled(lambda: tr.run_epoch(0), tmp_path / "t.json")
    (epoch,) = _named(ranges, spans.EPOCH)
    n_steps = {"cf": tr.n_batches, "kg": getattr(tr, "n_kg_batches", 0)}
    last = epoch[1]
    for phase in phases:
        (sample,) = _named(ranges, f"{spans.SAMPLE}:{phase}")
        steps = _named(ranges, f"{spans.STEP_ANNOTATION}:{phase}")
        (to_host,) = _named(ranges, f"{spans.LOSS_TO_HOST}:{phase}")
        assert len(steps) == n_steps[phase]
        # in the epoch, in order: the sampling, the steps, the wait for the loss
        assert all(_inside(r, epoch) for r in [sample, to_host] + steps)
        assert last <= sample[1] and sample[2] <= steps[0][1]
        assert steps[-1][2] <= to_host[1]
        last = to_host[2]
    # and no other span of the program (an epoch on the CPU captures no graph)
    assert {r[0] for r in ranges if r[0].startswith(("trainer.", "train_step", "eval."))} == {
        spans.EPOCH} | {f"{name}:{phase}" for phase in phases
                        for name in (spans.SAMPLE, spans.STEP_ANNOTATION, spans.LOSS_TO_HOST)}


@pytest.mark.parametrize("model", ["LightGCN", "KGAT"])
def test_an_evaluation_records_score_topk_and_metrics_in_each_block(recs, tmp_path, model):
    rec = recs[model]
    tr = _trainer(rec)
    ed, block = rec.bundle.cf.eval_data, rec.cfg.eval_user_batch
    n_blocks = ed.test_users.shape[0] // block
    assert n_blocks >= 2

    def run():
        tr.restore(tr.snapshot())  # the next encode encodes
        return tr.evaluate()

    _, ranges = _profiled(run, tmp_path / "t.json")
    (encode,) = _named(ranges, spans.EVAL_ENCODE)
    (to_host,) = _named(ranges, spans.EVAL_TO_HOST)
    score, topk, metrics = (_named(ranges, n) for n in (spans.EVAL_SCORE, spans.EVAL_TOPK,
                                                         spans.EVAL_METRICS))
    assert len(score) == len(topk) == len(metrics) == n_blocks
    last = encode[2]
    for s, t, m in zip(score, topk, metrics):
        assert last <= s[1] and s[2] <= t[1] and t[2] <= m[1]
        last = m[2]
    assert last <= to_host[1]


def test_the_encode_range_is_only_where_the_trainer_encodes(recs, tmp_path):
    tr = _trainer(recs["LightGCN"])
    tr.encode()
    _, ranges = _profiled(tr.encode, tmp_path / "t.json")  # the cached tables
    assert not _named(ranges, spans.EVAL_ENCODE)


def test_without_a_profiler_no_span_calls_record_function(recs, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    tr = _trainer(recs["KGAT"])
    tr.run_epoch(0)
    tr.evaluate()
    assert calls == []
    assert spans.span(spans.EPOCH) is spans.span(spans.EVAL_TOPK)  # one shared no-op
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tr.run_epoch(1)
    assert calls.count(spans.EPOCH) == 1


@pytest.mark.parametrize("profiler", ["torch.profiler", "autograd", "none"])
def test_span_opens_a_range_only_while_a_profiler_records(profiler):
    ctx = {"torch.profiler": lambda: torch.profiler.profile(
               activities=[torch.profiler.ProfilerActivity.CPU]),
           "autograd": torch.autograd.profiler.profile,
           "none": contextlib.nullcontext}[profiler]
    with ctx():
        s = spans.span(spans.EPOCH)
    assert isinstance(s, torch.profiler.record_function) == (profiler != "none")


@pytest.mark.parametrize("model", ["LightGCN", "KGAT"])
def test_a_profiled_epoch_and_evaluation_equal_unprofiled_ones(recs, tmp_path, model):
    tr = _trainer(recs[model])
    tr.run_epoch(0)
    state = tr.snapshot(optimizer=True)

    def run():
        out = tr.run_epoch(1)
        return out, tr.evaluate()

    want = run()
    tr.restore(state)
    got, _ = _profiled(run, tmp_path / "t.json")
    assert got == want  # the loss, every aux term and every metric, bit for bit


@pytest.mark.parametrize("metric,names", [
    ("trainer.sample_ms.train", (spans.EPOCH, spans.SAMPLE + ":")),
    ("trainer.boundary_idle_share.train", (spans.EPOCH, spans.STEP_ANNOTATION + ":")),
    ("trainer.step_idle_share.train", (spans.STEP_ANNOTATION + ":",)),
    ("eval.topk_ms", (spans.EVAL_TOPK,)),
])
def test_the_benchmark_reads_the_spans_by_their_names(metric, names):
    source = (METRICS / f"{metric}.py").read_text()
    for name in names:
        assert f'"{name}"' in source, (metric, name)


def test_main_program_is_a_step_not_the_epoch_that_holds_the_steps():
    stats = {n: TA.ProgramStats(program_id=n, n_executions=k, module_dur_s=d)
             for n, k, d in ((spans.EPOCH, 1, 3.0), ("train_step:cf", 10, 2.5),
                             ("Optimizer.step#Adam.step", 1, 0.1))}
    assert TA.main_program(stats).program_id == "train_step:cf"
    with pytest.raises(ValueError):
        TA.main_program({spans.EPOCH: stats[spans.EPOCH]})


class _FakeGraph:
    def register_generator_state(self, gen):
        pass


@pytest.mark.parametrize("launched,want", [
    ({}, {}),
    ({"segment_spmm_rows": 6}, {"segment_spmm_rows": 6}),
    ({"segment_spmm_dedup_int8": 16, "quantize_int8": 16, "resident_row_gather": 2},
     {"segment_spmm_dedup_int8": 16, "quantize_int8": 16, "resident_row_gather": 2}),
])
def test_a_capture_records_the_wrappers_launches(monkeypatch, launched, want):
    # CUDA graphs need a card: the graph and its capture context are stand-ins
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(segment_spmm, "LAUNCHES", dict(segment_spmm.LAUNCHES))
    monkeypatch.setattr(gather_fusion, "LAUNCHES", dict(gather_fusion.LAUNCHES))

    def work():
        for name, n in launched.items():
            mod = gather_fusion if name in gather_fusion.LAUNCHES else segment_spmm
            mod.LAUNCHES[name] += n
        return "out"

    segment_spmm.LAUNCHES["segment_spmm_rows"] += 5  # before the capture: not the graph's
    graph, out = graphs.capture(work)
    assert out == "out" and graph.launches == want


def test_replayed_launches_are_the_captures_times_the_replays(recs):
    tr = _trainer(recs["KGAT"])
    cf, kg = _FakeGraph(), _FakeGraph()
    cf.launches, kg.launches = {"segment_spmm_rows": 4}, {"segment_spmm_rows": 2,
                                                           "quantize_int8": 1}
    tr._step_graphs = {"full": (cf, {}), "kg:full": (kg, {})}
    assert tr.replayed_launches() == {}
    tr.replays = {"full": 3, "kg:full": 5}
    assert tr.replayed_launches() == {"segment_spmm_rows": 22, "quantize_int8": 5}
