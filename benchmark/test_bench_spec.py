"""BENCHMARK.json's form (keys, names, units, bounds), and every name in it
against the files it resolves to."""

import json
import re
import shutil

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec()


def test_top_level_keys_and_paths(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_entry_keys(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"])
    assert {m["name"] for m in bench["end_to_end"]} == {
        "train_examples_per_s", "eval_users_per_s", "eval_pass_p95_ms", "setup_s"}


def test_every_cell_resolves_and_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"], bench)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
            assert spec.metric_file(m["name"]).exists()
            assert callable(spec.reader(m["name"]))
        for part in ("reference", "counts"):
            assert spec.model_module(part, cell.config)
        assert cell.config["name"] == w["config"]
        loop = spec.loop(cell.traffic["loop"])
        assert loop.KIND in cell.config["limits"] and callable(loop.Loop)
        for name in reported - {"setup_s"}:
            assert w["name"] in e2e[name]["workloads"]


def test_a_cell_is_added_without_editing_a_file(tmp_path, bench):
    """A copy of the benchmark with one more cell, made only of new files and
    entries: a configuration, a traffic mix with a loop of its own, and a
    per-layer metric."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((spec.BENCH_DIR / "configs" / "lightgcn-amazonbook.json").read_text())
    cfg["name"] = "lightgcn-newshape"
    (root / "benchmark/configs/lightgcn-newshape.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/train_long.json").write_text(
        json.dumps(dict(json.loads((spec.BENCH_DIR / "traffic/train.json").read_text()),
                        loop="serve_batches", trace_seconds=4.0)))
    (root / "benchmark/loops/serve_batches.py").write_text(
        'KIND = "train"\nBACKWARD = False\nCONTROLS = ()\n\n\nclass Loop:\n    pass\n')
    (root / "benchmark/metrics/step.host_share.train.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "lightgcn-newshape", "source": "x",
                           "file": "benchmark/configs/lightgcn-newshape.json", "reduced": [],
                           "why": "x"})
    new["workloads"].append({"name": "lightgcn-newshape.train", "config": "lightgcn-newshape",
                             "traffic": "train_long", "chips": 1, "why": "x"})
    new["end_to_end"][0]["workloads"].append("lightgcn-newshape.train")
    new["per_layer"].append({"name": "step.host_share.train", "unit": "%", "better": "lower",
                             "source": "program_span", "layer": "Trainer",
                             "moves": "train_examples_per_s",
                             "workloads": ["lightgcn-newshape.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    old = (spec.ROOT, spec.BENCH_DIR)
    try:
        spec.ROOT, spec.BENCH_DIR = root, root / "benchmark"
        cell = spec.resolve("lightgcn-newshape.train", spec.load_spec(root / "BENCHMARK.json"))
        assert cell.traffic["trace_seconds"] == 4.0
        assert spec.loop(cell.traffic["loop"]).CONTROLS == ()
        assert [m["name"] for m in cell.per_layer] == ["step.host_share.train"]
        assert spec.reader("step.host_share.train")({}) == 1.0
    finally:
        spec.ROOT, spec.BENCH_DIR = old
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_missing_file_or_name_fails(bench, tmp_path):
    with pytest.raises(KeyError):
        spec.resolve("no-such.cell", bench)
    broken = json.loads(json.dumps(bench))
    broken["per_layer"].append({"name": "no.such.reader", "unit": "ms", "better": "lower",
                                "source": "device_trace", "layer": "Device",
                                "moves": "setup_s", "workloads": ["khgrec-ml1m.train"]})
    with pytest.raises(FileNotFoundError):
        spec.resolve("khgrec-ml1m.train", broken)
