"""BENCHMARK.json's form (keys, names, units, bounds), and every name in it
against the files it resolves to."""

import dataclasses
import json
import re
import shutil
import subprocess
import sys

import pytest

from harness import spec
from harness.small import cells, small_cell

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
        "train_examples_per_s", "eval_users_per_s", "setup_s"}


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


def _copy(tmp_path):
    """(checkout, its benchmark directory, {file: bytes}): a copy of the
    benchmark's directory in a new checkout, with its files as copied."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root, root / "benchmark", {
        p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_a_cell_is_added_without_editing_a_file(tmp_path, bench):
    """A copy of the benchmark with one more cell, made only of new files and
    entries: a configuration, a traffic mix with a loop of its own, and a
    per-layer metric."""
    root, _, before = _copy(tmp_path)
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


# the small cuts as `harness/small.py` held them, by model, before each
# configuration's file carried its own
OLD_SMALL = {
    "khgrec": dict(data=dict(n_users=60, n_items=120, n_clusters=4, mean_degree=8.0),
                   settings=dict(batch_size=64, batch_size_kg=128, hyper_dim=16, relation_dim=8,
                                 eval_user_batch=32)),
    "lightgcn": dict(data=dict(n_users=60, n_items=80, n_interactions=900, n_clusters=4,
                               min_degree=3, block_users=32),
                     settings=dict(embedding_size=16, batch_size=64, eval_user_batch=32)),
}


@pytest.mark.parametrize("name", cells())
def test_the_small_cuts_are_the_old_ones(name):
    full, small = spec.resolve(name).config, small_cell(name).config
    cut = OLD_SMALL[full["reference"]]
    for part in ("data", "settings"):
        assert small[part] == dict(full[part], **cut[part]), part
        for key, value in cut[part].items():
            assert small[part][key] == value and type(small[part][key]) is type(value), key


def test_a_configuration_without_its_small_cut_is_named(monkeypatch):
    resolve = spec.resolve

    def without(name, bench=None):
        cell = resolve(name, bench)
        cfg = {k: v for k, v in cell.config.items() if k != "small"}
        return dataclasses.replace(cell, config=cfg)

    monkeypatch.setattr(spec, "resolve", without)
    with pytest.raises(ValueError, match="'lightgcn-amazonbook' has no 'small' block"):
        small_cell("lightgcn-amazonbook.train")


# A model that no cell runs: LightGCN with feature dropout on both tables
# before propagation, drawn in the step from the generator that the trainer
# passes to the loss. The reference draws the same masks from the generator
# that the training loop hands it.
NEW_REFERENCE = '''"""LightGCN with feature dropout (rate `RATE`) on both tables before
propagation, the masks drawn from the step's generator."""

import torch

from . import lightgcn
from .lightgcn import *  # noqa: F401,F403

RATE = 0.5


def _drop(x, generator):
    keep = 1.0 - RATE
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def loss(p, extras, batch, keys, g, s, precision, generator=None):
    dropped = dict(p, user_emb=_drop(p["user_emb"], generator),
                   item_emb=_drop(p["item_emb"], generator))
    return lightgcn.loss(dropped, extras, batch, keys, g, s, precision)
'''

NEW_COUNTS = "from .lightgcn import ADJACENCIES, other_sparse_flops, products, width  # noqa\n"

# The program's LightGCN with the same dropout, drawn from the generator that
# the trainer gives its loss; then the cell at the small size, with the
# program's dropout stream handed to the reference, and with it withheld.
NEW_MODEL_PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import torch
from harness import program, spec
from harness.small import cells, run_small
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.dropout import feature_dropout
import reference.{model} as ref

torch.set_num_threads(1)
build = program.build


def with_dropout(*args, **kwargs):
    bundle, cfg, inter = build(*args, **kwargs)
    module, loss = bundle.module, bundle.batch_loss
    tables = module.forward

    def batch_loss(extras, batch, edge_keys=(), generator=None):
        def dropped():
            u, i = tables()
            return (feature_dropout(u, ref.RATE, generator, True),
                    feature_dropout(i, ref.RATE, generator, True))

        module.forward = dropped
        try:
            return loss(extras, batch, edge_keys, generator)
        finally:
            del module.forward

    bundle.batch_loss = batch_loss
    return bundle, cfg, inter


program.build = with_dropout
out = {{"bench_dir": str(spec.BENCH_DIR), "reference": ref.__file__,
       "train_cells": cells("train_epochs")}}
r = run_small({cell!r})
out["handed"] = {{"correct": r["correct"], "checks": r["checks"]}}
program.dropout_state = lambda trainer: torch.Generator().manual_seed(12345).get_state()
r = run_small({cell!r})
out["withheld"] = {{"correct": r["correct"], "checks": r["checks"]}}
print(json.dumps(out))
"""


def test_a_new_model_joins_from_new_files_alone(tmp_path, bench):
    """A copy of the benchmark with a configuration of a model that no cell
    runs, and its cell, made only of new files and entries: the model's
    reference and counts, its configuration with its small cut, the cell,
    and the cell's name in the lists of the metrics it reports. At the small
    size on the CPU the cell comes out correct, and not correct where the
    reference's generator is seeded otherwise than the program's."""
    model, config, cell = "lightgcn_dropout", "lightgcn_dropout-amazonbook", \
        "lightgcn_dropout-amazonbook.train"
    root, copy, before = _copy(tmp_path)
    cfg = json.loads((spec.BENCH_DIR / "configs" / "lightgcn-amazonbook.json").read_text())
    cfg.update(name=config, reference=model)
    (copy / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    (copy / "reference" / f"{model}.py").write_text(NEW_REFERENCE)
    (copy / "counts" / f"{model}.py").write_text(NEW_COUNTS)
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": config, "source": "x", "file": f"benchmark/configs/{config}.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": cell, "config": config, "traffic": "train", "chips": 1,
                             "why": "x"})
    for m in new["end_to_end"] + new["per_layer"]:
        if m["name"] == "train_examples_per_s" or m["name"].startswith("trainer."):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(new))

    probe = NEW_MODEL_PROBE.format(bench=str(copy), root=str(spec.ROOT), model=model, cell=cell)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bench_dir"] == str(copy) and got["reference"].startswith(str(copy))
    assert cell in got["train_cells"]
    handed, withheld = got["handed"], got["withheld"]
    assert handed["correct"] is True, handed["checks"]
    assert handed["checks"]["loss_gap"]["value"] < 1e-6, handed["checks"]
    assert withheld["correct"] is False, withheld["checks"]
    assert withheld["checks"]["loss_gap"]["value"] > withheld["checks"]["loss_gap"]["limit"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
