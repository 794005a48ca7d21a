"""What `BENCHMARK.json` names, and the files each name resolves to.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by name:

  * a configuration: `configs/<config>.json`, its plain reference
    `reference/<model>.py` and its work counts `counts/<model>.py`
    (`<model>` is the configuration's `reference` key);
  * a traffic mix: `traffic/<traffic>.json`, the parameters of the loop it
    names, `loops/<loop>.py`, which drives the program and checks it;
  * a per-layer metric: `metrics/<metric>.py`, whose `read(ctx)` returns the
    metric's value or None.

A new cell, configuration or metric is added by adding such files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


@dataclass(frozen=True)
class Cell:
    """One workload of `BENCHMARK.json` with what its names resolve to."""

    name: str
    chips: int
    config: dict  # the configuration's file, parsed
    traffic: dict  # the traffic mix's file, parsed
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def load_spec(path: Path = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, spec: dict | None = None) -> Cell:
    """The cell `name`; raises KeyError for a name `BENCHMARK.json` lacks
    and FileNotFoundError for a file that is not there."""
    spec = load_spec() if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[w["config"]]
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    needed = [BENCH_DIR / part / f"{config['reference']}.py" for part in ("reference", "counts")]
    for path in needed + [loop_file(traffic["loop"])]:
        if not path.exists():
            raise FileNotFoundError(path)
    per_layer = [m for m in spec["per_layer"] if _reports(m, name)]
    for m in per_layer:
        if not metric_file(m["name"]).exists():
            raise FileNotFoundError(metric_file(m["name"]))
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
                per_layer=per_layer)


def metric_file(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def loop_file(name: str) -> Path:
    return BENCH_DIR / "loops" / f"{name}.py"


def load_file(path: Path, module_name: str):
    """Import the Python file `path` as a module of its own (a metric's name
    holds dots, so it is no importable module name), once."""
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def _module_name(prefix: str, name: str) -> str:
    return prefix + name.replace(".", "_").replace("-", "_")


def reader(name: str):
    """The `read(ctx)` of the per-layer metric `name`."""
    return load_file(metric_file(name), _module_name("bench_metric_", name)).read


def loop(name: str):
    """`loops/<name>.py`: its `Loop` class, its `KIND` ("train" or "eval": the
    configuration's limits it is held to, and what the readers see), its
    `BACKWARD` (whether a unit multiplies backward too) and its `CONTROLS`."""
    return load_file(loop_file(name), _module_name("bench_loop_", name))


def model_module(part: str, config: dict):
    """`reference/<model>.py` or `counts/<model>.py` of a configuration."""
    return importlib.import_module(f"{part}.{config['reference']}")
