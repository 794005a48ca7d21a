"""Cells at a size a test run can hold: the same configurations, traffic and
code paths as `BENCHMARK.json`'s, with the data and the widths cut so that
a run takes seconds on a CPU. For tests only: no benchmark run uses them.

The cut is the configuration's own: its file's `small` block, whose `data`
and `settings` replace those keys of its `data` and `settings`. So a new
configuration brings its cut in its own file, and nothing here names a
model.
"""

from __future__ import annotations

import dataclasses
import json
import sys

from . import spec

if str(spec.ROOT) not in sys.path:
    sys.path.insert(0, str(spec.ROOT))


def cells(loop: str | None = None) -> list:
    """The names of BENCHMARK.json's cells (whose traffic runs `loop`)."""
    names = [w["name"] for w in spec.load_spec()["workloads"]]
    return [n for n in names if loop is None or spec.resolve(n).traffic["loop"] == loop]


def small_cell(name: str) -> spec.Cell:
    """The cell `name` of BENCHMARK.json at the small size."""
    cell = spec.resolve(name)
    cfg = json.loads(json.dumps(cell.config))
    cut = cfg.get("small")
    if not isinstance(cut, dict) or not {"data", "settings"} <= set(cut):
        raise ValueError(f"configuration {cfg.get('name')!r} has no 'small' block with 'data' "
                         f"and 'settings': its cell {name!r} has no size for a test run")
    cfg["data"].update(cut["data"])
    cfg["settings"].update(cut["settings"])
    return dataclasses.replace(cell, config=cfg)


def run_small(name: str, seed: int = 2147483999, seconds: float = 0.2, trace: bool = False,
              device: str = "cpu", control: str | None = None, log=lambda msg: None) -> dict:
    """One run of the small cell. On the CPU the program has no kernel
    layouts, so its products are float32 and the reference computes so too."""
    import time

    from .runner import run_cell

    return run_cell(small_cell(name), seed, seconds, trace, device, log, time.perf_counter(),
                    control=control, precision="float32" if device == "cpu" else None)
