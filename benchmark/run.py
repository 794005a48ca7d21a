"""The benchmark of the PyTorch port: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets the cell up from the seed, runs its window for `--seconds` (with
`--trace 1`, a profiled window whose per-layer metrics it reads), checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output, each number compared beside its limit
on standard error last. It needs a CUDA card (as many as the cell asks
for); without one it prints no result and exits 3. It exits 4 if JAX, or
the JAX package, is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

# build and kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench_cache" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# the program as its configuration states it: no switch of layout or path
for _name in ("HGDR_DEDUP", "HGDR_INT8", "HGDR_JOINT", "HGDR_PAD_TABLE_BUDGET"):
    os.environ.pop(_name, None)

# whole top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hypergraph_diffusion_for_recommendation_tpu")


def forbidden_modules() -> list:
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec

    cell = spec.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}")
        return 3
    from harness.runner import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", log, T_START)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process, which the benchmark must not load: {found}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
