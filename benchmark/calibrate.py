"""The readings that a cell's limits are set from: one process runs a cell
on many seeds, as the program (`--control none`) or as the configuration's
control, and prints one JSON line a seed with the numbers compared.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 2 --control none

The control is a configuration's `control` entry: the program with its own
lower-precision path switched on ("program_env"), or the reference in a
lower precision in the program's place ("reference"); a fault of the cell's
loop (its `CONTROLS`: "half_batch", half of each batch or of the test users
left out; "mask_off", a ranking that keeps the training items) puts the
reference there with the fault planted. Every control and fault has to come
out not correct. A seed's set-up is paid again; the kernels are built
once.
"""

import gc
import json
import sys
import time

import run as bench  # noqa: F401  (its path and environment set-up)
from harness import spec
from harness.runner import run_cell


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", default="none",
                    help="none, program_env, or one of the cell's loop's CONTROLS")
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    known = ("none", "program_env") + spec.loop(cell.traffic["loop"]).CONTROLS
    if args.control not in known:
        bench.log(f"--control {args.control!r} is not one of {known}")
        return 2
    if not torch.cuda.is_available():
        bench.log("no CUDA card")
        return 3
    control = None if args.control == "none" else args.control
    if control in ("program_env", "reference") and cell.config["control"]["kind"] != control:
        bench.log(f"{cell.config['name']}'s control is {cell.config['control']['kind']!r}")
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(cell, seed, args.seconds, False, "cuda", bench.log, time.perf_counter(),
                     control=control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": r["correct"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
