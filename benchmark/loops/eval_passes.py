"""The loop of the evaluation mixes: one `Trainer` over tables as training
leaves them, made by the benchmark from the seed (`weights`); a pass is
`Trainer.restore(snapshot)`, which makes the next encode anew, then
`Trainer.encode()` and `Trainer.evaluate()`: the encode and the
full-catalog ranking of every test user. The window runs passes back to
back until `--seconds` have passed. A pass records three ranges (the pass,
its encode, its ranking), which cost nothing without a profiler, so the
profiled window runs the timed pass itself.

The tables carry a signal that the ranking can find: each user's and
item's rows are drawn towards the generator's planted clusters and item
popularity (`reference/common.planted_rows`, scaled by the mix's
`table_signal`), so that the metrics read well above chance and a ranking
that skips the mask, loses users or sorts wrong moves them.

What `correct` compares, in every pass of the window: the encoded tables
against the reference's, and the metrics against the reference's ranking
of the tables the program ranked, in the program's blocks of users.

Controls and faults put in the program's place (`check`'s `control`):
"reference", the reference's encode and scoring at the configuration's
control precision; "half_batch", the first half of the test users alone;
"mask_off", a ranking that leaves each user's training items in.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np

from harness import check, program
from harness.runner import counting, sync
from harness.trace import profile_window

KIND = "eval"
BACKWARD = False  # an encode multiplies forward only
CONTROLS = ("reference", "half_batch", "mask_off")
EVAL_PASS, EVAL_ENCODE, EVAL_RANK = "bench.eval.pass", "bench.eval.encode", "bench.eval.rank"


class Loop:
    def __init__(self, run, params: dict):
        self.run, self.p = run, params

    def weights(self) -> dict:
        r = self.run
        return r.ref.trained_weights(r.graph, r.sizes, r.latent, self.p["table_signal"], r.gen,
                                     r.device)

    def setup(self):
        r = self.run
        extras = r.ref.trained_extras(r.graph, r.sizes, r.gen, r.device)
        self.extras0 = {k: v.clone() for k, v in extras.items()}
        self.trainer = program.trainer(r.bundle, r.seed, extras)
        self.snapshot = self.trainer.snapshot()
        self.answers = []
        self._pass()  # captures the encode graph
        self.answers = []
        sync(r.device)

    def _pass(self):
        from torch.profiler import record_function

        with record_function(EVAL_PASS):
            self.trainer.restore(self.snapshot)
            with record_function(EVAL_ENCODE):
                self.trainer.encode()
            with record_function(EVAL_RANK):
                self.answers.append(self.trainer.evaluate())

    def _passes(self, seconds: float) -> list:
        """The wall time of each pass, until `seconds` have passed."""
        times = []
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            self._pass()
            e = time.perf_counter()
            times.append(e - s)
            if e - t0 >= seconds:
                return times

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        times = self._passes(seconds)
        sync(self.run.device)
        wall = time.perf_counter() - t0
        self.attempted = len(times)
        q = self.p["tail_percentile"]
        tail = statistics.quantiles(times, n=100, method="inclusive")[q - 1] if len(times) > 1 \
            else times[0]
        # the passes' tail swings with the host's load from machine to machine
        # more than any bound allows (PERF.md section 2): logged, not a metric
        self.run.log(f"[window] {len(times)} passes, median {statistics.median(times) * 1e3:.3f}"
                     f" ms, p{q} {tail * 1e3:.3f} ms")
        return {"eval_users_per_s": len(times) * self.run.sizes["n_test_users"] / wall}

    def traced(self, seconds: float):
        trace, times = profile_window(lambda: self._passes(seconds), EVAL_PASS,
                                      self.p["trace_attempts"], self.run.log)
        self.attempted = len(times)
        return trace, {"pass_span": EVAL_PASS, "encode_span": EVAL_ENCODE,
                       "rank_span": EVAL_RANK, "units": len(trace.ranges(EVAL_PASS))}

    def collect(self):
        """The tables of the last pass (the encode is cached since), then
        frees the program's trainer."""
        self.outputs = tuple(t.detach().clone() for t in self.trainer.encode())
        self.trainer = self.snapshot = None

    def check(self, limits: dict, control: str | None, flops: dict | None) -> tuple[dict, int]:
        """(each compared number, the passes whose metrics fail): the
        reference's tables against the program's last pass's, and every
        pass's metrics against the reference's ranking of the tables the
        program ranked; or a control's or fault's in the program's place."""
        r = self.run
        tables = self.encode(r.precision, flops)
        outputs, answers = self.outputs, self.answers
        if control == "reference":
            precision = r.cell.config["control"]["precision"]
            outputs = self.encode(precision)
            answers = [self.rank(outputs, precision)]
        elif control == "half_batch":
            outputs, answers = tables, [self.rank(tables, r.precision, half_users=True)]
        elif control == "mask_off":
            outputs, answers = tables, [self.rank(tables, r.precision, mask=False)]
        elif control is not None:
            raise ValueError(f"no control {control!r} in an evaluation loop: {CONTROLS}")
        # the ranking judged on the tables it ranked, which `table_gap` judges
        metrics = self.rank(outputs, "float32")
        r.log("[check] reference metrics " + " ".join(
            f"{m}@{n} {v!r}" for n, ms in metrics.items() for m, v in ms.items()))
        gaps = [check.metric_gap(a, metrics) for a in answers]
        values = {"table_gap": check.table_gap(outputs, tables), "metric_gap": max(gaps)}
        return values, sum(g > limits["metric_gap"] for g in gaps)

    def encode(self, precision: str, flops: dict | None = None):
        """The reference's tables from the benchmark's weights and extras."""
        r = self.run
        with counting(flops):
            return r.ref.encode(r.weights, self.extras0, r.graph, r.sizes, precision)

    def rank(self, tables, precision: str, half_users: bool = False, mask: bool = True) -> dict:
        """The reference's metrics of ranking `tables`, scored at `precision`
        in the program's blocks of test users (faults: with `half_users` the
        first half of the test users alone; without `mask` the users'
        training items left in the ranking)."""
        from reference.common import ranking_metrics

        r = self.run
        cf = r.graph.cf
        if half_users:
            users = np.unique(cf.test_u)
            keep = np.isin(cf.test_u, users[: len(users) // 2])
            cf = dataclasses.replace(cf, test_u=cf.test_u[keep], test_i=cf.test_i[keep])
        return ranking_metrics(tables[0], tables[1], cf, r.sizes["item_ranking"], precision,
                               block=r.sizes["eval_user_batch"], mask=mask)

    def unit_flops(self, dense: float, sparse: float) -> float:
        """A pass's FLOPs: the encode's, and the scoring product over the
        padded test users."""
        s = self.run.sizes
        block = s["eval_user_batch"]
        n_pad = -(-s["n_test_users"] // block) * block
        return dense + sparse + 2 * n_pad * s["n_items"] * self.run.counts.width(s)
