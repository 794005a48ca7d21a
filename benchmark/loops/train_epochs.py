"""The loop of the training mixes: one `Trainer`, driven from the seed
through its first `first_steps` steps (eager, captured, replayed) on
batches and dropout keys that the benchmark draws, then handed to the
window, which runs `Trainer.run_epoch` back to back (the program's own
sampling, step graphs, epoch hooks and loss copy) until `--seconds` have
passed, whole epochs only.

What `correct` compares: the first steps' losses, the first gradient as
Adam got it (the program's read back from its first moment) and the
parameters' change over those steps, against the plain reference's same
steps from the same weights, batches and keys (`harness/check.py`).

A step that draws inside its graph (feature dropout) draws from the
trainer's dropout generator. Its state before the first step is read
(`program.dropout_state`), and the reference's `loss` gets, as its
`generator`, one generator set to that state, which serves its steps in
order, as the program's eager, captured and replayed steps draw from its
own. A reference whose model draws nothing takes it and leaves it.

Controls and faults put in the program's place (`check`'s `control`):
"reference", the reference at the configuration's control precision;
"half_batch", the reference with half of each batch left out, the mean
taken over the rest. Each follows its steps with a generator of its own
at the same state.
"""

from __future__ import annotations

import time

import torch

from harness import check, program
from harness.runner import counting, sync
from harness.trace import profile_window

KIND = "train"
BACKWARD = True  # a step multiplies forward and backward
CONTROLS = ("reference", "half_batch")


class Loop:
    def __init__(self, run, params: dict):
        self.run, self.p = run, params

    def weights(self) -> dict:
        r = self.run
        return r.ref.make_weights(r.sizes, r.gen, r.device)

    def setup(self):
        r = self.run
        extras = r.ref.initial_extras(r.graph, r.sizes, r.device)
        self.extras0 = {k: v.clone() for k, v in extras.items()}
        self.trainer = program.trainer(r.bundle, r.seed, extras)
        self.drop_state = program.dropout_state(self.trainer)
        n = self.p["first_steps"]
        self.batches = r.ref.draw_batches(r.graph, r.sizes, n, r.gen, r.device)
        self.keys = torch.randint(0, 1 << 32, (n, r.ref.n_edge_keys(), 2), generator=r.gen,
                                  device=r.device, dtype=torch.int64)
        named = program.params(r.bundle)
        losses, grad = [], None
        for s in range(n):
            loss, _ = self.trainer.train_step(self.batches[s], self.keys[s])
            losses.append(loss.detach().clone())
            if s == 0:
                state = self.trainer.opt.state
                grad = {k: check.first_gradient(state[p]["exp_avg"] if "exp_avg" in state[p]
                                                else torch.zeros_like(p))
                        for k, p in named.items()}
        self.readings = {
            "losses": [float(x) for x in losses], "grad": grad,
            "change": {k: p.detach().double() - r.weights[k].double() for k, p in named.items()}}
        # the sampler's kernels and the epoch's buffers, once, outside the window
        self.trainer.sample_epoch()
        sync(r.device)

    def _epochs(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        epochs = steps = 0
        while True:
            self.trainer.run_epoch(epochs)
            epochs += 1
            steps += self.trainer.n_batches
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.run.device)
        return {"epochs": epochs, "steps": steps, "wall_s": time.perf_counter() - t0}

    def window(self, seconds: float) -> dict:
        w = self._epochs(seconds)
        self.attempted = w["steps"]
        return {"train_examples_per_s": w["steps"] * self.run.sizes["batch_size"] / w["wall_s"]}

    def traced(self, seconds: float):
        prefix = program.step_annotation()
        trace, w = profile_window(lambda: self._epochs(seconds), prefix,
                                  self.p["trace_attempts"], self.run.log)
        self.attempted = w["steps"]
        return trace, {"step_prefix": prefix, "units": len(trace.ranges(prefix))}

    def collect(self):
        """Frees the program's trainer: its readings were taken in set-up."""
        self.trainer = None

    def check(self, limits: dict, control: str | None, flops: dict | None) -> tuple[dict, int]:
        """(each compared number, 0): the reference's first steps against the
        program's readings, or against a control's or fault's put in the
        program's place."""
        r = self.run
        ref = self.reference(r.precision, self.batches, flops)
        readings = self.readings
        if control == "reference":
            readings = self.reference(r.cell.config["control"]["precision"], self.batches)
        elif control == "half_batch":
            half = [tuple(t[: t.shape[0] // 2] for t in b) for b in self.batches]
            readings = self.reference(r.precision, half)
        elif control is not None:
            raise ValueError(f"no control {control!r} in a training loop: {CONTROLS}")
        check.log_train(readings, ref, r.log)
        return check.train_gaps(readings, ref), 0

    def reference(self, precision: str, batches, flops: dict | None = None) -> dict:
        """The reference's first steps from the benchmark's weights, extras,
        batches and keys, with its own Adam, drawing from a generator at the
        program's dropout state before its first step (the first step's
        FLOPs counted into `flops`)."""
        from reference.common import Adam

        r = self.run
        s = r.sizes
        params = {k: v.detach().clone() for k, v in r.weights.items()}
        adam = Adam(params, s["lrate"], s["weight_decay"])
        extras = self.extras0
        gen = torch.Generator(r.device)
        gen.set_state(self.drop_state)
        out = {"losses": []}
        for step, batch in enumerate(batches):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            key_list = [tuple(int(w) for w in k) for k in self.keys[step].tolist()]
            with counting(flops if step == 0 else None):
                loss, extras = r.ref.loss(leaves, extras, batch, key_list, r.graph, s, precision,
                                          generator=gen)
                grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(leaves.items(), grads)}
            used = adam.step(params, grads)
            if step == 0:
                out["raw_grad"], out["grad"] = grads, used
            out["losses"].append(float(loss.detach()))
        out["change"] = {k: params[k].double() - r.weights[k].double() for k in params}
        return out

    def unit_flops(self, dense: float, sparse: float) -> float:
        """A step's FLOPs: the reference's dense ones and the sparse products'."""
        return dense + sparse
