"""CUDA graphs: the port's counterpart of the JAX trainer's jitted scan body
and jitted encode.

A graph is captured once and replayed: a replay launches every kernel of
the captured work from one host call, at the addresses the capture saw.
So what a graph reads and writes stays in place between replays (the
parameters, the optimiser's state, the trainer's fixed input and extras
buffers), and whatever would have to come back to the host inside the
work cannot be there: a copy to the host or any other host sync during a
capture makes the capture raise. Nothing falls back to eager execution.

A trainer's graphs share one memory pool. What a graph leaves for later
is copied into tensors allocated outside the pool, so that the pool holds
only each replay's temporaries, and the graphs may replay in any order.

The kernel wrappers' `LAUNCHES` count Python calls, which a replay makes
none of; a captured graph carries, as `graph.launches`, the wrappers'
launches made during its capture, which is what each of its replays
launches.
"""

from __future__ import annotations

import torch

from ..ops.kernels import gather_fusion, segment_spmm
from ..utils.spans import CAPTURE_ENCODE, span


def _launches() -> dict:
    return {**segment_spmm.LAUNCHES, **gather_fusion.LAUNCHES}


def capture(fn, pool=None, generators=()):
    """(graph, outputs): `fn()` captured into a new CUDA graph whose
    temporaries come from the memory pool `pool`. The capture does not run
    the work; `graph.replay()` does, writing the same output tensors each
    time. `generators` are the CUDA generators `fn` draws from besides the
    default one: each replay then draws fresh numbers from their current
    state, as an eager call would. `graph.launches`: {kernel wrapper:
    launches} made during the capture (those above 0), which every replay
    launches again."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = _launches()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    graph.launches = {k: n - before[k] for k, n in _launches().items() if n != before[k]}
    return graph, out


class EncodeGraph:
    """`bundle.encode_eval(extras)` as a replayed CUDA graph over the
    parameters and the extras' tensors, which stay where they are (update
    them in place). The first call runs the encode once eagerly, which
    fills the layouts' caches, then captures it; every call replays it and
    returns the graph's tables, which the next call writes again."""

    def __init__(self, bundle, extras: dict, pool=None):
        self.bundle, self.extras, self.pool = bundle, extras, pool
        self.graph = self.tables = None

    @torch.no_grad()
    def __call__(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.graph is None:
            self.tables = tuple(torch.empty_like(t) for t in self.bundle.encode_eval(self.extras))

            def encode():
                for out, t in zip(self.tables, self.bundle.encode_eval(self.extras)):
                    out.copy_(t)

            with span(CAPTURE_ENCODE):
                self.graph, _ = capture(encode, self.pool)
        self.graph.replay()
        return self.tables
