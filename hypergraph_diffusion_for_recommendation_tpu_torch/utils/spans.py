"""The program's spans: `torch.profiler.record_function` ranges at the
Trainer's and the evaluation's layer boundaries, which a profiler writes
into the same Chrome trace as the device's operations, on one clock.

`span(name)` opens the range only while a profiler records
(`torch.profiler.profile`, `torch.autograd.profiler.profile`, `emit_nvtx`);
otherwise it returns one shared `nullcontext`, so a span costs a check and
no `record_function` call. No span goes inside work that a CUDA graph
captures: it would record once, at the capture, and a replay's kernels
already carry the correlation of its `cudaGraphLaunch`.

The names, which the benchmark's readers and the tests cite from here
(":<phase>", or ":<phase>:<branch>", appended to the names that take it):

    trainer.epoch                     Trainer.run_epoch, whole (EPOCH)
    trainer.sample:<phase>            the epoch's batches: sample_epoch ("cf",
                                      with a joint model's KG batches), an
                                      alternating epoch's sample_kg_epoch ("kg")
    train_step:<phase>                each step of run_phase (STEP_ANNOTATION)
    trainer.loss_to_host:<phase>      run_phase's copy of the phase's sums to
                                      the host: the wait for its queued steps
    trainer.capture:<phase>:<branch>  a step graph's capture
    trainer.capture:encode            the encode graph's capture
    eval.encode                       Trainer.encode when it encodes
    eval.score                        a block's scoring product
    eval.topk                         a block's masked top-k (on a mesh, its
                                      sharded top-k)
    eval.metrics                      a block's hit, recall and NDCG sums
    eval.to_host                      the metrics' copy to the host
"""

from __future__ import annotations

import contextlib

import torch

EPOCH = "trainer.epoch"
SAMPLE = "trainer.sample"
STEP_ANNOTATION = "train_step"
LOSS_TO_HOST = "trainer.loss_to_host"
CAPTURE = "trainer.capture"
CAPTURE_ENCODE = CAPTURE + ":encode"
EVAL_ENCODE = "eval.encode"
EVAL_SCORE = "eval.score"
EVAL_TOPK = "eval.topk"
EVAL_METRICS = "eval.metrics"
EVAL_TO_HOST = "eval.to_host"

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A `record_function(name)` range while a profiler records, else a
    context that does nothing."""
    return torch.profiler.record_function(name) if _recording() else _OFF
