"""Generic trainer — the port of the JAX package's `train/trainer.py`
(single device): pairwise batches, KGAT's alternating epoch, the sequence
batches of SASRec and CL4SRec, run artifacts and checkpoint/resume.

The lifecycle (reference base/recommender.py:80-114):
  Trainer.fit() -> per epoch [run_epoch -> evaluate -> plateau.step ->
  best-model vote -> early stopping] -> final metrics from the best state.

Where the JAX trainer runs an epoch, or a chunk of steps, as one jitted
`lax.scan` (`_build_epoch_fn`, `_build_chunk_fn`, `_run_epoch_chunked`)
with the state buffers donated (`_jit_hoisted`), the port samples the
epoch's batches and dropout keys on the card and, on a CUDA card, runs
each step as a replay of a CUDA graph of the step (`train_step`): the
graph holds zero_grad, the loss, the backward, the gradient clip, Adam's
update and the copy of the new extras into fixed buffers, one graph per
code path of the loss (full, and cached under cached propagation). The
state stays where it is, as donation keeps it in JAX: parameters, Adam's
moments, the extras buffers and the graphs' input buffers are updated in
place. The first step of each path runs eagerly (a real training step,
which fills Adam's state and the layouts' caches), the next is captured
and replayed. The loss and aux terms add up on the card and reach the
host once an epoch. The encode is a replayed graph too (`encode`).
`Trainer(..., graphs=False)` runs every step and encode eagerly on the
card; on the CPU they always run eagerly. A capture that meets a host
sync raises: there is no eager fallback.

Two hooks of the JAX trainer: a bundle's `update_extras` runs inside the
step (and its graph) before the loss, from the parameters before the
update (BUIR's EMA targets; AutoCF's masked subgraphs, drawn from the card
generator the loss draws from, in the graph of the branch that refreshes
them), and its `epoch_setup` runs eagerly at the start of each epoch
(NCL's k-means, SGL's augmented views); both write the extras buffers in
place. A bundle's `epoch_update_extras` runs eagerly after the epoch's
steps and before its evaluation (KGAT's attention refresh).

A bundle with `batch_kind == "sequence"` (SASRec, CL4SRec) trains on
shuffled [B, L] windows of its `seq` data with one negative per position
(`_sequence_epoch_batches`); its step graph's fixed inputs take those
shapes, and its dropout and augmentation draws come from the card
generator like any other loss's.

The alternating epoch (a bundle with `alternating`, KGAT; the JAX
trainer's `_build_alternating_epoch_fn`): a CF phase over the epoch's CF
batches with `batch_loss` and the CF optimiser, then a KG phase over
`n_kg_train // batch_size_kg + 1` KG batches drawn on their own, with
`kg_batch_loss` and a second optimiser over the same parameters (its own
Adam state, its own plateau schedule stepped on the KG phase's mean). Each
phase has its own step graphs, fixed input buffers, aux names and on-card
sums; every graph shares the trainer's memory pool. The epoch's loss is
cf_loss + kg_loss, each the mean of its phase's losses.

Parity points:
  * best-model vote: at K = max(topN), count the metrics that worsened
    against those that improved; a majority of improvements is a new
    best (base/main_recommender.py:138-160);
  * early stop on Recall@maxN not improving for `early_stopping_steps`
    (times the patience scale) epochs (util/evaluation.py:195-202);
  * ReduceLROnPlateau on the epoch mean train loss (KHGRec.py:191);
  * Adam with coupled weight decay updates every parameter each step,
    those the loss does not reach included, as optax does;
  * `bundle.grad_clip_norm` scales the gradients by min(1, c / (global
    norm + 1e-6)) before the update (the JAX step's clip).

Randomness comes from explicit generators seeded with `cfg.seed`: a CPU
one for the initial weights (the same as `Recommender.init_weights`), a
CPU one for the edge-dropout key words and the exact sampler's seeds, one
on the card for the redraw sampler, and one on the card that feature
dropout and the losses' other draws come from (passed to `batch_loss`;
each step graph draws from it at replay; `epoch_setup` draws from it
eagerly). A model with cached propagation keeps its step counter as
a host integer in the extras, so no step waits on the card to pick its
branch.

Checkpoints (`fit(ckpt=..., ckpt_every=...)`, `restore(ckpt)`, as the JAX
trainer's `fit` and `restore`, train/trainer.py:1080-1266): a checkpoint
holds the parameters, every phase's Adam state and learning rate, the
extras, the epoch and the three generators' states, so a resumed run's
next epoch equals the uninterrupted run's bit for bit. `restore` writes
into the tensors the step graphs read (parameters, Adam's state, extras
buffers); the plateau schedules are not saved (neither are they in the JAX
package). `Trainer(..., debug_nans=True)` runs every step eagerly under
`torch.autograd.detect_anomaly` and raises at the first non-finite loss.
`profile_epoch` runs an epoch under torch.profiler and writes a Chrome
trace that `utils/trace_analysis.py` reads. Under any profiler the trainer
records its spans (`utils/spans.py`), on the trace's clock: the epoch
(`trainer.epoch`), its sampling (`trainer.sample:<phase>`), each step
(`train_step:<phase>`, `STEP_ANNOTATION`), the wait for the phase's loss
(`trainer.loss_to_host:<phase>`), each graph's capture
(`trainer.capture:<phase>:<branch>`, `trainer.capture:encode`), the
encode (`eval.encode`), and in `evaluate` each block's `eval.score`,
`eval.topk` and `eval.metrics`, then `eval.to_host`. Without a profiler a
span is a check and nothing more. `replayed_launches` counts the kernel
wrappers' launches of the replayed graphs, which `LAUNCHES` does not see,
from each graph's captured launches and its replays.

Meshes (`Trainer(..., mesh=)`, a `parallel.make_mesh` mesh over the ranks
that `utils.platform.run_ranks` starts; the JAX trainer's GSPMD mesh,
trainer.py:234-252, 461-476, 940-975, 1090-1110). Every rank runs the step
the single-device trainer runs for the GLOBAL batch, from the same batches
and keys (every rank's generators are seeded alike):
  * the tables that `parallel.param_shardings` marks row-sharded live on
    each rank as its row block (`parallel.mesh.shard_tables`): the
    parameter and its Adam state are [rows / model, d], and reading the
    table all-gathers it over the model group;
  * adjacencies the bundle's data builds sharded (`shard_needs`) hold about
    nnz / model edges per rank (`parallel.sharded_adj`);
  * the data axis splits every model's batch (`ModelBundle.data_split`, which
    every builder sets for a mesh whose data axis is above 1, over
    `parallel.mesh.data_share`'s rows), as the JAX trainer's `_dp_constrain`
    shards it: each data rank computes the per-example work of its share,
    its loss is its share of the global batch's, and after the backward the
    gradients and the loss terms are summed over the data group, in one
    all_reduce. The propagation stays whole on every rank; the terms that
    couple the batch's rows read the whole activations: a contrast adds the
    terms of its share's rows over every row's denominator (SASRec and
    CL4SRec, whose encoder runs on the share's sequences, gather the other
    ranks' rows through `parallel.mesh.gather_shares`), the next attention is
    scored from the whole KG batch;
  * the gradient clip's norm adds the row blocks' squares over the model
    group;
  * evaluation with a model axis above 1 scores each rank's item block and
    merges the top-k over the group (`parallel.sharded_user_topk`);
  * the steps and the encode run eagerly (gloo's collectives of CUDA
    tensors go through the host, which a CUDA graph cannot hold):
    `graphs=True` with a mesh raises; a row-sharded table is gathered once
    a step or encode however often the model reads it
    (`torch.nn.utils.parametrize.cached`);
  * a checkpoint holds the whole tables, gathered over the model group
    (written by rank 0 alone: `fit(..., ckpt=)` calls `ckpt.save` on it),
    and every rank restores its own block: a checkpoint written on a mesh
    restores on one device and the reverse.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..eval import early_stopping
from ..eval.metrics import metrics_from_topk, metrics_to_host, ranking_metrics
from ..models.base import Extras, ModelBundle
from ..ops.dropout import epoch_key_words, key_words
from ..ops.sampling import (
    HostExactSampler,
    epoch_kg_batches,
    epoch_pairwise_batches,
    sample_negatives_chunked,
)
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_gather_cat,
    all_reduce_,
    axis_size,
    canonical_name,
    row_block,
    shard_tables,
    unshard_tables,
)
from ..utils.spans import (
    CAPTURE,
    EPOCH,
    EVAL_ENCODE,
    EVAL_TO_HOST,
    EVAL_TOPK,
    LOSS_TO_HOST,
    SAMPLE,
    STEP_ANNOTATION,
    span,
)
from .graphs import EncodeGraph, capture
from .optim import PlateauState, make_optimizer, set_lr

_FROZEN_EPOCHS = 10
# eager steps of each code path of the loss before its step graph is
# captured: a real step, which fills Adam's state and the layouts' caches
# (the dedup layout's parts are cut on the host at first use)
GRAPH_WARMUP_STEPS = 1


@dataclass
class EpochRecord:
    epoch: int
    train_time: float
    test_time: float
    losses: dict
    metrics: dict  # {N: {metric: value}}


@dataclass
class FitResult:
    best_epoch: int
    best_metrics: dict
    history: list[EpochRecord] = field(default_factory=list)
    final_metrics: dict | None = None
    examples_per_sec: float = 0.0


@dataclass
class _Phase:
    """One loss's step state (the CF phase; the KG phase of an alternating
    epoch): its optimiser, the step graphs' fixed (batch, keys) inputs and
    their loss and aux terms (outside the graphs' pool), the aux names of
    its first step, and the loss and aux terms summed on the card since the
    phase began."""

    opt: torch.optim.Optimizer
    inputs: Optional[tuple] = None
    stats: Optional[torch.Tensor] = None
    aux_names: Optional[list] = None
    sums: Optional[torch.Tensor] = None


def _graph_key(phase: str, branch: str) -> str:
    """The step graph's name: the loss's code path, prefixed in the KG phase."""
    return branch if phase == "cf" else f"{phase}:{branch}"


def clip_grads_(grads: list[torch.Tensor], max_norm: float, blocks=(), group=None) -> None:
    """Scale `grads` in place by min(1, max_norm / (norm + 1e-6)), the
    norm over all of them (`optax.global_norm`), as the JAX step clips;
    nothing is read on the host. `blocks`: the positions of row blocks of
    tables sharded over `group`, whose squares are summed over it."""
    norms = torch.stack(torch._foreach_norm(grads))
    if blocks:
        sq = torch.square(norms)
        mask = torch.zeros_like(sq, dtype=torch.bool)
        mask[list(blocks)] = True
        sharded = all_reduce_(torch.where(mask, sq, 0.0).sum(), group)
        norm = torch.sqrt(torch.where(mask, 0.0, sq).sum() + sharded)
    else:
        norm = torch.linalg.vector_norm(norms)
    # a true division: a Python number over a CUDA tensor is a reciprocal product
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)


class Trainer:
    def __init__(self, bundle: ModelBundle, seed: Optional[int] = None,
                 extras: Optional[Extras] = None, graphs: Optional[bool] = None,
                 debug_nans: bool = False, mesh=None):
        """`extras` given: train from the module's current weights with
        (a copy of) these extras; else initialise both from `seed` (default
        `cfg.seed`). `graphs`: None runs the steps and the encode as CUDA
        graphs on a CUDA card and eagerly on the CPU; False runs them
        eagerly on the card too. `debug_nans`: every step eager, under
        anomaly detection, raising at the first non-finite loss. `mesh`:
        train on every rank of the mesh (the module's docstring), eagerly;
        build the bundle with the same mesh (`build_model(..., mesh=)`)."""
        if bundle.batch_loss is None:
            raise ValueError(f"{bundle.name} has no training loss in the port yet")
        self.bundle = bundle
        self.cfg = cfg = bundle.cfg
        seed = cfg.seed if seed is None else seed
        self.device = bundle.cf.edge_u.device
        self.debug_nans = debug_nans
        self.mesh = mesh
        if mesh is not None:
            if graphs:
                raise ValueError("a mesh's steps run eagerly: their collectives cannot be "
                                 "captured in a CUDA graph (graphs=True with a mesh)")
            graphs = False
        if debug_nans:
            graphs = False
        elif graphs is None:
            graphs = self.device.type == "cuda"
        elif graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need the model on a CUDA card, not {self.device}")
        self.graphs = graphs
        raw = [n for n, _ in bundle.module.named_parameters()]
        names = [canonical_name(n) for n in raw]
        if extras is None and names != raw:
            unshard_tables(bundle.module)  # a mesh trainer sharded it: init the whole tables
        init = bundle.init(torch.Generator().manual_seed(seed)) if extras is None else extras
        self.sharded: list[str] = []
        self._data_group = self._model_group = None
        if mesh is not None:
            self.sharded = shard_tables(bundle.module, mesh, cfg.shard_min_rows)
            self._model_group = mesh.get_group(MODEL_AXIS)
            if bundle.data_split:
                self._data_group = mesh.get_group(DATA_AXIS)
        elif bundle.data_split:
            raise ValueError(f"{bundle.name} was built for a mesh's data axis: give the "
                             "trainer the same mesh")
        # the trainer's own buffers, which every step writes in place
        self.extras = {k: v.clone() if torch.is_tensor(v) else v for k, v in init.items()}
        self.host_gen = torch.Generator().manual_seed(seed + 1)
        self.dev_gen = torch.Generator(self.device).manual_seed(seed + 2)
        self.drop_gen = torch.Generator(self.device).manual_seed(seed + 3)
        # in the unsharded module's order under the unsharded names, on a
        # mesh too (a row block stands where its table stood)
        by_name = {canonical_name(n): p for n, p in bundle.module.named_parameters()}
        self._param_names = names
        self._params = [by_name[n] for n in names]
        for p in self._params:
            # zero, not None: Adam then updates (decays) every parameter, and
            # the backward adds into these tensors in place. A gradient that
            # is there already (another trainer of this module) stays: that
            # trainer's step graphs write it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt = make_optimizer(self._params, cfg.lrate, cfg.weight_decay)
        self.plateau = PlateauState(lr=cfg.lrate, factor=cfg.lr_decay, patience=cfg.lr_patience)
        self._phases = {"cf": _Phase(self.opt)}
        if bundle.alternating:
            # KGAT: two Adam instances over the same parameters (KGAT.py:66-67)
            self.kg_opt = make_optimizer(self._params, cfg.lrate, cfg.weight_decay)
            self.kg_plateau = PlateauState(lr=cfg.lrate, factor=cfg.lr_decay,
                                           patience=cfg.lr_patience)
            self._phases["kg"] = _Phase(self.kg_opt)
            self.n_kg_batches = bundle.kg.n_kg_train // cfg.batch_size_kg + 1
        sequence = bundle.batch_kind == "sequence"
        n_rows = bundle.seq.seq.shape[0] if sequence else bundle.cf.n_train
        self.n_batches = -(-n_rows // cfg.batch_size)
        if cfg.sampler not in ("redraw", "exact"):
            raise ValueError(f"sampler {cfg.sampler!r} is not 'redraw' or 'exact'")
        if sequence and cfg.sampler == "exact":
            raise ValueError("--sampler=exact is not supported for sequence models "
                             "(their negatives are drawn on the card with the epoch's windows)")
        self._exact = self._make_exact_sampler() if cfg.sampler == "exact" else None
        # the state the cached encode was taken at: bumped by every step
        # and every restore
        self._version = 0
        self._encoded = None
        # graph mode: one memory pool for every graph of this trainer
        self._pool = torch.cuda.graph_pool_handle() if graphs else None
        # code path (a KG phase's prefixed "kg:") -> (graph, host-value steps)
        self._step_graphs = {}
        self.replays = {}  # graph key (a step graph's; "encode") -> replays
        self._eager_steps = {}  # code path -> eager steps taken
        self._encode_graph = None
        self._frozen = False  # a graph reads the extras buffers: they stay where they are

    # -- batches ---------------------------------------------------------
    def _make_exact_sampler(self) -> HostExactSampler:
        b = self.bundle
        kw = {}
        if b.uses_kg:
            n = b.kg.n_kg_train
            kw = dict(kg_heads=b.kg.att_h[:n].cpu().numpy(),
                      kg_relations=b.kg.att_r[:n].cpu().numpy(),
                      kg_tails=b.kg.att_t[:n].cpu().numpy(), n_entities=b.kg.n_entities)
        return HostExactSampler(b.cf.edge_u.cpu().numpy(), b.cf.edge_i.cpu().numpy(),
                                b.cf.n_items, **kw)

    def _host_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.host_gen))

    def sample_epoch(self) -> tuple[torch.Tensor, ...]:
        """One epoch of batches on the card: (users, pos, neg) and, for a
        KG model that is not alternating, (h, r, pos_t, neg_t), each
        [n_batches, B] int32 (an alternating model's KG batches come from
        `sample_kg_epoch`); for a sequence model (seq, pos, y, neg, valid),
        [n_batches, B, L] and [n_batches, B]."""
        b, cfg = self.bundle, self.cfg
        cf = b.cf
        if b.batch_kind == "sequence":
            return _sequence_epoch_batches(self.dev_gen, b.seq, cfg.batch_size,
                                           cfg.neg_resample_rounds)
        joint = b.uses_kg and not b.alternating
        if self._exact is not None:
            host = self._exact.pairwise(self._host_seed(), cfg.batch_size)
            batches = tuple(torch.as_tensor(a, device=self.device) for a in host)
        else:
            batches = epoch_pairwise_batches(
                self.dev_gen, cf.edge_u, cf.edge_i, cf.sample_membership, cf.n_items,
                cfg.batch_size, cfg.neg_resample_rounds)
        if joint:
            batches += self._kg_batches(batches[0].shape[0])
        return batches

    def _kg_batches(self, n_batches: int) -> tuple[torch.Tensor, ...]:
        """`n_batches` KG batches on the card (the exact sampler's on the host)."""
        cfg, kg = self.cfg, self.bundle.kg
        if self._exact is not None:
            host = self._exact.kg_batches(self._host_seed(), n_batches, cfg.batch_size_kg)
            return tuple(torch.as_tensor(a, device=self.device) for a in host)
        n = kg.n_kg_train
        return epoch_kg_batches(
            self.dev_gen, kg.att_h[:n], kg.att_r[:n], kg.att_t[:n], kg.head_tails,
            kg.n_entities, n_batches, cfg.batch_size_kg, cfg.neg_resample_rounds)

    def sample_kg_epoch(self) -> tuple[torch.Tensor, ...]:
        """An alternating epoch's KG batches on the card, drawn on their own:
        (h, r, pos_t, neg_t), each [n_kg_batches, B_kg] int32."""
        return self._kg_batches(self.n_kg_batches)

    def edge_keys(self) -> tuple[tuple[int, int], ...]:
        """Fresh dropout key words, one pair per adjacency the model drops."""
        return tuple(key_words(self.host_gen) for _ in range(self.bundle.n_edge_keys))

    def epoch_keys(self, n_steps: int) -> torch.Tensor:
        """[n_steps, n_edge_keys, 2] dropout key words on the card: the words
        `n_steps` calls of `edge_keys` would draw, in one copy."""
        return epoch_key_words(self.host_gen, n_steps, self.bundle.n_edge_keys).to(self.device)

    # -- steps -----------------------------------------------------------
    def _store(self, name: str, value: torch.Tensor) -> None:
        """Write a new extras tensor into its buffer in place."""
        buf = self.extras.get(name)
        if torch.is_tensor(buf) and buf.shape == value.shape and buf.dtype == value.dtype:
            if buf is not value:
                buf.copy_(value)
        elif self._frozen:
            raise ValueError(f"extras[{name!r}] changed its shape or dtype after a CUDA graph "
                             f"was captured over its buffer")
        else:
            self.extras[name] = value.detach().clone()

    def _step_body(self, batch, edge_keys, phase: str = "cf") -> tuple[torch.Tensor, dict]:
        """The training step as a step graph holds it: zero_grad, loss,
        backward, clip, the phase's Adam, the new extras tensors written into
        their buffers, the loss and aux terms added to the phase's sums.
        Returns (stats: the loss then the aux terms in the phase's
        `aux_names` order, the new host values of the extras). In the CF
        phase a bundle's `update_extras` runs first, from the parameters
        before the step, and its tensors are written into their buffers
        before the loss reads them; the KG phase runs `kg_batch_loss`."""
        b, ph = self.bundle, self._phases[phase]
        if phase == "cf" and b.update_extras is not None:
            with torch.no_grad():
                for k, v in b.update_extras(self.extras, batch, self.drop_gen).items():
                    self._store(k, v)
        ph.opt.zero_grad(set_to_none=False)
        loss_fn = b.batch_loss if phase == "cf" else b.kg_batch_loss
        with self._tables_gathered():
            loss, aux = loss_fn(self.extras, batch, edge_keys, self.drop_gen)
        loss.backward()
        new_extras = aux.pop("_new_extras", None) or {}
        if ph.aux_names is None:
            ph.aux_names = sorted(aux)
        elif sorted(aux) != ph.aux_names:
            raise ValueError(f"{b.name}: a {phase} step's aux terms {sorted(aux)} differ from "
                             f"the first step's {ph.aux_names}")
        stats = torch.stack([loss.detach()] + [aux[k] for k in ph.aux_names])
        if self._data_group is not None:
            stats = self._sum_over_data(stats)
        if b.grad_clip_norm is not None:
            blocks = [k for k, n in enumerate(self._param_names) if n in self.sharded]
            clip_grads_([p.grad for p in self._params], b.grad_clip_norm, blocks,
                        self._model_group)
        ph.opt.step()
        host = {}
        for k, v in new_extras.items():
            if torch.is_tensor(v):
                self._store(k, v)
            else:
                host[k] = v
        if ph.sums is None:
            ph.sums = torch.zeros_like(stats)
        ph.sums += stats
        return stats, host

    def _sum_over_data(self, stats: torch.Tensor) -> torch.Tensor:
        """Every gradient and `stats` (the data rank's shares of the loss
        terms) summed over the data group, in one all_reduce of their
        concatenation; returns the summed stats."""
        grads = [p.grad for p in self._params]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads] + [stats]), self._data_group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[offset:]

    def _tables_gathered(self):
        """On a mesh, a context in which each row-sharded table is gathered
        once, at its first read; else none."""
        if not self.sharded:
            return contextlib.nullcontext()
        from torch.nn.utils import parametrize

        return parametrize.cached()

    def _replay(self, phase: str, branch: str, batch, edge_keys) -> torch.Tensor:
        """The step as a replay of the graph of `branch` of `phase`, captured
        at its first use, with the batch and keys copied into the phase's
        fixed inputs."""
        ph = self._phases[phase]
        keys = (edge_keys if torch.is_tensor(edge_keys)
                else torch.tensor(edge_keys, dtype=torch.int64).reshape(-1, 2))
        if ph.inputs is None:
            ph.inputs = (tuple(torch.empty_like(t) for t in batch),
                         torch.empty(keys.shape, dtype=torch.int64, device=self.device))
        in_batch, in_keys = ph.inputs
        for buf, t in zip(in_batch, batch):
            buf.copy_(t)
        in_keys.copy_(keys)
        key = _graph_key(phase, branch)
        if key not in self._step_graphs:
            before = dict(self.extras)
            self._frozen = True
            if ph.stats is None:
                ph.stats = torch.empty(1 + len(ph.aux_names), device=self.device)

            def step():
                stats, host = self._step_body(in_batch, in_keys, phase)
                ph.stats.copy_(stats)
                return host

            with span(f"{CAPTURE}:{phase}:{branch}"):
                graph, host = capture(step, self._pool, (self.drop_gen,))
            # a host value's change in one step (cached propagation's age: +1)
            self._step_graphs[key] = (graph, {k: v - before[k] for k, v in host.items()})
        graph, host_steps = self._step_graphs[key]
        graph.replay()
        self.replays[key] = self.replays.get(key, 0) + 1
        for k, d in host_steps.items():
            self.extras[k] += d
        return ph.stats

    def train_step(self, batch, edge_keys, phase: str = "cf") -> tuple[torch.Tensor, dict]:
        """One optimiser step on one batch of `phase` ("cf"; an alternating
        model's "kg" steps its KG loss with its KG optimiser); returns the
        (detached) loss and aux terms, still on the card (in graph mode views
        of one buffer, which the phase's next step writes again).
        `edge_keys`: one pair of dropout key words per dropped adjacency, as
        integers or as an int64 tensor [n_edge_keys, 2]. In graph mode each
        code path of each phase runs `GRAPH_WARMUP_STEPS` eager steps, then
        is captured, then replayed."""
        b = self.bundle
        if phase not in self._phases:
            raise ValueError(f"{b.name} has no {phase!r} phase")
        branch = b.step_branch(self.extras) if b.step_branch is not None else "full"
        key = _graph_key(phase, branch)
        eager = self._eager_steps.get(key, 0)
        if self.debug_nans:
            with torch.autograd.detect_anomaly():
                stats, host = self._step_body(batch, edge_keys, phase)
            self.extras.update(host)
            if not torch.isfinite(stats[0]):
                raise FloatingPointError(f"{b.name}: non-finite {phase} loss {float(stats[0])} "
                                         f"at step {self._version}")
        elif not self.graphs or eager < GRAPH_WARMUP_STEPS:
            self._eager_steps[key] = eager + 1
            stats, host = self._step_body(batch, edge_keys, phase)
            self.extras.update(host)
        else:
            stats = self._replay(phase, branch, batch, edge_keys)
        self._version += 1
        return stats[0], dict(zip(self._phases[phase].aux_names, stats[1:]))

    def _write_extras(self, hook) -> None:
        """Run an epoch hook (`epoch_setup`, `epoch_update_extras`) eagerly
        from the card generator and copy its tensors into the extras
        buffers in place, where the step and encode graphs read them."""
        if hook is None:
            return
        with torch.no_grad():
            for k, v in hook(self.extras, self.drop_gen).items():
                self._store(k, v)
        self._version += 1

    def begin_epoch(self) -> None:
        """A bundle's `epoch_setup`, run before the epoch's steps (the JAX
        epoch runs it before its scan)."""
        self._write_extras(self.bundle.epoch_setup)

    def end_epoch(self) -> None:
        """A bundle's `epoch_update_extras`, run after the epoch's steps and
        before its evaluation (KGAT's attention refresh: the first epoch
        trains on the zero attention, KGAT.py:128-133)."""
        self._write_extras(self.bundle.epoch_update_extras)

    def run_phase(self, batches, phase: str = "cf") -> list[float]:
        """Every step of one phase over `batches` ([n, B] tensors); returns
        the means of its loss and aux terms over the steps (loss first, then
        `aux_names` order), copied to the host once."""
        n = batches[0].shape[0]
        keys = self.epoch_keys(n)
        ph = self._phases[phase]
        if ph.sums is not None:
            ph.sums.zero_()
        step = f"{STEP_ANNOTATION}:{phase}"
        for s in range(n):
            with span(step):
                self.train_step(tuple(t[s] for t in batches), keys[s], phase)
        with span(f"{LOSS_TO_HOST}:{phase}"):
            return (ph.sums / n).cpu().tolist()

    def run_epoch(self, epoch: int) -> tuple[float, dict]:
        with span(EPOCH):
            self.begin_epoch()
            with span(f"{SAMPLE}:cf"):
                batches = self.sample_epoch()
            means = self.run_phase(batches)
            if self.bundle.alternating:
                with span(f"{SAMPLE}:kg"):
                    kg_batches = self.sample_kg_epoch()
                kg_means = self.run_phase(kg_batches, "kg")
                aux = {"cf_loss": means[0], "kg_loss": kg_means[0]}
                loss = means[0] + kg_means[0]
            else:
                loss = means[0]
                aux = dict(zip(self._phases["cf"].aux_names, means[1:]))
            self.end_epoch()
            # NaN guard: the reference checks every batch (KGAT.py:96-97);
            # here a non-finite epoch mean fails the epoch
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite train loss ({loss}) at epoch {epoch + 1} for {self.cfg.model}")
            aux["train_loss"] = loss
            return loss, aux

    def profile_epoch(self, trace_dir: str, epoch: int = 0) -> tuple[float, dict]:
        """`run_epoch` under torch.profiler (CPU activity, and CUDA on a card),
        its replayed step graphs included; writes the Chrome trace as
        `<trace_dir>/epoch_<epoch>.<ns>.pt.trace.json` (read by
        `utils.trace_analysis`; view with Perfetto or chrome://tracing) and
        returns what `run_epoch` returns."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            out = self.run_epoch(epoch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"epoch_{epoch}.{time.time_ns()}.pt.trace.json"))
        return out

    # -- evaluation --------------------------------------------------------
    @torch.no_grad()
    def encode(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The full-graph tables of the current state (cached until the
        next step or restore); in graph mode the encode graph's outputs,
        which the next encode writes again."""
        if self._encoded is None or self._encoded[0] != self._version:
            with span(EVAL_ENCODE):
                if self.graphs:
                    if self._encode_graph is None:
                        self._frozen = True
                        self._encode_graph = EncodeGraph(self.bundle, self.extras, self._pool)
                    tables = self._encode_graph()
                    self.replays["encode"] = self.replays.get("encode", 0) + 1
                else:
                    with self._tables_gathered():
                        tables = self.bundle.encode_eval(self.extras)
            self._encoded = (self._version, tables)
        return self._encoded[1]

    def replayed_launches(self) -> dict:
        """{kernel wrapper: launches} of every replay of this trainer's step
        and encode graphs so far: each graph's launches in its capture times
        its replays (the wrappers' `LAUNCHES` count Python calls, which a
        replay makes none of)."""
        graphs = {k: g for k, (g, _) in self._step_graphs.items()}
        if self._encode_graph is not None:
            graphs["encode"] = self._encode_graph.graph
        out = {}
        for key, n in self.replays.items():
            for name, per in graphs[key].launches.items():
                out[name] = out.get(name, 0) + n * per
        return out

    def evaluate(self) -> dict:
        cfg, cf = self.cfg, self.bundle.cf
        u, i = self.encode()
        top_ns = tuple(cfg.top_ns)
        if self.mesh is not None and axis_size(self.mesh, MODEL_AXIS) > 1:
            # the item table as row blocks: each rank's top-k of its block,
            # merged over the model group (the JAX trainer, trainer.py:940-975)
            from ..parallel.topk import sharded_user_topk

            ed, block = cf.eval_data, cfg.eval_user_batch
            local = row_block(i, self.mesh)
            ids = []
            for s in range(0, ed.test_users.shape[0], block):
                users = ed.test_users[s:s + block].long()
                with span(EVAL_TOPK):
                    ids.append(sharded_user_topk(self.mesh, u[users], local, cf.rated_pad[users],
                                                 max(top_ns), i.shape[0])[1])
            m = metrics_from_topk(torch.cat(ids), ed, top_ns, block=block)
        else:
            m = ranking_metrics(u, i, cf.rated_pad, cf.eval_data, top_ns,
                                block=cfg.eval_user_batch)
        with span(EVAL_TO_HOST):
            return metrics_to_host(m, top_ns)

    def snapshot(self, optimizer: bool = False):
        """Copies of the parameters and the extras; with `optimizer`, also
        of each phase's Adam state and the generators' states, so that
        `restore` brings back the whole training state (after at least one
        step of each phase)."""
        snap = ({k: v.detach().clone() for k, v in self.bundle.module.state_dict().items()},
                {k: v.clone() if torch.is_tensor(v) else v for k, v in self.extras.items()})
        if optimizer:
            adam = [[{k: v.clone() for k, v in ph.opt.state[p].items()} for p in self._params]
                    for ph in self._phases.values()]
            gens = [g.get_state() for g in (self.host_gen, self.dev_gen, self.drop_gen)]
            snap += (adam, gens)
        return snap

    def checkpoint_state(self, epoch: int) -> dict:
        """What a checkpoint holds after `epoch`: copies on the card of the
        whole training state (`snapshot(optimizer=True)`), which the next
        steps do not touch, and each phase's learning rate. On a mesh the
        row-sharded tables and their Adam state are gathered whole over the
        model group (every rank calls it), under the unsharded names."""
        params, extras, adam, gens = self.snapshot(optimizer=True)
        if self.sharded:
            params, adam = self._tables(params, adam, whole=True)
        lrs = [float(ph.opt.param_groups[0]["lr"]) for ph in self._phases.values()]
        return dict(epoch=epoch, params=params, extras=extras, adam=adam, lrs=lrs,
                    generators=gens)

    def _tables(self, params: dict, adam: list, whole: bool) -> tuple[dict, list]:
        """A snapshot's parameters and Adam state with the sharded tables
        whole (gathered over the model group, under the unsharded names), or
        with `whole=False` the inverse: this rank's row blocks, under the
        module's (parametrized) state-dict names."""
        names = {canonical_name(k): k for k in self.bundle.module.state_dict()}

        def convert(name, t):
            if name not in self.sharded:
                return t
            return all_gather_cat(t, self._model_group) if whole else row_block(t, self.mesh)

        params = {(canonical_name(k) if whole else names[k]): convert(canonical_name(k), v)
                  for k, v in params.items()}
        adam = [[{k: convert(n, v) if k != "step" else v for k, v in st.items()}
                 for n, st in zip(self._param_names, states)] for states in adam]
        return params, adam

    def restore(self, src) -> Optional[int]:
        """Copy a snapshot back in place, or resume from a checkpoint
        manager's latest checkpoint and return the epoch to start from (0
        without one). The parameters, the extras buffers and each phase's
        Adam state keep the addresses the graphs read; a trainer that has
        not stepped yet gets Adam's state from the snapshot."""
        if hasattr(src, "latest_step"):  # a utils.checkpoint.CheckpointManager
            state = src.restore()
            if state is None:
                return 0
            params, adam = state["params"], state["adam"]
            if self.sharded:
                params, adam = self._tables(params, adam, whole=False)
            self.restore((params, state["extras"], adam, state["generators"]))
            for ph, lr in zip(self._phases.values(), state["lrs"]):
                set_lr(ph.opt, lr)
            return state["epoch"] + 1
        snap = src
        self.bundle.module.load_state_dict(snap[0])
        for k, v in snap[1].items():
            if torch.is_tensor(v):
                self._store(k, v)
            else:
                self.extras[k] = v
        if len(snap) > 2:
            for ph, states in zip(self._phases.values(), snap[2]):
                on_card = ph.opt.defaults.get("capturable") or ph.opt.defaults.get("fused")
                for p, saved in zip(self._params, states):
                    live = ph.opt.state[p]
                    for k, v in saved.items():
                        if k in live:
                            live[k].copy_(v)
                        else:  # no step yet, so no graph reads it
                            dev = p.device if k != "step" or on_card else torch.device("cpu")
                            live[k] = v.to(dev, copy=True)
            for g, state in zip((self.host_gen, self.dev_gen, self.drop_gen), snap[3]):
                g.set_state(state)
        self._version += 1
        return None

    def fit(self, max_epoch: Optional[int] = None, log_fn=print, quiet: bool = False,
            artifacts=None, ckpt=None, ckpt_every: int = 10, start_epoch: int = 0) -> FitResult:
        """Epochs `start_epoch`..`max_epoch - 1` (default `cfg.max_epoch`),
        then the final evaluation from the best epoch's state. `artifacts`
        (a `utils.logging.RunArtifacts`) gets each epoch's record and the
        result; `ckpt` (a `utils.checkpoint.CheckpointManager`) saves the
        state after every `ckpt_every`-th epoch."""
        cfg = self.cfg
        max_epoch = cfg.max_epoch if max_epoch is None else max_epoch
        max_n = cfg.max_n
        result = FitResult(best_epoch=-1, best_metrics={})
        best_perf: dict | None = None
        best = self.snapshot()
        recall_list: list[float] = []
        loss_list: list[float] = []
        frozen_warned = False
        last_metrics: dict | None = None
        examples = 0
        train_time_total = 0.0
        scale = (cfg.early_stop_patience_scale if cfg.early_stop_patience_scale > 0
                 else self.bundle.early_stop_patience_scale)
        patience = cfg.early_stopping_steps * scale

        for ep in range(start_epoch, max_epoch):
            t0 = time.time()
            loss, aux = self.run_epoch(ep)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.time()
            examples += self.n_batches * cfg.batch_size
            train_time_total += t1 - t0
            if ep % max(cfg.evaluate_every, 1) == 0 or last_metrics is None:
                last_metrics = self.evaluate()
            metrics = last_metrics
            perf = metrics[max_n]
            # best-model vote (base/main_recommender.py:138-160)
            if best_perf is None or sum(1 if best_perf[k] > perf[k] else -1
                                        for k in best_perf) < 0:
                best_perf, result.best_epoch = dict(perf), ep + 1
                best = self.snapshot()
            if not self.bundle.lr_plateau:
                pass  # the reference trains this model at a fixed rate
            elif self.bundle.alternating:
                # a schedule per phase on its own mean loss (KGAT.py:68-69,140-141)
                self.plateau = self.plateau.step(aux["cf_loss"])
                self.kg_plateau = self.kg_plateau.step(aux["kg_loss"])
                set_lr(self.opt, self.plateau.lr)
                set_lr(self.kg_opt, self.kg_plateau.lr)
            else:
                self.plateau = self.plateau.step(loss)
                set_lr(self.opt, self.plateau.lr)
            if ckpt is not None and (ep + 1) % ckpt_every == 0:
                state = self.checkpoint_state(ep)
                if self.mesh is None or dist.get_rank() == 0:
                    ckpt.save(ep, state)
            eval_t = time.time() - t1
            record = EpochRecord(ep, t1 - t0, eval_t, aux, metrics)
            result.history.append(record)
            if artifacts is not None:
                artifacts.on_epoch(record)
            if not quiet:
                log_fn(f"epoch {ep + 1:3d} loss {loss:.4f} "
                       + " ".join(f"{k}@{max_n}:{v:.5f}" for k, v in perf.items())
                       + f" (train {t1 - t0:.2f}s eval {eval_t:.2f}s)")
            recall_list.append(perf["recall"])
            loss_list.append(float(loss))
            if not frozen_warned and _loss_frozen(loss_list):
                frozen_warned = True
                log_fn(f"WARNING: training appears FROZEN — identical epoch loss {loss:.6f} "
                       f"for {_FROZEN_EPOCHS} consecutive epochs despite fresh negative "
                       f"samples; embedding norms have likely collapsed to zero")
            _, should_stop = early_stopping(recall_list, patience, cfg.early_stop_smooth)
            if should_stop:
                if not quiet:
                    log_fn(f"early stop at epoch {ep + 1}")
                break

        # final test with the best state (base/main_recommender.py:179-181)
        self.restore(best)
        result.best_metrics = best_perf or {}
        result.final_metrics = self.evaluate()
        result.examples_per_sec = examples / max(train_time_total, 1e-9)
        if artifacts is not None:
            artifacts.finish(result)
        return result


def _sequence_epoch_batches(generator: torch.Generator, seq_data, batch_size: int,
                            rounds: int) -> tuple[torch.Tensor, ...]:
    """One epoch of shuffled sequence windows on the card, with one negative
    per position (`next_batch_sequence`, util/sampler.py:292-320): the rows
    permuted, cut into ceil(n / B) batches, the tail filled by wrapping
    around the permutation (modulo n: the JAX package's concat([perm,
    perm[:total - n]]) wherever that is defined), and negatives redrawn
    against the user's history, 1-based, 0 where the target is padding.
    Returns (seq, pos, y, neg) [n_batches, B, L] int32 and the rows' valid
    mask [n_batches, B]."""
    n = seq_data.seq.shape[0]
    dev = seq_data.seq.device
    n_batches = -(-n // batch_size)
    perm = torch.randperm(n, generator=generator, device=dev)
    idx = perm[torch.arange(n_batches * batch_size, device=dev) % n]

    def rows(t):
        return t[idx].reshape((n_batches, batch_size) + tuple(t.shape[1:]))

    seq, pos, y, valid = (rows(t) for t in (seq_data.seq, seq_data.pos, seq_data.y,
                                            seq_data.seq_valid))
    length = seq.shape[-1]
    users = rows(seq_data.seq_user).repeat_interleave(length, dim=1)  # [n_batches, B * L]
    # drawn 0-based against the 0-based history (pad -2: never an item), then shifted
    negs0 = sample_negatives_chunked(generator, users, seq_data.rated_pad_1b - 1,
                                     seq_data.n_items, rounds)
    neg = (negs0 + 1).reshape(n_batches, batch_size, length)
    return seq, pos, y, torch.where(y > 0, neg, 0), valid


def _loss_frozen(loss_list: list[float], n: int = _FROZEN_EPOCHS) -> bool:
    """True when the last n epoch losses are bit-identical, or all NaN:
    with fresh negatives every epoch that means the parameters stopped
    moving (the norm-collapse signature)."""
    if len(loss_list) < n:
        return False
    tail = loss_list[-n:]
    if math.isnan(tail[0]):
        return all(math.isnan(x) for x in tail)
    return all(x == tail[0] for x in tail)
