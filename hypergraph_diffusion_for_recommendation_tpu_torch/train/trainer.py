"""Generic trainer — the port of the JAX package's `train/trainer.py`,
the pairwise, non-alternating, single-device subset.

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
update (BUIR's EMA targets), and its `epoch_setup` runs eagerly at the
start of each epoch (NCL's k-means); both write the extras buffers in
place.

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
branch. Meshes, checkpoints and the alternating KGAT path wait.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..eval import early_stopping
from ..eval.metrics import metrics_to_host, ranking_metrics
from ..models.base import Extras, ModelBundle
from ..ops.dropout import epoch_key_words, key_words
from ..ops.sampling import HostExactSampler, epoch_kg_batches, epoch_pairwise_batches
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


def clip_grads_(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale `grads` in place by min(1, max_norm / (norm + 1e-6)), the
    norm over all of them (`optax.global_norm`), as the JAX step clips;
    nothing is read on the host."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    # a true division: a Python number over a CUDA tensor is a reciprocal product
    scale = torch.clamp(torch.full_like(norm, max_norm) / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)


class Trainer:
    def __init__(self, bundle: ModelBundle, seed: Optional[int] = None,
                 extras: Optional[Extras] = None, graphs: Optional[bool] = None):
        """`extras` given: train from the module's current weights with
        (a copy of) these extras; else initialise both from `seed` (default
        `cfg.seed`). `graphs`: None runs the steps and the encode as CUDA
        graphs on a CUDA card and eagerly on the CPU; False runs them
        eagerly on the card too."""
        if bundle.batch_loss is None:
            raise ValueError(f"{bundle.name} has no training loss in the port yet")
        self.bundle = bundle
        self.cfg = cfg = bundle.cfg
        seed = cfg.seed if seed is None else seed
        self.device = bundle.cf.edge_u.device
        if graphs is None:
            graphs = self.device.type == "cuda"
        elif graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need the model on a CUDA card, not {self.device}")
        self.graphs = graphs
        init = bundle.init(torch.Generator().manual_seed(seed)) if extras is None else extras
        # the trainer's own buffers, which every step writes in place
        self.extras = {k: v.clone() if torch.is_tensor(v) else v for k, v in init.items()}
        self.host_gen = torch.Generator().manual_seed(seed + 1)
        self.dev_gen = torch.Generator(self.device).manual_seed(seed + 2)
        self.drop_gen = torch.Generator(self.device).manual_seed(seed + 3)
        self._params = list(bundle.module.parameters())
        for p in self._params:
            # zero, not None: Adam then updates (decays) every parameter, and
            # the backward adds into these tensors in place. A gradient that
            # is there already (another trainer of this module) stays: that
            # trainer's step graphs write it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt = make_optimizer(self._params, cfg.lrate, cfg.weight_decay)
        self.plateau = PlateauState(lr=cfg.lrate, factor=cfg.lr_decay, patience=cfg.lr_patience)
        self.n_batches = -(-bundle.cf.n_train // cfg.batch_size)
        if cfg.sampler not in ("redraw", "exact"):
            raise ValueError(f"sampler {cfg.sampler!r} is not 'redraw' or 'exact'")
        self._exact = self._make_exact_sampler() if cfg.sampler == "exact" else None
        # the state the cached encode was taken at: bumped by every step
        # and every restore
        self._version = 0
        self._encoded = None
        # graph mode: one memory pool for every graph of this trainer
        self._pool = torch.cuda.graph_pool_handle() if graphs else None
        self._step_graphs = {}  # code path -> (graph, host-value steps)
        self._stats = None  # the step graphs' loss and aux terms, outside their pool
        self._eager_steps = {}  # code path -> eager steps taken
        self._inputs = None  # the step graphs' fixed (batch, keys) buffers
        self._encode_graph = None
        self._frozen = False  # a graph reads the extras buffers: they stay where they are
        # the loss and aux terms, summed on the card since the epoch began
        self._aux_names = None
        self._sums = None

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
        KG model, (h, r, pos_t, neg_t), each [n_batches, B] int32."""
        b, cfg = self.bundle, self.cfg
        cf = b.cf
        if self._exact is not None:
            users, pos, neg = self._exact.pairwise(self._host_seed(), cfg.batch_size)
            host = [users, pos, neg]
            if b.uses_kg:
                host += self._exact.kg_batches(self._host_seed(), users.shape[0],
                                               cfg.batch_size_kg)
            return tuple(torch.as_tensor(a, device=self.device) for a in host)
        batches = epoch_pairwise_batches(
            self.dev_gen, cf.edge_u, cf.edge_i, cf.sample_membership, cf.n_items,
            cfg.batch_size, cfg.neg_resample_rounds)
        if b.uses_kg:
            kg, n = b.kg, b.kg.n_kg_train
            batches += epoch_kg_batches(
                self.dev_gen, kg.att_h[:n], kg.att_r[:n], kg.att_t[:n], kg.head_tails,
                kg.n_entities, batches[0].shape[0], cfg.batch_size_kg, cfg.neg_resample_rounds)
        return batches

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

    def _step_body(self, batch, edge_keys) -> tuple[torch.Tensor, dict]:
        """The training step as a step graph holds it: zero_grad, loss,
        backward, clip, Adam, the new extras tensors written into their
        buffers, the loss and aux terms added to the epoch's sums. Returns
        (stats: the loss then the aux terms in `_aux_names` order, the
        new host values of the extras). A bundle's `update_extras` runs
        first, from the parameters before the step, and its tensors are
        written into their buffers before the loss reads them."""
        if self.bundle.update_extras is not None:
            with torch.no_grad():
                for k, v in self.bundle.update_extras(self.extras, batch).items():
                    self._store(k, v)
        self.opt.zero_grad(set_to_none=False)
        loss, aux = self.bundle.batch_loss(self.extras, batch, edge_keys, self.drop_gen)
        loss.backward()
        if self.bundle.grad_clip_norm is not None:
            clip_grads_([p.grad for p in self._params], self.bundle.grad_clip_norm)
        self.opt.step()
        host = {}
        for k, v in (aux.pop("_new_extras", None) or {}).items():
            if torch.is_tensor(v):
                self._store(k, v)
            else:
                host[k] = v
        if self._aux_names is None:
            self._aux_names = sorted(aux)
        elif sorted(aux) != self._aux_names:
            raise ValueError(f"{self.bundle.name}: a step's aux terms {sorted(aux)} differ from "
                             f"the first step's {self._aux_names}")
        stats = torch.stack([loss.detach()] + [aux[k] for k in self._aux_names])
        if self._sums is None:
            self._sums = torch.zeros_like(stats)
        self._sums += stats
        return stats, host

    def _replay(self, branch: str, batch, edge_keys) -> torch.Tensor:
        """The step as a replay of `branch`'s graph, captured at its first
        use, with the batch and keys copied into the graphs' fixed inputs."""
        keys = (edge_keys if torch.is_tensor(edge_keys)
                else torch.tensor(edge_keys, dtype=torch.int64).reshape(-1, 2))
        if self._inputs is None:
            self._inputs = (tuple(torch.empty_like(t) for t in batch),
                            torch.empty(keys.shape, dtype=torch.int64, device=self.device))
        in_batch, in_keys = self._inputs
        for buf, t in zip(in_batch, batch):
            buf.copy_(t)
        in_keys.copy_(keys)
        if branch not in self._step_graphs:
            before = dict(self.extras)
            self._frozen = True
            if self._stats is None:
                self._stats = torch.empty(1 + len(self._aux_names), device=self.device)

            def step():
                stats, host = self._step_body(in_batch, in_keys)
                self._stats.copy_(stats)
                return host

            graph, host = capture(step, self._pool, (self.drop_gen,))
            # a host value's change in one step (cached propagation's age: +1)
            self._step_graphs[branch] = (graph, {k: v - before[k] for k, v in host.items()})
        graph, host_steps = self._step_graphs[branch]
        graph.replay()
        for k, d in host_steps.items():
            self.extras[k] += d
        return self._stats

    def train_step(self, batch, edge_keys) -> tuple[torch.Tensor, dict]:
        """One optimiser step on one batch; returns the (detached) loss and
        aux terms, still on the card (in graph mode views of one buffer,
        which the next step writes again). `edge_keys`:
        one pair of dropout key words per dropped adjacency, as integers
        or as an int64 tensor [n_edge_keys, 2]. In graph mode each code
        path of the loss runs `GRAPH_WARMUP_STEPS` eager steps, then is
        captured, then replayed."""
        b = self.bundle
        branch = b.step_branch(self.extras) if b.step_branch is not None else "full"
        eager = self._eager_steps.get(branch, 0)
        if not self.graphs or eager < GRAPH_WARMUP_STEPS:
            self._eager_steps[branch] = eager + 1
            stats, host = self._step_body(batch, edge_keys)
            self.extras.update(host)
        else:
            stats = self._replay(branch, batch, edge_keys)
        self._version += 1
        return stats[0], dict(zip(self._aux_names, stats[1:]))

    def begin_epoch(self) -> None:
        """A bundle's `epoch_setup`, run eagerly before the epoch's steps
        (the JAX epoch runs it before its scan), from the card generator;
        its tensors are copied into the extras buffers in place, where the
        step and encode graphs read them."""
        if self.bundle.epoch_setup is None:
            return
        with torch.no_grad():
            for k, v in self.bundle.epoch_setup(self.extras, self.drop_gen).items():
                self._store(k, v)
        self._version += 1

    def run_epoch(self, epoch: int) -> tuple[float, dict]:
        self.begin_epoch()
        batches = self.sample_epoch()
        n = batches[0].shape[0]
        keys = self.epoch_keys(n)
        if self._sums is not None:
            self._sums.zero_()
        for s in range(n):
            self.train_step(tuple(t[s] for t in batches), keys[s])
        # one copy to the host for the epoch's means
        means = (self._sums / n).cpu().tolist()
        loss = means[0]
        # NaN guard: the reference checks every batch (KGAT.py:96-97);
        # here a non-finite epoch mean fails the epoch
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite train loss ({loss}) at epoch {epoch + 1} for {self.cfg.model}")
        aux = dict(zip(self._aux_names, means[1:]))
        aux["train_loss"] = loss
        return loss, aux

    # -- evaluation --------------------------------------------------------
    @torch.no_grad()
    def encode(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The full-graph tables of the current state (cached until the
        next step or restore); in graph mode the encode graph's outputs,
        which the next encode writes again."""
        if self._encoded is None or self._encoded[0] != self._version:
            if self.graphs:
                if self._encode_graph is None:
                    self._frozen = True
                    self._encode_graph = EncodeGraph(self.bundle, self.extras, self._pool)
                tables = self._encode_graph()
            else:
                tables = self.bundle.encode_eval(self.extras)
            self._encoded = (self._version, tables)
        return self._encoded[1]

    def evaluate(self) -> dict:
        cfg, cf = self.cfg, self.bundle.cf
        u, i = self.encode()
        m = ranking_metrics(u, i, cf.rated_pad, cf.eval_data, tuple(cfg.top_ns),
                            block=cfg.eval_user_batch)
        return metrics_to_host(m, tuple(cfg.top_ns))

    def snapshot(self, optimizer: bool = False):
        """Copies of the parameters and the extras; with `optimizer`, also
        of Adam's state and the generators' states, so that `restore`
        brings back the whole training state (after at least one step)."""
        snap = ({k: v.detach().clone() for k, v in self.bundle.module.state_dict().items()},
                {k: v.clone() if torch.is_tensor(v) else v for k, v in self.extras.items()})
        if optimizer:
            adam = [{k: v.clone() for k, v in self.opt.state[p].items()} for p in self._params]
            gens = [g.get_state() for g in (self.host_gen, self.dev_gen, self.drop_gen)]
            snap += (adam, gens)
        return snap

    def restore(self, snap) -> None:
        """Copy a snapshot back in place: the parameters, the extras
        buffers and Adam's state keep the addresses the graphs read."""
        self.bundle.module.load_state_dict(snap[0])
        for k, v in snap[1].items():
            if torch.is_tensor(v):
                self._store(k, v)
            else:
                self.extras[k] = v
        if len(snap) > 2:
            for p, saved in zip(self._params, snap[2]):
                for k, v in saved.items():
                    self.opt.state[p][k].copy_(v)
            for g, state in zip((self.host_gen, self.dev_gen, self.drop_gen), snap[3]):
                g.set_state(state)
        self._version += 1

    def fit(self, max_epoch: Optional[int] = None, log_fn=print, quiet: bool = False) -> FitResult:
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

        for ep in range(max_epoch):
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
            if self.bundle.lr_plateau:
                self.plateau = self.plateau.step(loss)
                set_lr(self.opt, self.plateau.lr)
            eval_t = time.time() - t1
            result.history.append(EpochRecord(ep, t1 - t0, eval_t, aux, metrics))
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
        return result


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
