"""Generic trainer — the port of the JAX package's `train/trainer.py`,
the pairwise, non-alternating, single-device subset.

The lifecycle (reference base/recommender.py:80-114):
  Trainer.fit() -> per epoch [run_epoch -> evaluate -> plateau.step ->
  best-model vote -> early stopping] -> final metrics from the best state.

Where the JAX trainer jits one epoch (sampling + `lax.scan` over steps),
the port samples the epoch's batches on the card and runs the steps as
an eager loop; the loss and aux terms stay on the card until the epoch
ends and are copied to the host once.

Parity points:
  * best-model vote: at K = max(topN), count the metrics that worsened
    against those that improved; a majority of improvements is a new
    best (base/main_recommender.py:138-160);
  * early stop on Recall@maxN not improving for `early_stopping_steps`
    (times the patience scale) epochs (util/evaluation.py:195-202);
  * ReduceLROnPlateau on the epoch mean train loss (KHGRec.py:191);
  * Adam with coupled weight decay updates every parameter each step,
    those the loss does not reach included, as optax does.

Randomness comes from explicit generators seeded with `cfg.seed`: a CPU
one for the initial weights (the same as `Recommender.init_weights`), a
CPU one for the edge-dropout key words and the exact sampler's seeds, one
on the card for the redraw sampler, and one on the card that feature
dropout draws from (passed to `batch_loss`). A model with cached
propagation keeps its step counter as a host integer in the extras, so
no step waits on the card to pick its branch. Chunked execution, donation,
meshes, checkpoints and the alternating KGAT path wait.
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
from ..ops.dropout import key_words
from ..ops.sampling import HostExactSampler, epoch_kg_batches, epoch_pairwise_batches
from .optim import PlateauState, make_optimizer, set_lr

_FROZEN_EPOCHS = 10


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


class Trainer:
    def __init__(self, bundle: ModelBundle, seed: Optional[int] = None,
                 extras: Optional[Extras] = None):
        """`extras` given: train from the module's current weights with
        these extras; else initialise both from `seed` (default
        `cfg.seed`)."""
        if bundle.batch_loss is None:
            raise ValueError(f"{bundle.name} has no training loss in the port yet")
        self.bundle = bundle
        self.cfg = cfg = bundle.cfg
        seed = cfg.seed if seed is None else seed
        self.device = bundle.cf.edge_u.device
        self.extras = bundle.init(torch.Generator().manual_seed(seed)) if extras is None else extras
        self.host_gen = torch.Generator().manual_seed(seed + 1)
        self.dev_gen = torch.Generator(self.device).manual_seed(seed + 2)
        self.drop_gen = torch.Generator(self.device).manual_seed(seed + 3)
        params = list(bundle.module.parameters())
        for p in params:
            # zero, not None: Adam then updates (decays) every parameter
            p.grad = torch.zeros_like(p)
        self.opt = make_optimizer(params, cfg.lrate, cfg.weight_decay)
        self.plateau = PlateauState(lr=cfg.lrate, factor=cfg.lr_decay, patience=cfg.lr_patience)
        self.n_batches = -(-bundle.cf.n_train // cfg.batch_size)
        if cfg.sampler not in ("redraw", "exact"):
            raise ValueError(f"sampler {cfg.sampler!r} is not 'redraw' or 'exact'")
        self._exact = self._make_exact_sampler() if cfg.sampler == "exact" else None
        # the state the cached encode was taken at: bumped by every step
        # and every restore
        self._version = 0
        self._encoded = None

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

    # -- steps -----------------------------------------------------------
    def train_step(self, batch, edge_keys) -> tuple[torch.Tensor, dict]:
        """One optimiser step on one batch; returns the (detached) loss and
        aux terms, still on the card."""
        self.opt.zero_grad(set_to_none=False)
        loss, aux = self.bundle.batch_loss(self.extras, batch, edge_keys, self.drop_gen)
        loss.backward()
        self.opt.step()
        new_extras = aux.pop("_new_extras", None)
        if new_extras is not None:
            self.extras = new_extras
        self._version += 1
        return loss.detach(), aux

    def run_epoch(self, epoch: int) -> tuple[float, dict]:
        batches = self.sample_epoch()
        losses, auxes = [], []
        for s in range(batches[0].shape[0]):
            loss, aux = self.train_step(tuple(t[s] for t in batches), self.edge_keys())
            losses.append(loss)
            auxes.append(aux)
        names = sorted(auxes[0])
        # one copy to the host for the epoch's means
        means = torch.stack([torch.stack(losses).mean()] + [
            torch.stack([a[k] for a in auxes]).mean() for k in names]).cpu().tolist()
        loss = means[0]
        # NaN guard: the reference checks every batch (KGAT.py:96-97);
        # here a non-finite epoch mean fails the epoch
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite train loss ({loss}) at epoch {epoch + 1} for {self.cfg.model}")
        aux = dict(zip(names, means[1:]))
        aux["train_loss"] = loss
        return loss, aux

    # -- evaluation --------------------------------------------------------
    @torch.no_grad()
    def encode(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The full-graph tables of the current state (cached until the
        next step or restore)."""
        if self._encoded is None or self._encoded[0] != self._version:
            self._encoded = (self._version, self.bundle.encode_eval(self.extras))
        return self._encoded[1]

    def evaluate(self) -> dict:
        cfg, cf = self.cfg, self.bundle.cf
        u, i = self.encode()
        m = ranking_metrics(u, i, cf.rated_pad, cf.eval_data, tuple(cfg.top_ns),
                            block=cfg.eval_user_batch)
        return metrics_to_host(m, tuple(cfg.top_ns))

    def snapshot(self):
        return ({k: v.detach().clone() for k, v in self.bundle.module.state_dict().items()},
                dict(self.extras))

    def restore(self, snap) -> None:
        self.bundle.module.load_state_dict(snap[0])
        self.extras = dict(snap[1])
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
