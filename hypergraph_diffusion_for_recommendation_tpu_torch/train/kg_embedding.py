"""Standalone knowledge-graph triple-embedding trainer — the port of the JAX
package's `train/kg_embedding.py`.

The reference ships a KG-embedding CLI (`main_kg_embedding.py`) and the
`Measure` evaluation class (util/evaluation.py:99-156: Hit@1/3/10, MR,
MRR in raw and filtered settings), but the `KnowledgeGraphEmbedding` class
it imports does not exist at HEAD (survey 3.5). The JAX package rebuilt it;
this module carries that rebuild over:

  * models: TransE (margin/softplus), DistMult (full-entity cross-entropy)
    and the ReAlE-style windowed scorer over arity-k tuples;
  * training: the host 90/10 split of the JAX package; each epoch draws its
    permutation and corrupted entities on the device from the trainer's
    generator, once, and runs its steps, each step on a CUDA card as a
    replay of a CUDA graph of the step (zero_grad, loss, backward, Adam)
    over fixed input buffers that the epoch's batches are copied into;
  * evaluation: full-entity ranking per test tuple, scored on the device in
    exact float32, ranked on the host as the JAX package ranks, raw and
    FILTERED (known true completions masked).

`run_epoch(draws)` takes the epoch's permutation and negatives from the
caller instead of the generator (the tests hand it the JAX draws).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..models.kg_common import relation_lookup
from ..ops.sparse import gather_rows_hubs
from ..ops.topk import exact_f32
from ..weights import _xavier_uniform
from .graphs import capture
from .optim import make_optimizer
from .trainer import GRAPH_WARMUP_STEPS

# the largest [block, chunk, dim] difference TransE's evaluation holds at once
_L1_CHUNK_ELEMENTS = 1 << 24


@dataclass
class KGEConfig:
    model: str = "TransE"  # TransE | DistMult | RealE
    dim: int = 64
    lrate: float = 0.001
    batch_size: int = 2048
    max_epoch: int = 100
    reg: float = 1e-5
    margin: float = 1.0
    neg_ratio: int = 10  # negatives per position (reference RealE.conf: nr=10)
    seed: int = 0
    eval_every: int = 10
    # ReAlE knobs (conf/kg_embedding/RealE.conf: window_size=2,
    # DEFAULT_MAX_ARITY=6, non_linearity/ent_non_linearity=sigmoid)
    window_size: int = 2
    max_arity: int = 6
    non_linearity: str = "sigmoid"
    ent_non_linearity: str = "sigmoid"


def _nl(name: str):
    return {
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "relu": torch.relu,
        "none": lambda x: x,
    }[name]


@dataclass
class Measure:
    """util/evaluation.py:99-156 parity: accumulated rank statistics."""

    hit1: dict = field(default_factory=lambda: {"raw": 0.0, "fil": 0.0})
    hit3: dict = field(default_factory=lambda: {"raw": 0.0, "fil": 0.0})
    hit10: dict = field(default_factory=lambda: {"raw": 0.0, "fil": 0.0})
    mr: dict = field(default_factory=lambda: {"raw": 0.0, "fil": 0.0})
    mrr: dict = field(default_factory=lambda: {"raw": 0.0, "fil": 0.0})

    def update_batch(self, ranks: np.ndarray, setting: str) -> None:
        self.hit1[setting] += float((ranks == 1).sum())
        self.hit3[setting] += float((ranks <= 3).sum())
        self.hit10[setting] += float((ranks <= 10).sum())
        self.mr[setting] += float(ranks.sum())
        self.mrr[setting] += float((1.0 / ranks).sum())

    def normalize(self, normalizer: float) -> None:
        if normalizer == 0:
            return
        for s in ("raw", "fil"):
            self.hit1[s] /= normalizer
            self.hit3[s] /= normalizer
            self.hit10[s] /= normalizer
            self.mr[s] /= normalizer
            self.mrr[s] /= normalizer


def _score(model: str, h_e, r_e, t_e):
    """Higher = more plausible (binary-triple models)."""
    if model == "TransE":
        return -torch.sum(torch.abs(h_e + r_e - t_e), dim=-1)
    return torch.sum(h_e * r_e * t_e, dim=-1)  # DistMult


def _reale_entity_terms(params, cfg: KGEConfig, ents, valid):
    """Per-position transformed entity factors for the ReAlE scorer:
    position j's embedding is circularly shifted by j*d//max_arity, passed
    through `ent_non_linearity`, and a padded position contributes the
    multiplicative identity. ents: [B, A] entity ids (pad 0), valid: [B, A]
    bool -> [B, A, d]. The gather's backward is hub-safe: the pads hold
    thousands of id 0 a batch."""
    d = cfg.dim
    g = _nl(cfg.ent_non_linearity)
    e = gather_rows_hubs(params["ent"], ents)  # [B, A, d]
    shifted = torch.stack(
        [torch.roll(e[:, j], (j * d) // cfg.max_arity, dims=-1) for j in range(ents.shape[1])],
        dim=1,
    )
    return torch.where(valid[..., None], g(shifted), 1.0)


def _position_product(terms):
    """The product over the positions axis (1) of [B, A, d] factors, as a
    chain of products: `torch.prod`'s backward looks for zeros on the host,
    which a CUDA graph of the step cannot hold."""
    out = terms[:, 0]
    for j in range(1, terms.shape[1]):
        out = out * terms[:, j]
    return out


def _windowed(q, cand, cfg: KGEConfig):
    """sum over windows of f(window-sum of q ⊙ cand) along the last axis
    (q and cand broadcast against each other)."""
    f = _nl(cfg.non_linearity)
    prod = q * cand
    nb = cfg.dim // cfg.window_size
    return torch.sum(f(prod.reshape(prod.shape[:-1] + (nb, cfg.window_size)).sum(-1)), dim=-1)


def _reale_score_from_terms(params, cfg: KGEConfig, rel_ids, terms):
    """score = sum over windows of f(window-sum of r ⊙ Π_j g(e_j))."""
    prod = _position_product(terms)  # [B, d]
    return _windowed(relation_lookup(params["rel"], rel_ids), prod, cfg)


def _reale_score(params, cfg: KGEConfig, rel_ids, ents, valid):
    return _reale_score_from_terms(params, cfg, rel_ids,
                                   _reale_entity_terms(params, cfg, ents, valid))


def _all_entity_windowed(q, ent, shift: int, cfg: KGEConfig):
    """Every entity's windowed score at a position of shift `shift`, for the
    leave-one-out queries q [B, d]: [B, E], through the [B, E, windows]
    window sums (the JAX einsum "bnw,enw->ben")."""
    f, g = _nl(cfg.non_linearity), _nl(cfg.ent_non_linearity)
    nb = cfg.dim // cfg.window_size
    G = g(torch.roll(ent, shift, dims=-1))  # [E, d]
    qw = q.reshape(q.shape[0], nb, cfg.window_size)
    Gw = G.reshape(G.shape[0], nb, cfg.window_size)
    return torch.sum(f(torch.einsum("bnw,enw->ben", qw, Gw)), dim=-1)


def _neg_l1(x, ent):
    """-sum |x[:, None] - ent[None]| over the last axis, [B, E], without the
    whole [B, E, d] difference: the entities go in chunks."""
    chunk = max(1, _L1_CHUNK_ELEMENTS // max(x.shape[0] * x.shape[1], 1))
    return torch.cat([-torch.sum(torch.abs(x[:, None, :] - ent[None, s:s + chunk]), dim=-1)
                      for s in range(0, ent.shape[0], chunk)], dim=1)


class KGEmbeddingTrainer:
    """Replaces the missing `KnowledgeGraphEmbedding.train_and_eval`.

    Accepts binary triples [n, 3] = (h, r, t), or — for the RealE
    hyper-relational model — arity-k tuples [n, 1 + max_arity] with the
    relation in column 0 and entities (pad -1) after. Runs on `device` (the
    GPU unless the caller asks for the CPU); on a CUDA card each training
    step is a replayed CUDA graph unless `graphs=False`.
    """

    def __init__(
        self,
        triples: np.ndarray | None,
        n_entities: int,
        n_relations: int,
        cfg: KGEConfig,
        tuples: np.ndarray | None = None,
        device: torch.device | str | None = None,
        graphs: bool | None = None,
    ):
        self.cfg = cfg
        self.n_entities = n_entities
        self.n_relations = n_relations
        self.device = resolve_device(device)
        self.graphs = self.device.type == "cuda" if graphs is None else graphs
        if tuples is not None:
            tup = np.asarray(tuples, np.int64)
            if tup.shape[1] != cfg.max_arity + 1:
                raise ValueError(f"tuples must be [n, 1+max_arity], got {tup.shape}")
        else:
            tr3 = np.asarray(triples, np.int64)
            tup = np.full((tr3.shape[0], cfg.max_arity + 1), -1, np.int64)
            tup[:, 0] = tr3[:, 1]  # relation
            tup[:, 1] = tr3[:, 0]  # head
            tup[:, 2] = tr3[:, 2]  # tail
        n = tup.shape[0]
        rng = np.random.default_rng(cfg.seed)
        perm = rng.permutation(n)
        n_test = max(int(n * 0.1), 1)
        self.test_tup = tup[perm[:n_test]]
        self.train_tup = tup[perm[n_test:]]
        # binary-triple views for the TransE/DistMult paths
        self.test = np.stack([self.test_tup[:, 1], self.test_tup[:, 0], self.test_tup[:, 2]], 1)
        self.train = np.stack(
            [self.train_tup[:, 1], self.train_tup[:, 0], self.train_tup[:, 2]], 1
        )

        # filtered-setting lookup: known completions per (position, rest),
        # over every tuple, the test ones included
        ht = {}
        th = {}
        for h, r, t in np.stack([tup[:, 1], tup[:, 0], tup[:, 2]], 1):
            ht.setdefault((int(h), int(r)), []).append(int(t))
            th.setdefault((int(r), int(t)), []).append(int(h))
        self._ht = ht
        self._th = th
        # arity-general filtered lookup: (rel, position, other entities) -> completions
        comp = {}
        for row in tup:
            r = int(row[0])
            ents = row[1:]
            for j, e in enumerate(ents):
                if e < 0:
                    continue
                rest = tuple(int(x) for k2, x in enumerate(ents) if k2 != j)
                comp.setdefault((r, j, rest), []).append(int(e))
        self._completions = comp

        # Xavier-uniform tables (flax's limit sqrt(6 / (rows + dim)))
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.params = {
            k: _xavier_uniform((rows, cfg.dim), init_gen).to(self.device).requires_grad_(True)
            for k, rows in (("ent", n_entities), ("rel", n_relations))
        }
        self._param_list = list(self.params.values())
        for p in self._param_list:  # optax updates every parameter each step
            p.grad = torch.zeros_like(p)
        self.opt = make_optimizer(self._param_list, cfg.lrate, 0.0)
        # the epochs' permutations and negatives, drawn on the device
        self.gen = torch.Generator(self.device).manual_seed(cfg.seed + 1)

        self._train_dev = torch.as_tensor(self.train, device=self.device)
        self._train_tup_dev = torch.as_tensor(self.train_tup, device=self.device)
        self.n_batches = -(-self.train.shape[0] // cfg.batch_size)
        # only positions that ever hold an entity get a loss term
        self.active = [j for j in range(cfg.max_arity)
                       if (self.train_tup[:, 1 + j] >= 0).any()]
        # full-entity cross-entropy when the catalogue is small, sampled
        # grouped CE beyond that (the JAX package's rule)
        self.full_ce = n_entities <= 2048
        self._loss_sum = torch.zeros((), device=self.device)
        self._eager_steps = 0
        self._graph = self._inputs = self._out = None
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None

    # -- parameters ----------------------------------------------------------
    @torch.no_grad()
    def load_params(self, params: dict) -> None:
        """Copy {"ent", "rel"} tables (`weights.kge_params_from_jax`) into the
        trainer's parameters, in place: the step graph reads them there."""
        for k, v in params.items():
            self.params[k].copy_(v)

    def snapshot(self) -> tuple:
        """Copies of the parameters, Adam's state and the generator's state."""
        return ({k: v.detach().clone() for k, v in self.params.items()},
                [{k: v.clone() for k, v in self.opt.state[p].items()} for p in self._param_list],
                self.gen.get_state())

    @torch.no_grad()
    def restore(self, snap) -> None:
        """Copy a `snapshot` back in place (after at least one step)."""
        params, adam, gen = snap
        self.load_params(params)
        for p, st in zip(self._param_list, adam):
            for k, v in st.items():
                self.opt.state[p][k].copy_(v)
        self.gen.set_state(gen)

    # -- batches -------------------------------------------------------------
    def draw(self) -> tuple[torch.Tensor, ...]:
        """One epoch's draws on the device, from the trainer's generator: the
        permutation of the training rows and the corrupted entities,
        (perm, nh, nt) with nh, nt [n_batches, B] for TransE and DistMult,
        (perm, negs) with negs [n_batches, B, A, nr] for RealE."""
        cfg, dev = self.cfg, self.device
        n, b = self.train.shape[0], cfg.batch_size
        perm = torch.randperm(n, generator=self.gen, device=dev)
        if cfg.model == "RealE":
            shape = (self.n_batches, b, cfg.max_arity, cfg.neg_ratio)
            return perm, torch.randint(0, self.n_entities, shape, generator=self.gen,
                                       device=dev)
        shape = (self.n_batches, b)
        return (perm,) + tuple(torch.randint(0, self.n_entities, shape, generator=self.gen,
                                             device=dev) for _ in range(2))

    def epoch_batches(self, draws) -> tuple[torch.Tensor, ...]:
        """The epoch's batches from its draws: the permuted rows cut into
        [n_batches, B], the tail wrapped around the permutation (modulo n,
        which equals the JAX package's concat([perm, perm[:total - n]])
        wherever that is defined). Binary: (h, r, t, nh, nt); RealE: (rel,
        ents [n_batches, B, A] pad 0, valid, negs)."""
        cfg = self.cfg
        draws = tuple(torch.as_tensor(t, device=self.device).long() for t in draws)
        perm = draws[0]
        n = perm.shape[0]
        total = self.n_batches * cfg.batch_size
        idx = perm[torch.arange(total, device=self.device) % n]
        if cfg.model == "RealE":
            tup = self._train_tup_dev[idx]
            ents_r = tup[:, 1:].reshape(self.n_batches, -1, cfg.max_arity)
            valid = ents_r >= 0
            return (tup[:, 0].reshape(self.n_batches, -1), torch.where(valid, ents_r, 0), valid,
                    draws[1])
        tri = self._train_dev[idx]
        return tuple(tri[:, k].reshape(self.n_batches, -1) for k in range(3)) + draws[1:]

    # -- losses --------------------------------------------------------------
    def loss(self, batch) -> torch.Tensor:
        """The loss of one batch (a step of `epoch_batches`' output)."""
        if self.cfg.model == "RealE":
            return self._reale_loss(*batch)
        return self._binary_loss(*batch)

    def _binary_loss(self, h, r, t, nh, nt):
        cfg = self.cfg
        ent, rel = self.params["ent"], self.params["rel"]
        r_e = relation_lookup(rel, r)
        h_e, t_e = ent[h], ent[t]
        if cfg.model == "TransE":
            pos = _score(cfg.model, h_e, r_e, t_e)
            neg_t = _score(cfg.model, h_e, r_e, ent[nt])
            neg_h = _score(cfg.model, ent[nh], r_e, t_e)
            loss = torch.mean(F.softplus(cfg.margin - pos + neg_t)) + torch.mean(
                F.softplus(cfg.margin - pos + neg_h))
        else:
            # DistMult: full-entity cross-entropy on both ends
            loss = F.cross_entropy((h_e * r_e) @ ent.T, t) + F.cross_entropy(
                (t_e * r_e) @ ent.T, h)
        reg = cfg.reg * (torch.mean(h_e**2) + torch.mean(t_e**2) + torch.mean(r_e**2))
        return loss + reg

    def _reale_loss(self, rel, ents, valid, negs):
        """Every valid position of every tuple ranked against all entities
        (full CE) or against its true entity and `neg_ratio` negatives
        (sampled grouped CE), by the leave-one-out product of the other
        positions' factors (the terms set to 1 at j: exact where
        `ent_non_linearity` emits zeros)."""
        cfg = self.cfg
        params = self.params
        terms = _reale_entity_terms(params, cfg, ents, valid)  # [B, A, d]
        r_e = relation_lookup(params["rel"], rel)
        positions = torch.arange(cfg.max_arity, device=ents.device)
        loss = n_terms = 0.0
        for j in self.active:
            others = _position_product(torch.where((positions == j)[None, :, None], 1.0, terms))
            q = r_e * others  # [B, d]
            shift = (j * cfg.dim) // cfg.max_arity
            if self.full_ce:
                logits = _all_entity_windowed(q, params["ent"], shift, cfg)  # [B, E]
                labels = ents[:, j]
            else:
                # candidate factors at position j: true entity + negatives
                cand = torch.cat([ents[:, j:j + 1], negs[:, j]], dim=1)
                g = _nl(cfg.ent_non_linearity)
                gc = g(torch.roll(gather_rows_hubs(params["ent"], cand), shift, dims=-1))
                logits = _windowed(q[:, None, :], gc, cfg)  # [B, 1+nr]
                labels = torch.zeros_like(ents[:, j])
            ce = F.cross_entropy(logits, labels, reduction="none")
            vj = valid[:, j].float()
            loss = loss + torch.sum(ce * vj)
            n_terms = n_terms + torch.sum(vj)
        reg = cfg.reg * (torch.mean(params["ent"] ** 2) + torch.mean(params["rel"] ** 2))
        return loss / torch.clamp(n_terms, min=1.0) + reg

    # -- steps and epochs ----------------------------------------------------
    def _step_body(self, batch) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=False)
        loss = self.loss(batch)
        loss.backward()
        self.opt.step()
        loss = loss.detach()
        self._loss_sum += loss
        return loss

    def train_step(self, batch) -> torch.Tensor:
        """One Adam step on one batch; returns the loss on the device. In
        graph mode the first `GRAPH_WARMUP_STEPS` steps run eagerly, the next
        is captured with the batch in fixed input buffers, and every later
        step copies its batch there and replays the graph."""
        if not self.graphs or self._eager_steps < GRAPH_WARMUP_STEPS:
            self._eager_steps += 1
            return self._step_body(batch)
        if self._inputs is None:
            self._inputs = tuple(torch.empty_like(t) for t in batch)
        for buf, t in zip(self._inputs, batch):
            buf.copy_(t)
        if self._graph is None:
            self._graph, self._out = capture(lambda: self._step_body(self._inputs), self._pool)
        self._graph.replay()
        return self._out

    def run_epoch(self, draws=None) -> float:
        """One epoch over the training rows; returns its mean loss. `draws`
        (see `draw`) replaces the generator's draws for this epoch."""
        batches = self.epoch_batches(self.draw() if draws is None else draws)
        self._loss_sum.zero_()
        for s in range(self.n_batches):
            self.train_step(tuple(t[s] for t in batches))
        return float(self._loss_sum / self.n_batches)

    # -- evaluation ----------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, max_triples: int = 2000, by_arity: bool = False):
        """Entity-ranking evaluation, raw + filtered (Measure parity).

        For each test tuple, ranks the true entity at every valid position
        against all entities with a strict `>` against its score; the
        filtered setting masks other known true completions first.
        `by_arity=True` (RealE) returns {arity: Measure}."""
        if self.cfg.model == "RealE":
            return self._evaluate_reale(max_triples, by_arity)
        cfg = self.cfg
        test = self.test[:max_triples]
        ent, rel = self.params["ent"].detach(), self.params["rel"].detach()

        def scores(e, r, sign):
            """Every entity's score as the tail (sign 1: h + r) or the head
            (sign -1: t - r) of the block's triples: [b, E]."""
            if cfg.model == "TransE":
                return _neg_l1(e + sign * r, ent)
            return (e * r) @ ent.T

        measure = Measure()
        bs = 128
        for s in range(0, len(test), bs):
            blk = test[s : s + bs]
            h, r, t = (torch.as_tensor(blk[:, k], device=self.device) for k in range(3))
            with exact_f32():
                ts = scores(ent[h], rel[r], 1.0).cpu().numpy()
                hs = scores(ent[t], rel[r], -1.0).cpu().numpy()
            t_np = blk[:, 2]
            h_np = blk[:, 0]
            # raw ranks
            raw_t = 1 + (ts > ts[np.arange(len(blk)), t_np][:, None]).sum(1)
            raw_h = 1 + (hs > hs[np.arange(len(blk)), h_np][:, None]).sum(1)
            measure.update_batch(np.concatenate([raw_t, raw_h]), "raw")
            # filtered ranks
            for k, (hh, rr, tt) in enumerate(blk):
                known_t = self._ht.get((int(hh), int(rr)), [])
                known_h = self._th.get((int(rr), int(tt)), [])
                row_t = ts[k].copy()
                row_t[known_t] = -np.inf
                row_h = hs[k].copy()
                row_h[known_h] = -np.inf
                fil_t = 1 + (row_t > ts[k, int(tt)]).sum()
                fil_h = 1 + (row_h > hs[k, int(hh)]).sum()
                measure.update_batch(np.asarray([fil_t, fil_h]), "fil")
        measure.normalize(2 * len(test))
        return measure

    def _evaluate_reale(self, max_tuples: int, by_arity: bool):
        """Arity-general entity ranking for the ReAlE scorer."""
        cfg = self.cfg
        test = self.test_tup[:max_tuples]
        A = cfg.max_arity
        params = {k: v.detach() for k, v in self.params.items()}
        positions = torch.arange(A, device=self.device)

        def all_scores(rel, ents, valid, j):
            """Scores of every entity substituted at position j: [b, E]."""
            terms = _reale_entity_terms(params, cfg, ents, valid)
            loo = torch.where((positions == j)[None, :, None], 1.0, terms)
            q = params["rel"][rel] * _position_product(loo)  # [b, d]
            return _all_entity_windowed(q, params["ent"], (j * cfg.dim) // A, cfg)

        measures: dict[int, Measure] = {}
        counts: dict[int, int] = {}
        overall = Measure()
        n_events = 0
        bs = 32
        for s in range(0, len(test), bs):
            blk = test[s : s + bs]
            rel = torch.as_tensor(blk[:, 0], device=self.device)
            ents_r = blk[:, 1:]
            valid_np = ents_r >= 0
            ents = torch.as_tensor(np.where(valid_np, ents_r, 0), device=self.device)
            valid = torch.as_tensor(valid_np, device=self.device)
            arities = valid_np.sum(1)
            for j in range(A):
                if not valid_np[:, j].any():
                    continue
                with exact_f32():
                    sc = all_scores(rel, ents, valid, j).cpu().numpy()
                for k2 in np.nonzero(valid_np[:, j])[0]:
                    true_e = int(ents_r[k2, j])
                    row = sc[k2]
                    raw = 1 + int((row > row[true_e]).sum())
                    rest = tuple(int(x) for q2, x in enumerate(ents_r[k2]) if q2 != j)
                    known = self._completions.get((int(blk[k2, 0]), j, rest), [])
                    rowf = row.copy()
                    rowf[known] = -np.inf
                    fil = 1 + int((rowf > row[true_e]).sum())
                    ar = int(arities[k2])
                    m = measures.setdefault(ar, Measure())
                    m.update_batch(np.asarray([raw]), "raw")
                    m.update_batch(np.asarray([fil]), "fil")
                    counts[ar] = counts.get(ar, 0) + 1
                    overall.update_batch(np.asarray([raw]), "raw")
                    overall.update_batch(np.asarray([fil]), "fil")
                    n_events += 1
        overall.normalize(max(n_events, 1))
        if by_arity:
            for ar, m in measures.items():
                m.normalize(max(counts[ar], 1))
            return measures
        return overall

    def train_and_eval(self, log_fn=print, quiet: bool = True) -> Measure:
        cfg = self.cfg
        for ep in range(cfg.max_epoch):
            loss = self.run_epoch()
            if not quiet and (ep + 1) % cfg.eval_every == 0:
                log_fn(f"epoch {ep+1}: loss {loss:.4f}")
        m = self.evaluate()
        if not quiet:
            log_fn(
                f"fil: hit@1 {m.hit1['fil']:.4f} hit@3 {m.hit3['fil']:.4f} "
                f"hit@10 {m.hit10['fil']:.4f} MR {m.mr['fil']:.1f} MRR {m.mrr['fil']:.4f}"
            )
        return m
