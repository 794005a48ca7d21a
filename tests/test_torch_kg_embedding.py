"""The KG-embedding trainer and its CLI in the port against the JAX package,
on the CPU, at a small size (dim 16; KGs from `generate_kg` seeds, and
arity-3 tuples planted as in `tests/test_kg_embedding.py`):

  * the 90/10 split, the binary views and the three completion lookups: bit
    for bit;
  * the scorers on a random draw within 1e-6;
  * one step's loss and gradients for TransE, DistMult and RealE (its
    full-entity CE branch on a KG of 332 entities, its sampled branch on one
    of 2,228, and arity-3 tuples) within 1e-5 of each gradient's scale. The
    JAX gradient is read from a JAX epoch of one batch whose optimiser is
    `optax.sgd(2**16)`: params_before - params_after is 2**16 times the
    gradient, exactly scaled, where a unit step would round it to the
    parameters' ulp (about 3e-5 of the smallest gradient scales here);
  * three Adam epochs of several batches, the JAX draws recomputed from the
    JAX key sequence and handed to the port's epoch: losses within 1e-4
    relative, parameters within 1e-4 of each table's scale;
  * the evaluation of the same parameters (`kge_params_from_jax`): every
    ranking event's raw and filtered rank equal, except events where some
    other entity's score lies within 1e-5 of the row's scale of the true
    entity's in float64 (counted); the Measure (and `by_arity`) then equal
    exactly where there is no such event;
  * the CLI: the same flags, defaults and choices, and at --max_epoch 1 from
    the same initial tables and draws, the same Measure and printed lines.
"""

import argparse
import contextlib

import jax
import numpy as np
import optax
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu import kg_embedding_cli as j_cli
from hypergraph_diffusion_for_recommendation_tpu.data.synthetic import generate_kg as j_generate_kg
from hypergraph_diffusion_for_recommendation_tpu.train import kg_embedding as jk
from hypergraph_diffusion_for_recommendation_tpu_torch import kg_embedding_cli as t_cli
from hypergraph_diffusion_for_recommendation_tpu_torch.data.synthetic import generate_kg
from hypergraph_diffusion_for_recommendation_tpu_torch.train import kg_embedding as tk
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import kge_params_from_jax

GRAD_RTOL = 1e-5
ADAM_RTOL = 1e-4
TIE_RTOL = 1e-6
SGD_SCALE = 2.0**16
DIM = 16


def _triples(n_items, n_clusters, seed, **kw):
    kg = generate_kg(n_items=n_items, n_clusters=n_clusters, seed=seed, **kw)[["h", "r", "t"]]
    kg = kg.to_numpy()
    return kg, int(max(kg[:, 0].max(), kg[:, 2].max())) + 1, int(kg[:, 1].max()) + 1


def _arity3(n_tuples=600, n_ent=240, n_clusters=8, A=6):
    """Tuples of three entities of one cluster (tests/test_kg_embedding.py)."""
    rng = np.random.default_rng(5)
    cluster = rng.integers(0, n_clusters, n_ent)
    members = [np.nonzero(cluster == c)[0] for c in range(n_clusters)]
    rows = []
    for _ in range(n_tuples):
        c = rng.integers(0, n_clusters)
        e = rng.choice(members[c], 3, replace=False)
        rows.append([rng.integers(0, 2)] + list(e) + [-1] * (A - 3))
    return np.asarray(rows, np.int64), n_ent, 2


@pytest.fixture(scope="module")
def kgs():
    return {
        # 332 entities: RealE's full-entity CE branch
        "small": _triples(300, 8, 2, n_attrs_per_cluster=4, max_triples_per_item=2),
        # 2,228 entities: its sampled branch
        "large": _triples(2100, 16, 1, max_triples_per_item=1),
        "arity3": _arity3(),
    }


CASES = {  # name -> (model, kg)
    "TransE": ("TransE", "small"),
    "DistMult": ("DistMult", "small"),
    "RealE-full": ("RealE", "small"),
    "RealE-sampled": ("RealE", "large"),
    "RealE-arity3": ("RealE", "arity3"),
}


def _pair(kgs, case, **cfg_kw):
    """A JAX trainer and a port trainer on the CPU for the same KG and
    configuration, the port holding the JAX initial tables."""
    model, kg_name = CASES[case]
    data, n_ent, n_rel = kgs[kg_name]
    cfg = dict(model=model, dim=DIM, **cfg_kw)
    kw = dict(tuples=data) if kg_name == "arity3" else {}
    triples = None if kg_name == "arity3" else data
    jt = jk.KGEmbeddingTrainer(triples, n_ent, n_rel, jk.KGEConfig(**cfg), **kw)
    tt = tk.KGEmbeddingTrainer(triples, n_ent, n_rel, tk.KGEConfig(**cfg), device="cpu", **kw)
    tt.load_params(kge_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), "cpu"))
    return jt, tt


def _jax_draws(jt, rng):
    """The draws of the JAX epoch that `jt.run_epoch` runs from `rng`
    (its `self.rng`): (next rng, draws as numpy arrays)."""
    cfg = jt.cfg
    rng, k = jax.random.split(rng)
    n = jt.train.shape[0]
    n_batches = -(-n // cfg.batch_size)
    if cfg.model == "RealE":
        k_perm, k_neg = jax.random.split(k)
        negs = jax.random.randint(k_neg, (n_batches, cfg.batch_size, cfg.max_arity,
                                          cfg.neg_ratio), 0, jt.n_entities)
        return rng, (np.asarray(jax.random.permutation(k_perm, n)), np.asarray(negs))
    k_perm, k_nh, k_nt = jax.random.split(k, 3)
    shape = (n_batches, cfg.batch_size)
    return rng, (np.asarray(jax.random.permutation(k_perm, n)),
                 np.asarray(jax.random.randint(k_nh, shape, 0, jt.n_entities)),
                 np.asarray(jax.random.randint(k_nt, shape, 0, jt.n_entities)))


def _close(got, want, rtol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("kg_name", ["small", "arity3"])
def test_split_and_lookups_match_jax(kgs, kg_name):
    jt, tt = _pair(kgs, "RealE-arity3" if kg_name == "arity3" else "TransE")
    for name in ("train", "test", "train_tup", "test_tup"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name), err_msg=name)
    for name in ("_ht", "_th", "_completions"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt.n_batches == -(-jt.train.shape[0] // jt.cfg.batch_size)


@pytest.mark.parametrize("scorer", ["TransE", "DistMult", "RealE"])
def test_scorers_match_jax(scorer):
    # the scoring functions on one random draw: rtol 1e-6
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if scorer != "RealE":
        h, r, t = f(40, DIM), f(40, DIM), f(40, DIM)
        got = tk._score(scorer, *map(torch.as_tensor, (h, r, t)))
        want = jk._score(scorer, h, r, t)
    else:
        cfg = dict(dim=DIM, max_arity=6)
        params = {"ent": f(50, DIM), "rel": f(3, DIM)}
        ents = rng.integers(0, 50, (40, 6))
        valid = np.arange(6)[None] < rng.integers(2, 7, (40, 1))
        rel = rng.integers(0, 3, 40)
        got = tk._reale_score({k: torch.as_tensor(v) for k, v in params.items()},
                              tk.KGEConfig(**cfg), torch.as_tensor(rel),
                              torch.as_tensor(np.where(valid, ents, 0)), torch.as_tensor(valid))
        want = jk._reale_score(params, jk.KGEConfig(**cfg), rel, np.where(valid, ents, 0), valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_step_gradients_match_jax(kgs, case):
    model, kg_name = CASES[case]
    n_train = len(kgs[kg_name][0]) - max(int(len(kgs[kg_name][0]) * 0.1), 1)
    jt, tt = _pair(kgs, case, batch_size=n_train)  # one batch an epoch
    assert tt.full_ce == (kg_name != "large")
    before = jax.tree_util.tree_map(np.asarray, jt.params)
    jt.opt = optax.sgd(SGD_SCALE)
    jt.opt_state = jt.opt.init(jt.params)
    jt._epoch_fn = jax.jit(jt._build_reale_epoch_fn() if model == "RealE"
                           else jt._build_epoch_fn())
    _, draws = _jax_draws(jt, jt.rng)
    jloss = jt.run_epoch()
    batch = tuple(t[0] for t in tt.epoch_batches(draws))
    loss = tt.loss(batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=GRAD_RTOL)
    for k in ("ent", "rel"):
        jgrad = (before[k] - np.asarray(jt.params[k])) / SGD_SCALE
        _close(tt.params[k].grad.numpy(), jgrad, GRAD_RTOL, f"{case} d{k}")


def _adam_moments(jt):
    """The JAX trainer's Adam moments {"mu": {...}, "nu": {...}} as numpy."""
    (adam, *_) = [s for s in jt.opt_state if hasattr(s, "mu")]
    return {m: jax.tree_util.tree_map(np.asarray, getattr(adam, m)) for m in ("mu", "nu")}


@pytest.mark.parametrize("case", list(CASES))
def test_three_adam_epochs_match_jax(kgs, case):
    model, kg_name = CASES[case]
    batch = {"small": 128, "large": 512, "arity3": 160}[kg_name]
    jt, tt = _pair(kgs, case, batch_size=batch, lrate=0.01)
    assert tt.n_batches >= 3
    # Elements whose gradient at some step lies within the gradients'
    # tolerance of 0 are recorded: there the two packages' roundings are a
    # large part of the gradient (their signs may differ), and Adam's
    # normalised step turns that into a visible part of the learning rate
    # (TransE's L1 gradients cancel to that level in a few coordinates of
    # its relation rows). Only a recorded element may be off; the elements
    # off are counted. After each epoch the recorded elements take the JAX
    # values and moments, so that they do not move the elements they meet
    # in the next epoch's scores.
    near_zero = {k: torch.zeros_like(v, dtype=torch.bool) for k, v in tt.params.items()}
    adam_step = tt.opt.step

    def recording_step(*a, **kw):
        for k, p in tt.params.items():
            g = p.grad.abs()
            near_zero[k] |= (g <= GRAD_RTOL * g.max()) & (g > 0)
        return adam_step(*a, **kw)

    tt.opt.step = recording_step
    rng = jt.rng
    recorded = 0
    for epoch in range(3):
        rng, draws = _jax_draws(jt, rng)
        jloss = jt.run_epoch()
        loss = tt.run_epoch(draws)
        np.testing.assert_allclose(loss, jloss, rtol=ADAM_RTOL, err_msg=f"epoch {epoch}")
        moments = _adam_moments(jt)
        for k, p in tt.params.items():
            want = np.asarray(jt.params[k])
            mask = near_zero[k]
            off = np.abs(p.detach().numpy() - want) > ADAM_RTOL * np.abs(want).max()
            assert not (off & ~mask.numpy()).any(), (
                f"{case} {k} after epoch {epoch}: {int((off & ~mask.numpy()).sum())} elements "
                f"off by more than {ADAM_RTOL} of the scale without a near-zero gradient")
            recorded += int(off.sum())
            with torch.no_grad():
                p[mask] = torch.as_tensor(want)[mask]
                st = tt.opt.state[p]
                for name, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                    st[name][mask] = torch.as_tensor(moments[m][k])[mask]
            mask.zero_()
    print(f"{case}: {recorded} elements off, each with a near-zero gradient, over 3 epochs")


# -- evaluation ---------------------------------------------------------------

@contextlib.contextmanager
def _recorded_ranks():
    """Every rank either package's Measure receives, in order, per setting."""
    seen = {"jax": {"raw": [], "fil": []}, "torch": {"raw": [], "fil": []}}
    originals = {}
    for side, cls in (("jax", jk.Measure), ("torch", tk.Measure)):
        originals[side] = cls.update_batch

        def update(self, ranks, setting, side=side):
            seen[side][setting].extend(np.asarray(ranks).tolist())
            return originals[side](self, ranks, setting)

        cls.update_batch = update
    try:
        yield seen
    finally:
        jk.Measure.update_batch = originals["jax"]
        tk.Measure.update_batch = originals["torch"]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _near_ties(jt, max_triples):
    """In JAX's event order, per setting: does another entity's float64
    score lie within TIE_RTOL of the row's scale of the true entity's?"""
    cfg = jt.cfg
    ent = np.asarray(jt.params["ent"], np.float64)
    rel = np.asarray(jt.params["rel"], np.float64)

    def near(row, true_e):
        gap = np.abs(row - row[true_e])
        gap[true_e] = np.inf
        return bool((gap <= TIE_RTOL * max(np.abs(row).max(), 1e-30)).any())

    if cfg.model != "RealE":
        test = jt.test[:max_triples]
        raw, fil = [], []
        for s in range(0, len(test), 128):
            blk = test[s:s + 128]
            h, r, t = ent[blk[:, 0]], rel[blk[:, 1]], ent[blk[:, 2]]
            if cfg.model == "TransE":
                ts = -np.abs((h + r)[:, None] - ent[None]).sum(-1)
                hs = -np.abs((t - r)[:, None] - ent[None]).sum(-1)
            else:
                ts, hs = (h * r) @ ent.T, (t * r) @ ent.T
            tails = [near(ts[k], blk[k, 2]) for k in range(len(blk))]
            heads = [near(hs[k], blk[k, 0]) for k in range(len(blk))]
            raw += tails + heads
            fil += [x for pair in zip(tails, heads) for x in pair]
        return {"raw": raw, "fil": fil}
    A, nb, w = cfg.max_arity, cfg.dim // cfg.window_size, cfg.window_size
    test = jt.test_tup[:max_triples]
    events = []
    for s in range(0, len(test), 32):
        blk = test[s:s + 32]
        valid = blk[:, 1:] >= 0
        ents = np.where(valid, blk[:, 1:], 0)
        terms = np.stack([_sigmoid(np.roll(ent[ents[:, j]], (j * cfg.dim) // A, -1))
                          for j in range(A)], 1)
        terms = np.where(valid[..., None], terms, 1.0)
        for j in range(A):
            if not valid[:, j].any():
                continue
            loo = terms.copy()
            loo[:, j] = 1.0
            q = rel[blk[:, 0]] * loo.prod(1)
            G = _sigmoid(np.roll(ent, (j * cfg.dim) // A, -1))
            sc = _sigmoid(np.einsum("bnw,enw->ben", q.reshape(-1, nb, w),
                                    G.reshape(-1, nb, w))).sum(-1)
            # each event goes to its arity's Measure, then to the overall one
            events += [near(sc[k], ents[k, j]) for k in np.nonzero(valid[:, j])[0]
                       for _ in range(2)]
    return {"raw": events, "fil": events}


def _assert_same_ranks(seen, ties, what):
    """Ranks equal event by event except at near ties; returns the count of
    near-tie events."""
    for setting in ("raw", "fil"):
        j_ranks, t_ranks = seen["jax"][setting], seen["torch"][setting]
        assert len(j_ranks) == len(t_ranks) == len(ties[setting]), (what, setting)
        bad = [i for i, (a, b) in enumerate(zip(j_ranks, t_ranks))
               if a != b and not ties[setting][i]]
        assert not bad, f"{what} {setting}: ranks differ at events {bad[:10]}"
    return sum(ties["raw"]) + sum(ties["fil"])


@pytest.mark.parametrize("case", ["TransE", "DistMult", "RealE-full", "RealE-arity3"])
def test_evaluation_matches_jax(kgs, case):
    jt, tt = _pair(kgs, case, batch_size=128, lrate=0.01)
    for _ in range(2):
        jt.run_epoch()
    tt.load_params(kge_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), "cpu"))
    by_arity = case == "RealE-arity3"
    max_triples = 150
    with _recorded_ranks() as seen:
        jm = jt.evaluate(max_triples=max_triples, by_arity=by_arity)
        tm = tt.evaluate(max_triples=max_triples, by_arity=by_arity)
    n_ties = _assert_same_ranks(seen, _near_ties(jt, max_triples), case)
    if by_arity:
        assert set(tm) == set(jm) == {3}
        jm, tm = jm[3], tm[3]
    if n_ties == 0:
        assert vars(tm) == vars(jm), (tm, jm)
    else:
        print(f"{case}: {n_ties} near-tie events")


def test_measure_normalize():
    m = tk.Measure()
    m.update_batch(np.array([1, 2, 10, 50]), "raw")
    m.normalize(4)
    assert abs(m.hit1["raw"] - 0.25) < 1e-9
    assert abs(m.hit10["raw"] - 0.75) < 1e-9
    assert abs(m.mr["raw"] - 15.75) < 1e-9
    m.normalize(0)  # an empty evaluation leaves the sums
    assert abs(m.mr["raw"] - 15.75) < 1e-9


# -- the CLI ------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser a CLI's `main` builds, read at parse time."""
    seen = []

    def record(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.undo()
    return [(a.option_strings, a.dest, a.default, a.type, a.choices, a.nargs, a.const)
            for a in seen[0]._actions]


def test_cli_matches_jax(monkeypatch, capsys):
    assert _parser_of(t_cli.main, monkeypatch) == _parser_of(j_cli.main, monkeypatch)
    # the default KG is the JAX CLI's, bit for bit
    np.testing.assert_array_equal(
        generate_kg(n_items=2000, n_clusters=16, seed=1).to_numpy(),
        j_generate_kg(n_items=2000, n_clusters=16, seed=1).to_numpy())
    argv = ["--max_epoch", "1", "--dim", str(DIM), "--test_by_arity"]
    jaxside = {}
    j_init = jk.KGEmbeddingTrainer.__init__

    def jax_init(self, *a, **kw):
        j_init(self, *a, **kw)
        jaxside["trainer"] = self
        jaxside["params"] = jax.tree_util.tree_map(np.asarray, self.params)
        jaxside["rng"] = self.rng

    monkeypatch.setattr(jk.KGEmbeddingTrainer, "__init__", jax_init)
    with _recorded_ranks() as seen:
        jm = j_cli.main(argv)
        j_out = capsys.readouterr().out
        # the port from the JAX initial tables, on the JAX draws
        t_init = tk.KGEmbeddingTrainer.__init__

        def port_init(self, *a, **kw):
            t_init(self, *a, **kw)
            self.load_params(kge_params_from_jax(jaxside["params"], "cpu"))

        def jax_draws(self):
            jaxside["rng"], draws = _jax_draws(jaxside["trainer"], jaxside["rng"])
            return draws

        monkeypatch.setattr(tk.KGEmbeddingTrainer, "__init__", port_init)
        monkeypatch.setattr(tk.KGEmbeddingTrainer, "draw", jax_draws)
        tm = t_cli.main(argv, device="cpu")
        t_out = capsys.readouterr().out
    jt = jaxside["trainer"]
    # events of the evaluation and of the by-arity evaluation, in order
    ties = _near_ties(jt, 2000)
    ties = {s: ties[s] * 2 for s in ties}
    if _assert_same_ranks(seen, ties, "cli") == 0:
        assert vars(tm) == vars(jm), (tm, jm)
        assert t_out == j_out
    assert t_out.count("\n") == j_out.count("\n") == 2
    assert t_out.splitlines()[1].startswith("arity 2: hit@1")


# -- learning (the slow tier's twins of tests/test_kg_embedding.py) ------------

@pytest.mark.slow
@pytest.mark.parametrize("model", ["TransE", "DistMult", "RealE"])
def test_kge_learns_structure(model):
    kg, n_ent, n_rel = _triples(400, 8, 2, n_attrs_per_cluster=4, max_triples_per_item=8)
    cfg = tk.KGEConfig(model=model, dim=32, lrate=0.03 if model == "RealE" else 0.01,
                       batch_size=512, max_epoch=40)
    trainer = tk.KGEmbeddingTrainer(kg, n_ent, n_rel, cfg, device="cpu")
    losses = [trainer.run_epoch() for _ in range(cfg.max_epoch)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    m = trainer.evaluate(max_triples=200)
    assert m.hit10["fil"] > 0.15, (model, m.hit10)
    assert m.mrr["fil"] >= m.mrr["raw"] - 1e-9


@pytest.mark.slow
def test_reale_hyper_relational_arity3():
    tuples, n_ent, n_rel = _arity3(n_tuples=3000)
    cfg = tk.KGEConfig(model="RealE", dim=32, lrate=0.03, batch_size=512, max_epoch=30)
    tr = tk.KGEmbeddingTrainer(None, n_ent, n_rel, cfg, tuples=tuples, device="cpu")
    losses = [tr.run_epoch() for _ in range(cfg.max_epoch)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    by_ar = tr.evaluate(max_triples=150, by_arity=True)
    assert set(by_ar) == {3}
    assert by_ar[3].hit10["fil"] > 0.15, by_ar[3].hit10
