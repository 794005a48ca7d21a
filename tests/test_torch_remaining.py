"""The functions the port's already-ported modules lacked, against the JAX
package on the CPU, one parametrised test per JAX module:

  * `train/recommender.py`: `Recommender.from_conf` (the same Config),
    `dump_recommendations` (the same file, byte for byte, from the same
    tables) and `recommend` (the same items, their scores within 1e-6);
  * `data/synthetic.py`: the cold-item, hierarchical, affinity, min-degree
    and popularity-scaled regimes and `oracle_metrics`: bit for bit;
  * `data/normalize.py`, `data/knowledge.py` (`adjacency_dict`,
    `laplacian_dict`) and `core/types.py` (`from_scipy`, `to_scipy`,
    `transpose_coo`): bit for bit;
  * `ops/losses.py`: each loss within rtol 1e-6 of JAX's, and its gradients
    within 1e-5 of their scale;
  * `ops/sampling.py`: `epoch_pointwise_batches`' layout from the JAX draws,
    bit for bit; the port's own draws in range and off the rated items;
  * `ops/sparse.py`: `spmm_t` and `sp_dense_left` within 1e-6 of JAX's scale,
    the same bits on a second call;
  * `ops/dropout.py`: `drop_edges`, `node_dropout_mask` and
    `drop_edges_by_nodes` bit for bit from the same masks (the JAX
    `jax.random.bernoulli` and the port's `bernoulli_mask` both handed one
    numpy stream), and the port's keep fractions within 5 standard
    deviations of the keep rate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from hypergraph_diffusion_for_recommendation_tpu import core as jcore
from hypergraph_diffusion_for_recommendation_tpu import data as jd
from hypergraph_diffusion_for_recommendation_tpu.core import make_config as j_make_config
from hypergraph_diffusion_for_recommendation_tpu.data import knowledge as jknow
from hypergraph_diffusion_for_recommendation_tpu.data import normalize as jnorm
from hypergraph_diffusion_for_recommendation_tpu.data import synthetic as jsyn
from hypergraph_diffusion_for_recommendation_tpu.ops import dropout as jdrop
from hypergraph_diffusion_for_recommendation_tpu.ops import losses as jloss
from hypergraph_diffusion_for_recommendation_tpu.ops import sampling as jsam
from hypergraph_diffusion_for_recommendation_tpu.ops import sparse as jsp
from hypergraph_diffusion_for_recommendation_tpu.train import recommender as jrec
from hypergraph_diffusion_for_recommendation_tpu_torch import core as tcore
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import knowledge as tknow
from hypergraph_diffusion_for_recommendation_tpu_torch.data import normalize as tnorm
from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic as tsyn
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import dropout as tdrop
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import losses as tloss
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sampling as tsam
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse as tsp
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
SPMM_RTOL = 1e-6


def _close(got, want, rtol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _csr_eq(got, want, what):
    got, want = got.tocsr(), want.tocsr()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def split():
    return td.synthetic_dataset(n_users=50, n_items=70, mean_degree=9.0, seed=2, with_kg=True)


# -- train/recommender.py ------------------------------------------------------

@pytest.mark.parametrize("what", ["from_conf", "dump_recommendations", "recommend"])
def test_recommender_matches_jax(what, split, tmp_path):
    if what == "from_conf":
        path = tmp_path / "LightGCN.conf"
        path.write_text("model.name=LightGCN\ndataset=lastfm\nembedding.size=32\n"
                        "num.max.epoch=7\nbatch_size=256\nlearnRate=0.005\n"
                        "item.ranking=-topN 10,20\n")
        rec = Recommender.from_conf(str(path), device="cpu", seed=3)
        want = jrec.Recommender.from_conf(str(path), seed=3)
        assert dataclasses.asdict(rec.cfg) == dataclasses.asdict(want.cfg)
        assert rec.device == torch.device("cpu")
        return
    train, test, _ = split
    kw = dict(embedding_size=16, eval_user_batch=64, item_ranking=(5, 10),
              output_dir=str(tmp_path / "out"))
    rec = Recommender(make_config("LightGCN", **kw), device="cpu")
    rec.build((train, test, None))
    jr = jrec.Recommender(j_make_config("LightGCN", **kw))
    jr.inter = jd.build_interaction(train, test)
    jr.cf_dev = jd.build_cf_device_data(jr.inter, eval_user_multiple=64)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((rec.inter.n_users, 16)).astype(np.float32)
    i = rng.standard_normal((rec.inter.n_items, 16)).astype(np.float32)
    rec.user_emb, rec.item_emb = torch.as_tensor(u), torch.as_tensor(i)
    jr.user_emb, jr.item_emb = jnp.asarray(u), jnp.asarray(i)
    if what == "recommend":
        for raw in rec.inter.id2user[::7]:
            for exclude in (True, False):
                got = rec.recommend(int(raw), k=10, exclude_rated=exclude)
                want = jr.recommend(int(raw), k=10, exclude_rated=exclude)
                assert [g[0] for g in got] == [w[0] for w in want]
                np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                                           rtol=1e-6, atol=1e-6)
        return
    got = rec.dump_recommendations()
    want = jr.dump_recommendations(str(tmp_path / "jax.txt"))
    assert got.endswith("LightGCN-top-10items.txt")
    text = open(got, "rb").read()
    assert text == open(want, "rb").read()
    assert text.count(b"\n") == 1 + rec.cf_dev.eval_data.n_test_users and b"*" in text


# -- data/synthetic.py -----------------------------------------------------------

SYN = dict(n_users=60, n_items=150, n_clusters=6, mean_degree=10.0, seed=9)


@pytest.mark.parametrize("regime", ["cold_item", "hierarchy", "affinity_min_degree",
                                    "pop_scale", "oracle", "oracle_hierarchy"])
def test_synthetic_matches_jax(regime):
    if regime == "pop_scale":
        scale = np.random.default_rng(1).uniform(0.05, 2.0, SYN["n_items"])
        got = [tsyn.generate_interactions(**SYN, pop_scale=scale)]
        want = [jsyn.generate_interactions(**SYN, pop_scale=scale)]
    elif regime.startswith("oracle"):
        kw = dict(SYN, hierarchy=(2, 3), sibling_affinity=5.0) if regime.endswith(
            "hierarchy") else SYN
        train, test, _ = tsyn.synthetic_dataset(**kw)
        got = tsyn.oracle_metrics(train, test, **kw, cluster_seed=SYN["seed"], k=10)
        want = jsyn.oracle_metrics(train, test, **kw, cluster_seed=SYN["seed"], k=10)
        assert got == want and got["recall"] > got["recall_pop"]
        return
    else:
        kw = {"cold_item": dict(cold_item_frac=0.1, with_kg=True),
              "hierarchy": dict(hierarchy=(2, 3), sibling_affinity=4.0),
              "affinity_min_degree": dict(affinity=3.0, min_degree=8)}[regime]
        got = tsyn.synthetic_dataset(**SYN, **kw)
        want = jsyn.synthetic_dataset(**SYN, **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif hasattr(w, "to_numpy"):
            assert g.equals(w)
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), regime


# -- data/normalize.py, data/knowledge.py, core/types.py -----------------------

@pytest.mark.parametrize("fn", ["normalize_graph_mat_hyper", "random_walk_norm",
                                "symmetric_norm"])
def test_normalize_matches_jax(fn):
    rng = np.random.default_rng(3)
    mat = sps.random(40, 25, density=0.15, random_state=rng, format="csr", dtype=np.float32)
    mat = mat.tolil()
    mat[3] = 0  # an empty row and column: their inverse degrees are 0
    mat[:, 7] = 0
    mat = mat.tocsr()
    mat.eliminate_zeros()
    if fn != "normalize_graph_mat_hyper":
        mat = (mat @ mat.T).tocsr()
    _csr_eq(getattr(tnorm, fn)(mat), getattr(jnorm, fn)(mat), fn)


@pytest.mark.parametrize("what", ["adjacency_dict", "random-walk", "symmetric"])
def test_knowledge_dicts_match_jax(what, split):
    train, test, kg = split
    tkg = tknow.build_knowledge(kg, td.build_interaction(train, test))
    jkg = jknow.build_knowledge(kg, jd.build_interaction(train, test))
    if what == "adjacency_dict":
        got, want = tkg.adjacency_dict(), jkg.adjacency_dict()
    else:
        got, want = tkg.laplacian_dict(what), jkg.laplacian_dict(what)
        with pytest.raises(ValueError, match="laplacian_type"):
            tkg.laplacian_dict("other")
    assert sorted(got) == sorted(want) and len(got) == tkg.n_relations
    for rel in want:
        _csr_eq(got[rel], want[rel], f"{what} {rel}")


@pytest.mark.parametrize("fn", ["from_scipy", "to_scipy", "transpose_coo"])
def test_types_match_jax(fn):
    rng = np.random.default_rng(6)
    mat = sps.random(30, 45, density=0.1, random_state=rng, format="csr", dtype=np.float32)
    jm, tm = jcore.from_scipy(mat), tcore.from_scipy(mat, "cpu")
    if fn == "to_scipy":
        _csr_eq(tcore.to_scipy(tm), jcore.to_scipy(jm), fn)
        _csr_eq(tcore.to_scipy(tm), mat, "round trip")
        return
    if fn == "transpose_coo":
        jm, tm = jcore.transpose_coo(jm), tcore.transpose_coo(tm)
    assert (tm.nrows, tm.ncols, tm.nnz) == (jm.nrows, jm.ncols, jm.nnz)
    for f in ("rows", "cols", "vals"):
        got, want = getattr(tm, f).numpy(), np.asarray(getattr(jm, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f"{fn} {f}"


# -- ops/losses.py ---------------------------------------------------------------

def _loss_inputs(name, rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if name == "triplet_loss":
        return (f(32, 8), f(32, 8), f(32, 8)), {}
    if name == "l2_reg_loss_sq":
        return (0.01, f(10, 8), f(7, 8)), {}
    if name in ("contrast_loss", "contrast_loss_masked"):
        nodes = np.unique(rng.integers(0, 40, 24)).astype(np.int32)
        args = (f(40, 8), f(40, 8), nodes)
        if name == "contrast_loss_masked":
            args += (rng.random(nodes.shape[0]) < 0.7,)
        return args + (0.2,), {}
    if name in ("kl_divergence", "js_divergence"):
        return (f(16, 10), f(16, 10)), {}
    return (f(12, 8), f(12, 6), f(12, 8, 6), f(12, 8), f(12, 8), 0.01, 12), {}  # transr


@pytest.mark.parametrize("name", ["triplet_loss", "l2_reg_loss_sq", "contrast_loss",
                                  "contrast_loss_masked", "kl_divergence", "js_divergence",
                                  "transr_kg_loss"])
def test_losses_match_jax(name):
    args, _ = _loss_inputs(name, np.random.default_rng(8))
    floats = [k for k, a in enumerate(args) if isinstance(a, np.ndarray)
              and a.dtype == np.float32]
    t_args = [torch.tensor(a, requires_grad=k in floats) if isinstance(a, np.ndarray) else a
              for k, a in enumerate(args)]
    loss = getattr(tloss, name)(*t_args)
    loss.backward()

    def jfn(*fl):
        full = list(args)
        for k, v in zip(floats, fl):
            full[k] = v
        return getattr(jloss, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                      for a in full])

    jval, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(floats))))(
        *[jnp.asarray(args[k]) for k in floats])
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=LOSS_RTOL)
    for k, g in zip(floats, jgrads):
        _close(t_args[k].grad.numpy(), np.asarray(g), GRAD_RTOL, f"{name} d{k}")


# -- ops/sampling.py -------------------------------------------------------------

def test_pointwise_batches_match_jax(split):
    train, test, _ = split
    ji = jd.build_interaction(train, test)
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64)
    tcf = td.build_cf_device_data(td.build_interaction(train, test), "cpu",
                                  eval_user_multiple=64)
    n, batch, n_negs = int(jcf.edge_u.shape[0]), 96, 3
    rng = jax.random.PRNGKey(5)
    want = jsam.epoch_pointwise_batches(rng, jcf.edge_u, jcf.edge_i, jcf.rated_pad, jcf.n_items,
                                        batch, n_negs)
    # the JAX draws: its permutation, wrapped, and the negatives it placed
    total = -(-n // batch) * batch
    perm = np.asarray(jax.random.permutation(jax.random.split(rng)[0], n))
    idx = np.concatenate([perm, perm[: total - n]])
    negs = np.asarray(want[1]).reshape(total, 1 + n_negs)[:, 1:]
    got = tsam.pointwise_layout(torch.tensor(idx), torch.tensor(negs), tcf.edge_u,
                                tcf.edge_i, batch)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the port's own draws: the same layout, negatives in range and unrated
    users, items, labels = tsam.epoch_pointwise_batches(
        torch.Generator().manual_seed(0), tcf.edge_u, tcf.edge_i, tcf.rated_pad, tcf.n_items,
        batch, n_negs)
    assert users.shape == items.shape == labels.shape == (total // batch, batch * (1 + n_negs))
    rows = items.reshape(-1, 1 + n_negs)
    assert sorted(rows[:n, 0].tolist()) == sorted(tcf.edge_i.tolist())
    assert bool((labels.reshape(-1, 1 + n_negs) == torch.tensor([1.0] + [0.0] * n_negs)).all())
    neg_users = users.reshape(-1, 1 + n_negs)[:, 1:].reshape(-1)
    negs = rows[:, 1:].reshape(-1)
    assert int(negs.min()) >= 0 and int(negs.max()) < tcf.n_items
    assert not bool(tsam.is_rated(tcf.rated_pad, neg_users, negs).any())


# -- ops/sparse.py ---------------------------------------------------------------

@pytest.mark.parametrize("fn", ["spmm_t", "sp_dense_left"])
def test_sparse_transposed_products_match_jax(fn):
    rng = np.random.default_rng(7)
    mat = sps.random(60, 35, density=0.12, random_state=rng, format="csr", dtype=np.float32)
    jm, tm = jcore.from_scipy(mat), tcore.from_scipy(mat, "cpu")
    x = rng.standard_normal((60, 8) if fn == "spmm_t" else (8, 60)).astype(np.float32)
    if fn == "spmm_t":
        got, want = tsp.spmm_t(tm, torch.as_tensor(x)), jsp.spmm_t(jm, jnp.asarray(x))
        exact = mat.T.astype(np.float64) @ x.astype(np.float64)
    else:
        got = tsp.sp_dense_left(torch.as_tensor(x), tm)
        want = jsp.sp_dense_left(jnp.asarray(x), jm)
        exact = x.astype(np.float64) @ mat.astype(np.float64)
    assert got.shape == want.shape == exact.shape
    _close(got.numpy(), np.asarray(want), SPMM_RTOL, fn)
    _close(got.numpy(), exact, SPMM_RTOL, f"{fn} against f64")
    again = tsp.spmm_t(tm, torch.as_tensor(x)) if fn == "spmm_t" else tsp.sp_dense_left(
        torch.as_tensor(x), tm)
    assert torch.equal(got, again)


# -- ops/dropout.py --------------------------------------------------------------

@pytest.mark.parametrize("fn", ["drop_edges", "node_dropout_mask", "drop_edges_by_nodes"])
def test_dropout_matches_jax(fn, monkeypatch):
    rng = np.random.default_rng(9)
    mat = sps.random(50, 40, density=0.2, random_state=rng, format="csr", dtype=np.float32)
    jm, tm = jcore.from_scipy(mat), tcore.from_scipy(mat, "cpu")
    # one numpy stream of Bernoulli masks, in call order, for both packages
    masks = {"jax": np.random.default_rng(10), "torch": np.random.default_rng(10)}

    def draw(side, p, shape):
        return masks[side].random(tuple(shape)) < p

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(draw("jax", p, shape)))
    monkeypatch.setattr(tdrop, "bernoulli_mask",
                        lambda gen, p, shape, device: torch.as_tensor(draw("torch", p, shape)))
    key = jax.random.PRNGKey(0)
    if fn == "node_dropout_mask":
        got = tdrop.node_dropout_mask(None, 77, 0.3, "cpu").numpy()
        want = np.asarray(jdrop.node_dropout_mask(key, 77, 0.3))
    else:
        rate = 0.7 if fn == "drop_edges" else 0.2
        got = getattr(tdrop, fn)(None, tm, rate).vals.numpy()
        want = np.asarray(getattr(jdrop, fn)(key, jm, rate).vals)
        assert (got == 0).any() and (got != 0).any()
        # at rate 1 (or 0) the matrix comes back unchanged
        assert getattr(tdrop, fn)(None, tm, 1.0 if fn == "drop_edges" else 0.0) is tm
    assert got.dtype == want.dtype and np.array_equal(got, want), fn
    monkeypatch.undo()
    # the port's own draws: the keep fraction within 5 standard deviations
    big = tcore.from_edges(np.arange(200_000) % 500, np.arange(200_000) // 500, None,
                           (500, 400), "cpu")
    gen = torch.Generator().manual_seed(1)
    if fn == "node_dropout_mask":
        n, p = 200_000, 0.7
        kept = int(tdrop.node_dropout_mask(gen, n, 0.3, "cpu").sum())
        sd = (n * p * (1 - p)) ** 0.5 / n
    elif fn == "drop_edges":
        n, p = big.nnz, 0.7
        kept = int((tdrop.drop_edges(gen, big, p).vals != 0).sum())
        sd = (n * p * (1 - p)) ** 0.5 / n
    else:
        # an edge survives when both its nodes do, (1 - rate)^2; the spread is
        # that of the product of the 500 rows' and 400 columns' keep fractions
        n, q = big.nnz, 0.8
        kept = int((tdrop.drop_edges_by_nodes(gen, big, 1 - q).vals != 0).sum())
        p = q * q
        sd = (q * q * q * (1 - q) * (1 / 500 + 1 / 400)) ** 0.5
    assert abs(kept / n - p) <= 5 * sd, (fn, kept / n, p, sd)
