"""The fused ranking (`ops/kernels/score_topk.py`) on the CPU: its plain
version against the blocked scoring and select it stands for and against
the JAX package's `masked_topk`, the choice between the fused and the
blocked path, `ranking_metrics` on the CPU as it was before the fused path,
and every caller of `eval.metrics.top_items` reaching the fused path with
its own users and k. The kernel itself runs in
`tests/test_torch_kernels_gpu.py` on a card."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu.ops import topk as jt
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.eval import metrics as tm
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import topk as tt
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import score_topk as fs
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import topk_select as ts

TOP_NS = (5, 10, 20)


def _dyadic(rng, shape, levels: int = 8) -> np.ndarray:
    """Multiples of 1/16 in [-levels/16, levels/16]: products are multiples of
    1/256 and a row's sum is exact in any order, with many exact ties."""
    return (rng.integers(-levels, levels + 1, shape) / 16).astype(np.float32)


def _rated(rng, n_users: int, n_items: int, deg: int) -> np.ndarray:
    """[n_users, deg + 3] int32 rated lists in no order, pad -1, with repeats
    and ids outside [0, n_items); user 0 rated every item but two when deg
    allows."""
    rated = rng.integers(0, n_items, (n_users, deg + 3)).astype(np.int32)
    lens = rng.integers(0, deg + 1, n_users)
    rated[np.arange(deg + 3)[None, :] >= lens[:, None]] = -1
    rated[:, -3:] = [n_items, n_items + 5, -1]
    if deg >= n_items:
        rated[0, : n_items - 2] = rng.permutation(n_items)[: n_items - 2]
    return rated


def _case(seed: int, n_users: int = 70, n_items: int = 133, d: int = 24, deg: int = 30):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, 2 * n_users).astype(np.int32)
    return (torch.as_tensor(_dyadic(rng, (n_users, d))), torch.as_tensor(users),
            torch.as_tensor(_dyadic(rng, (n_items, d))),
            torch.as_tensor(_rated(rng, n_users, n_items, deg)))


@pytest.mark.parametrize("block", [1, 7, 512])
@pytest.mark.parametrize("k", [1, 20, 133, 300])
def test_reference_is_the_blocked_scoring_and_select(k, block):
    u, users, i, rated = _case(seed=k + block)
    got = fs.score_topk_reference(u, users, i, rated, k, block=block)
    vals, ids = [], []
    for s in range(0, users.shape[0], block):
        rows = users[s:s + block].long()
        scores = tt.exact_scores(u.index_select(0, rows), i)
        v, j = ts.topk_select_reference(scores, rated.index_select(0, rows), k)
        vals.append(v)
        ids.append(j)
    assert torch.equal(got[1], torch.cat(ids))
    assert torch.equal(got[0].view(torch.int32), torch.cat(vals).view(torch.int32))
    assert tuple(got[1].shape) == (users.shape[0], min(k, i.shape[0]))
    # on these sums, exact in any order, the blocks change nothing
    whole = ts.topk_select_reference(tt.exact_scores(u[users.long()], i), rated[users.long()], k)
    assert torch.equal(got[1], whole[1]) and torch.equal(got[0], whole[0])


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("k", [1, 10, 40])
def test_ids_match_jax_masked_topk(k, masked):
    # JAX's lax.top_k orders -0.0 below +0.0 and the port ties them: these
    # scores are nonzero multiples of 1/256 plus 1/512, so no zero arises
    u, users, i, rated = _case(seed=100 + k, n_items=300, deg=40)
    u_np, i_np = u.numpy(), i.numpy()
    rows = users.long()
    got = fs.score_topk(u, users, i, rated if masked else None, k)
    scores = jnp.dot(jnp.asarray(u_np)[users.numpy()], jnp.asarray(i_np).T,
                     precision="highest") + np.float32(1 / 512)
    want_scores = torch.as_tensor(np.array(scores))
    if masked:
        want_vals, want_ids = jt.masked_topk(scores, jnp.asarray(rated.numpy()[users.numpy()]), k)
    else:
        want_vals, want_ids = jt.topk_ids(scores, k)
    mine = fs.score_topk_reference(u, users, i, rated if masked else None, k)
    ours = ts.topk_select_reference(
        want_scores, rated[rows] if masked else None, k)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(want_vals))
    # the offset moves no order: the port's own scores give the same ids
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(mine[1].numpy(), got[1].numpy())


class _Table(types.SimpleNamespace):
    """The attributes `covers` reads, for a table on a card this host lacks."""

    def dim(self):
        return len(self.shape)


def _table(rows: int, d: int, dtype=torch.float32, device: str = "cuda"):
    return _Table(shape=(rows, d), dtype=dtype, device=torch.device(device))


@pytest.mark.parametrize("d,k,dtype,device,want", [
    (64, 40, torch.float32, "cuda", True),       # the LightGCN Amazon-Book cell
    (128, 40, torch.float32, "cuda", True),      # KHGRec's and HGNN_HD3's hyper_dim
    (256, 256, torch.float32, "cuda", True),     # the limits
    (1, 1, torch.float32, "cuda", True),
    (257, 40, torch.float32, "cuda", False),     # too wide
    (64, 257, torch.float32, "cuda", False),     # k past KMAX
    (64, 0, torch.float32, "cuda", False),
    (64, 40, torch.bfloat16, "cuda", False),     # not f32
    (64, 40, torch.float32, "cpu", False),       # the CPU: the blocked path
])
def test_the_fused_path_is_chosen_from_width_k_and_device(d, k, dtype, device, want):
    u, i = _table(1000, d, dtype, device), _table(5000, d, dtype, device)
    rated = _Table(shape=(1000, 8), dtype=torch.int32, device=torch.device(device))
    assert fs.covers(u, i, rated, k) is want
    assert fs.covers(u, i, None, k) is want


def test_the_fused_path_needs_one_device():
    u = _table(1000, 64)
    assert not fs.covers(u, _table(5000, 64, device="cuda:1"), None, 40)
    rated = _Table(shape=(1000, 8), dtype=torch.int32, device=torch.device("cpu"))
    assert not fs.covers(u, _table(5000, 64), rated, 40)
    assert not fs.covers(u, _table(5000, 32), None, 40)  # widths differ


@pytest.fixture(scope="module")
def cf(tiny_dataset):
    train, test = tiny_dataset
    inter = td.build_interaction(train, test)
    dev = td.build_cf_device_data(inter, "cpu", eval_user_multiple=64, needs={"adj"})
    rng = np.random.default_rng(21)
    u = torch.as_tensor(rng.standard_normal((inter.n_users, 16)).astype(np.float32))
    i = torch.as_tensor(rng.standard_normal((inter.n_items, 16)).astype(np.float32))
    return dev, u, i


def _blocked_metrics(u, i, dev, top_ns, block):
    """`ranking_metrics` as it read before the fused path: each block scored
    with `exact_scores` and ranked with `masked_topk`."""
    users = dev.eval_data.test_users.long()
    ids = [tt.masked_topk(tt.exact_scores(u.index_select(0, rows), i),
                          dev.rated_pad.index_select(0, rows), max(top_ns))[1]
           for rows in users.split(block)]
    return tm.metrics_from_topk(torch.cat(ids), dev.eval_data, top_ns, block)


@pytest.mark.parametrize("block", [64, 32])
def test_cpu_ranking_metrics_are_those_of_the_blocked_path(cf, block, monkeypatch):
    dev, u, i = cf

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU must not take the fused path")

    monkeypatch.setattr(fs, "score_topk", refuse)
    got = tm.ranking_metrics(u, i, dev.rated_pad, dev.eval_data, TOP_NS, block=block)
    want = _blocked_metrics(u, i, dev, TOP_NS, block)
    for name in ("hit_ratio", "precision", "recall", "ndcg"):
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("block", [64, 32])
def test_the_fused_path_ranks_every_test_user_in_one_call(cf, block, monkeypatch):
    # the fused path's plumbing, with the plain version in the kernel's place:
    # one call for the whole evaluation inside one eval.topk span, the metrics
    # from its ids a block at a time
    dev, u, i = cf
    calls, spans = [], []
    real_span = tm.span

    def plain(user_emb, users, item_emb, rated, k):
        calls.append((users.shape[0], k))
        return fs.score_topk_reference(user_emb, users, item_emb, rated, k)

    def recording(name):
        spans.append(name)
        return real_span(name)

    monkeypatch.setattr(fs, "covers", lambda *args: True)
    monkeypatch.setattr(fs, "score_topk", plain)
    monkeypatch.setattr(tm, "span", recording)
    got = tm.ranking_metrics(u, i, dev.rated_pad, dev.eval_data, TOP_NS, block=block)
    n_pad = dev.eval_data.test_users.shape[0]
    assert calls == [(n_pad, max(TOP_NS))]
    assert spans.count("eval.topk") == 1 and "eval.score" not in spans
    assert spans.count("eval.metrics") == n_pad // block
    want = _blocked_metrics(u, i, dev, TOP_NS, block)
    for name in ("hit_ratio", "precision", "recall", "ndcg"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version():
    u, users, i, rated = _case(seed=5)
    before = dict(fs.LAUNCHES)
    got = fs.score_topk(u, users, i, rated, 9)
    want = fs.score_topk_reference(u, users, i, rated, 9)
    assert fs.LAUNCHES == before  # no kernel on the CPU
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """A LightGCN facade on the CPU whose tables are multiples of 1/16, so
    that a score is exact whatever rows a product holds."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender

    r = Recommender(make_config("LightGCN", embedding_size=16, eval_user_batch=32,
                                item_ranking=(5, 10),
                                output_dir=str(tmp_path_factory.mktemp("out"))), device="cpu")
    r.build(synthetic_dataset(n_users=80, n_items=120, mean_degree=10.0, seed=3))
    r.init_weights(0)
    rng = np.random.default_rng(23)
    r.user_emb = torch.as_tensor(_dyadic(rng, (r.inter.n_users, 16)))
    r.item_emb = torch.as_tensor(_dyadic(rng, (r.inter.n_items, 16)))
    return r


def _ranking_metrics(rec, path):
    cf = rec.cf_dev
    out = tm.ranking_metrics(rec.user_emb, rec.item_emb, cf.rated_pad, cf.eval_data, (5, 10),
                             block=32)
    return {k: v.view(torch.int32).tolist() for k, v in out.items()}, cf.eval_data.test_users, 10


def _evaluate(rec, path):
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer

    tr = Trainer(rec.bundle, seed=0, extras=rec.extras)
    tr.encode = lambda: (rec.user_emb, rec.item_emb)
    return tr.evaluate(), rec.cf_dev.eval_data.test_users, 10


def _retriever(exclude_rated):
    def run(rec, path):
        from hypergraph_diffusion_for_recommendation_tpu_torch.eval.serving import Retriever

        r = Retriever.load(rec.export_embeddings(str(path / "emb.npz")), block=16, device="cpu")
        raw = [int(x) for x in rec.inter.id2user[::3]]  # several blocks, a ragged tail
        ids, scores = r.topk(raw, k=7, exclude_rated=exclude_rated)
        return ((ids.tolist(), scores.view(np.int32).tolist()),
                [rec.inter.user[u] for u in raw], 7)

    return run


def _recommend(rec, path):
    raw = int(rec.inter.id2user[5])
    return rec.recommend(raw, k=9), [rec.inter.user[raw]], 9


def _dump(rec, path):
    ed = rec.cf_dev.eval_data
    out = rec.dump_recommendations(str(path / f"dump{len(list(path.iterdir()))}.txt"), k=6)
    return open(out, "rb").read(), ed.test_users[: ed.n_test_users], 6


@pytest.mark.parametrize("caller,masked", [
    (_ranking_metrics, True), (_evaluate, True), (_retriever(True), True),
    (_retriever(False), False), (_recommend, True), (_dump, True),
], ids=["ranking_metrics", "Trainer.evaluate", "Retriever.topk", "Retriever.topk-unmasked",
        "recommend", "dump_recommendations"])
def test_every_caller_ranks_through_the_fused_path_where_it_covers(rec, tmp_path, monkeypatch,
                                                                  caller, masked):
    # unpatched on the CPU: the blocked path. Patched as on a covered card:
    # one `score_topk` call with the caller's own users and k, nothing of the
    # blocked path, and (on sums exact in any order) the same answer
    want, users, k = caller(rec, tmp_path)
    calls = []

    def plain(user_emb, users, item_emb, rated, k):
        calls.append((users.tolist(), k, rated is not None))
        return fs.score_topk_reference(user_emb, users, item_emb, rated, k)

    def refuse(*args, **kwargs):
        raise AssertionError("a covered ranking took the blocked path")

    monkeypatch.setattr(fs, "covers", lambda *args: True)
    monkeypatch.setattr(fs, "score_topk", plain)
    for name in ("exact_scores", "masked_topk", "topk_ids"):
        monkeypatch.setattr(tm, name, refuse)
    got, _, _ = caller(rec, tmp_path)
    assert calls == [([int(u) for u in users], k, masked)]
    assert got == want
