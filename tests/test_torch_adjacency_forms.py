"""The data and the building blocks of the other adjacency forms in the port
against the JAX package, at a small size (60 users x 90 items):

  * `raw_adj` (the unnormalised bipartite matrix) and `bip_src` (each of its
    entries' interaction edge) bit for bit, both directions, and the kernel
    layouts packed from them (base and dedup) bit for bit;
  * `renormalize_sym` on edge-dropped bipartite values, within 1e-6 of
    their scale (an rsqrt and two products in float32);
  * `segment_softmax` over [E, heads] scores with an [E, heads] mask (AutoCF's
    call; the port took only 1-D scores before), within 1e-6;
  * `EquivSetGNNScatter` over the rectangular U x I incidence and its
    transpose and `DenseEquivSetGNN` over a dense incidence, with the flax
    parameters carried across: output and input gradient within 1e-5 of
    their scale (float32 sums in another order);
  * `update_extras` gets the trainer's card generator (BUIR's hook ignores
    it; the hook had no generator before).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu import data as jd
from hypergraph_diffusion_for_recommendation_tpu.core.types import with_new_vals as j_with_new_vals
from hypergraph_diffusion_for_recommendation_tpu.models import layers as jl
from hypergraph_diffusion_for_recommendation_tpu.ops import sparse as jsp
from hypergraph_diffusion_for_recommendation_tpu.ops.pallas import segment_spmm as jss
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.core.types import with_new_vals
from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
from hypergraph_diffusion_for_recommendation_tpu_torch.models import layers as tlayers
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse as tsp
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as tss
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import params_from_jax

NEEDS = {"adj", "raw_adj"}


@pytest.fixture(scope="module")
def graphs():
    train, test, _ = td.synthetic_dataset(n_users=60, n_items=90, mean_degree=10.0, seed=4)
    jcf = jd.build_cf_device_data(jd.build_interaction(train, test), eval_user_multiple=64,
                                  needs=NEEDS)
    tcf = td.build_cf_device_data(td.build_interaction(train, test), "cpu",
                                  eval_user_multiple=64, needs=NEEDS)
    return jcf, tcf


def _eq(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _close(got, want, rtol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def test_raw_adj_and_bip_src_bit_for_bit(graphs):
    jcf, tcf = graphs
    # raw_adj needs raw_int (bip_src indexes its values); the rest stays unbuilt
    assert tcf.raw_int is not None and tcf.int_norm is None and tcf.b_hyper is None
    for side in ("fwd", "bwd"):
        js, ts = getattr(jcf.raw_adj, side), getattr(tcf.raw_adj, side)
        for f in ("rows", "cols", "vals"):
            _eq(getattr(ts, f), getattr(js, f), f"raw_adj.{side}.{f}")
        assert (ts.nrows, ts.ncols, ts.nnz) == (js.nrows, js.ncols, js.nnz)
    _eq(tcf.raw_adj.t_perm, jcf.raw_adj.t_perm, "raw_adj.t_perm")
    _eq(tcf.bip_src, jcf.bip_src, "bip_src")
    assert tcf.bip_src.dtype == torch.int32
    # each live bipartite entry traces back to its interaction edge
    n_u = tcf.n_users
    live = tcf.raw_adj.fwd.rows < tcf.n_nodes
    r, c = tcf.raw_adj.fwd.rows[live].long(), tcf.raw_adj.fwd.cols[live].long()
    src = tcf.bip_src[live].long()
    u = torch.where(r < n_u, r, c)
    i = torch.where(r < n_u, c, r) - n_u
    assert torch.equal(tcf.raw_int.fwd.rows[src].long(), u)
    assert torch.equal(tcf.raw_int.fwd.cols[src].long(), i)
    # without raw_adj, bip_src is empty
    none = td.build_cf_device_data(td.build_interaction(*td.synthetic_dataset(
        n_users=60, n_items=90, mean_degree=10.0, seed=4)[:2]), "cpu", eval_user_multiple=64,
        needs={"adj"})
    assert none.raw_adj is None and none.raw_int is None and none.bip_src.numel() == 0


@pytest.mark.parametrize("dedup", [False, True], ids=["base", "dedup"])
def test_raw_adj_kernel_layouts_bit_for_bit(graphs, dedup):
    jcf, tcf = graphs
    tiles = dict(edge_block=64, row_block=32)
    jpack = jss.pack_blocked_dedup if dedup else jss.pack_blocked
    tpack = tss.pack_blocked_dedup if dedup else tss.pack_blocked
    for side, canon in (("fwd", None), ("bwd", tcf.raw_adj.t_perm.numpy())):
        s = getattr(tcf.raw_adj, side)
        args = (s.rows.numpy(), s.cols.numpy(), s.vals.numpy(), s.shape)
        jb = jpack(*args, canon_map=canon, **tiles)
        tb = tpack(*args, canon_map=canon, device="cpu", **tiles)
        fields = ("cols", "vals", "local_rows", "wmap", "src", "canon") + (
            ("ucols", "local_cols") if dedup else ())
        for f in fields:
            _eq(getattr(tb, f), getattr(jb, f), f"{side}.{f}")


def _view_vals(cf, keep, xp):
    """Edge-dropped interaction values carried to the bipartite entries."""
    vals = cf.raw_int.fwd.vals * xp.asarray(keep.astype(np.float32))
    return vals[cf.bip_src.long() if xp is torch else cf.bip_src]


def test_renormalize_sym_matches_jax(graphs):
    jcf, tcf = graphs
    keep = np.random.default_rng(2).random(tcf.raw_int.fwd.nnz_pad) < 0.7
    want = jsp.renormalize_sym(j_with_new_vals(
        jcf.raw_adj.fwd, _view_vals(jcf, keep, jnp))).vals
    got = tsp.renormalize_sym(with_new_vals(tcf.raw_adj.fwd, _view_vals(tcf, keep, torch)))
    _close(got.vals.numpy(), want, 1e-6, "renormalised values")
    # the layout-free COO keeps its structure; the dropped edges stay 0
    assert torch.equal(got.rows, tcf.raw_adj.fwd.rows)
    assert float(got.vals[~torch.as_tensor(keep)[tcf.bip_src.long()]].abs().max()) == 0.0


@pytest.mark.parametrize("use_valid", [True, False])
def test_segment_softmax_over_heads_matches_jax(use_valid):
    rng = np.random.default_rng(5)
    n, heads = 12, 4
    ids = rng.integers(0, n, 70).astype(np.int32)  # unsorted, as AutoCF's decoder rows
    ids[ids == 3] = 2  # segment 3 stays empty
    scores = rng.standard_normal((70, heads)).astype(np.float32)
    valid = np.broadcast_to((rng.random(70) < 0.8)[:, None], (70, heads))
    v = (jnp.asarray(valid), torch.as_tensor(valid.copy())) if use_valid else (None, None)
    want = jsp.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), n, v[0])
    got = tsp.segment_softmax(torch.as_tensor(scores), torch.as_tensor(ids), n, v[1])
    assert got.shape == (70, heads)
    _close(got.numpy(), want, 1e-6, "softmax")
    # each head's column is the 1-D softmax of that column, bit for bit
    for h in range(heads):
        one = tsp.segment_softmax(torch.as_tensor(scores[:, h].copy()), torch.as_tensor(ids), n,
                                  None if v[1] is None else v[1][:, h].contiguous())
        assert torch.equal(one, got[:, h])


@pytest.mark.parametrize("case", ["scatter_users", "scatter_items", "dense"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_equivset_wrappers_match_jax(graphs, case, train, monkeypatch):
    from flax import linen as fnn

    # training mode with dropout the identity on both sides (flax's stream
    # cannot be reproduced): the same function as in eval, through the train path
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(tlayers, "feature_dropout", lambda x, *a, **k: x)
    jcf, tcf = graphs
    d = 16
    rng = np.random.default_rng(11)
    if case == "dense":
        n, n_edges = 40, 8
        inc = rng.standard_normal((n, n_edges)).astype(np.float32)
        inc[:, 3] = -1.0  # a hyperedge with no vertex: its mean is 0
        jm, tm = jl.DenseEquivSetGNN(d), tlayers.DenseEquivSetGNN(d)
        jinc, tinc = jnp.asarray(inc), torch.as_tensor(inc)
    else:
        users = case == "scatter_users"
        n, n_edges = (tcf.n_users, tcf.n_items) if users else (tcf.n_items, tcf.n_users)
        jh = jcf.raw_int if users else jcf.raw_int.replace(fwd=jcf.raw_int.bwd,
                                                           bwd=jcf.raw_int.fwd)
        th = tcf.raw_int if users else tcf.raw_int.replace(fwd=tcf.raw_int.bwd,
                                                           bwd=tcf.raw_int.fwd)
        jm, tm = jl.EquivSetGNNScatter(d, n_edges), tlayers.EquivSetGNNScatter(d, n_edges)
        jinc, tinc = jh, th
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((n, d)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jinc)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params["params"]), "cpu")
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)

    def jf(xx):
        return jm.apply(params, xx, jinc, train)

    want = jf(jnp.asarray(x))
    jgrad = jax.grad(lambda xx: jnp.sum(jf(xx) * jnp.asarray(w)))(jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_(True)
    got = tm(tx, tinc, train)
    (got * torch.as_tensor(w)).sum().backward()
    _close(got.detach().numpy(), want, 1e-5, f"{case} output")
    _close(tx.grad.numpy(), jgrad, 1e-5, f"{case} input gradient")


def test_update_extras_gets_the_trainer_generator(graphs):
    """The hook is called with the trainer's card generator (the one its
    step graphs register), which BUIR's EMA ignores."""
    _, tcf = graphs
    bundle = build_model(make_config("BUIR", embedding_size=16, batch_size=32), tcf)
    seen = []
    hook = bundle.update_extras

    def spy(extras, batch, generator):
        seen.append(generator)
        return hook(extras, batch, generator)

    bundle.update_extras = spy
    tr = Trainer(bundle, seed=0)
    tr.train_step(tuple(t[0] for t in tr.sample_epoch()), ())
    assert seen == [tr.drop_gen]


@pytest.mark.parametrize("chunk", [4, 512])
@pytest.mark.parametrize("n", [30, 3], ids=["rows", "relations"])
def test_chunked_sum_matches_scatter_sum(chunk, n):
    """The hub-safe sum the card runs for AutoCF's decoder and the KG's
    relations (`_chunked_sum`, which any device can run): a hub id of 300
    repeats among unsorted ids, out of range ids dropped, [E, heads] and
    [E, d] values, many ids or few; within 1e-6 of the plain `scatter_sum`,
    and the same bits on a second call."""
    rng = np.random.default_rng(12)
    ids = np.concatenate([rng.integers(0, n, 200), np.full(300, n // 2), [n, -1, n + 4]])
    ids = torch.as_tensor(rng.permutation(ids).astype(np.int32))
    for tail in ((), (4,), (16,)):
        values = torch.as_tensor(rng.standard_normal((ids.shape[0],) + tail).astype(np.float32))
        want = tsp.scatter_sum(values, ids, n)
        got = tsp._chunked_sum(values, ids, n, chunk)
        assert got.shape == want.shape
        _close(got.numpy(), want.numpy(), 1e-6, f"chunked sum {tail}")
        assert torch.equal(got, tsp._chunked_sum(values, ids, n, chunk))
    empty = tsp._chunked_sum(torch.zeros(0, 3), torch.zeros(0, dtype=torch.int32), n)
    assert empty.shape == (n, 3) and not empty.any()


def test_hub_gather_backward_matches_indexing():
    # the card's gather whose backward sums through `_chunked_sum`, run here
    # through its autograd Function: the gradient of plain indexing
    rng = np.random.default_rng(13)
    ids = torch.as_tensor(np.concatenate([rng.integers(0, 20, 50), np.full(700, 3)]))
    x = torch.as_tensor(rng.standard_normal((20, 8)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((750, 8)).astype(np.float32))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    (tsp._GatherRows.apply(xa, ids) * w).sum().backward()
    (xb[ids] * w).sum().backward()
    _close(xa.grad.numpy(), xb.grad.numpy(), 1e-6, "gather gradient")
    # on the CPU the hub-safe forms are the plain ones
    assert torch.equal(tsp.gather_rows_hubs(x, ids), x[ids])
    assert torch.equal(tsp.scatter_sum_hubs(w, ids, 20), tsp.scatter_sum(w, ids, 20))


def test_hub_gather_takes_any_id_shape():
    # [B, L] ids, as the JAX `x[ids]` takes them (SASRec's windows, the KG
    # embedding's [B, A] tuples), through the card's autograd Function run
    # here: the value and the gradient of plain indexing, bit for bit
    rng = np.random.default_rng(14)
    ids = torch.as_tensor(rng.integers(0, 20, (16, 12)))
    x = torch.as_tensor(rng.standard_normal((20, 8)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((16, 12, 8)).astype(np.float32))
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = tsp._GatherRows.apply(xa, ids)
    assert torch.equal(out, xb[ids])
    (out * w).sum().backward()
    (xb[ids] * w).sum().backward()
    assert torch.equal(xa.grad, xb.grad)
