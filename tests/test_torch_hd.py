"""The port's HD family against the JAX package's.

Both sides build from the same split; the JAX model is initialised and
its parameters are carried across with `weights.params_from_jax`.
`encode_eval` must agree within 1e-5 of the tables' scale (float32, sums
in another order; measured: 7e-7). The HGNN_HD3 training loss and every
gradient are held against `jax.value_and_grad(bundle.batch_loss)` on the
same `HostExactSampler` batch, with the edge-dropout key recorded from the
JAX `AdjPair.dropped` and handed to the port. Feature dropout is patched
to the identity on both sides in these tests only: flax's PRNG stream
cannot be reproduced. The port's feature dropout is checked on its own,
statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from hypergraph_diffusion_for_recommendation_tpu import data as jd
from hypergraph_diffusion_for_recommendation_tpu.core import make_config as j_make_config
from hypergraph_diffusion_for_recommendation_tpu.data import device as jdev
from hypergraph_diffusion_for_recommendation_tpu.models import build_model as j_build_model
from hypergraph_diffusion_for_recommendation_tpu.ops import sampling as jsam
from hypergraph_diffusion_for_recommendation_tpu.ops import sparse as jsparse
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model, model_data_needs
from hypergraph_diffusion_for_recommendation_tpu_torch.models import layers as tlayers
from hypergraph_diffusion_for_recommendation_tpu_torch.models.hd_family import HDModule
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse as tsparse
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.dropout import feature_dropout
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import params_from_jax, init_hd

CFG = dict(hyper_dim=16, n_layers=2, batch_size=128, drop_rate=0.2, cl_rate=0.1, temp=0.2,
           reg=0.1)
# (model, mode): every variant, and the dual-view model in each mode
CASES = [("HD", "full"), ("HGNN_HD", "full"), ("HGNN_HD2", "full"), ("HGNN_HD3", "full"),
         ("HGNN_HD3", "local_only"), ("HGNN_HD3", "group_only"), ("HGNN_HD4", "full"),
         ("WaveletHD", "full"), ("WaveletHD2", "full"), ("LocalEncoder", "full")]


@pytest.fixture(scope="module")
def graphs():
    train, test, _ = td.synthetic_dataset(n_users=60, n_items=90, mean_degree=10.0, seed=4)
    ji = jd.build_interaction(train, test)
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64, needs={"adj", "b_hyper"})
    ti = td.build_interaction(train, test)
    tcf = td.build_cf_device_data(ti, "cpu", eval_user_multiple=64,
                                  needs=model_data_needs("HGNN_HD3"))
    return jcf, tcf


def _pair(graphs, name, mode="full", **kw):
    jcf, tcf = graphs
    cfg = dict(CFG, mode=mode, **kw)
    jb = j_build_model(j_make_config(name, **cfg), jcf)
    params, jextras = jb.init(jax.random.PRNGKey(0))
    tb = build_model(make_config(name, **cfg), tcf)
    tb.module.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                        params["params"]), "cpu"))
    return jb, params, jextras, tb


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def test_data_needs_and_registry():
    assert model_data_needs("HGNN_HD3") == frozenset({"adj", "b_hyper"})
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import MODEL_REGISTRY

    assert {n for n, _ in CASES} <= set(MODEL_REGISTRY)


@pytest.mark.parametrize("name,mode", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_encode_eval_matches_jax(graphs, name, mode):
    jb, params, jextras, tb = _pair(graphs, name, mode)
    ju, ji = jb.encode_eval(params, jextras)
    u, i = tb.encode_eval({})
    assert u.shape == ju.shape and i.shape == ji.shape
    _close(u.numpy(), ju, 1e-5, "users")
    _close(i.numpy(), ji, 1e-5, "items")


def _no_feature_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(tlayers, "feature_dropout", lambda x, *a, **k: x)


def _record_keys(monkeypatch):
    keys = []
    original = jdev.AdjPair.dropped

    def recording(self, rng, keep_rate):
        kd = jnp.asarray(rng)
        kd = (kd if kd.dtype == jnp.uint32 else jax.random.key_data(rng)).reshape(-1)
        keys.append((int(kd[0]), int(kd[-1])))
        return original(self, rng, keep_rate)

    monkeypatch.setattr(jdev.AdjPair, "dropped", recording)
    return keys


def _batch(graphs, seed=4):
    jcf = graphs[0]
    sampler = jsam.HostExactSampler(np.asarray(jcf.edge_u), np.asarray(jcf.edge_i), jcf.n_items)
    users, pos, neg = sampler.pairwise(seed, CFG["batch_size"])
    return tuple(a[0] for a in (users, pos, neg))


@pytest.mark.parametrize("mode", ["full", "wossl"])
def test_hgnn_hd3_loss_and_grads_match_jax(graphs, mode, monkeypatch):
    _no_feature_dropout(monkeypatch)
    jb, params, jextras, tb = _pair(graphs, "HGNN_HD3", mode)
    keys = _record_keys(monkeypatch)
    batch = _batch(graphs)
    (jloss, jaux), jgrads = jax.value_and_grad(jb.batch_loss, has_aux=True)(
        params, jextras, tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(1))
    # both views drop with the same key: the port takes one a step
    assert len(keys) == 2 and keys[0] == keys[1]
    loss, aux = tb.batch_loss({}, tuple(torch.as_tensor(a) for a in batch), keys[:1])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads["params"]), "cpu")
    params_t = dict(tb.module.named_parameters())
    assert set(params_t) == set(want)
    for name, p in params_t.items():
        assert p.grad is not None, name
        _close(p.grad.numpy(), want[name].numpy(), 1e-5, name)


def test_edge_key_changes_the_loss(graphs, monkeypatch):
    _no_feature_dropout(monkeypatch)
    tb = _pair(graphs, "HGNN_HD3")[3]
    batch = tuple(torch.as_tensor(a) for a in _batch(graphs))
    with torch.no_grad():
        a = tb.batch_loss({}, batch, ((1, 2),))[0]
        b = tb.batch_loss({}, batch, ((1, 2),))[0]
        c = tb.batch_loss({}, batch, ((5, 6),))[0]
    assert float(a) == float(b) != float(c)


def test_feature_dropout_semantics():
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(0)
    for rate in (0.2, 0.6):
        y = feature_dropout(x, rate, gen, train=True)
        kept = y != 0
        share = float(kept.float().mean())
        # 200k Bernoulli draws: the kept share within 5 sigma of 1 - rate
        sigma = np.sqrt(rate * (1 - rate) / x.numel())
        assert abs(share - (1 - rate)) < 5 * sigma, (rate, share)
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.0 / (1.0 - rate)))
    assert feature_dropout(x, 0.0, gen, train=True) is x
    assert feature_dropout(x, 0.6, gen, train=False) is x
    assert torch.equal(feature_dropout(x, 1.0, gen, train=True), torch.zeros_like(x))
    # the draws come from the generator: the same seed, the same mask
    a = feature_dropout(x, 0.5, torch.Generator().manual_seed(7), train=True)
    b = feature_dropout(x, 0.5, torch.Generator().manual_seed(7), train=True)
    assert torch.equal(a, b)


def test_dropout_reaches_the_training_loss(graphs):
    # unpatched: the generator the trainer passes drives the ED-HNN dropout
    tb = _pair(graphs, "HGNN_HD3")[3]
    batch = tuple(torch.as_tensor(a) for a in _batch(graphs))
    with torch.no_grad():
        losses = [float(tb.batch_loss({}, batch, ((1, 2),), torch.Generator().manual_seed(s))[0])
                  for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2]


def test_scatter_mean_matches_jax():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((50, 4)).astype(np.float32)
    ids = rng.integers(-1, 12, 50).astype(np.int32)  # out of range: -1 and 10, 11
    want = np.asarray(jsparse.scatter_mean(jnp.asarray(vals), jnp.asarray(ids), 10,
                                           sorted_ids=False))
    got = tsparse.scatter_mean(torch.as_tensor(vals), torch.as_tensor(ids), 10).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_native_init_matches_flax_scales():
    module = HDModule(300, 500, 64, 2, 0.2, "spmm", True, True, True)
    sd = init_hd(module, torch.Generator().manual_seed(0))
    module.load_state_dict(sd)
    limit = np.sqrt(6.0 / (300 + 64))  # flax xavier_uniform of the user table
    v = sd["user_emb"]
    assert float(v.abs().max()) <= limit
    assert abs(float(v.std()) - limit / np.sqrt(3.0)) < 0.05 * limit
    par, diag = sd["group_enc.HWNNLayer_0.par"], sd["group_enc.HWNNLayer_1.diagonal_weight_filter"]
    assert par.shape == (6,) and 0.0 <= float(par.min()) and float(par.max()) < 0.99
    assert diag.shape == (500,) and 0.99 <= float(diag.min()) and float(diag.max()) <= 1.01
    dense = sd["local_enc.EquivSetGNN_0.Dense_0.weight"]
    assert float(dense.abs().max()) <= 2.0 / np.sqrt(64) / 0.87962566103423978 + 1e-6
    assert torch.equal(sd["local_enc.LayerNorm_0.weight"], torch.ones(64))
    assert torch.equal(sd["local_enc.EquivSetGNN_0.Dense_0.bias"], torch.zeros(64))
    again = init_hd(module, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# the building blocks beyond what the variants use: deeper MLPs (hidden
# LayerNorm, flax's Dense_k / LayerNorm_k numbering) inside both ED-HNN forms
LAYER_CASES = ["mlp2", "scatter_mlps", "spmm_mlps", "gcn_prop", "mean_pool"]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layers_match_jax(graphs, case):
    from hypergraph_diffusion_for_recommendation_tpu.models import layers as jl

    jcf, tcf = graphs
    n, d = tcf.n_users + tcf.n_items, 16
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x0 = rng.standard_normal((n, d)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    if case == "gcn_prop":
        want, got = jl.gcn_prop(jcf.adj, jx), tlayers.gcn_prop(tcf.adj, tx)
    elif case == "mean_pool":
        x2 = rng.standard_normal((n, 2 * d)).astype(np.float32)
        want = jl.mean_pool_feature(jnp.asarray(x2), d)
        got = tlayers.mean_pool_feature(torch.as_tensor(x2), d)
    else:
        if case == "mlp2":
            jm = jl.MLP(d, d, 2, 0.5, "ln", True)
            tm = tlayers.MLP(d, d, d, 2, 0.5, "ln", True)
            args, targs = (jx,), (tx,)
        elif case == "scatter_mlps":  # the JAX defaults: three 1-layer MLPs, alpha 0.5
            jm = jl.EquivSetConvScatter(d, n_edges=n)
            tm = tlayers.EquivSetConvScatter(d, n_edges=n)
            args, targs = (jx, jcf.adj, jnp.asarray(x0)), (tx, tcf.adj, torch.as_tensor(x0))
        else:
            jm = jl.EquivSetConvSpMM(d, mlp1_layers=1, mlp2_layers=2, mlp3_layers=1, alpha=0.3)
            tm = tlayers.EquivSetConvSpMM(n, d, mlp1_layers=1, mlp2_layers=2, mlp3_layers=1,
                                          alpha=0.3)
            args, targs = (jx, jcf.adj, jnp.asarray(x0)), (tx, tcf.adj, torch.as_tensor(x0))
        params = jm.init(jax.random.PRNGKey(3), *args)
        sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params["params"]), "cpu")
        assert set(sd) == set(tm.state_dict())
        tm.load_state_dict(sd)
        want = jm.apply(params, *args)
        with torch.no_grad():
            got = tm(*targs)
    _close(got.numpy(), want, 1e-5, case)
