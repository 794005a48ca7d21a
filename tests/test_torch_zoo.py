"""The models that read only the CF adjacency — LightGCN, MF, HCCF, HGCN,
SHT and the SSL family (DirectAU, SimGCL, XSimGCL, NCL, MixGCF, SSL4Rec,
BUIR, SelfCF) — in the port against the JAX package, at a small size (60
users x 90 items, width 16, 2 layers, batch 128).

Each port model starts from the JAX initial parameters, carried across by
`weights.params_from_jax`, and the JAX extras. Tolerances (float32 sums in
another order):

  * `encode_eval`: within 1e-5 of the tables' scale (max |x|);
  * the loss and every aux term of one injected `HostExactSampler` batch
    against `jax.value_and_grad(bundle.batch_loss)`: rtol 1e-5;
  * every parameter's gradient within 1e-5 of its own scale or 1e-6 of the
    model's largest gradient, whichever is larger (an attention key bias
    has a zero gradient in exact arithmetic: both sides are rounding
    noise there);
  * the hooks, through `Trainer.train_step` against the JAX trainer's
    `_build_chunk_fn`: 3 BUIR steps (`update_extras`) and one NCL epoch
    (`epoch_setup`'s k-means, then every batch of the epoch), each step's
    loss within rtol 1e-5, the parameters and extras after the last step
    within 1e-5 of their scale.

What torch cannot reproduce is made equal: the edge-dropout keys are
recorded from the JAX `AdjPair.dropped` and handed to the port; flax's
`nn.Dropout` and the port's `feature_dropout` are the identity; every
other draw inside a loss (`jax.random.uniform`, `randint`, `bernoulli`,
`choice`) and its port function (`ssl_family._uniform`, `_randint`,
`_keep_mask`, `_initial_centroids`, `sht._sample_pairs`) return the same
numpy draw, in call order.
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
from hypergraph_diffusion_for_recommendation_tpu.ops import losses as jlosses
from hypergraph_diffusion_for_recommendation_tpu.ops import sampling as jsam
from hypergraph_diffusion_for_recommendation_tpu.train.trainer import Trainer as JTrainer
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
    MODEL_REGISTRY,
    build_model,
    hccf,
    model_data_needs,
    sht,
    ssl_family,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.models import layers as tlayers
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import losses as tlosses
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import init_flax, params_from_jax

CFG = dict(embedding_size=16, hyper_dim=16, hyperedge_num=8, n_layers=2, batch_size=128)
MODELS = ["LightGCN", "MF", "HCCF", "HGCN", "SHT", "DirectAU", "SimGCL", "XSimGCL", "NCL",
          "MixGCF", "SSL4Rec", "BUIR", "SelfCF"]
# the SHT regularisers, both
CASES = [(m, {}) for m in MODELS] + [("SHT", dict(sht_reg="full"))]
ENCODE_RTOL = LOSS_RTOL = GRAD_RTOL = 1e-5
GRAD_FLOOR = 1e-6


@pytest.fixture(scope="module")
def graphs():
    train, test, _ = td.synthetic_dataset(n_users=60, n_items=90, mean_degree=10.0, seed=4)
    ji = jd.build_interaction(train, test)
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64, needs={"adj"})
    ti = td.build_interaction(train, test)
    tcf = td.build_cf_device_data(ti, "cpu", eval_user_multiple=64, needs={"adj"})
    sampler = jsam.HostExactSampler(np.asarray(jcf.edge_u), np.asarray(jcf.edge_i), jcf.n_items)
    users, pos, neg = sampler.pairwise(4, CFG["batch_size"])
    return dict(jcf=jcf, tcf=tcf, batches=(users, pos, neg))


def _close(got, want, rtol, what, atol=0.0):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= max(rtol * scale, atol), f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _port_extras(jextras):
    return {k: torch.tensor(np.asarray(v)) for k, v in dict(jextras or {}).items()}


def _pair(graphs, name, **kw):
    cfg = dict(CFG, **kw)
    jb = j_build_model(j_make_config(name, **cfg), graphs["jcf"])
    params, jextras = jb.init(jax.random.PRNGKey(0))
    tb = build_model(make_config(name, **cfg), graphs["tcf"])
    tb.module.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                     params["params"]), "cpu"))
    return jb, params, jextras, tb


def _identity_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(tlayers, "feature_dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(hccf, "feature_dropout", lambda x, *a, **k: x)


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


def _shared_draws(monkeypatch, seed=3):
    """Replace the JAX draws inside the losses, and their port functions,
    by one numpy stream: each JAX call draws and queues its values, the
    port's function of the same kind takes them in the same order."""
    rng = np.random.default_rng(seed)
    queues = {"uniform": [], "randint": [], "bernoulli": [], "choice": []}

    def put(kind, value):
        queues[kind].append(value)
        return jnp.asarray(value)

    def take(kind):
        return torch.as_tensor(queues[kind].pop(0))

    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: put(
        "uniform", rng.random(tuple(shape), dtype=np.float32)))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, minval, maxval, *a, **k: put(
        "randint", rng.integers(minval, maxval, tuple(shape)).astype(np.int32)))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None, *a, **k: put(
        "bernoulli", rng.random(tuple(shape)) < p))
    monkeypatch.setattr(jax.random, "choice", lambda key, a, shape=(), replace=True, *r, **k: put(
        "choice", rng.permutation(int(a))[: int(np.prod(shape))].astype(np.int32)))
    monkeypatch.setattr(ssl_family, "_uniform", lambda shape, gen, device: take("uniform"))
    monkeypatch.setattr(ssl_family, "_randint", lambda shape, high, gen, device: take("randint"))
    monkeypatch.setattr(ssl_family, "_keep_mask", lambda shape, keep, gen, device:
                        take("bernoulli"))
    monkeypatch.setattr(ssl_family, "_initial_centroids", lambda n, k, gen, device:
                        take("choice").long())
    monkeypatch.setattr(sht, "_sample_pairs", lambda n, nu, ni, gen, device: (
        take("randint").long(), take("randint").long()))
    return queues


def test_registry_and_data_needs():
    assert set(MODELS) <= set(MODEL_REGISTRY)
    assert model_data_needs("MF") == frozenset()
    for name in MODELS[1:]:
        if name != "MF":
            assert model_data_needs(name) == frozenset({"adj"}), name


@pytest.mark.parametrize("name", MODELS)
def test_encode_eval_matches_jax(graphs, name):
    jb, params, jextras, tb = _pair(graphs, name)
    ju, ji = jb.encode_eval(params, jextras)
    u, i = tb.encode_eval(_port_extras(jextras))
    assert u.shape == ju.shape and i.shape == ji.shape
    _close(u.numpy(), ju, ENCODE_RTOL, "users")
    _close(i.numpy(), ji, ENCODE_RTOL, "items")


@pytest.mark.parametrize("name,kw", CASES, ids=[n + "".join(f"-{v}" for v in kw.values())
                                                for n, kw in CASES])
def test_loss_and_grads_match_jax(graphs, name, kw, monkeypatch):
    _identity_dropout(monkeypatch)
    jb, params, jextras, tb = _pair(graphs, name, **kw)
    keys = _record_keys(monkeypatch)
    queues = _shared_draws(monkeypatch)
    batch = tuple(a[0] for a in graphs["batches"])
    (jloss, jaux), jgrads = jax.value_and_grad(jb.batch_loss, has_aux=True)(
        params, jextras, tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(1))
    assert len(keys) == tb.n_edge_keys, (keys, tb.n_edge_keys)
    loss, aux = tb.batch_loss(_port_extras(jextras), tuple(torch.as_tensor(a) for a in batch),
                              keys)
    assert all(not q for q in queues.values()), "the port made other draws than JAX"
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=LOSS_RTOL, err_msg=k)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads["params"]), "cpu")
    got = dict(tb.module.named_parameters())
    assert set(got) == set(want)
    g_max = max(float(w.abs().max()) for w in want.values())
    for pname, p in got.items():
        assert p.grad is not None, pname
        _close(p.grad.numpy(), want[pname].numpy(), GRAD_RTOL, pname, GRAD_FLOOR * g_max)


def _py_scan(ys_out):
    """lax.scan as a Python loop; the per-step outputs land in `ys_out`."""
    def scan(f, init, xs):
        carry = init
        n = jax.tree_util.tree_leaves(xs)[0].shape[0]
        ys = []
        for s in range(n):
            carry, y = f(carry, jax.tree_util.tree_map(lambda a: a[s], xs))
            ys.append(y)
        ys_out.extend(ys)
        return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)

    return scan


@pytest.mark.parametrize("name,n_steps", [("BUIR", 3), ("NCL", None)], ids=["BUIR", "NCL"])
def test_hooks_match_jax_chunk_fn(graphs, name, n_steps, monkeypatch):
    """BUIR's `update_extras` over 3 steps; NCL's `epoch_setup` (k-means with
    the same initial rows), then one epoch of steps."""
    jb = j_build_model(j_make_config(name, **CFG), graphs["jcf"])
    jt = JTrainer(jb, seed=0)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params["params"])
    tb = build_model(make_config(name, **CFG), graphs["tcf"])
    tb.module.load_state_dict(params_from_jax(params0, "cpu"))
    tr = Trainer(tb, seed=0, extras=_port_extras(jt.extras))
    queues = _shared_draws(monkeypatch)
    ys = []
    monkeypatch.setattr(jax.lax, "scan", _py_scan(ys))
    jextras = jt.extras
    if jb.epoch_setup is not None:
        jextras = jb.epoch_setup(jt.params, jextras, jax.random.PRNGKey(2))
        tr.begin_epoch()
        assert not queues["choice"]
        for k in ("user_centroids", "item_centroids"):
            _close(tr.extras[k].numpy(), jextras[k], 1e-5, k)
    batches = graphs["batches"]
    n = batches[0].shape[0] if n_steps is None else n_steps
    chunk = jt._build_chunk_fn(masked=False)
    jparams, _, jextras, _, _ = chunk(jt.params, jt.opt_state, jextras,
                                      tuple(jnp.asarray(a[:n]) for a in batches),
                                      jax.random.split(jax.random.PRNGKey(7), n))
    for s in range(n):
        loss, _ = tr.train_step(tuple(torch.as_tensor(a[s]) for a in batches), ())
        np.testing.assert_allclose(float(loss), float(ys[s][0]), rtol=LOSS_RTOL,
                                   err_msg=f"step {s}")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams["params"]), "cpu")
    for pname, p in tb.module.named_parameters():
        _close(p.detach().numpy(), want[pname].numpy(), 1e-5, pname)
    assert set(tr.extras) == set(jextras)
    for k, v in jextras.items():
        _close(tr.extras[k].numpy(), v, 1e-5, k)


def test_buir_targets_are_copies_and_move_in_place(graphs):
    tb = build_model(make_config("BUIR", **CFG), graphs["tcf"])
    tr = Trainer(tb, seed=0)
    bufs = dict(tr.extras)
    assert bufs["target_u"].data_ptr() != tb.module.user_emb.data_ptr()
    before = bufs["target_u"].clone()
    tr.train_step(tuple(torch.as_tensor(a[0]) for a in graphs["batches"]), ())
    # the EMA wrote into the same buffer, from the parameters before the step
    assert tr.extras["target_u"] is bufs["target_u"]
    assert not torch.equal(before, tr.extras["target_u"])
    snap = tr.snapshot()
    tr.train_step(tuple(torch.as_tensor(a[1]) for a in graphs["batches"]), ())
    tr.restore(snap)
    assert tr.extras["target_u"] is bufs["target_u"]
    assert torch.equal(tr.extras["target_u"], snap[1]["target_u"])


def test_transformer_encoder_layer_matches_flax(monkeypatch):
    from hypergraph_diffusion_for_recommendation_tpu.models.hgcn import (
        TransformerEncoderLayer as JLayer,
    )

    _identity_dropout(monkeypatch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    w = jnp.asarray(rng.standard_normal((50, 16)).astype(np.float32))
    jlayer = JLayer(16, 2, 32, 0.2)
    params = jax.tree_util.tree_map(
        np.asarray, jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x), False)["params"])
    assert params["MultiHeadDotProductAttention_0"]["query"]["kernel"].shape == (16, 2, 8)
    for train in (False, True):
        jout = jlayer.apply({"params": params}, jnp.asarray(x), train)
        jgrad = jax.grad(lambda xx: jnp.sum(jlayer.apply({"params": params}, xx, train) * w))(
            jnp.asarray(x))
        layer = tlayers.TransformerEncoderLayer(16, 2, 32, 0.2)
        layer.load_state_dict(params_from_jax(params, "cpu"))
        tx = torch.as_tensor(x).requires_grad_(True)
        out = layer(tx, train, None)
        (out * torch.tensor(np.asarray(w))).sum().backward()
        _close(out.detach().numpy(), jout, 1e-5, f"output train={train}")
        _close(tx.grad.numpy(), jgrad, 1e-5, f"input gradient train={train}")


@pytest.mark.parametrize("case", ["info_nce", "batch_softmax", "info_nce_masked"])
def test_losses_match_jax(case):
    rng = np.random.default_rng(9)
    a = rng.standard_normal((40, 16)).astype(np.float32)
    b = rng.standard_normal((40, 16)).astype(np.float32)
    valid = rng.random(40) < 0.7
    ja, jb_, ta, tb_ = jnp.asarray(a), jnp.asarray(b), torch.as_tensor(a), torch.as_tensor(b)
    if case == "info_nce":
        want, got = jlosses.info_nce(ja, jb_, 0.2), tlosses.info_nce(ta, tb_, 0.2)
        want2, got2 = jlosses.info_nce(ja, jb_, 0.5, False), tlosses.info_nce(ta, tb_, 0.5, False)
        np.testing.assert_allclose(float(got2), float(want2), rtol=1e-5)
    elif case == "batch_softmax":
        want, got = jlosses.batch_softmax_loss(ja, jb_, 0.2), tlosses.batch_softmax_loss(ta, tb_,
                                                                                         0.2)
    else:
        want = jlosses.info_nce_masked(ja, jb_, jnp.asarray(valid), 0.2)
        got = tlosses.info_nce_masked(ta, tb_, torch.as_tensor(valid), 0.2)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("name", ["HGCN", "HCCF", "SHT", "BUIR", "SSL4Rec"])
def test_native_init_matches_flax_scales(graphs, name):
    tb = build_model(make_config(name, **CFG), graphs["tcf"])
    sd = init_flax(tb.module, torch.Generator().manual_seed(0))
    assert set(sd) == set(tb.module.state_dict())
    jb = j_build_model(j_make_config(name, **CFG), graphs["jcf"])
    jparams = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jb.init(jax.random.PRNGKey(0))[0]["params"]), "cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                          for k, v in jparams.items()}
    kinds = dict(tb.module.named_modules())
    for k, v in sd.items():
        owner = kinds[k.rpartition(".")[0]]
        if k.endswith("bias"):
            assert torch.equal(v, torch.zeros_like(v)), k
        elif isinstance(owner, torch.nn.LayerNorm):
            assert torch.equal(v, torch.ones_like(v)), k
        elif isinstance(owner, torch.nn.Linear):  # flax Dense: LeCun truncated normal
            fan_in = v.shape[1]
            assert float(v.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6, k
            assert abs(float(v.std()) - 1.0 / np.sqrt(fan_in)) < 0.25 / np.sqrt(fan_in), k
        else:  # a table or an incidence weight: flax xavier_uniform
            limit = np.sqrt(6.0 / (v.shape[-2] + v.shape[-1]))
            assert float(v.abs().max()) <= limit, k
            assert abs(float(v.std()) - limit / np.sqrt(3.0)) < 0.1 * limit, k
            assert abs(float(jparams[k].std()) - float(v.std())) < 0.1 * limit, k
    again = init_flax(tb.module, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
