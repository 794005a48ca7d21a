"""Cached-propagation training (`prop_cache_steps`) in the port against the
JAX package's `full_loss` / `cached_loss`, for KHGRec and HGNN_HD3.

With K = 3 the JAX `batch_loss` takes `full_loss` at age 0 and
`cached_loss` at age 1. Both sides start from the JAX initial parameters
(carried across), the same numpy-made attention extras and the same
`HostExactSampler` batch; the JAX side's edge-dropout keys are recorded
from `AdjPair.dropped` and handed to the port. The JAX `lax.cond` is run
as a Python `if` here (as the port chooses its branch), so that the
recorded keys are concrete; HGNN_HD3's feature dropout is the identity on
both sides (flax's PRNG stream cannot be reproduced). The full step's loss,
gradients and refreshed tables must agree, then the cached step's loss and
gradients from each side's own tables: within 1e-5 relative (loss) and
1e-5 of each gradient's and table's scale (float32 sums in another order).
Also: the schedule over 7 `Trainer` steps (full at 0, 3, 6, no SpMM in
between, the age a host integer).
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
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
from hypergraph_diffusion_for_recommendation_tpu_torch.models import layers as tlayers
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse as tsparse
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import (
    params_from_jax,
    khgrec_params_from_jax,
)

K = 3
KHGREC = dict(hyper_dim=16, relation_dim=8, n_layers=2, batch_size=128, batch_size_kg=64,
              mode="full", drop_rate=0.2, temp=1.0, cl_rate=0.01, prop_cache_steps=K)
HD3 = dict(hyper_dim=16, n_layers=2, batch_size=128, drop_rate=0.2, cl_rate=0.1, temp=0.2,
           reg=0.1, mode="full", prop_cache_steps=K)
TABLES = {"KHGRec": ("prop_u", "prop_icf", "prop_fused", "prop_ent"),
          "HGNN_HD3": ("prop_u", "prop_i", "prop_lu", "prop_li", "prop_gu", "prop_gi")}


@pytest.fixture(scope="module")
def setups(tiny_kg_dataset):
    train, test, kg_df = tiny_kg_dataset
    ji = jd.build_interaction(train, test)
    ti = td.build_interaction(train, test)
    out = {}
    # KHGRec
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64, needs={"adj"})
    jkg = jd.build_kg_device_data(jd.build_knowledge(kg_df, ji))
    tcf = td.build_cf_device_data(ti, "cpu", eval_user_multiple=64, needs={"adj"})
    tkg = td.build_kg_device_data(td.build_knowledge(kg_df, ti), "cpu")
    jb = j_build_model(j_make_config("KHGRec", **KHGREC), jcf, jkg)
    params, jextras = jb.init(jax.random.PRNGKey(0))
    n = tkg.n_kg_train
    sampler = jsam.HostExactSampler(
        np.asarray(jcf.edge_u), np.asarray(jcf.edge_i), jcf.n_items,
        kg_heads=np.asarray(jkg.att_h[:n]), kg_relations=np.asarray(jkg.att_r[:n]),
        kg_tails=np.asarray(jkg.att_t[:n]), n_entities=jkg.n_entities)
    users, pos, neg = sampler.pairwise(4, KHGREC["batch_size"])
    h, r, pt, nt = sampler.kg_batches(5, users.shape[0], KHGREC["batch_size_kg"])
    rng = np.random.default_rng(5)
    pick = rng.choice(n, KHGREC["batch_size_kg"], replace=False)
    att = {"att_h": tkg.att_h.numpy()[pick], "att_t": tkg.att_t.numpy()[pick],
           "att_v": rng.uniform(0.05, 1.0, pick.shape[0]).astype(np.float32)}
    tb = build_model(make_config("KHGRec", **KHGREC), tcf, tkg)
    sd, _ = khgrec_params_from_jax(jax.tree_util.tree_map(np.asarray, params["params"]), None,
                                   "cpu")
    tb.module.load_state_dict(sd)
    out["KHGRec"] = dict(jb=jb, params=params, jextras=dict(jextras, **att), tb=tb,
                         batch=tuple(a[0] for a in (users, pos, neg, h, r, pt, nt)),
                         att=att, to_sd=lambda g: khgrec_params_from_jax(g, None, "cpu")[0])
    # HGNN_HD3
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64, needs={"adj", "b_hyper"})
    tcf = td.build_cf_device_data(ti, "cpu", eval_user_multiple=64, needs={"adj", "b_hyper"})
    jb = j_build_model(j_make_config("HGNN_HD3", **HD3), jcf)
    params, jextras = jb.init(jax.random.PRNGKey(0))
    tb = build_model(make_config("HGNN_HD3", **HD3), tcf)
    tb.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), "cpu"))
    sampler = jsam.HostExactSampler(np.asarray(jcf.edge_u), np.asarray(jcf.edge_i), jcf.n_items)
    users, pos, neg = sampler.pairwise(4, HD3["batch_size"])
    out["HGNN_HD3"] = dict(jb=jb, params=params, jextras=jextras, tb=tb, att={},
                           batch=tuple(a[0] for a in (users, pos, neg)),
                           to_sd=lambda g: params_from_jax(g, "cpu"))
    return out


def _close(got, want, rtol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _port_extras(jextras):
    return {k: (int(v) if k == "prop_age" else torch.as_tensor(np.array(v)))
            for k, v in jextras.items()}


@pytest.mark.parametrize("model", ["KHGRec", "HGNN_HD3"])
def test_full_then_cached_step_match_jax(setups, model, monkeypatch):
    st = setups[model]
    monkeypatch.setattr(jax.lax, "cond", lambda pred, t, f, *ops: t(*ops) if bool(pred)
                        else f(*ops))
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(tlayers, "feature_dropout", lambda x, *a, **k: x)
    keys = []
    original = jdev.AdjPair.dropped

    def recording(self, rng, keep_rate):
        kd = jnp.asarray(rng)
        kd = (kd if kd.dtype == jnp.uint32 else jax.random.key_data(rng)).reshape(-1)
        keys.append((int(kd[0]), int(kd[-1])))
        return original(self, rng, keep_rate)

    monkeypatch.setattr(jdev.AdjPair, "dropped", recording)
    jb, tb = st["jb"], st["tb"]
    jbatch = tuple(jnp.asarray(a) for a in st["batch"])
    tbatch = tuple(torch.as_tensor(a) for a in st["batch"])
    vg = jax.value_and_grad(jb.batch_loss, has_aux=True)
    params_t = dict(tb.module.named_parameters())

    def compare(jloss, jgrads, loss, what):
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, err_msg=what)
        want = st["to_sd"](jax.tree_util.tree_map(np.asarray, jgrads["params"]))
        for name, p in params_t.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            _close(g.numpy(), want[name].numpy(), 1e-5, f"{what} {name}")
            p.grad = None

    # age 0: the full step, which refreshes the tables
    jextras = {k: jnp.asarray(v) for k, v in st["jextras"].items()}
    assert int(jextras["prop_age"]) == 0
    (jloss, jaux), jgrads = vg(st["params"], jextras, jbatch, jax.random.PRNGKey(1))
    edge_keys = tuple(keys[:1]) if model == "HGNN_HD3" else tuple(keys)
    extras = _port_extras(jextras)
    loss, aux = tb.batch_loss(extras, tbatch, edge_keys)
    loss.backward()
    compare(jloss, jgrads, loss, "full")
    new, jnew = aux["_new_extras"], jaux["_new_extras"]
    assert new["prop_age"] == 1 and type(new["prop_age"]) is int
    for k in TABLES[model]:
        _close(new[k].numpy(), jnew[k], 1e-5, k)

    # age 1: the cached step on each side's own tables, no dropout drawn
    n_keys = len(keys)
    calls = []
    monkeypatch.setattr(tsparse, "spmm", lambda *a: calls.append(1))
    (jloss, jaux), jgrads = vg(st["params"], jnew, jbatch, jax.random.PRNGKey(2))
    assert len(keys) == n_keys
    loss, aux = tb.batch_loss(new, tbatch, edge_keys)
    loss.backward()
    assert not calls  # no propagation on a cached step
    compare(jloss, jgrads, loss, "cached")
    for k in ("rec_loss", "cl_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    again = aux["_new_extras"]
    assert again["prop_age"] == 2
    assert all(again[k] is new[k] for k in TABLES[model])  # the tables stay as they were


@pytest.mark.parametrize("model", ["KHGRec", "HGNN_HD3"])
def test_schedule_over_seven_steps(setups, model, monkeypatch):
    st = setups[model]
    tb = st["tb"]
    trainer = Trainer(tb, seed=3)
    assert trainer.extras["prop_age"] == 0
    if st["att"]:
        trainer.extras.update({k: torch.as_tensor(v) for k, v in st["att"].items()})
    batch = tuple(torch.as_tensor(a) for a in st["batch"])
    calls = []
    original = tsparse.spmm
    monkeypatch.setattr(tsparse, "spmm", lambda *a: calls.append(1) or original(*a))
    full = []
    for _ in range(7):
        del calls[:]
        loss, _ = trainer.train_step(batch, trainer.edge_keys())
        assert torch.isfinite(loss)
        full.append(bool(calls))
    assert full == [age % K == 0 for age in range(7)]
    assert trainer.extras["prop_age"] == 7 and type(trainer.extras["prop_age"]) is int
