"""HGNN, HD2 and HGNNAblation — the rest of the KHGRec skeleton — in the
port against the JAX package.

`SelfAttentionBlock` is held against the JAX block (flax's
`MultiHeadDotProductAttention` and its Dense and LayerNorm layers) with
the flax parameters carried across, in eval mode and in training mode
with dropout the identity on both sides (flax's PRNG stream cannot be
reproduced): output and input gradient within 1e-5 of their scale.

Each model (HGNNAblation in mode full and in mode wohyper) starts from the
JAX initial parameters (`weights.khgrec_params_from_jax`, the attention
blocks included), the same numpy-made attention extras and the same
`HostExactSampler` batch, with the JAX side's edge-dropout keys recorded
from `AdjPair.dropped` and handed to the port and feature dropout the
identity on both sides. The encode tables must agree within 1e-5 of their
scale, the loss and aux terms within rtol 1e-5, every gradient within 1e-5
of its scale or 1e-6 of the model's largest gradient, whichever is larger
(float32 sums in another order; measured: 1.6e-6 of its own scale at most,
but 6.3e-5 for a LayerNorm bias whose gradient is 1e-3 of the largest, and
3.3e-8 of the largest for all).
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
from hypergraph_diffusion_for_recommendation_tpu.models import layers as jlayers
from hypergraph_diffusion_for_recommendation_tpu.ops import sampling as jsam
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
    MODEL_REGISTRY,
    build_model,
    model_data_needs,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.models import layers as tlayers
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import (
    _flax_tree_to_torch,
    init_flax,
    khgrec_params_from_jax,
)

CFG = dict(hyper_dim=16, relation_dim=8, n_layers=2, batch_size=128, batch_size_kg=64,
           drop_rate=0.2, temp=1.0, cl_rate=0.01)
CASES = [("HGNN", "full"), ("HD2", "full"), ("HGNNAblation", "full"),
         ("HGNNAblation", "wohyper")]


def _close(got, want, rtol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _identity_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(tlayers, "feature_dropout", lambda x, *a, **k: x)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_self_attention_block_matches_flax(train, monkeypatch):
    _identity_dropout(monkeypatch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 16)).astype(np.float32)
    jblock = jlayers.SelfAttentionBlock(16)
    params = jblock.init(jax.random.PRNGKey(3), jnp.asarray(x), False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    assert params["MultiHeadDotProductAttention_0"]["query"]["kernel"].shape == (16, 1, 16)
    w = jnp.asarray(rng.standard_normal((40, 16)).astype(np.float32))

    def jf(xx):
        return jnp.sum(jblock.apply({"params": params}, xx, train) * w)

    jout = jblock.apply({"params": params}, jnp.asarray(x), train)
    jgrad = jax.grad(jf)(jnp.asarray(x))
    block = tlayers.SelfAttentionBlock(16)
    block.load_state_dict(_flax_tree_to_torch(params, "", "cpu"))
    tx = torch.as_tensor(x).requires_grad_(True)
    out = block(tx, train, None)
    (out * torch.tensor(np.asarray(w))).sum().backward()
    _close(out.detach().numpy(), jout, 1e-5, "output")
    _close(tx.grad.numpy(), jgrad, 1e-5, "input gradient")


@pytest.fixture(scope="module")
def family(tiny_kg_dataset):
    train, test, kg_df = tiny_kg_dataset
    ji = jd.build_interaction(train, test)
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64, needs={"adj"})
    jkg = jd.build_kg_device_data(jd.build_knowledge(kg_df, ji))
    ti = td.build_interaction(train, test)
    tcf = td.build_cf_device_data(ti, "cpu", eval_user_multiple=64, needs={"adj"})
    tkg = td.build_kg_device_data(td.build_knowledge(kg_df, ti), "cpu")
    n = tkg.n_kg_train
    sampler = jsam.HostExactSampler(
        np.asarray(jcf.edge_u), np.asarray(jcf.edge_i), jcf.n_items,
        kg_heads=np.asarray(jkg.att_h[:n]), kg_relations=np.asarray(jkg.att_r[:n]),
        kg_tails=np.asarray(jkg.att_t[:n]), n_entities=jkg.n_entities)
    users, pos, neg = sampler.pairwise(4, CFG["batch_size"])
    h, r, pt, nt = sampler.kg_batches(5, users.shape[0], CFG["batch_size_kg"])
    rng = np.random.default_rng(5)
    pick = rng.choice(n, CFG["batch_size_kg"], replace=False)
    extras_np = {"att_h": tkg.att_h.numpy()[pick], "att_t": tkg.att_t.numpy()[pick],
                 "att_v": rng.uniform(0.05, 1.0, pick.shape[0]).astype(np.float32)}
    return dict(jcf=jcf, jkg=jkg, tcf=tcf, tkg=tkg, extras_np=extras_np,
                batch=tuple(a[0] for a in (users, pos, neg, h, r, pt, nt)))


@pytest.mark.parametrize("model,mode", CASES)
def test_family_matches_jax(family, model, mode, monkeypatch):
    _identity_dropout(monkeypatch)
    cfg = dict(CFG, mode=mode)
    jb = j_build_model(j_make_config(model, **cfg), family["jcf"], family["jkg"])
    params, _ = jb.init(jax.random.PRNGKey(0))
    keys = []
    original = jdev.AdjPair.dropped

    def recording(self, rng, keep_rate):
        kd = jnp.asarray(rng)
        kd = (kd if kd.dtype == jnp.uint32 else jax.random.key_data(rng)).reshape(-1)
        keys.append((int(kd[0]), int(kd[-1])))
        return original(self, rng, keep_rate)

    monkeypatch.setattr(jdev.AdjPair, "dropped", recording)
    jextras = {k: jnp.asarray(v) for k, v in family["extras_np"].items()}
    jbatch = tuple(jnp.asarray(a) for a in family["batch"])
    (jloss, jaux), jgrads = jax.value_and_grad(jb.batch_loss, has_aux=True)(
        params, jextras, jbatch, jax.random.PRNGKey(1))
    ju, ji = jb.encode_eval(params, jextras)
    assert len(keys) == 2

    tb = build_model(make_config(model, **cfg), family["tcf"], family["tkg"])
    assert tb.early_stop_patience_scale == jb.early_stop_patience_scale
    params_np = jax.tree_util.tree_map(np.asarray, params["params"])
    sd, extras = khgrec_params_from_jax(params_np, family["extras_np"], "cpu")
    # flax creates the attention fusion only where it runs (not in wohyper,
    # whose mode turns it off): those parameters keep the port's values
    unused = set(tb.module.state_dict()) - set(sd)
    assert unused == (set() if mode == "full" else
                      {k for k in tb.module.state_dict() if k.startswith("attention_item.")})
    tb.module.load_state_dict(sd, strict=not unused)
    u, i = tb.encode_eval(extras)
    _close(u.numpy(), ju, 1e-5, "user table")
    _close(i.numpy(), ji, 1e-5, "item table")
    loss, aux = tb.batch_loss(extras, tuple(torch.as_tensor(a) for a in family["batch"]),
                              tuple(keys), torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(aux) == set(jaux)
    for k in set(aux) - {"_new_extras"}:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(aux["_new_extras"]["att_v"].numpy(),
                               np.asarray(jaux["_new_extras"]["att_v"]), rtol=1e-4, atol=1e-6)
    want = khgrec_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads["params"]), None,
                                  "cpu")[0]
    g_max = max(float(w.abs().max()) for w in want.values())
    for name, p in tb.module.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if name in unused:
            assert not g.any(), name
            continue
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        # a gradient summed from far larger terms (the key bias's is zero in
        # exact arithmetic: the softmax ignores a shift a row's scores share)
        # is held to 1e-6 of the model's largest gradient instead
        assert err <= max(1e-5 * float(np.abs(w).max()), 1e-6 * g_max), (
            f"grad {name}: max err {err:.3e}, its scale {np.abs(w).max():.3e}, "
            f"the largest gradient {g_max:.3e}")


def test_registered_with_their_switches(family):
    for name in ("HGNN", "HD2", "HGNNAblation"):
        assert name in MODEL_REGISTRY
        assert model_data_needs(name) == frozenset({"adj"})
    tcf, tkg = family["tcf"], family["tkg"]
    hgnn = build_model(make_config("HGNN", **CFG), tcf, tkg).module
    assert hgnn.cf_encoder.att_blocks is not None and not hgnn.kg_encoder.use_att_adj
    hd2 = build_model(make_config("HD2", **CFG), tcf, tkg)
    assert hd2.module.cf_encoder.att_blocks is not None and hd2.module.kg_encoder.use_att_adj
    ab = build_model(make_config("HGNNAblation", **dict(CFG, mode="wohyper")), tcf, tkg)
    assert not ab.module.cf_encoder.use_hyper and ab.module.cf_encoder.att_blocks is None
    # a fresh initialisation covers the attention blocks: flax's Dense and
    # LayerNorm initialisers
    sd = init_flax(hgnn, torch.Generator().manual_seed(0))
    assert set(sd) == set(hgnn.state_dict())
    blk = "cf_encoder.att_blocks.1."
    assert torch.equal(sd[blk + "LayerNorm_1.weight"], torch.ones(16))
    assert torch.equal(sd[blk + "MultiHeadDotProductAttention_0.out.bias"], torch.zeros(16))
    q = sd[blk + "MultiHeadDotProductAttention_0.query.weight"]
    assert q.shape == (16, 16) and 0.1 < float(q.std()) < 0.4  # lecun normal: 1 / sqrt(16)


def test_hgnn_executes_one_epoch_on_cpu():
    cfg = make_config("HGNN", hyper_dim=16, relation_dim=8, batch_size=256, batch_size_kg=128,
                      eval_user_batch=64, item_ranking=(10, 20), max_epoch=1)
    rec = Recommender(cfg, device="cpu")
    rec.build(td.synthetic_dataset(n_users=60, n_items=80, mean_degree=10.0, seed=1,
                                   with_kg=True))
    out = rec.execute()
    assert set(out) == {10, 20} and all(0.0 <= v <= 1.0 for m in out.values() for v in m.values())
    assert len(rec.result.history) == 1
    assert set(rec.result.history[0].losses) == {"train_loss", "rec_loss", "cf_loss", "kg_loss",
                                                 "cl_loss"}
    assert rec.bundle.early_stop_patience_scale == 2
    assert rec.user_emb.shape == (rec.inter.n_users, 16)
