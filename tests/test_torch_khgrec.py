"""The port's KHGRec encode against the JAX package's.

The JAX model is initialised, its parameters are carried across with
`weights.khgrec_params_from_jax`, and both sides get the same numpy-made
attention extras. `encode_eval` must then agree in float32 (the sums run
in another order, and flax's LayerNorm takes the variance as
E[x^2] - E[x]^2): within rtol 1e-4 and atol 1e-4 on tables of unit
scale.
"""

import jax
import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu import data as jd
from hypergraph_diffusion_for_recommendation_tpu.core import make_config as j_make_config
from hypergraph_diffusion_for_recommendation_tpu.models import build_model as j_build_model
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as tsp
from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
    build_model,
    model_data_needs,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.models.khgrec import (
    KHGRecModule,
    attention_extras,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import (
    init_flax,
    khgrec_params_from_jax,
)

CFG = dict(hyper_dim=16, relation_dim=8, n_layers=2, batch_size_kg=64)
RTOL = ATOL = 1e-4


def _packed(pair, dedup: bool):
    """`pair` with the kernel layout of the given kind on both directions,
    whatever its device and size (the port attaches it only on CUDA, for
    large matrices)."""
    pack = tsp.pack_blocked_dedup if dedup else tsp.pack_blocked

    def side(sp, canon_map=None):
        rows, cols, vals = (a.numpy() for a in (sp.rows, sp.cols, sp.vals))
        return sp.replace(blocked=pack(rows, cols, vals, sp.shape, canon_map=canon_map,
                                       device="cpu"))

    return pair.replace(fwd=side(pair.fwd), bwd=side(pair.bwd, pair.t_perm.numpy()))


@pytest.fixture(scope="module")
def both(tiny_kg_dataset):
    train, test, kg_df = tiny_kg_dataset
    ji = jd.build_interaction(train, test)
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64, needs={"adj"})
    jkg = jd.build_kg_device_data(jd.build_knowledge(kg_df, ji))
    jb = j_build_model(j_make_config("KHGRec", **CFG), jcf, jkg)
    params, _ = jb.init(jax.random.PRNGKey(0))

    ti = td.build_interaction(train, test)
    tcf = td.build_cf_device_data(ti, "cpu", eval_user_multiple=64,
                                  needs=model_data_needs("KHGRec"))
    tkg = td.build_kg_device_data(td.build_knowledge(kg_df, ti), "cpu")

    # attention extras as a training step leaves them: 64 KG triples with
    # positive row-softmax-like weights, made with numpy for both sides
    rng = np.random.default_rng(5)
    pick = rng.choice(tkg.n_kg_train, CFG["batch_size_kg"], replace=False)
    extras_np = {
        "att_h": np.asarray(tkg.att_h)[pick],
        "att_t": np.asarray(tkg.att_t)[pick],
        "att_v": rng.uniform(0.05, 1.0, pick.shape[0]).astype(np.float32),
    }
    params_np = jax.tree_util.tree_map(np.asarray, params["params"])
    return jb, params, extras_np, params_np, tcf, tkg


def _jax_tables(jb, params, extras_np):
    extras = {k: jax.numpy.asarray(v) for k, v in extras_np.items()}
    u, i = jb.encode_eval(params, extras)
    return np.asarray(u), np.asarray(i)


def _port_bundle(tcf, tkg, params_np, extras_np):
    tb = build_model(make_config("KHGRec", **CFG), tcf, tkg)
    sd, extras = khgrec_params_from_jax(params_np, extras_np, "cpu")
    tb.module.load_state_dict(sd)
    return tb, extras


@pytest.mark.parametrize("layout", ["coo", "packed_base", "packed_dedup"])
def test_encode_eval_matches_jax(both, layout):
    jb, params, extras_np, params_np, tcf, tkg = both
    if layout != "coo":
        # the packed layout forced on the CPU: the model's products then run
        # through the CUDA kernels' plain version (JAX uses segment_sum here,
        # the same math)
        dedup = layout == "packed_dedup"
        tcf = tcf.replace(adj=_packed(tcf.adj, dedup))
        tkg = tkg.replace(kg_adj=_packed(tkg.kg_adj, dedup))
        assert tcf.adj.fwd.blocked.dedup == dedup
    tb, extras = _port_bundle(tcf, tkg, params_np, extras_np)
    u, i = tb.encode_eval(extras)
    ju, ji = _jax_tables(jb, params, extras_np)
    assert u.shape == ju.shape and i.shape == ji.shape
    np.testing.assert_allclose(u.numpy(), ju, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(i.numpy(), ji, rtol=RTOL, atol=ATOL)


def test_attention_extras_match_jax(both):
    from hypergraph_diffusion_for_recommendation_tpu.models import kg_common as jkc

    jb, params, extras_np, params_np, tcf, tkg = both
    tb, extras = _port_bundle(tcf, tkg, params_np, extras_np)
    p = params["params"]
    ent = np.random.default_rng(6).standard_normal(p["user_entity_emb"].shape).astype(np.float32)
    h, r, t = (np.asarray(a)[:64] for a in (tkg.att_h, tkg.att_r, tkg.att_t))
    jv = jkc.attention_values(jax.numpy.asarray(ent), p["relation_emb"], p["trans_M"], h, t, r)
    jsm = np.asarray(jkc.attention_softmax(jv, h, tkg.n_entities))
    got = attention_extras(tb.module, torch.as_tensor(ent), *(torch.as_tensor(a) for a in (h, r, t)))
    np.testing.assert_allclose(got["att_v"].numpy(), jsm, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["att_h"].numpy(), h)


def test_native_init_matches_flax_scales():
    module = KHGRecModule(4096, 10, 100, 64, 32, 2, 0.3)
    sd = init_flax(module, torch.Generator().manual_seed(0))
    module.load_state_dict(sd)
    # flax xavier_uniform: limit sqrt(6 / (fan_in + fan_out)), the leading
    # axis of trans_M counted as receptive field
    for name, fan in (("user_entity_emb", 4096 + 64), ("trans_M", 10 * (64 + 32))):
        limit = np.sqrt(6.0 / fan)
        v = sd[name]
        assert float(v.abs().max()) <= limit
        assert abs(float(v.std()) - limit / np.sqrt(3.0)) < 0.05 * limit
    assert torch.equal(sd["cf_encoder.lns.0.weight"], torch.ones(64))
    assert torch.equal(sd["attention_item.dense0.bias"], torch.zeros(64))
    again = init_flax(module, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
