"""KHGRec's joint encode (`HGDR_JOINT`): the CF and KG encoders' product
chains as one chain over blockdiag(A, K), in the port against the JAX
package's joint path.

Both sides build from the same split with `HGDR_JOINT` set; the port
carries the JAX initial parameters (`weights.khgrec_params_from_jax`) and
takes the same numpy-made attention extras and `HostExactSampler` batch.
The one edge-dropout key of the joint matrix is recorded from the JAX
`AdjPair.dropped`. Tolerances (float32 sums in another order): the joint
adjacency's COO bit for bit; the encode tables within 1e-5 of their scale;
the loss and aux terms within rtol 1e-5, the next attention within rtol
1e-4; every gradient within 1e-5 of its scale or 1e-6 of the model's
largest gradient, whichever is larger. At keep rate 1 the port's joint
encode equals its unfused encode within 1e-6 of the tables' scale (the
JAX docstring's claim, khgrec.py:196-202), with 4 SpMM products an encode
against 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu import data as jd
from hypergraph_diffusion_for_recommendation_tpu.core import make_config as j_make_config
from hypergraph_diffusion_for_recommendation_tpu.data import device as jdev
from hypergraph_diffusion_for_recommendation_tpu.models import build_model as j_build_model
from hypergraph_diffusion_for_recommendation_tpu.ops import sampling as jsam
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data.device import blockdiag_pair
from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse as tsparse
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import khgrec_params_from_jax

CFG = dict(hyper_dim=16, relation_dim=8, n_layers=2, batch_size=128, batch_size_kg=64,
           mode="full", drop_rate=0.2, temp=1.0, cl_rate=0.01)


@pytest.fixture(scope="module")
def data(tiny_kg_dataset):
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


def _close(got, want, rtol, what, atol=0.0):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= max(rtol * scale, atol), f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def test_blockdiag_pair_matches_jax(data):
    want = jdev.blockdiag_pair(data["jcf"].adj, data["jkg"].kg_adj)
    got = blockdiag_pair(data["tcf"].adj, data["tkg"].kg_adj, "cpu")
    for side in ("fwd", "bwd"):
        w, g = getattr(want, side), getattr(got, side)
        assert (g.nrows, g.ncols, g.nnz) == (w.nrows, w.ncols, w.nnz)
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)))
    np.testing.assert_array_equal(got.t_perm.numpy(), np.asarray(want.t_perm))


def test_joint_only_where_the_jax_builder_takes_it(data, monkeypatch):
    monkeypatch.setenv("HGDR_JOINT", "1")
    tcf, tkg = data["tcf"], data["tkg"]
    assert build_model(make_config("KHGRec", **CFG), tcf, tkg).n_edge_keys == 1
    # the self-attention encoders and the one-hop ablation keep the unfused pair
    for name, mode in (("HGNN", "full"), ("HD2", "full"), ("HGNNAblation", "wohyper")):
        assert build_model(make_config(name, **dict(CFG, mode=mode)), tcf, tkg).n_edge_keys == 2
    assert build_model(make_config("HGNNAblation", **CFG), tcf, tkg).n_edge_keys == 1
    monkeypatch.delenv("HGDR_JOINT")
    assert build_model(make_config("KHGRec", **CFG), tcf, tkg).n_edge_keys == 2


def test_joint_encode_equals_the_unfused_encode(data, monkeypatch):
    tcf, tkg = data["tcf"], data["tkg"]
    unfused = build_model(make_config("KHGRec", **CFG), tcf, tkg)
    monkeypatch.setenv("HGDR_JOINT", "1")
    joint = build_model(make_config("KHGRec", **CFG), tcf, tkg)
    extras = unfused.init(torch.Generator().manual_seed(0))
    joint.module.load_state_dict(unfused.module.state_dict())
    calls = []
    original = tsparse.spmm
    monkeypatch.setattr(tsparse, "spmm", lambda a, x: calls.append(a.nrows) or original(a, x))
    u0, i0 = unfused.encode_eval(extras)
    n_unfused = len(calls)
    u1, i1 = joint.encode_eval(extras)
    assert (n_unfused, len(calls) - n_unfused) == (8, 4)
    _close(u1.numpy(), u0.numpy(), 1e-6, "users")
    _close(i1.numpy(), i0.numpy(), 1e-6, "items")


def test_joint_encode_and_step_match_jax(data, monkeypatch):
    monkeypatch.setenv("HGDR_JOINT", "1")
    jb = j_build_model(j_make_config("KHGRec", **CFG), data["jcf"], data["jkg"])
    params, _ = jb.init(jax.random.PRNGKey(0))
    keys = []
    original = jdev.AdjPair.dropped

    def recording(self, rng, keep_rate):
        kd = jnp.asarray(rng)
        kd = (kd if kd.dtype == jnp.uint32 else jax.random.key_data(rng)).reshape(-1)
        keys.append((int(kd[0]), int(kd[-1])))
        return original(self, rng, keep_rate)

    monkeypatch.setattr(jdev.AdjPair, "dropped", recording)
    jextras = {k: jnp.asarray(v) for k, v in data["extras_np"].items()}
    (jloss, jaux), jgrads = jax.value_and_grad(jb.batch_loss, has_aux=True)(
        params, jextras, tuple(jnp.asarray(a) for a in data["batch"]), jax.random.PRNGKey(1))
    ju, ji = jb.encode_eval(params, jextras)
    assert len(keys) == 1  # one key for the joint matrix

    tb = build_model(make_config("KHGRec", **CFG), data["tcf"], data["tkg"])
    assert tb.n_edge_keys == 1
    sd, extras = khgrec_params_from_jax(jax.tree_util.tree_map(np.asarray, params["params"]),
                                        data["extras_np"], "cpu")
    tb.module.load_state_dict(sd)
    u, i = tb.encode_eval(extras)
    _close(u.numpy(), ju, 1e-5, "user table")
    _close(i.numpy(), ji, 1e-5, "item table")
    loss, aux = tb.batch_loss(extras, tuple(torch.as_tensor(a) for a in data["batch"]),
                              tuple(keys))
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
        _close(p.grad.numpy(), want[name].numpy(), 1e-5, f"grad {name}", 1e-6 * g_max)
