"""The port's KHGRec training path against the JAX package's.

`full_loss`: both sides start from the JAX initial parameters (carried
across with `weights.khgrec_params_from_jax`), the same numpy-made
attention extras and the same `HostExactSampler` batch. The JAX side's
edge-dropout keys come from flax's `make_rng("edges")`; the test records
the key words the JAX `AdjPair.dropped` receives and hands them to the
port. Loss, aux terms, every parameter's gradient and the next batch's
attention must then agree in float32 (sums in another order): the loss
and aux terms within rtol 1e-5, each gradient within 1e-5 of its own
scale (max |g|; measured: 8e-7). With the int8 layouts both sides
quantise each product's operand, and an operand that differs in its last
f32 bit between the two can round to the other int8 step: those
gradients agree within 1e-2 of their scale (measured: 4.7e-3).

Also here: the `gather_layout` mapping against the JAX CLI's, and the
facade end to end on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

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
from hypergraph_diffusion_for_recommendation_tpu.ops.pallas import segment_spmm as jsp
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import device as tdev
from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as tsp
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import khgrec_params_from_jax

CFG = dict(hyper_dim=16, relation_dim=8, n_layers=2, batch_size=128, batch_size_kg=64,
           mode="full", drop_rate=0.2, temp=1.0, cl_rate=0.01)
LAYOUTS = ["coo", "base", "dedup", "int8", "dedup_int8"]
TILES = dict(edge_block=64, row_block=32)


def _pack_pair(pair, layout: str, torch_side: bool):
    """Both directions packed by hand in `layout` (small tiles, so windows
    span several blocks): JAX attaches layouts only on a TPU, the port
    only on a CUDA card."""
    dedup = layout.startswith("dedup")
    if torch_side:
        pack = tsp.pack_blocked_dedup if dedup else tsp.pack_blocked
        host = lambda a: a.numpy()  # noqa: E731
        extra = dict(device="cpu")
    else:
        pack = jsp.pack_blocked_dedup if dedup else jsp.pack_blocked
        host = np.asarray
        extra = {}
    tiles = dict(TILES, **(dict(unique_block=16) if dedup else {}))

    def side(sp, canon_map=None):
        b = pack(host(sp.rows), host(sp.cols), host(sp.vals), sp.shape, canon_map=canon_map,
                 **tiles, **extra)
        return sp.replace(blocked=b.replace(int8=layout.endswith("int8")))

    return pair.replace(fwd=side(pair.fwd), bwd=side(pair.bwd, host(pair.t_perm)))


@pytest.fixture(scope="module")
def state(tiny_kg_dataset):
    train, test, kg_df = tiny_kg_dataset
    ji = jd.build_interaction(train, test)
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64, needs={"adj"})
    jkg = jd.build_kg_device_data(jd.build_knowledge(kg_df, ji))
    jb = j_build_model(j_make_config("KHGRec", **CFG), jcf, jkg)
    params, _ = jb.init(jax.random.PRNGKey(0))

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
    batch = tuple(a[0] for a in (users, pos, neg, h, r, pt, nt))

    rng = np.random.default_rng(5)
    pick = rng.choice(n, CFG["batch_size_kg"], replace=False)
    extras_np = {"att_h": tkg.att_h.numpy()[pick], "att_t": tkg.att_t.numpy()[pick],
                 "att_v": rng.uniform(0.05, 1.0, pick.shape[0]).astype(np.float32)}
    params_np = jax.tree_util.tree_map(np.asarray, params["params"])
    return dict(jb=jb, jcf=jcf, jkg=jkg, params=params, params_np=params_np, tcf=tcf, tkg=tkg,
                batch=batch, extras_np=extras_np)


def _jax_step(st, layout, monkeypatch):
    """jax.value_and_grad of the JAX batch_loss; records the dropout keys."""
    jb = st["jb"]
    if layout != "coo":
        cf = st["jcf"].replace(adj=_pack_pair(st["jcf"].adj, layout, False))
        kg = st["jkg"].replace(kg_adj=_pack_pair(st["jkg"].kg_adj, layout, False))
        jb = j_build_model(j_make_config("KHGRec", **CFG), cf, kg)
    keys = []
    original = jdev.AdjPair.dropped

    def recording(self, rng, keep_rate):
        kd = jnp.asarray(rng)
        kd = (kd if kd.dtype == jnp.uint32 else jax.random.key_data(rng)).reshape(-1)
        keys.append((int(kd[0]), int(kd[-1])))
        return original(self, rng, keep_rate)

    monkeypatch.setattr(jdev.AdjPair, "dropped", recording)
    extras = {k: jnp.asarray(v) for k, v in st["extras_np"].items()}
    (loss, aux), grads = jax.value_and_grad(jb.batch_loss, has_aux=True)(
        st["params"], extras, tuple(jnp.asarray(a) for a in st["batch"]),
        jax.random.PRNGKey(1))
    return loss, aux, grads, keys


def _port_bundle(st, layout, cfg=CFG):
    tcf, tkg = st["tcf"], st["tkg"]
    if layout != "coo":
        tcf = tcf.replace(adj=_pack_pair(tcf.adj, layout, True))
        tkg = tkg.replace(kg_adj=_pack_pair(tkg.kg_adj, layout, True))
    tb = build_model(make_config("KHGRec", **cfg), tcf, tkg)
    sd, extras = khgrec_params_from_jax(st["params_np"], st["extras_np"], "cpu")
    tb.module.load_state_dict(sd)
    return tb, extras


@pytest.mark.parametrize("layout", LAYOUTS)
def test_full_loss_and_grads_match_jax(state, layout, monkeypatch):
    jloss, jaux, jgrads, keys = _jax_step(state, layout, monkeypatch)
    assert len(keys) == 2 and keys[0] != keys[1]  # one key per adjacency
    tb, extras = _port_bundle(state, layout)
    batch = tuple(torch.as_tensor(a) for a in state["batch"])
    loss, aux = tb.batch_loss(extras, batch, tuple(keys))
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in ("rec_loss", "cf_loss", "kg_loss", "cl_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    new, jnew = aux["_new_extras"], jaux["_new_extras"]
    np.testing.assert_array_equal(new["att_h"].numpy(), np.asarray(jnew["att_h"]))
    np.testing.assert_array_equal(new["att_t"].numpy(), np.asarray(jnew["att_t"]))
    np.testing.assert_allclose(new["att_v"].numpy(), np.asarray(jnew["att_v"]),
                               rtol=1e-4, atol=1e-6)

    want, _ = khgrec_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads["params"]),
                                     None, "cpu")
    tol = 1e-2 if layout.endswith("int8") else 1e-5
    params = dict(tb.module.named_parameters())
    assert set(params) == set(want)
    for name, p in params.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        assert p.grad is not None, name
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= tol * scale, f"{name}: max err {err:.3e} vs scale {scale:.3e}"


def test_dropout_keys_change_the_loss(state):
    tb, extras = _port_bundle(state, "coo")
    batch = tuple(torch.as_tensor(a) for a in state["batch"])
    with torch.no_grad():
        a = tb.batch_loss(extras, batch, ((1, 2), (3, 4)))[0]
        b = tb.batch_loss(extras, batch, ((1, 2), (3, 4)))[0]
        c = tb.batch_loss(extras, batch, ((5, 6), (3, 4)))[0]
    assert float(a) == float(b) != float(c)


@pytest.mark.parametrize("mode", ["woatt", "wossl"])
def test_modes_match_jax(state, mode, monkeypatch):
    # woatt: SSL on, attention fusion off (its parameters get no gradient);
    # wossl: attention on, no cl_loss
    cfg = dict(CFG, mode=mode)
    jb = j_build_model(j_make_config("KHGRec", **cfg), state["jcf"], state["jkg"])
    keys = []
    original = jdev.AdjPair.dropped

    def recording(self, rng, keep_rate):
        kd = jnp.asarray(rng).reshape(-1)
        keys.append((int(kd[0]), int(kd[-1])))
        return original(self, rng, keep_rate)

    monkeypatch.setattr(jdev.AdjPair, "dropped", recording)
    extras = {k: jnp.asarray(v) for k, v in state["extras_np"].items()}
    (jloss, jaux), _ = jax.value_and_grad(jb.batch_loss, has_aux=True)(
        state["params"], extras, tuple(jnp.asarray(a) for a in state["batch"]),
        jax.random.PRNGKey(2))
    tb, textras = _port_bundle(state, "coo", cfg)
    loss, aux = tb.batch_loss(textras, tuple(torch.as_tensor(a) for a in state["batch"]),
                              tuple(keys))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert ("cl_loss" in aux) == ("cl_loss" in jaux) == (mode == "woatt")


@pytest.mark.parametrize("int8_env", [None, "1"])
@pytest.mark.parametrize("dedup_env", [None, "0", "1"])
@pytest.mark.parametrize("gather_layout", tdev.GATHER_LAYOUTS)
def test_gather_layout_mapping_matches_jax_cli(gather_layout, dedup_env, int8_env, monkeypatch):
    # HGDR_DEDUP and HGDR_INT8 set (or unset) for both packages; the JAX CLI
    # maps gather_layout and, under "auto", the variables onto the packer's
    # module globals (cli.py:225-237), written here as it writes them; its
    # packer attaches only on a TPU and above PALLAS_MIN_NNZ, so both
    # conditions are lifted here
    for name, value in (("HGDR_DEDUP", dedup_env), ("HGDR_INT8", int8_env)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    if gather_layout != "auto":
        monkeypatch.setattr(jdev, "PALLAS_DEDUP",
                            "1" if gather_layout in ("dedup", "dedup_int8") else "0")
        monkeypatch.setattr(jdev, "PALLAS_INT8", gather_layout in ("int8", "dedup_int8"))
    else:
        monkeypatch.setattr(jdev, "PALLAS_DEDUP", os.environ.get("HGDR_DEDUP", "auto"))
        monkeypatch.setattr(jdev, "PALLAS_INT8", os.environ.get("HGDR_INT8") == "1")
    monkeypatch.setattr(jdev, "PALLAS_MIN_NNZ", 0)
    monkeypatch.setattr(jdev.jax, "default_backend", lambda: "tpu")
    for shape, deg, seed in (((150, 100), 40.0, 9), ((120, 300), 20.0, 3)):
        train, test, _ = td.synthetic_dataset(n_users=shape[0], n_items=shape[1],
                                              mean_degree=deg, seed=seed)
        mat = td.build_interaction(train, test).norm_adj.tocoo()
        jp = jdev.make_adj_pair(mat.row, mat.col, mat.data, mat.shape)
        tp = tdev.make_adj_pair(mat.row, mat.col, mat.data, mat.shape, "cpu")
        for side in ("fwd", "bwd"):
            jb_, sp = getattr(jp, side).blocked, getattr(tp, side)
            # the port attaches only on CUDA: pack this side by hand
            tb_ = tdev.attach_blocked(sp, sp.rows.numpy(), sp.cols.numpy(), sp.vals.numpy(),
                                      gather_layout=gather_layout).blocked
            assert (tb_.dedup, tb_.int8) == (jb_.ucols is not None, jb_.int8), side
            np.testing.assert_array_equal(tb_.cols.numpy(), np.asarray(jb_.cols))


def test_pad_table_budget_reads_the_environment():
    # HGDR_PAD_TABLE_BUDGET sets the padded membership tables' byte budget at
    # import, as in the JAX package (data/device.py:118): at 0 bytes every
    # table takes the CSR form, in both packages
    probe = ("import os, sys; os.environ['HGDR_PAD_TABLE_BUDGET'] = '0'; "
             "from hypergraph_diffusion_for_recommendation_tpu_torch.data import device as t; "
             "from hypergraph_diffusion_for_recommendation_tpu_torch import data as td; "
             "from hypergraph_diffusion_for_recommendation_tpu.data import device as j; "
             "tr, te, _ = td.synthetic_dataset(n_users=30, n_items=40, mean_degree=6.0, seed=1); "
             "cf = td.build_cf_device_data(td.build_interaction(tr, te), 'cpu'); "
             "print(t.PAD_TABLE_BUDGET, j.PAD_TABLE_BUDGET, type(cf.sample_membership).__name__)")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parents[1],
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.stdout.split() == ["0", "0", "CSRMembership"], proc.stdout + proc.stderr


def test_recommender_routes_gather_layout(monkeypatch):
    # Recommender.build -> build_{cf,kg}_device_data -> make_adj_pair: every
    # layout comes out as configured (attached on the CPU for the test)
    monkeypatch.setattr(tdev, "_maybe_attach_blocked", tdev.attach_blocked)
    data = td.synthetic_dataset(n_users=60, n_items=80, mean_degree=10.0, seed=1, with_kg=True)
    for gl, want in (("base", (False, False)), ("dedup_int8", (True, True)),
                     ("int8", (False, True))):
        rec = Recommender(make_config("KHGRec", hyper_dim=16, relation_dim=8, batch_size_kg=64,
                                      eval_user_batch=64, gather_layout=gl,
                                      compute_dtype="bfloat16"), device="cpu")
        rec.build(data)
        for pair in (rec.bundle.cf.adj, rec.bundle.kg.kg_adj):
            for sp in (pair.fwd, pair.bwd):
                assert (sp.blocked.dedup, sp.blocked.int8, sp.blocked.bf16) == want + (True,)
    # under "auto" the layout variables decide, read when the layouts are packed
    monkeypatch.setenv("HGDR_DEDUP", "1")
    monkeypatch.setenv("HGDR_INT8", "1")
    rec = Recommender(make_config("KHGRec", hyper_dim=16, relation_dim=8, batch_size_kg=64,
                                  eval_user_batch=64), device="cpu")
    rec.build(data)
    for pair in (rec.bundle.cf.adj, rec.bundle.kg.kg_adj):
        assert all((sp.blocked.dedup, sp.blocked.int8) == (True, True)
                   for sp in (pair.fwd, pair.bwd))
    with pytest.raises(ValueError, match="gather_layout"):
        tdev.make_adj_pair([0], [0], [1.0], (1, 1), "cpu", gather_layout="int4")


@pytest.mark.parametrize("gather_layout", ["auto", "int8"])
def test_execute_end_to_end_on_cpu(gather_layout, monkeypatch):
    if gather_layout != "auto":  # run the packed plain versions, as on a card
        monkeypatch.setattr(tdev, "_maybe_attach_blocked", tdev.attach_blocked)
    cfg = make_config("KHGRec", hyper_dim=16, relation_dim=8, batch_size=256, batch_size_kg=128,
                      eval_user_batch=64, item_ranking=(10, 20), max_epoch=3,
                      gather_layout=gather_layout)
    rec = Recommender(cfg, device="cpu")
    rec.build(td.synthetic_dataset(n_users=60, n_items=80, mean_degree=10.0, seed=1,
                                   with_kg=True))
    out = rec.execute()
    assert set(out) == {10, 20} and all(0.0 <= v <= 1.0 for m in out.values() for v in m.values())
    res = rec.result
    assert 1 <= res.best_epoch <= 3 and len(res.history) == 3
    assert all(np.isfinite(r.losses["train_loss"]) for r in res.history)
    assert set(res.history[0].losses) == {"train_loss", "rec_loss", "cf_loss", "kg_loss",
                                          "cl_loss"}
    # the final metrics are the best epoch's
    assert res.final_metrics[20] == res.history[res.best_epoch - 1].metrics[20]
    assert rec.user_emb.shape == (rec.inter.n_users, 16)


def test_trainer_state_and_samplers(state):
    tb, _ = _port_bundle(state, "coo", dict(CFG, max_epoch=2, sampler="exact"))
    tr = Trainer(tb, seed=3)
    batches = tr.sample_epoch()
    assert len(batches) == 7 and batches[0].shape == (tr.n_batches, CFG["batch_size"])
    assert batches[3].shape == (tr.n_batches, CFG["batch_size_kg"])
    before = {k: v.clone() for k, v in tb.module.state_dict().items()}
    loss, aux = tr.train_step(tuple(t[0] for t in batches), tr.edge_keys())
    assert torch.isfinite(loss) and "_new_extras" not in aux
    after = tb.module.state_dict()
    # Adam moves every parameter, the unused-by-this-batch rows included
    # (coupled weight decay), as optax does
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert tr.extras["att_h"].shape == (CFG["batch_size_kg"],)
    snap = tr.snapshot()
    tr.run_epoch(0)
    tr.restore(snap)
    assert all(torch.equal(snap[0][k], v) for k, v in tb.module.state_dict().items())
    # same seed, same initial state and batches
    tb2, _ = _port_bundle(state, "coo", dict(CFG, sampler="exact"))
    a, b = Trainer(tb2, seed=3), Trainer(tb2, seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.sample_epoch(), b.sample_epoch()))
    assert a.edge_keys() == b.edge_keys()
