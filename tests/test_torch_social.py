"""The social data path and the social models MHCN and SEPT in the port
against the JAX package, at a small size (60 users x 90 items, width 16, 2
layers, batch 128; the synthetic trust network of `synthetic_social(inter,
n_per_user=5)`, as the JAX package's tests build it).

  * `synthetic_social`, `build_social` and the social matrices: bit for bit;
  * MHCN's three channel matrices and SEPT's friend and sharing matrices (read
    from the JAX bundles' closures): the host arrays of their AdjPairs and
    their kernel layouts (base and dedup) bit for bit; packed, as on the card,
    with the configuration's bf16 operand and gather layout;
  * each encode within 1e-5 of the tables' scale; the loss and every aux term
    of one injected batch against `jax.value_and_grad` within rtol 1e-5, and
    every gradient within 1e-5 of its own scale or 1e-6 of the model's
    largest gradient (the tolerances of `test_torch_zoo_adjacency.py`).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu import data as jd
from hypergraph_diffusion_for_recommendation_tpu.core import make_config as j_make_config
from hypergraph_diffusion_for_recommendation_tpu.data import social as jsocial
from hypergraph_diffusion_for_recommendation_tpu.models import build_model as j_build_model
from hypergraph_diffusion_for_recommendation_tpu.ops import sampling as jsam
from hypergraph_diffusion_for_recommendation_tpu.ops.pallas import segment_spmm as jss
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import device as tdev
from hypergraph_diffusion_for_recommendation_tpu_torch.models import MODEL_REGISTRY, build_model
from hypergraph_diffusion_for_recommendation_tpu_torch.models import social_models
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as tss
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import init_flax, params_from_jax

CFG = dict(embedding_size=16, n_layers=2, batch_size=128, temp=0.2)
MODELS = ["MHCN", "SEPT"]
ENCODE_RTOL = LOSS_RTOL = GRAD_RTOL = 1e-5
GRAD_FLOOR = 1e-6


@pytest.fixture(scope="module")
def graphs():
    train, test, _ = td.synthetic_dataset(n_users=60, n_items=90, mean_degree=10.0, seed=4)
    ji = jd.build_interaction(train, test)
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64)
    ti = td.build_interaction(train, test)
    tcf = td.build_cf_device_data(ti, "cpu", eval_user_multiple=64)
    jsoc = jsocial.build_social(jsocial.synthetic_social(ji, n_per_user=5), ji)
    tsoc = td.build_social(td.synthetic_social(ti, n_per_user=5), ti)
    sampler = jsam.HostExactSampler(np.asarray(jcf.edge_u), np.asarray(jcf.edge_i), jcf.n_items)
    users, pos, neg = sampler.pairwise(4, CFG["batch_size"])
    return dict(train=train, test=test, ji=ji, ti=ti, jcf=jcf, tcf=tcf, jsoc=jsoc, tsoc=tsoc,
                batches=(users, pos, neg))


def _eq(got, want, what):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _close(got, want, rtol, what, atol=0.0):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= max(rtol * scale, atol), f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _csr_eq(got, want, what):
    got, want = got.tocsr(), want.tocsr()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    for f in ("indptr", "indices", "data"):
        _eq(getattr(got, f), getattr(want, f), f"{what}.{f}")


def test_social_data_bit_for_bit(graphs):
    ji, ti = graphs["ji"], graphs["ti"]
    for n in (5, 3):
        _eq(td.synthetic_social(ti, n_per_user=n), jsocial.synthetic_social(ji, n_per_user=n),
            f"synthetic_social n={n}")
    js, ts = graphs["jsoc"], graphs["tsoc"]
    assert isinstance(ts, td.SocialData)
    _eq(ts.edges, js.edges, "edges")
    assert ts.n_users == js.n_users and ts.n_relations == js.n_relations > 0
    _csr_eq(ts.social_mat, js.social_mat, "social_mat")
    _csr_eq(ts.bidirectional_mat(), js.bidirectional_mat(), "bidirectional_mat")
    _csr_eq(ts.norm_social(), js.norm_social(), "norm_social")
    for u in (0, 7, 31):
        _eq(ts.followees(u), js.followees(u), f"followees {u}")
        _eq(ts.followers(u), js.followers(u), f"followers {u}")
    # pairs with an unknown user are dropped
    assert td.build_social(np.array([[999999, 999998]]), ti).n_relations == 0


def _jax_pairs(graphs, name):
    """The JAX bundle's user-user AdjPairs, read from its loss's closure."""
    jb = j_build_model(j_make_config(name, **CFG), graphs["jcf"], social=graphs["jsoc"])
    free = inspect.getclosurevars(jb.batch_loss).nonlocals
    return dict(free["channels"]) if name == "MHCN" else {k: free[k]
                                                          for k in ("friend", "sharing")}


def _port_mats(graphs, name):
    fn = (social_models.social_channel_mats if name == "MHCN"
          else social_models.sept_view_mats)
    return fn(graphs["tcf"], graphs["tsoc"].social_mat)


@pytest.mark.parametrize("name", MODELS)
def test_user_matrices_bit_for_bit(graphs, name):
    want = _jax_pairs(graphs, name)
    mats = _port_mats(graphs, name)
    assert sorted(mats) == sorted(want)
    for k, mat in mats.items():
        pair = tdev.adj_pair_from_scipy(mat, "cpu")
        for side in ("fwd", "bwd"):
            js, ts = getattr(want[k], side), getattr(pair, side)
            for f in ("rows", "cols", "vals"):
                _eq(getattr(ts, f), getattr(js, f), f"{k}.{side}.{f}")
            assert (ts.nrows, ts.ncols, ts.nnz) == (js.nrows, js.ncols, js.nnz)
        _eq(pair.t_perm, want[k].t_perm, f"{k}.t_perm")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dedup", [False, True], ids=["base", "dedup"])
def test_user_matrix_kernel_layouts_bit_for_bit(graphs, name, dedup):
    tiles = dict(edge_block=64, row_block=32)
    jpack = jss.pack_blocked_dedup if dedup else jss.pack_blocked
    tpack = tss.pack_blocked_dedup if dedup else tss.pack_blocked
    for k, mat in _port_mats(graphs, name).items():
        pair = tdev.adj_pair_from_scipy(mat, "cpu")
        for side, canon in (("fwd", None), ("bwd", pair.t_perm.numpy())):
            s = getattr(pair, side)
            args = (s.rows.numpy(), s.cols.numpy(), s.vals.numpy(), s.shape)
            jb = jpack(*args, canon_map=canon, **tiles)
            tb = tpack(*args, canon_map=canon, device="cpu", **tiles)
            fields = ("cols", "vals", "local_rows", "wmap", "src", "canon") + (
                ("ucols", "local_cols") if dedup else ())
            for f in fields:
                _eq(getattr(tb, f), getattr(jb, f), f"{k}.{side}.{f}")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("layout", ["dedup", "base"])
def test_user_matrices_take_the_configured_layout(graphs, name, layout, monkeypatch):
    """The user-user matrices are packed as the CF data is: on its device,
    with the configuration's operand type and gather layout (here the
    layout is forced on the CPU, where none is attached otherwise)."""
    monkeypatch.setattr(tdev, "_maybe_attach_blocked", tdev.attach_blocked)
    tb = build_model(make_config(name, **CFG, compute_dtype="bfloat16", gather_layout=layout),
                     graphs["tcf"], social=graphs["tsoc"])
    free = inspect.getclosurevars(tb.batch_loss).nonlocals
    pairs = free["channels"] if name == "MHCN" else free["views"]
    assert len(pairs) == (3 if name == "MHCN" else 2)
    for k, pair in pairs.items():
        for side in (pair.fwd, pair.bwd):
            b = side.blocked
            assert b is not None and b.bf16 and b.dedup == (layout == "dedup"), k
            assert side.rows.device == graphs["tcf"].edge_u.device


def _pair(graphs, name):
    jb = j_build_model(j_make_config(name, **CFG), graphs["jcf"], social=graphs["jsoc"])
    params, _ = jb.init(jax.random.PRNGKey(0))
    tb = build_model(make_config(name, **CFG), graphs["tcf"], social=graphs["tsoc"])
    tb.module.load_state_dict(params_from_jax(_np(params["params"]), "cpu"))
    return jb, params, tb


@pytest.mark.parametrize("name", MODELS)
def test_encode_eval_matches_jax(graphs, name):
    jb, params, tb = _pair(graphs, name)
    ju, ji = jb.encode_eval(params, ())
    u, i = tb.encode_eval({})
    assert u.shape == ju.shape and i.shape == ji.shape
    _close(u.numpy(), ju, ENCODE_RTOL, "users")
    _close(i.numpy(), ji, ENCODE_RTOL, "items")


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax(graphs, name):
    jb, params, tb = _pair(graphs, name)
    batch = tuple(a[0] for a in graphs["batches"])
    (jloss, jaux), jgrads = jax.value_and_grad(jb.batch_loss, has_aux=True)(
        params, (), tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(1))
    loss, aux = tb.batch_loss({}, tuple(torch.as_tensor(a) for a in batch), ())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=LOSS_RTOL, err_msg=k)
    want = params_from_jax(_np(jgrads["params"]), "cpu")
    got = dict(tb.module.named_parameters())
    assert set(got) == set(want)
    g_max = max(float(w.abs().max()) for w in want.values())
    for pname, p in got.items():
        _close(p.grad.numpy(), want[pname].numpy(), GRAD_RTOL, pname, GRAD_FLOOR * g_max)


@pytest.mark.parametrize("name", MODELS)
def test_native_init_and_social_argument(graphs, name):
    assert name in MODEL_REGISTRY
    with pytest.raises(ValueError, match="social data"):
        build_model(make_config(name, **CFG), graphs["tcf"])
    tb = build_model(make_config(name, **CFG), graphs["tcf"], social=graphs["tsoc"])
    sd = init_flax(tb.module, torch.Generator().manual_seed(0))
    jb = j_build_model(j_make_config(name, **CFG), graphs["jcf"], social=graphs["jsoc"])
    jparams = params_from_jax(_np(jb.init(jax.random.PRNGKey(0))[0]["params"]), "cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                          for k, v in jparams.items()}


@pytest.mark.parametrize("model", MODELS)
def test_social_models_refuse_without_social_data(model, graphs, tmp_path, monkeypatch):
    """Without social data `Recommender.build` and the CLI refuse a social
    model, as the JAX `build_mhcn` and `build_sept` do (they assert that
    social data was passed, and the JAX CLI passes none)."""
    from hypergraph_diffusion_for_recommendation_tpu_torch import cli
    from hypergraph_diffusion_for_recommendation_tpu_torch.data.io import write_interactions

    rec = Recommender(make_config(model, **CFG, eval_user_batch=64), device="cpu")
    with pytest.raises(ValueError, match=f"{model} requires social data"):
        rec.build((graphs["train"], graphs["test"], None))
    assert rec.bundle is None
    # the CLI over the same split written as files
    data = tmp_path / "data" / "tiny"
    write_interactions(str(data / "train.txt"), graphs["train"])
    write_interactions(str(data / "test.txt"), graphs["test"])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=f"{model} requires social data"):
        cli.main([f"--model={model}", "--dataset=tiny", f"--data_dir={tmp_path / 'data'}",
                  "--max_epoch=1", "--embedding_size=16", f"--output_dir={tmp_path / 'out'}",
                  "--quiet"], device="cpu")
    assert not (tmp_path / "out").exists()
