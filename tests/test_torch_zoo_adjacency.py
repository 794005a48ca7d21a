"""The models of the other adjacency forms — SGL (both augmentations), DHCF,
DHCF_diffusion, HCCF_diffusion, KGIN, KGCL, AutoCF and LRMRec — in the port
against the JAX package, at a small size (60 users x 90 items, width 16, 2
layers, batch 128; KGIN and KGCL on the synthetic KG of the same split).

Each port model starts from the JAX initial parameters, carried across by
`weights.params_from_jax`, and the JAX extras. Tolerances, as in
`test_torch_zoo.py` (float32 sums in another order):

  * `encode_eval`: within 1e-5 of the tables' scale;
  * the loss and every aux term of one injected batch against
    `jax.value_and_grad(bundle.batch_loss)`: rtol 1e-5; every gradient
    within 1e-5 of its own scale or 1e-6 of the model's largest gradient;
  * the hooks, through `Trainer.train_step` against the JAX trainer's
    `_build_chunk_fn`: SGL's `epoch_setup` (both augmented views, within
    1e-6 of their scale) then every batch of the epoch; AutoCF's and
    LRMRec's `update_extras` over steps 0-11 (a refresh, nine keeps, a
    second refresh): each step's loss within rtol 1e-5, and after the last
    step the parameters and the float extras within 1e-5 of their scale,
    the decoder's integer lists and the step count exactly.

What torch cannot reproduce is made equal: the edge-dropout keys are
recorded from the JAX `AdjPair.dropped`; flax's `nn.Dropout` and the port's
`feature_dropout` are the identity; the JAX draws (`jax.random.uniform`,
`randint`, `bernoulli`, `choice`) and the port's named draw functions
(`sgl._keep_mask`, `autocf._uniform`, `_randint`, `_choice`) return the
same numpy draws in call order; the JAX `lax.cond` of AutoCF's refresh runs
as a Python `if`, so that only the branch taken draws.
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
from hypergraph_diffusion_for_recommendation_tpu.models import autocf as jautocf
from hypergraph_diffusion_for_recommendation_tpu.models import build_model as j_build_model
from hypergraph_diffusion_for_recommendation_tpu.ops import sampling as jsam
from hypergraph_diffusion_for_recommendation_tpu.train.trainer import Trainer as JTrainer
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
    MODEL_REGISTRY,
    autocf,
    build_model,
    hccf_diffusion,
    model_data_needs,
    sgl,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.models import layers as tlayers
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import init_flax, params_from_jax

CFG = dict(embedding_size=16, hyper_dim=16, n_layers=2, batch_size=128)
MODELS = ["SGL", "DHCF", "DHCF_diffusion", "HCCF_diffusion", "KGIN", "KGCL", "AutoCF", "LRMRec"]
KG_MODELS = ("KGIN", "KGCL")
# SGL's node dropout beside its default edge dropout; AutoCF and LRMRec on a
# refresh step (with the seed-score term) and on a keep step
CASES = ([(m, {}) for m in MODELS if m not in ("AutoCF", "LRMRec")]
         + [("SGL", dict(aug_type=0))]
         + [(m, dict(branch=b)) for m in ("AutoCF", "LRMRec") for b in ("refresh", "keep")])
ENCODE_RTOL = LOSS_RTOL = GRAD_RTOL = 1e-5
GRAD_FLOOR = 1e-6


@pytest.fixture(scope="module")
def graphs():
    train, test, kg_df = td.synthetic_dataset(n_users=60, n_items=90, mean_degree=10.0, seed=4,
                                              with_kg=True)
    ji = jd.build_interaction(train, test)
    jcf = jd.build_cf_device_data(ji, eval_user_multiple=64)
    jkg = jd.build_kg_device_data(jd.build_knowledge(kg_df, ji))
    ti = td.build_interaction(train, test)
    tcf = td.build_cf_device_data(ti, "cpu", eval_user_multiple=64)
    tkg = td.build_kg_device_data(td.build_knowledge(kg_df, ti), "cpu")
    sampler = jsam.HostExactSampler(np.asarray(jcf.edge_u), np.asarray(jcf.edge_i), jcf.n_items)
    users, pos, neg = sampler.pairwise(4, CFG["batch_size"])
    return dict(jcf=jcf, jkg=jkg, tcf=tcf, tkg=tkg, batches=(users, pos, neg))


def _close(got, want, rtol, what, atol=0.0):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= max(rtol * scale, atol), f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _port_extras(jextras):
    """The JAX extras as the port keeps them: tensors, and AutoCF's step
    count as a host integer."""
    return {k: int(v) if k == "step" else torch.tensor(np.asarray(v))
            for k, v in dict(jextras or {}).items()}


def _pair(graphs, name, **kw):
    cfg = dict(CFG, **kw)
    kg = name in KG_MODELS
    jb = j_build_model(j_make_config(name, **cfg), graphs["jcf"], graphs["jkg"] if kg else None)
    params, jextras = jb.init(jax.random.PRNGKey(0))
    tb = build_model(make_config(name, **cfg), graphs["tcf"], graphs["tkg"] if kg else None)
    tb.module.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                     params["params"]), "cpu"))
    return jb, params, jextras, tb


def _identity_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(tlayers, "feature_dropout", lambda x, *a, **k: x)
    monkeypatch.setattr(hccf_diffusion, "feature_dropout", lambda x, *a, **k: x)


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
    """The JAX draws and the port's draw functions from one numpy stream:
    each JAX call draws and queues, the port's function of the same kind
    takes the queued values in the same order."""
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
    monkeypatch.setattr(sgl, "_keep_mask", lambda shape, keep, gen, device: take("bernoulli"))
    monkeypatch.setattr(autocf, "_uniform", lambda shape, gen, device: take("uniform"))
    monkeypatch.setattr(autocf, "_randint", lambda shape, high, gen, device: take("randint"))
    monkeypatch.setattr(autocf, "_choice", lambda n, k, gen, device: take("choice"))
    return queues


def _python_cond(monkeypatch):
    """`lax.cond` as a Python `if` on its concrete predicate."""
    monkeypatch.setattr(jax.lax, "cond", lambda pred, t, f, *ops: t(*ops) if bool(pred)
                        else f(*ops))


def test_registry_and_data_needs():
    assert set(MODELS) <= set(MODEL_REGISTRY)
    want = {"SGL": {"adj", "raw_adj", "raw_int"}, "DHCF": {"raw_int"},
            "DHCF_diffusion": {"raw_int"}, "HCCF_diffusion": {"adj"},
            "KGIN": {"adj", "int_norm"}, "KGCL": {"adj", "int_norm"},
            "AutoCF": {"adj", "raw_adj"}, "LRMRec": {"adj", "raw_adj"}}
    for name, needs in want.items():
        assert model_data_needs(name) == frozenset(needs), name
    from hypergraph_diffusion_for_recommendation_tpu.models import model_data_needs as j_needs

    for name in MODELS:
        assert model_data_needs(name) == j_needs(name), name


@pytest.mark.parametrize("name", MODELS)
def test_encode_eval_matches_jax(graphs, name):
    jb, params, jextras, tb = _pair(graphs, name)
    ju, ji = jb.encode_eval(params, jextras)
    u, i = tb.encode_eval(_port_extras(jextras))
    assert u.shape == ju.shape and i.shape == ji.shape
    _close(u.numpy(), ju, ENCODE_RTOL, "users")
    _close(i.numpy(), ji, ENCODE_RTOL, "items")


def _autocf_extras(jb, params, jextras, branch, monkeypatch):
    """JAX extras after a refresh (the decoder drawn from numpy), and the port's
    copy: the port's step count is the one before the step (its branch is
    chosen from it), the JAX count the one after `update_extras`."""
    _python_cond(monkeypatch)
    rng = np.random.default_rng(6)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: jnp.asarray(
        rng.random(tuple(shape), dtype=np.float32)))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi, *a, **k: jnp.asarray(
        rng.integers(lo, hi, tuple(shape)).astype(np.int32)))
    jextras = jb.update_extras(params, jextras, None, jax.random.PRNGKey(5))
    monkeypatch.undo()
    if branch == "keep":
        jextras = dict(jextras, step=jnp.int32(2))
    port = _port_extras(jextras)
    port["step"] = int(jextras["step"]) - 1
    return jextras, port


@pytest.mark.parametrize("name,kw", CASES, ids=[n + "".join(f"-{v}" for v in kw.values())
                                                for n, kw in CASES])
def test_loss_and_grads_match_jax(graphs, name, kw, monkeypatch):
    branch = kw.pop("branch", None)
    jb, params, jextras, tb = _pair(graphs, name, **kw)
    if branch is not None:
        jextras, extras = _autocf_extras(jb, params, jextras, branch, monkeypatch)
        assert tb.step_branch(extras) == branch
    elif name == "SGL":  # the views of one epoch, drawn alike
        queues = _shared_draws(monkeypatch)
        jextras = jb.epoch_setup(params, jextras, jax.random.PRNGKey(2))
        extras = tb.epoch_setup(_port_extras(jextras), None)
        assert all(not q for q in queues.values())
        for k in ("view1", "view2"):
            _close(extras[k].numpy(), jextras[k], 1e-6, k)
        monkeypatch.undo()
    else:
        extras = _port_extras(jextras)
    _identity_dropout(monkeypatch)
    keys = _record_keys(monkeypatch)
    queues = _shared_draws(monkeypatch)
    batch = tuple(a[0] for a in graphs["batches"])
    (jloss, jaux), jgrads = jax.value_and_grad(jb.batch_loss, has_aux=True)(
        params, jextras, tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(1))
    assert len(keys) == tb.n_edge_keys, (keys, tb.n_edge_keys)
    loss, aux = tb.batch_loss(extras, tuple(torch.as_tensor(a) for a in batch), keys)
    assert all(not q for q in queues.values()), "the port made other draws than JAX"
    new = aux.pop("_new_extras", None)
    if branch is not None:
        assert new == {"step": extras["step"] + 1}
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
        if p.grad is None:  # the loss does not reach it (HCCF_diffusion's incidence
            # weights, read only through H > 0): JAX's gradient is exactly 0
            assert not want[pname].any(), pname
            continue
        _close(p.grad.numpy(), want[pname].numpy(), GRAD_RTOL, pname, GRAD_FLOOR * g_max)


def test_autocf_subgraphs_bit_for_bit(graphs, monkeypatch):
    """The seeds, the encoder's kept edges, the decoder's lists and masks from
    the same injected draws: integers bit for bit, the encoder values and the
    noisy scores within 1e-5."""
    jcf, tcf = graphs["jcf"], graphs["tcf"]
    queues = _shared_draws(monkeypatch)
    n, d = tcf.n_nodes, 16
    ego = np.random.default_rng(7).standard_normal((n, d)).astype(np.float32)
    jnoisy, jseeds = jautocf._local_graph_scores(jax.random.PRNGKey(0), jcf.raw_adj.fwd,
                                                 jnp.asarray(ego))
    noisy, seeds = autocf._local_graph_scores(None, tcf.raw_adj.fwd, torch.as_tensor(ego))
    _close(noisy.numpy(), jnoisy, 1e-5, "noisy scores")
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(jseeds))
    jenc, jdec = jautocf._mask_subgraphs(jax.random.PRNGKey(1), jcf, jseeds)
    enc_vals, dec = autocf._mask_subgraphs(None, tcf, seeds)
    assert all(not q for q in queues.values())
    _close(enc_vals.numpy(), jenc.vals, 1e-5, "encoder values")
    np.testing.assert_array_equal(enc_vals.numpy() == 0, np.asarray(jenc.vals) == 0)
    for what, got, want in zip(("rows", "cols", "valid"), dec, jdec):
        assert got.dtype == (torch.bool if what == "valid" else torch.int32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def test_autocf_refuses_unshared_edge_order(graphs):
    tcf = graphs["tcf"]
    swapped = tcf.replace(raw_adj=tcf.int_norm)
    with pytest.raises(ValueError, match="edge order"):
        build_model(make_config("AutoCF", **CFG), swapped)


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


@pytest.mark.parametrize("name,n_steps", [("SGL", None), ("AutoCF", 12), ("LRMRec", 12)])
def test_hooks_match_jax_chunk_fn(graphs, name, n_steps, monkeypatch):
    """SGL's `epoch_setup` then one epoch of steps; AutoCF's and LRMRec's
    `update_extras` over steps 0-11 (a refresh, nine keeps, a refresh)."""
    jb = j_build_model(j_make_config(name, **CFG), graphs["jcf"])
    jt = JTrainer(jb, seed=0)
    params0 = jax.tree_util.tree_map(np.asarray, jt.params["params"])
    tb = build_model(make_config(name, **CFG), graphs["tcf"])
    tb.module.load_state_dict(params_from_jax(params0, "cpu"))
    tr = Trainer(tb, seed=0, extras=_port_extras(jt.extras))
    queues = _shared_draws(monkeypatch)
    _python_cond(monkeypatch)
    ys = []
    monkeypatch.setattr(jax.lax, "scan", _py_scan(ys))
    jextras = jt.extras
    if jb.epoch_setup is not None:
        jextras = jb.epoch_setup(jt.params, jextras, jax.random.PRNGKey(2))
        tr.begin_epoch()
        assert not queues["bernoulli"]
        for k in ("view1", "view2"):
            _close(tr.extras[k].numpy(), jextras[k], 1e-6, k)
    batches = graphs["batches"]
    n = batches[0].shape[0] if n_steps is None else n_steps
    idx = np.arange(n) % batches[0].shape[0]
    chunk = jt._build_chunk_fn(masked=False)
    jparams, _, jextras, _, _ = chunk(jt.params, jt.opt_state, jextras,
                                      tuple(jnp.asarray(a[idx]) for a in batches),
                                      jax.random.split(jax.random.PRNGKey(7), n))
    branches = []
    for s in range(n):
        branches.append(tb.step_branch(tr.extras) if tb.step_branch else "full")
        loss, _ = tr.train_step(tuple(torch.as_tensor(a[idx[s]]) for a in batches), ())
        np.testing.assert_allclose(float(loss), float(ys[s][0]), rtol=LOSS_RTOL,
                                   err_msg=f"step {s}")
    assert all(not q for q in queues.values()), "the port made other draws than JAX"
    if n_steps == 12:
        assert branches == ["refresh"] + ["keep"] * 9 + ["refresh", "keep"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams["params"]), "cpu")
    for pname, p in tb.module.named_parameters():
        _close(p.detach().numpy(), want[pname].numpy(), 1e-5, pname)
    assert set(tr.extras) == set(jextras)
    for k, v in jextras.items():
        got = tr.extras[k]
        if k == "step" or np.asarray(v).dtype != np.float32:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(v), err_msg=k)
        else:
            _close(got.numpy(), v, 1e-5, k)


@pytest.mark.parametrize("name", ["HCCF_diffusion", "DHCF_diffusion", "AutoCF", "LRMRec", "KGIN"])
def test_native_init_matches_flax_scales(graphs, name):
    kg = name in KG_MODELS
    tb = build_model(make_config(name, **CFG), graphs["tcf"], graphs["tkg"] if kg else None)
    sd = init_flax(tb.module, torch.Generator().manual_seed(0))
    assert set(sd) == set(tb.module.state_dict())
    jb = j_build_model(j_make_config(name, **CFG), graphs["jcf"], graphs["jkg"] if kg else None)
    jparams = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jb.init(jax.random.PRNGKey(0))[0]["params"]), "cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                          for k, v in jparams.items()}
    if name == "LRMRec":  # the profiles are a buffer, kept out of the weights
        assert "profiles" not in sd and tb.module.profiles.shape == (tb.cf.n_nodes, 64)
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
        else:  # a table or a weight matrix: flax xavier_uniform
            limit = np.sqrt(6.0 / (v.shape[-2] + v.shape[-1]))
            assert float(v.abs().max()) <= limit, k
