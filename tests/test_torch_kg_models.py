"""The KG recommenders — KGAT (with its alternating epoch), KTUP and
HKGRippleNet — in the port against the JAX package, at a small size (60
users x 90 items on the synthetic KG of the same split, width 16, 2 layers
(KGAT's `conv_dim_list` (16, 8)), batch 128 and KG batch 128).

Each port model starts from the JAX initial parameters, carried across by
`weights.params_from_jax`, and the JAX extras. Tolerances, as in
`test_torch_zoo_adjacency.py` (float32 sums in another order):

  * `encode_eval` (KGAT's after an attention refresh): within 1e-5 of the
    tables' scale; the refresh itself within 1e-5 of its scale;
  * the loss and every aux term of one injected batch (KGAT's CF and KG
    phases both) against `jax.value_and_grad`: rtol 1e-5; every gradient
    within 1e-5 of its own scale or 1e-6 of the model's largest gradient;
  * `build_ripple_sets` bit for bit;
  * one whole alternating epoch on injected numpy batches, through
    `Trainer.run_phase` ("cf", then "kg") and `Trainer.end_epoch`, against
    the JAX `_build_phase_chunk_fn("cf")`, `("kg")` and
    `bundle.epoch_update_extras`: each phase's mean loss within rtol 1e-5,
    and after each phase and after the refresh the parameters, both Adam
    states and `att_vals` within 1e-5 of their scale; a first epoch on the
    zero attention: its phases' mean losses and its refresh;
  * the two plateau schedules, each stepped on its own phase's mean.

Flax's `nn.Dropout` and the port's message dropout are the identity here,
as in the earlier zoo tests: flax's PRNG stream cannot be reproduced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from hypergraph_diffusion_for_recommendation_tpu import data as jd
from hypergraph_diffusion_for_recommendation_tpu.core import make_config as j_make_config
from hypergraph_diffusion_for_recommendation_tpu.models import build_model as j_build_model
from hypergraph_diffusion_for_recommendation_tpu.models import ktup_ripplenet as jkr
from hypergraph_diffusion_for_recommendation_tpu.models import model_data_needs as j_needs
from hypergraph_diffusion_for_recommendation_tpu.ops import sampling as jsam
from hypergraph_diffusion_for_recommendation_tpu.train.optim import PlateauState as JPlateau
from hypergraph_diffusion_for_recommendation_tpu.train.trainer import Trainer as JTrainer
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
    MODEL_REGISTRY,
    build_model,
    kgat,
    ktup_ripplenet,
    model_data_needs,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.losses import l2_loss_mean
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import init_flax, params_from_jax

CFG = dict(embedding_size=16, relation_dim=16, n_layers=2, conv_dim_list=(16, 8),
           mess_dropout=(0.1, 0.1), batch_size=128, batch_size_kg=128)
MODELS = ["KGAT", "KTUP", "HKGRippleNet"]
ENCODE_RTOL = LOSS_RTOL = GRAD_RTOL = STATE_RTOL = 1e-5
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
    n = jkg.n_kg_train
    sampler = jsam.HostExactSampler(
        np.asarray(jcf.edge_u), np.asarray(jcf.edge_i), jcf.n_items,
        kg_heads=np.asarray(jkg.att_h[:n]), kg_relations=np.asarray(jkg.att_r[:n]),
        kg_tails=np.asarray(jkg.att_t[:n]), n_entities=jkg.n_entities)
    cf_batches = sampler.pairwise(4, CFG["batch_size"])
    n_kg = n // CFG["batch_size_kg"] + 1
    kg_batches = sampler.kg_batches(5, n_kg, CFG["batch_size_kg"])
    return dict(jcf=jcf, jkg=jkg, tcf=tcf, tkg=tkg, cf_batches=cf_batches,
                kg_batches=kg_batches)


def _close(got, want, rtol, what, atol=0.0):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= max(rtol * scale, atol), f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _identity_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(kgat, "feature_dropout", lambda x, *a, **k: x)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(graphs, name, **kw):
    cfg = dict(CFG, **kw)
    jb = j_build_model(j_make_config(name, **cfg), graphs["jcf"], graphs["jkg"])
    params, jextras = jb.init(jax.random.PRNGKey(0))
    tb = build_model(make_config(name, **cfg), graphs["tcf"], graphs["tkg"])
    tb.module.load_state_dict(params_from_jax(_np(params["params"]), "cpu"))
    return jb, params, jextras, tb


def _port_extras(jextras):
    return {k: torch.tensor(np.asarray(v)) for k, v in dict(jextras or {}).items()}


def _refreshed(jb, params, jextras):
    """The JAX extras after one attention refresh (KGAT), else as they are."""
    if jb.epoch_update_extras is None:
        return jextras
    return jb.epoch_update_extras(params, jextras, jax.random.PRNGKey(3))


def test_registry_and_data_needs():
    assert set(MODELS) <= set(MODEL_REGISTRY)
    for name in MODELS + ["MHCN", "SEPT"]:
        assert model_data_needs(name) == j_needs(name), name
    assert model_data_needs("KGAT") == frozenset()
    assert model_data_needs("MHCN") == frozenset({"adj", "inv_int_norm"})


def test_l2_loss_mean_matches_jax():
    from hypergraph_diffusion_for_recommendation_tpu.ops.losses import l2_loss_mean as j_l2

    x = np.random.default_rng(0).standard_normal((37, 5)).astype(np.float32)
    np.testing.assert_allclose(float(l2_loss_mean(torch.as_tensor(x))), float(j_l2(x)),
                               rtol=1e-6)


def test_ripple_sets_bit_for_bit(graphs):
    for seed in (0, 60):
        want = np.asarray(jkr.build_ripple_sets(graphs["jcf"], graphs["jkg"], seed))
        got = ktup_ripplenet.build_ripple_sets(graphs["tcf"], graphs["tkg"], seed)
        assert got.dtype == np.int32 and got.shape == want.shape == (
            graphs["tcf"].n_users, ktup_ripplenet.N_HOPS, ktup_ripplenet.N_MEM, 3)
        np.testing.assert_array_equal(got, want)


def test_kgat_refresh_matches_jax(graphs):
    jb, params, jextras, tb = _pair(graphs, "KGAT")
    assert not np.asarray(jextras["att_vals"]).any()
    want = jb.epoch_update_extras(params, jextras, jax.random.PRNGKey(3))["att_vals"]
    got = tb.epoch_update_extras(_port_extras(jextras), None)["att_vals"]
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want, STATE_RTOL, "att_vals")
    # pads carry no weight; each live head's weights sum to 1
    valid = graphs["tkg"].att_valid
    assert not got[~valid].any()


@pytest.mark.parametrize("name", MODELS)
def test_encode_eval_matches_jax(graphs, name, monkeypatch):
    _identity_dropout(monkeypatch)
    jb, params, jextras, tb = _pair(graphs, name)
    jextras = _refreshed(jb, params, jextras)
    ju, ji = jb.encode_eval(params, jextras)
    u, i = tb.encode_eval(_port_extras(jextras))
    assert u.shape == ju.shape and i.shape == ji.shape
    _close(u.numpy(), ju, ENCODE_RTOL, "users")
    _close(i.numpy(), ji, ENCODE_RTOL, "items")


def _grads_close(tb, jgrads):
    want = params_from_jax(_np(jgrads["params"]), "cpu")
    got = dict(tb.module.named_parameters())
    assert set(got) == set(want)
    g_max = max(float(w.abs().max()) for w in want.values())
    for pname, p in got.items():
        if p.grad is None:  # the loss does not reach it: JAX's gradient is exactly 0
            assert not want[pname].any(), pname
            continue
        _close(p.grad.numpy(), want[pname].numpy(), GRAD_RTOL, pname, GRAD_FLOOR * g_max)


@pytest.mark.parametrize("name,phase", [("KGAT", "cf"), ("KGAT", "cf-zero-attention"),
                                        ("KGAT", "kg"), ("KTUP", "cf"), ("HKGRippleNet", "cf")])
def test_loss_and_grads_match_jax(graphs, name, phase, monkeypatch):
    """KGAT's CF phase also on the zero attention of a first epoch, where the
    bi-interaction branch's Dense output is exactly 0 (the LeakyReLU's
    gradient at 0 is JAX's 1)."""
    _identity_dropout(monkeypatch)
    jb, params, jextras, tb = _pair(graphs, name)
    if phase != "cf-zero-attention":
        jextras = _refreshed(jb, params, jextras)
    if phase == "kg":
        batch = tuple(a[0] for a in graphs["kg_batches"])
        jfn, fn = jb.kg_batch_loss, tb.kg_batch_loss
    else:
        # KGAT's CF phase takes the CF batch; KTUP and RippleNet the joint batch
        # (CF then KG), as the non-alternating trainer builds it
        joint = graphs["cf_batches"] + (() if jb.alternating else graphs["kg_batches"])
        batch = tuple(a[0] for a in joint)
        jfn, fn = jb.batch_loss, tb.batch_loss
    (jloss, jaux), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        params, jextras, tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(1))
    loss, aux = fn(_port_extras(jextras), tuple(torch.as_tensor(a) for a in batch), ())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert set(aux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=LOSS_RTOL, err_msg=k)
    _grads_close(tb, jgrads)


def _adam_moments(opt_state):
    """(mu, nu) parameter trees of an optax `inject_hyperparams` Adam chain."""
    adam = next(s for s in opt_state.inner_state if hasattr(s, "mu"))
    return adam.mu["params"], adam.nu["params"]


def _state_close(tr, jparams, jostates, what):
    want = params_from_jax(_np(jparams["params"]), "cpu")
    for pname, p in tr.bundle.module.named_parameters():
        _close(p.detach().numpy(), want[pname].numpy(), STATE_RTOL, f"{what} {pname}")
    names = [n for n, _ in tr.bundle.module.named_parameters()]
    for phase, jst in jostates.items():
        opt = tr.opt if phase == "cf" else tr.kg_opt
        mu, nu = (params_from_jax(_np(t), "cpu") for t in _adam_moments(jst))
        for pname, p in zip(names, tr._params):
            state = opt.state[p]
            _close(state["exp_avg"].numpy(), mu[pname].numpy(), STATE_RTOL,
                   f"{what} {phase} exp_avg {pname}")
            _close(state["exp_avg_sq"].numpy(), nu[pname].numpy(), STATE_RTOL,
                   f"{what} {phase} exp_avg_sq {pname}")


def _kgat_trainers(graphs, refreshed: bool, agg: str = "bi-interaction"):
    """The JAX trainer and the port's from the JAX initial state; with
    `refreshed`, both start from the initial parameters' refreshed attention
    instead of the zero one."""
    cfg = dict(CFG, aggregation_type=agg)
    jb = j_build_model(j_make_config("KGAT", **cfg), graphs["jcf"], graphs["jkg"])
    jt = JTrainer(jb, seed=0)
    if refreshed:
        jt.extras = jb.epoch_update_extras(jt.params, jt.extras, jax.random.PRNGKey(2))
    tb = build_model(make_config("KGAT", **cfg), graphs["tcf"], graphs["tkg"])
    tb.module.load_state_dict(params_from_jax(_np(jt.params["params"]), "cpu"))
    tr = Trainer(tb, seed=0, extras=_port_extras(jt.extras))
    return jb, jt, tr


def _jax_phase(jt, phase, params, ostate, extras, batches, key):
    """(params, opt state, mean loss) after the JAX phase's steps over `batches`."""
    n = batches[0].shape[0]
    chunk = jt._build_phase_chunk_fn(phase, masked=False)
    params, ostate, total = chunk(params, ostate, extras, tuple(jnp.asarray(a) for a in batches),
                                  jax.random.split(jax.random.PRNGKey(key), n))
    return params, ostate, float(total) / n


def test_alternating_epoch_matches_jax(graphs, monkeypatch):
    """One whole KGAT epoch: every CF batch, then every KG batch, then the
    attention refresh; then a next epoch's CF phase, which reads the
    refreshed attention (its mean loss only: ten Adam steps from zero put
    the biases' last bits past 1e-5 of their scale, 1.3e-5 seen). It starts
    from the initial parameters' refreshed
    attention (a first epoch's zero attention: `test_first_epoch_...`), with
    the gcn aggregator: the bi-interaction branch LayerNorms ego * side,
    whose rows vary by about 1e-3 at initialisation, so its bias gradients
    are sums that nearly cancel, and Adam's per-element normalisation turns
    their last-bit differences into steps of the learning rate in either
    direction (1e-3 of the zero-initialised biases' scale after three steps,
    in both packages). The bi-interaction losses and gradients are held by
    `test_loss_and_grads_match_jax`, its epoch's losses by the test below."""
    _identity_dropout(monkeypatch)
    jb, jt, tr = _kgat_trainers(graphs, refreshed=True, agg="gcn")
    n_kg = graphs["tkg"].n_kg_train // CFG["batch_size_kg"] + 1
    assert tr.n_kg_batches == n_kg == graphs["kg_batches"][0].shape[0]
    jparams, jextras, jostates = jt.params, jt.extras, {}
    for step, (phase, batches) in enumerate((("cf", graphs["cf_batches"]),
                                             ("kg", graphs["kg_batches"]),
                                             ("refresh", None),
                                             ("cf", graphs["cf_batches"]))):
        if phase == "refresh":
            jextras = jb.epoch_update_extras(jparams, jextras, jax.random.PRNGKey(9))
            tr.end_epoch()
            _close(tr.extras["att_vals"].numpy(), jextras["att_vals"], STATE_RTOL, "att_vals")
            _state_close(tr, jparams, jostates, "after the refresh")
            continue
        jparams, jostates[phase], want = _jax_phase(
            jt, phase, jparams, jostates.get(phase, jt.opt_state[phase]), jextras, batches,
            7 + step)
        means = tr.run_phase(tuple(torch.as_tensor(a) for a in batches), phase)
        np.testing.assert_allclose(means[0], want, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}: {phase} mean loss")
        assert len(means) == 2  # the loss and the phase's one aux term
        if step < 3:  # the epoch's phases
            _state_close(tr, jparams, jostates, f"step {step}: after {phase}")
    assert tr._phases["cf"].aux_names == ["rec_loss"]
    assert tr._phases["kg"].aux_names == ["kg_loss"]


def test_first_epoch_losses_match_jax(graphs, monkeypatch):
    """The first epoch, on the zero attention: each phase's mean loss within
    rtol 1e-5, and the refresh after it. (Its parameters are not held to
    1e-5 of their scale: with side = 0 the bi-interaction branch's
    LayerNorm normalises rows of one value, its gradient sums nearly cancel,
    and Adam's per-element normalisation carries their rounding into the
    zero-initialised biases, whose scale is the learning rate, at about
    1e-4 of that scale in both packages.)"""
    _identity_dropout(monkeypatch)
    jb, jt, tr = _kgat_trainers(graphs, refreshed=False)
    assert not tr.extras["att_vals"].any()
    jparams = jt.params
    for key, (phase, batches) in enumerate((("cf", graphs["cf_batches"]),
                                            ("kg", graphs["kg_batches"]))):
        jparams, _, want = _jax_phase(jt, phase, jparams, jt.opt_state[phase], jt.extras,
                                      batches, 7 + key)
        means = tr.run_phase(tuple(torch.as_tensor(a) for a in batches), phase)
        np.testing.assert_allclose(means[0], want, rtol=LOSS_RTOL, err_msg=f"{phase} mean loss")
    jextras = jb.epoch_update_extras(jparams, jt.extras, jax.random.PRNGKey(9))
    tr.end_epoch()
    _close(tr.extras["att_vals"].numpy(), jextras["att_vals"], STATE_RTOL, "att_vals")


def test_run_epoch_draws_kg_batches_on_their_own(graphs, monkeypatch):
    """`run_epoch`: n_batches CF steps, n_kg_train // B_kg + 1 KG steps (the
    exact sampler's too), the refresh after both, the JAX epoch's aux keys."""
    for sampler in ("redraw", "exact"):
        tb = build_model(make_config("KGAT", **CFG, sampler=sampler), graphs["tcf"],
                         graphs["tkg"])
        tr = Trainer(tb, seed=0)
        steps = []
        step = tr.train_step
        monkeypatch.setattr(tr, "train_step", lambda b, k, phase="cf": steps.append(
            (phase, tuple(t.shape[0] for t in b))) or step(b, k, phase))
        assert len(tr.sample_epoch()) == 3
        loss, aux = tr.run_epoch(0)
        cf_shape, kg_shape = (CFG["batch_size"],) * 3, (CFG["batch_size_kg"],) * 4
        assert steps == ([("cf", cf_shape)] * tr.n_batches
                         + [("kg", kg_shape)] * tr.n_kg_batches), sampler
        assert set(aux) == {"cf_loss", "kg_loss", "train_loss"}
        assert aux["train_loss"] == loss == pytest.approx(aux["cf_loss"] + aux["kg_loss"])
        assert tr.extras["att_vals"].abs().sum() > 0  # refreshed after the epoch


def test_plateaus_step_on_their_phase_means(graphs, monkeypatch):
    """`fit` steps the CF schedule on each epoch's cf_loss and the KG schedule
    on its kg_loss, as the JAX trainer does, and sets each optimiser's rate."""
    cfg = dict(CFG, lr_patience=0, lr_decay=0.5, item_ranking=(10, 20), eval_user_batch=64)
    tb = build_model(make_config("KGAT", **cfg), graphs["tcf"], graphs["tkg"])
    tr = Trainer(tb, seed=0)
    cf = [1.0, 0.9, 0.8, 0.7]  # improving: the CF rate stays
    kg = [2.0, 3.0, 3.0, 1.0]  # two epochs without a new best: the KG rate halves twice
    script = iter(zip(cf, kg))

    def run_epoch(epoch):
        c, k = next(script)
        return c + k, {"cf_loss": c, "kg_loss": k, "train_loss": c + k}

    monkeypatch.setattr(tr, "run_epoch", run_epoch)
    want_cf = want_kg = JPlateau(lr=tr.cfg.lrate, factor=0.5, patience=0)
    rates = []
    evaluate = tr.evaluate

    def record():
        rates.append((tr.opt.param_groups[0]["lr"], tr.kg_opt.param_groups[0]["lr"]))
        return evaluate()

    monkeypatch.setattr(tr, "evaluate", record)
    tr.fit(max_epoch=4, quiet=True)
    expect = []
    for c, k in zip(cf, kg):
        expect.append((want_cf.lr, want_kg.lr))
        want_cf, want_kg = want_cf.step(c), want_kg.step(k)
    assert rates[:4] == expect
    assert (tr.plateau.lr, tr.kg_plateau.lr) == (want_cf.lr, want_kg.lr)
    assert want_cf.lr != want_kg.lr  # the two schedules moved apart


@pytest.mark.parametrize("name", MODELS)
def test_native_init_matches_flax_shapes(graphs, name):
    tb = build_model(make_config(name, **CFG), graphs["tcf"], graphs["tkg"])
    sd = init_flax(tb.module, torch.Generator().manual_seed(0))
    assert set(sd) == set(tb.module.state_dict())
    jb = j_build_model(j_make_config(name, **CFG), graphs["jcf"], graphs["jkg"])
    jparams = params_from_jax(_np(jb.init(jax.random.PRNGKey(0))[0]["params"]), "cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                          for k, v in jparams.items()}
    extras = tb.init(torch.Generator().manual_seed(0))
    assert set(extras) == ({"att_vals"} if name == "KGAT" else set())
