"""The sequential models SASRec and CL4SRec in the port against the JAX
package, at a small size (60 users x 90 items, width 16, 2 blocks, one
head, batch 32 of windows of 50).

  * the sequence arrays (`build_seq_from_cf`, `build_seq_device_data`) bit
    for bit, on the synthetic data and on the committed LastFM fixture: the
    port's CF edge order is the JAX package's;
  * `_seq_augment` bit for bit under shared draws (below);
  * the encoder's output within 1e-5 of its scale (max |x|), rows of padding
    only and views with every item masked included (finite, uniform
    attention);
  * the loss and its aux terms on one injected batch against
    `jax.value_and_grad(bundle.batch_loss)`: rtol 1e-5, and every gradient
    within 1e-5 of its own scale or 1e-6 of the largest gradient, at
    drop_rate 0 and 0.2;
  * `encode_eval` within 1e-5 of the tables' scale;
  * `_sequence_epoch_batches`: shapes, the wrap, `neg == 0` where `y == 0`,
    negatives outside the user's history.

What torch cannot reproduce is made equal: every draw inside the loss
(`jax.random.uniform`, `randint`, `bernoulli`, so flax's dropout and its
[1, 1, L, L] attention-dropout mask included) and the port's
`sasrec._uniform`, `_randint`, `_keep_mask` return one numpy stream, in
call order. Each port model starts from the JAX initial parameters,
carried across by `weights.params_from_jax`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu import data as jd
from hypergraph_diffusion_for_recommendation_tpu.core import make_config as j_make_config
from hypergraph_diffusion_for_recommendation_tpu.data import sequence as jseq
from hypergraph_diffusion_for_recommendation_tpu.data.io import load_data_set as j_load
from hypergraph_diffusion_for_recommendation_tpu.models import build_model as j_build_model
from hypergraph_diffusion_for_recommendation_tpu.models import sasrec as jsasrec
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data.sequence import build_seq_device_data
from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
    MODEL_REGISTRY,
    build_model,
    model_data_needs,
    sasrec,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer
from hypergraph_diffusion_for_recommendation_tpu_torch.train.trainer import (
    _sequence_epoch_batches,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import params_from_jax

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
CFG = dict(embedding_size=16, n_layers=2, batch_size=32, cl_rate=0.1, temp=1.0)
MODELS = ["SASRec", "CL4SRec"]
ENCODE_RTOL = LOSS_RTOL = GRAD_RTOL = 1e-5
GRAD_FLOOR = 1e-6
SEQ_FIELDS = ("seq", "pos", "y", "seq_len", "seq_valid", "seq_user", "rated_pad_1b")


def _split():
    return td.synthetic_dataset(n_users=60, n_items=90, mean_degree=10.0, seed=4)[:2]


def _cf_pair(train, test):
    ji = jd.build_interaction(train, test)
    ti = td.build_interaction(train, test)
    return (ji, jd.build_cf_device_data(ji, eval_user_multiple=64, needs=set()),
            ti, td.build_cf_device_data(ti, "cpu", eval_user_multiple=64, needs=set()))


@pytest.fixture(scope="module")
def graphs():
    ji, jcf, ti, tcf = _cf_pair(*_split())
    return dict(ji=ji, jcf=jcf, ti=ti, tcf=tcf)


def _close(got, want, rtol, what, atol=0.0):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= max(rtol * scale, atol), f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _same_seq(got, want):
    for f in SEQ_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert (got.max_len, got.n_items, got.n_seqs) == (want.max_len, want.n_items, want.n_seqs)


def _shared_draws(monkeypatch, seed=3):
    """Replace the JAX draws inside the loss, and the port's draw functions,
    by one numpy stream: each JAX call draws and queues its values, the
    port's function of the same kind takes them in the same order, of the
    shape it asks for (the attention-dropout mask's is [1, 1, L, L])."""
    rng = np.random.default_rng(seed)
    queues = {"uniform": [], "randint": [], "bernoulli": []}

    def put(kind, value):
        queues[kind].append(value)
        return jnp.asarray(value)

    def take(kind, shape):
        value = queues[kind].pop(0)
        assert tuple(value.shape) == tuple(shape), (kind, value.shape, shape)
        return torch.as_tensor(value)

    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: put(
        "uniform", rng.random(tuple(shape), dtype=np.float32)))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, minval, maxval, *a, **k: put(
        "randint", rng.integers(minval, maxval, tuple(shape)).astype(np.int32)))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None, *a, **k: put(
        "bernoulli", rng.random(tuple(shape)) < p))
    monkeypatch.setattr(sasrec, "_uniform", lambda shape, gen, device: take("uniform", shape))
    monkeypatch.setattr(sasrec, "_randint", lambda shape, high, gen, device: take("randint",
                                                                                 shape))
    monkeypatch.setattr(sasrec, "_keep_mask", lambda shape, keep, gen, device: take("bernoulli",
                                                                                    shape))
    return queues


def _pair(graphs, name, **kw):
    cfg = dict(CFG, **kw)
    jb = j_build_model(j_make_config(name, **cfg), graphs["jcf"])
    params, jextras = jb.init(jax.random.PRNGKey(0))
    tb = build_model(make_config(name, **cfg), graphs["tcf"])
    tb.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), "cpu"))
    return jb, params, jextras, tb


def _batch(seq_data, seed=5):
    """Rows 32 from the end of the padded windows (the padding rows among
    them), with numpy negatives: 1-based, 0 where the target is padding."""
    rows = slice(-CFG["batch_size"], None)
    seq, pos, y = (np.asarray(getattr(seq_data, f))[rows] for f in ("seq", "pos", "y"))
    valid = np.asarray(seq_data.seq_valid)[rows]
    neg = np.random.default_rng(seed).integers(1, seq_data.n_items + 1, y.shape)
    return seq, pos, y, np.where(y > 0, neg, 0).astype(np.int32), valid


def test_registry_bundle_and_data_needs(graphs):
    assert set(MODELS) <= set(MODEL_REGISTRY)
    for name in MODELS:
        assert model_data_needs(name) == frozenset()
        b = build_model(make_config(name, **CFG), graphs["tcf"])
        assert b.batch_kind == "sequence" and b.seq is not None and b.kg is None


@pytest.mark.parametrize("source", ["synthetic", "lastfm_fixture"])
def test_sequence_arrays_match_jax_bit_for_bit(source):
    if source == "synthetic":
        train, test = _split()
    else:
        train = j_load(os.path.join(FIX, "lastfm_slice_tab.txt"))
        test = train[:3]
    ji, jcf, ti, tcf = _cf_pair(train, test)
    np.testing.assert_array_equal(tcf.edge_u.numpy(), np.asarray(jcf.edge_u))
    np.testing.assert_array_equal(tcf.edge_i.numpy(), np.asarray(jcf.edge_i))
    _same_seq(sasrec.build_seq_from_cf(tcf), jsasrec.build_seq_from_cf(jcf))
    _same_seq(build_seq_device_data(ti, device="cpu"), jseq.build_seq_device_data(ji))
    if source == "lastfm_fixture":  # users with one training item have no sequence
        assert build_seq_device_data(ti, device="cpu").n_seqs == 4


@pytest.mark.parametrize("trial", range(3))
def test_seq_augment_matches_jax_bit_for_bit(trial, monkeypatch):
    rng = np.random.default_rng(trial)
    b, length = 48, 20
    seq = np.zeros((b, length), np.int32)
    seq_len = rng.integers(0, length + 1, size=b).astype(np.int32)
    seq_len[:2] = 0  # rows of padding only
    for i in range(b):
        seq[i, : seq_len[i]] = rng.permutation(100)[: seq_len[i]] + 1
    pos = (np.tile(np.arange(1, length + 1), (b, 1)) * (seq > 0)).astype(np.int32)
    _shared_draws(monkeypatch, seed=trial)
    jout, jpos = jsasrec._seq_augment(jax.random.PRNGKey(trial), jnp.asarray(seq),
                                      jnp.asarray(pos), jnp.asarray(seq_len), 100)
    out, out_pos = sasrec._seq_augment(torch.as_tensor(seq), torch.as_tensor(pos),
                                       torch.as_tensor(seq_len), None)
    assert out.dtype == torch.int32 and out_pos.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_pos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("name", MODELS)
def test_encoder_matches_jax(graphs, name):
    jb, params, _, tb = _pair(graphs, name)
    sd = tb.seq
    seq, pos = sd.seq.numpy().copy(), sd.pos.numpy().copy()
    seq[0], pos[0] = 0, 0  # a view with every item masked (padding rows follow n_seqs)
    assert not sd.seq_valid[-1]
    jmod = jsasrec.SASRecEncoder(sd.n_items, CFG["embedding_size"], sd.max_len, n_blocks=2,
                                 n_heads=1, dropout=0.2)
    jh, jitems = jmod.apply(params, jnp.asarray(seq), jnp.asarray(pos))
    with torch.no_grad():
        h, items = tb.module(torch.as_tensor(seq), torch.as_tensor(pos))
    assert torch.isfinite(h).all()
    _close(h.numpy(), jh, ENCODE_RTOL, "h")
    _close(items.detach().numpy(), jitems, ENCODE_RTOL, "item table")


@pytest.mark.parametrize("name", MODELS)
def test_encode_eval_matches_jax(graphs, name):
    jb, params, jextras, tb = _pair(graphs, name)
    ju, ji = jb.encode_eval(params, jextras)
    with torch.no_grad():
        u, i = tb.encode_eval({})
    assert u.shape == ju.shape and i.shape == ji.shape
    _close(u.numpy(), ju, ENCODE_RTOL, "users")
    _close(i.numpy(), ji, ENCODE_RTOL, "items")


@pytest.mark.parametrize("drop_rate", [0.0, 0.2])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax(graphs, name, drop_rate, monkeypatch):
    jb, params, jextras, tb = _pair(graphs, name, drop_rate=drop_rate)
    batch = _batch(tb.seq)
    assert not batch[4].all() and batch[4].any()  # padding rows and sequences
    queues = _shared_draws(monkeypatch)
    (jloss, jaux), jgrads = jax.value_and_grad(jb.batch_loss, has_aux=True)(
        params, jextras, tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(1))
    if drop_rate:
        assert queues["bernoulli"], "flax drew no dropout masks"
    loss, aux = tb.batch_loss({}, tuple(torch.as_tensor(a) for a in batch), ())
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


@pytest.mark.parametrize("batch_size", [32, 150])
def test_sequence_epoch_batches_layout(graphs, batch_size):
    sd = sasrec.build_seq_from_cf(graphs["tcf"])
    n, length = sd.seq.shape
    gen = torch.Generator().manual_seed(0)
    seq, pos, y, neg, valid = _sequence_epoch_batches(gen, sd, batch_size, 8)
    n_b = -(-n // batch_size)
    assert seq.shape == pos.shape == y.shape == neg.shape == (n_b, batch_size, length)
    assert valid.shape == (n_b, batch_size) and valid.dtype == torch.bool
    assert seq.dtype == neg.dtype == torch.int32
    flat = torch.cat([seq, y], dim=-1).reshape(n_b * batch_size, -1)
    # the first n rows are a permutation of the windows, then they wrap modulo n
    key = torch.cat([sd.seq, sd.y], dim=-1)
    assert sorted(map(tuple, flat[:n].tolist())) == sorted(map(tuple, key.tolist()))
    for k in range(n, n_b * batch_size):
        assert torch.equal(flat[k], flat[k % n])
    assert torch.equal(neg == 0, y == 0)
    assert int(neg.max()) <= sd.n_items and int(neg.min()) >= 0
    hist = sd.rated_pad_1b.numpy()
    user_of = {tuple(r): int(u) for r, u in zip(key.tolist(), sd.seq_user.tolist())}
    for row, negs, ys in zip(flat.tolist(), neg.reshape(-1, length).tolist(),
                             y.reshape(-1, length).tolist()):
        seen = set(hist[user_of[tuple(row)]].tolist())
        assert not any(v in seen for v, t in zip(negs, ys) if t > 0)


def test_sequence_trainer_steps_and_refuses_exact_sampler(graphs):
    b = build_model(make_config("CL4SRec", **CFG, max_epoch=1, item_ranking=(10, 20),
                                eval_user_batch=64), graphs["tcf"])
    tr = Trainer(b)
    assert tr.n_batches == -(-b.seq.seq.shape[0] // CFG["batch_size"])
    loss, aux = tr.run_epoch(0)
    assert np.isfinite(loss) and set(aux) == {"rec_loss", "cl_loss", "train_loss"}
    with pytest.raises(ValueError, match="sampler=exact"):
        Trainer(build_model(make_config("SASRec", **CFG, sampler="exact"), graphs["tcf"]))
