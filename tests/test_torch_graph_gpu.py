"""The training step and the encode as replayed CUDA graphs against the
same work run eagerly, on the card (marker `gpu`; they skip without one).
The file imports no JAX:

    python -m pytest tests/test_torch_graph_gpu.py -q --noconftest -o addopts="" -m gpu

A replayed step must equal an eager step from the same full state (the
parameters, Adam's state, the extras and the generators) where two eager
steps from that state are equal bit for bit, and be within 1e-5 of each
tensor's scale where they are not (the card's atomic index additions sum
in another order from run to run). The encode has no backward: its replay
equals the eager encode bit for bit. A capture that meets a host sync
raises. A checkpoint restored into a fresh trainer resumes training bit for
bit (its graphs captured after the restore).
"""

import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

SMALL = dict(hyper_dim=32, relation_dim=16, n_layers=2, batch_size=256, batch_size_kg=512,
             eval_user_batch=128, compute_dtype="bfloat16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU form")
    return torch.device("cuda")


def _rec(model, cuda, **kw):
    kw = dict(SMALL, **kw) if model.startswith("KHGRec") or model == "HGNN" else dict(
        hyper_dim=32, batch_size=256, eval_user_batch=128, compute_dtype="bfloat16", **kw)
    rec = Recommender(make_config(model, **kw), cuda)
    rec.build(synthetic_dataset(n_users=300, n_items=500, mean_degree=20.0, seed=3,
                                with_kg=True))
    rec.init_weights(0)
    return rec


def _state(tr):
    """Every tensor a step writes: parameters, each phase's Adam moments, the
    extras."""
    out = {f"param {k}": v.detach().clone() for k, v in tr.bundle.module.state_dict().items()}
    for phase, ph in tr._phases.items():
        for i, p in enumerate(tr._params):
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{phase} {k} {i}"] = ph.opt.state[p][k].clone()
    out.update({f"extras {k}": v.clone() for k, v in tr.extras.items() if torch.is_tensor(v)})
    return out


def _assert_match(got, want, exact):
    for k, w in want.items():
        if exact:
            assert torch.equal(got[k], w), k
        else:
            scale = max(float(w.abs().max()), 1e-12)
            assert float((got[k] - w).abs().max()) <= 1e-5 * scale, k


@pytest.mark.gpu
@pytest.mark.parametrize("model,k_cache", [("KHGRec", 0), ("KHGRec", 2), ("HGNN_HD3", 2)])
def test_replayed_steps_equal_eager_steps(cuda, model, k_cache):
    rec = _rec(model, cuda, prop_cache_steps=k_cache)
    tg = Trainer(rec.bundle, seed=0, extras=rec.extras)
    te = Trainer(rec.bundle, seed=0, extras=rec.extras, graphs=False)
    assert tg.graphs and not te.graphs
    batches = tg.sample_epoch()
    keys = tg.epoch_keys(batches[0].shape[0])
    n_warm = 4 if k_cache else 2  # every branch captured
    for s in range(n_warm):
        tg.train_step(tuple(t[s] for t in batches), keys[s])
    assert len(tg._step_graphs) == (2 if k_cache else 1)
    te.train_step(tuple(t[0] for t in batches), keys[0])  # Adam's state exists
    snap = tg.snapshot(optimizer=True)
    n = 4

    def run(tr):
        tr.restore(snap)
        losses = [tr.train_step(tuple(t[s] for t in batches), keys[s])[0].clone()
                  for s in range(n_warm, n_warm + n)]
        torch.cuda.synchronize()
        return torch.stack(losses), _state(tr)

    l1, s1 = run(te)
    l2, s2 = run(te)
    exact = torch.equal(l1, l2) and all(torch.equal(s1[k], s2[k]) for k in s1)
    l3, s3 = run(tg)
    torch.testing.assert_close(l3, l1, rtol=0 if exact else 1e-5, atol=0)
    _assert_match(s3, s1, exact)
    if k_cache:
        assert tg.extras["prop_age"] == te.extras["prop_age"] == n_warm + n


@pytest.mark.gpu
def test_replayed_encode_equals_eager_bit_for_bit(cuda):
    rec = _rec("KHGRec", cuda)
    tr = Trainer(rec.bundle, seed=0, extras=rec.extras)
    u, i = tr.encode()
    ue, ie = rec.bundle.encode_eval(tr.extras)
    assert torch.equal(u, ue) and torch.equal(i, ie)
    batches = tr.sample_epoch()
    tr.train_step(tuple(t[0] for t in batches), tr.edge_keys())
    u, i = tr.encode()  # a replay over the new state
    ue, ie = rec.bundle.encode_eval(tr.extras)
    assert torch.equal(u, ue) and torch.equal(i, ie)
    ru, ri = rec.encode()  # the facade's own encode graph
    assert torch.equal(ru, rec.bundle.encode_eval(rec.extras)[0])


def _kgat(cuda):
    rec = Recommender(make_config("KGAT", embedding_size=32, relation_dim=32,
                                  conv_dim_list=(32, 16), mess_dropout=(0.1, 0.1), batch_size=256,
                                  batch_size_kg=512, eval_user_batch=128, item_ranking=(10, 20)),
                      cuda)
    rec.build(synthetic_dataset(n_users=300, n_items=500, mean_degree=20.0, seed=3,
                                with_kg=True))
    rec.init_weights(0)
    return rec


@pytest.mark.gpu
def test_kgat_phase_graphs_replay_their_eager_steps(cuda):
    """KGAT's CF and KG step graphs (each its own optimiser, inputs and
    aux terms) against eager steps from one full state, both Adam states
    included: bit for bit."""
    rec = _kgat(cuda)
    tg = Trainer(rec.bundle, seed=0, extras=rec.extras)
    te = Trainer(rec.bundle, seed=0, extras=rec.extras, graphs=False)
    cf, kg = tg.sample_epoch(), tg.sample_kg_epoch()
    assert len(cf) == 3 and len(kg) == 4 and kg[0].shape == (tg.n_kg_batches, 512)
    no_keys = torch.zeros(0, 2, dtype=torch.int64, device=cuda)
    for s in range(2):  # each phase: an eager step, then its capture
        tg.train_step(tuple(t[s] for t in cf), no_keys)
        tg.train_step(tuple(t[s] for t in kg), no_keys, "kg")
    assert sorted(tg._step_graphs) == ["full", "kg:full"]
    te.train_step(tuple(t[0] for t in cf), no_keys)
    te.train_step(tuple(t[0] for t in kg), no_keys, "kg")
    snap = tg.snapshot(optimizer=True)

    def run(tr):
        tr.restore(snap)
        losses = []
        for s in range(2, 5):
            losses.append(tr.train_step(tuple(t[s % cf[0].shape[0]] for t in cf),
                                        no_keys)[0].clone())
        for s in range(2, 5):
            losses.append(tr.train_step(tuple(t[s % kg[0].shape[0]] for t in kg), no_keys,
                                        "kg")[0].clone())
        torch.cuda.synchronize()
        return torch.stack(losses), _state(tr)

    l1, s1 = run(te)
    l2, s2 = run(tg)
    assert torch.equal(l1, l2)
    _assert_match(s2, s1, exact=True)


@pytest.mark.gpu
def test_kgat_refresh_between_epochs_feeds_the_graphs(cuda):
    """The refresh after an epoch writes the new attention into the buffer
    the step and encode graphs read: a replayed CF step after it equals an
    eager step on the new attention bit for bit, and the encode follows."""
    rec = _kgat(cuda)
    tg = Trainer(rec.bundle, seed=0, extras=rec.extras)
    te = Trainer(rec.bundle, seed=0, extras=rec.extras, graphs=False)
    assert not tg.extras["att_vals"].any()  # the first epoch trains on the zero attention
    tg.run_epoch(0)  # captures both phases' graphs, then refreshes
    buf = tg.extras["att_vals"]
    first = buf.clone()
    assert first.abs().sum() > 0
    tg.encode()
    cf, kg = tg.sample_epoch(), tg.sample_kg_epoch()
    no_keys = torch.zeros(0, 2, dtype=torch.int64, device=cuda)
    tg.train_step(tuple(t[0] for t in kg), no_keys, "kg")  # a replay: the state moves
    tg.end_epoch()
    assert tg.extras["att_vals"] is buf and not torch.equal(buf, first)
    u, i = tg.encode()
    ue, ie = rec.bundle.encode_eval(tg.extras)
    assert torch.equal(u, ue) and torch.equal(i, ie)
    te.train_step(tuple(t[0] for t in cf), no_keys)  # Adam's state exists
    te.train_step(tuple(t[0] for t in kg), no_keys, "kg")
    # the two trainers share the module: each step starts from the snapshot
    snap = tg.snapshot(optimizer=True)
    batch = tuple(t[1] for t in cf)
    tg.restore(snap)
    got = tg.train_step(batch, no_keys)[0].clone()
    torch.cuda.synchronize()
    got_state = _state(tg)
    te.restore(snap)
    want = te.train_step(batch, no_keys)[0].clone()
    torch.cuda.synchronize()
    assert "full" in tg._step_graphs and torch.equal(got, want)
    _assert_match(got_state, _state(te), exact=True)


@pytest.mark.gpu
def test_relation_gather_matches_plain_and_repeats(cuda):
    """`relation_lookup` (a one-hot matmul) over a KG batch's relation ids
    (runs of thousands of one id): the plain gather's values, a backward
    within 1e-5 of the f64 one, as the index backward's, bit for bit from
    run to run."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.models.kg_common import relation_lookup

    gen = torch.Generator(cuda).manual_seed(0)
    rel = torch.randn(10, 64, device=cuda, generator=gen)
    # the synthetic KG's mix: two relations hold most triples
    r = torch.multinomial(torch.tensor([8.0, 8.0, 1.7, 1.7, 1.7, 1.0, 1.0, 0.5, 0.5, 0.5],
                                       device=cuda), 8192, replacement=True, generator=gen)
    g = torch.randn(8192, 64, device=cuda, generator=gen)

    def grad(fn, x):
        x = x.clone().requires_grad_(True)
        out = fn(x, r)
        (dx,) = torch.autograd.grad((out * g.to(x.dtype)).sum(), x)
        return out.detach(), dx

    out, dx = grad(relation_lookup, rel)
    again = grad(relation_lookup, rel)
    plain_out, plain_dx = grad(lambda x, i: x[i], rel)
    _, ref_dx = grad(lambda x, i: x[i], rel.double())
    assert torch.equal(out, plain_out)
    assert torch.equal(out, again[0]) and torch.equal(dx, again[1])
    scale = float(ref_dx.abs().max())
    assert float((dx.double() - ref_dx).abs().max()) <= 1e-5 * scale
    assert float((plain_dx.double() - ref_dx).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_hub_gather_takes_any_id_shape_on_the_card(cuda):
    """`gather_rows_hubs` under autograd on [B, L] ids (one id repeated past
    the 512-element runs): the values of plain indexing, a backward within
    1e-5 of the f64 one, bit for bit from run to run."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.sparse import gather_rows_hubs

    gen = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(300, 32, device=cuda, generator=gen)
    ids = torch.randint(0, 300, (64, 50), device=cuda, generator=gen)
    ids[:40] = 7  # a run of 2,000 equal ids
    g = torch.randn(64, 50, 32, device=cuda, generator=gen)

    def grad(fn, t):
        t = t.clone().requires_grad_(True)
        out = fn(t, ids)
        (dt,) = torch.autograd.grad((out * g.to(t.dtype)).sum(), t)
        return out.detach(), dt

    out, dx = grad(gather_rows_hubs, x)
    again = grad(gather_rows_hubs, x)
    _, ref_dx = grad(lambda t, i: t[i], x.double())
    assert torch.equal(out, x[ids])
    assert torch.equal(out, again[0]) and torch.equal(dx, again[1])
    assert float((dx.double() - ref_dx).abs().max()) <= 1e-5 * float(ref_dx.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["SASRec", "CL4SRec"])
def test_sequence_step_graph_replays_its_eager_step(cuda, model):
    """SASRec's and CL4SRec's step graph (fixed [B, L] inputs; dropout and
    CL4SRec's augmentations drawn from the registered card generator)
    against eager steps from one full state, bit for bit."""
    rec = Recommender(make_config(model, embedding_size=32, batch_size=64, eval_user_batch=128,
                                  cl_rate=0.1, temp=1.0, item_ranking=(10, 20)), cuda)
    rec.build(synthetic_dataset(n_users=300, n_items=500, mean_degree=20.0, seed=3))
    rec.init_weights(0)
    tg = Trainer(rec.bundle, seed=0, extras=rec.extras)
    te = Trainer(rec.bundle, seed=0, extras=rec.extras, graphs=False)
    batches = tg.sample_epoch()
    assert batches[0].shape == (tg.n_batches, 64, 50)
    no_keys = torch.zeros(0, 2, dtype=torch.int64, device=cuda)
    for s in range(2):
        tg.train_step(tuple(t[s] for t in batches), no_keys)
    assert sorted(tg._step_graphs) == ["full"]
    te.train_step(tuple(t[0] for t in batches), no_keys)
    snap = tg.snapshot(optimizer=True)

    def run(tr):
        tr.restore(snap)
        losses = [tr.train_step(tuple(t[s % tg.n_batches] for t in batches), no_keys)[0]
                  .clone() for s in range(2, 10)]
        torch.cuda.synchronize()
        return torch.stack(losses), _state(tr)

    l1, s1 = run(te)
    l2, s2 = run(tg)
    assert torch.equal(l1, l2)
    _assert_match(s2, s1, exact=True)
    u, i = tg.encode()
    ue, ie = rec.bundle.encode_eval(tg.extras)
    assert torch.equal(u, ue) and torch.equal(i, ie)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["TransE", "DistMult", "RealE"])
def test_kge_step_graph_replays_its_eager_step(cuda, model):
    """The KG-embedding trainer's replayed step against its eager step from
    one full state (`snapshot`: tables, Adam's state, the generator), after 1
    and 5 steps, bit for bit; then an epoch through the graph."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.data.synthetic import generate_kg
    from hypergraph_diffusion_for_recommendation_tpu_torch.train.kg_embedding import (
        KGEConfig,
        KGEmbeddingTrainer,
    )

    kg = generate_kg(n_items=600, n_clusters=8, seed=1)[["h", "r", "t"]].to_numpy()
    tr = KGEmbeddingTrainer(kg, int(kg[:, [0, 2]].max()) + 1, int(kg[:, 1].max()) + 1,
                            KGEConfig(model=model, dim=32, batch_size=256), device=cuda)
    batches = tr.epoch_batches(tr.draw())
    tr.train_step(tuple(t[0] for t in batches))  # eager: fills Adam's state
    snap = tr.snapshot()
    states = {}
    for graphs in (True, False):
        tr.restore(snap)
        tr.graphs = graphs
        for s in range(1, 6):
            tr.train_step(tuple(t[s % tr.n_batches] for t in batches))
            if s in (1, 5):
                states[graphs, s] = [v.detach().clone() for v in tr.params.values()] + [
                    st[k].clone() for st in tr.opt.state.values()
                    for k in ("exp_avg", "exp_avg_sq")]
    for s in (1, 5):
        assert all(torch.equal(a, b) for a, b in zip(states[True, s], states[False, s])), s
    tr.graphs = True
    assert torch.isfinite(torch.tensor(tr.run_epoch()))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["KHGRec", "KGAT"])
def test_resume_on_the_card_is_bit_for_bit(cuda, tmp_path, model):
    """Two epochs with a checkpoint after each; a fresh trainer restores the
    last into the tensors its graphs will read, and its next epoch equals
    the uninterrupted run's third bit for bit (KGAT: both Adam states)."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    def trainer():
        rec = _kgat(cuda) if model == "KGAT" else _rec(model, cuda)
        return Trainer(rec.bundle, seed=0)

    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    trainer().fit(max_epoch=2, quiet=True, ckpt=ckpt, ckpt_every=1)
    whole = trainer()
    for ep in range(3):
        want = whole.run_epoch(ep)[0]
    want_state = _state(whole)
    resumed = trainer()
    assert resumed.restore(ckpt) == 2
    assert resumed.run_epoch(2)[0] == want
    _assert_match(_state(resumed), want_state, exact=True)
    ckpt.close()


@pytest.mark.gpu
def test_capture_with_a_host_sync_raises(cuda, monkeypatch):
    rec = _rec("KHGRec", cuda)
    bundle = rec.bundle
    loss_fn = bundle.batch_loss

    def syncing(extras, batch, keys, generator=None):
        loss, aux = loss_fn(extras, batch, keys, generator)
        float(loss)  # a copy to the host
        return loss, aux

    monkeypatch.setattr(bundle, "batch_loss", syncing)
    tr = Trainer(bundle, seed=0, extras=rec.extras)
    batches = tr.sample_epoch()
    tr.train_step(tuple(t[0] for t in batches), tr.edge_keys())  # eager: allowed
    with pytest.raises(RuntimeError):
        tr.train_step(tuple(t[1] for t in batches), tr.edge_keys())
    assert not tr._step_graphs  # nothing captured, and nothing ran eagerly in its place
