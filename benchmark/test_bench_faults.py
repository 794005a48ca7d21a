"""A run drives the cell with the timed path broken underneath and sees
`correct` come out false, for each fault the cell can have (on one card
there is no exchange between chips to leave out): training, a step that
leaves its state unchanged and half of each batch left out; evaluation,
half of the test users left out, the users' training items left in the
ranking, and an answer (a row of the encoded item table) altered where it
is produced. At the small size, on the CPU."""

import dataclasses

import pytest
import torch

import hypergraph_diffusion_for_recommendation_tpu_torch.eval.metrics as metrics_mod
import hypergraph_diffusion_for_recommendation_tpu_torch.train.trainer as trainer_mod
from harness import program
from harness.small import cells, run_small

TRAIN = cells("train_epochs")
EVAL = cells("eval_passes")


def _patch_bundle(monkeypatch, change):
    build = program.build

    def patched(*args, **kwargs):
        bundle, cfg, inter = build(*args, **kwargs)
        change(bundle)
        return bundle, cfg, inter

    monkeypatch.setattr(program, "build", patched)


def _assert_caught(cell):
    torch.set_num_threads(1)
    r = run_small(cell)
    assert r["correct"] is False, r["checks"]
    return r


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_its_state_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    r = _assert_caught(cell)
    change = [c["value"] for k, c in r["checks"].items() if "change" in k]
    assert change and change == [pytest.approx(1.0)] * len(change)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_each_batch_left_out(cell, monkeypatch):
    def halve(bundle):
        loss = bundle.batch_loss

        def half(extras, batch, *args, **kwargs):
            return loss(extras, tuple(t[: t.shape[0] // 2] for t in batch), *args, **kwargs)

        bundle.batch_loss = half

    _patch_bundle(monkeypatch, halve)
    _assert_caught(cell)


@pytest.mark.parametrize("cell", EVAL)
def test_half_of_the_test_users_left_out(cell, monkeypatch):
    ranking = trainer_mod.ranking_metrics

    def half(u, i, rated, ed, top_ns, block):
        n = ed.n_test_users // 2
        valid = ed.user_valid.clone()
        valid[n:] = False
        counts = torch.where(valid, ed.test_counts, 0)
        ed = dataclasses.replace(ed, user_valid=valid, test_counts=counts, n_test_users=n,
                                 total_test_interactions=int(counts.sum()))
        return ranking(u, i, rated, ed, top_ns, block=block)

    monkeypatch.setattr(trainer_mod, "ranking_metrics", half)
    r = _assert_caught(cell)
    assert r["checks"]["metric_gap"]["value"] > r["checks"]["metric_gap"]["limit"]


@pytest.mark.parametrize("cell", EVAL)
def test_the_training_items_left_in_the_ranking(cell, monkeypatch):
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.topk import topk_ids

    monkeypatch.setattr(metrics_mod, "masked_topk", lambda scores, rated, k: topk_ids(scores, k))
    r = _assert_caught(cell)
    assert r["checks"]["metric_gap"]["value"] > r["checks"]["metric_gap"]["limit"]


@pytest.mark.parametrize("cell", EVAL)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    def alter(bundle):
        encode = bundle.encode_eval

        def altered(extras):
            u, i = encode(extras)
            i = i.clone()
            i[0] += 1.0
            return u, i

        bundle.encode_eval = altered

    _patch_bundle(monkeypatch, alter)
    r = _assert_caught(cell)
    assert r["checks"]["table_gap"]["value"] > r["checks"]["table_gap"]["limit"]
