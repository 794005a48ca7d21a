"""The plain references against small CPU runs of the port (a test may
import the port; the references import nothing of it)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from harness.small import cells, run_small
from harness.spec import BENCH_DIR


@pytest.mark.parametrize("cell", cells())
def test_the_reference_follows_the_port(cell):
    """Every number the check compares, at the small size on the CPU, where
    the port's products are float32 (no kernel layout): the same inputs give
    the same losses and metrics to rounding."""
    torch.set_num_threads(1)
    r = run_small(cell)
    values = {k: v["value"] for k, v in r["checks"].items()}
    assert r["correct"], values
    small = {"loss_gap": 1e-6, "first_loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 1e-5,
             "whole_change_gap": 1e-5, "table_gap": 1e-5, "metric_gap": 5e-6 + 1e-9}
    assert all(v < small[k] for k, v in values.items()), values


def test_the_edge_dropout_draws_what_the_port_draws():
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.dropout import hash_keep_mask
    from reference.common import keep_mask

    for key in [(0, 0), (2**32 - 1, 12345), (987654321, 4000000000)]:
        ids = torch.arange(50000)
        assert torch.equal(keep_mask(key, 50000, 0.8, "cpu"), hash_keep_mask(key, ids, 0.8))


def test_the_recipe_is_the_ports():
    from generators.synthetic_recipe import generate
    from hypergraph_diffusion_for_recommendation_tpu_torch.data.synthetic import synthetic_dataset

    params = dict(n_users=40, n_items=90, n_clusters=4, mean_degree=9.0, with_kg=True,
                  train_frac=0.75)
    tr, te, kg, _ = generate(params, 2147483999)
    ptr, pte, pkg = synthetic_dataset(40, 90, 4, 9.0, seed=2147483999, with_kg=True)
    assert np.array_equal(tr, ptr) and np.array_equal(te, pte)
    assert np.array_equal(kg, pkg[["h", "r", "t"]].to_numpy())


def test_dense_ids_and_adjacency_are_the_ports():
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import build_interaction
    from reference.common import bipartite, cf_ids

    rng = np.random.default_rng(5)
    pairs = np.unique(np.stack([rng.integers(100, 130, 400), rng.integers(0, 50, 400)], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))]
    train, test = pairs[:250], pairs[250:]
    inter = build_interaction(train, test)
    cf = cf_ids(train, test)
    assert np.array_equal(inter.id2user, cf.user_raw) and np.array_equal(inter.id2item, cf.item_raw)
    assert np.array_equal(inter.test_u, cf.test_u) and np.array_equal(inter.test_i, cf.test_i)
    a = bipartite(cf, "cpu")
    coo = inter.norm_adj.tocoo()
    dense = np.zeros(coo.shape, np.float64)
    dense[coo.row, coo.col] = coo.data
    mine = np.zeros(coo.shape, np.float64)
    mine[a.rows.numpy(), a.cols.numpy()] = a.vals.numpy()
    assert np.allclose(dense, mine, rtol=1e-6, atol=0)


def test_the_references_import_nothing_of_the_program():
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        tree = ast.parse(Path(path).read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in (
                    "hypergraph_diffusion_for_recommendation_tpu_torch",
                    "hypergraph_diffusion_for_recommendation_tpu", "jax", "flax", "optax"), (path, n)
