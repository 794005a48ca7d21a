"""The port's collective layer (`parallel/`, `ops.topk.distributed_topk`,
`utils.platform.run_ranks`, `models.base.model_shard_needs`) against the
JAX package on the CPU.

One spawn of 4 gloo ranks (a 2 x 2 mesh) runs every sharded case once
(`parallel.check.run_cases`, module-scoped fixture); each test compares
one case with the JAX package's `make_mesh(2, 2)` on the conftest's 8
virtual CPU devices:

  * lookups: rows and the table gradient of sum(sin(rows) * w), through
    `spmd_sharded_lookup` and `spmd_a2a_lookup`, within 1e-6 of JAX's rows
    and `jax.grad` (no gradient S times too large); the a2a overflow case
    of tests/test_parallel.py (the count exactly, the rows within 1e-6);
  * `sharded_scatter_add` into each rank's block, within 1e-6;
  * `sharded_user_topk` over 100 items (not divisible by the shards): ids
    bit for bit, values within 1e-5; `distributed_topk` likewise;
  * `param_shardings`: each leaf's decision equal;
  * `ShardedMF`: two steps from JAX's initial tables, within 1e-6 of the
    JAX `ShardedMF`'s tables and losses; and the learning case of
    tests/test_sharded_mf.py (the same bound);
  * no rank loads JAX or the JAX package.

`mesh_shape`'s factoring (every n in 1..8, every data and model up to 8),
`pick_backend` and `model_shard_needs` need no processes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from hypergraph_diffusion_for_recommendation_tpu import parallel as JP
from hypergraph_diffusion_for_recommendation_tpu.models import MODEL_REGISTRY as J_REGISTRY
from hypergraph_diffusion_for_recommendation_tpu.models.base import (
    model_shard_needs as j_shard_needs,
)
from hypergraph_diffusion_for_recommendation_tpu.ops.topk import (
    distributed_topk as j_distributed_topk,
)
from hypergraph_diffusion_for_recommendation_tpu.parallel.embedding import (
    sharded_scatter_add as j_scatter_add,
)
from hypergraph_diffusion_for_recommendation_tpu.parallel.embedding import (
    spmd_a2a_lookup as j_a2a,
)
from hypergraph_diffusion_for_recommendation_tpu.parallel.embedding import (
    spmd_sharded_lookup as j_lookup,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
    MODEL_REGISTRY,
    model_shard_needs,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.parallel import mesh_shape, pick_backend
from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.check import run_cases
from hypergraph_diffusion_for_recommendation_tpu_torch.utils.platform import run_ranks
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import sharded_mf_from_jax

MESH = (2, 2)
N_RANKS = 4
MF_SHAPE = dict(n_users=96, n_items=128, dim=16)
PARAM_SHAPES = {"user_emb": (2048, 8), "item_emb": (1024, 8), "user_entity_emb": (1023, 8),
                "entity_user_embed": (512, 8), "w": (4096, 8), "small": (4096,)}


def _f32(a):
    return np.asarray(a, np.float32)


def _inputs():
    rng = np.random.default_rng(12)
    table = _f32(rng.standard_normal((64, 8)))
    learn = np.random.default_rng(1)
    users, items = [], []
    for u in range(64):  # tests/test_sharded_mf.py's planted preferences
        for i in range(96):
            if i % 8 == u % 8:
                users.append(u)
                items.append(i)
    users, items = np.asarray(users), np.asarray(items)
    perms = [learn.permutation(len(users))[:64] for _ in range(400)]
    negs = [learn.integers(0, 96, 64) for _ in range(400)]
    learn_batches = dict(users=np.stack([users[p] for p in perms]),
                         pos=np.stack([items[p] for p in perms]), neg=np.stack(negs))
    mf_rng = np.random.default_rng(0)
    mf_batches = {k: mf_rng.integers(0, MF_SHAPE["n_users" if k == "users" else "n_items"],
                                     (2, 32)).astype(np.int32)
                  for k in ("users", "pos", "neg")}
    return dict(
        lookup=dict(kind="lookup", table=table, idx=np.array([0, 5, 63, 17, 32, 31, 5], np.int32),
                    weight=_f32(rng.standard_normal((7, 8)))),
        a2a=dict(kind="a2a", table=table, idx=rng.integers(0, 64, 32).astype(np.int32),
                 weight=_f32(rng.standard_normal((32, 8)))),
        overflow=dict(kind="a2a", table=table, idx=np.zeros(64, np.int32),
                      weight=_f32(rng.standard_normal((64, 8))), capacity_factor=0.26),
        scatter_add=dict(kind="scatter_add", table=table,
                         idx=rng.integers(0, 64, 40).astype(np.int32),
                         updates=_f32(rng.standard_normal((40, 8)))),
        user_topk=dict(kind="user_topk", users=_f32(rng.standard_normal((16, 8))),
                       items=_f32(rng.standard_normal((100, 8))),
                       rated=np.array([[3, -1, 57, 99]] + [[-1] * 4] * 14 + [[0, 1, 2, 98]],
                                      np.int32), k=7),
        distributed_topk=dict(kind="distributed_topk", scores=_f32(rng.standard_normal((12, 40))),
                              k=6),
        param_shardings=dict(kind="param_shardings", shapes=PARAM_SHAPES),
        sharded_mf=dict(kind="sharded_mf", lrate=0.1, seed=3, **MF_SHAPE, **mf_batches),
        learns=dict(kind="sharded_mf", n_users=64, n_items=96, dim=16, lrate=2.0, seed=0,
                    **learn_batches),
    )


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return JP.make_mesh(*MESH)


@pytest.fixture(scope="module")
def jax_mf(jmesh):
    return JP.ShardedMF(jmesh, lrate=0.1, seed=3, **MF_SHAPE)


@pytest.fixture(scope="module")
def cases(jax_mf):
    cases = _inputs()
    cases["sharded_mf"]["tables"] = sharded_mf_from_jax(jax_mf.user_table, jax_mf.item_table)
    return cases


@pytest.fixture(scope="module")
def ranks(cases):
    """Every case on 4 spawned gloo ranks, once for the module."""
    return run_ranks(N_RANKS, run_cases, MESH, "cpu", cases, device="cpu")


def _model_blocks(ranks, case, key="grad"):
    """The full table from the model ranks' blocks (data rank 0's)."""
    return np.concatenate([r[case][key] for r in ranks if r["coordinate"][0] == 0])


def _row_sharded(jmesh, a):
    return jax.device_put(jnp.asarray(a), JP.row_sharded(jmesh))


def test_ranks_run_gloo_on_a_2x2_mesh_without_jax(ranks):
    assert [r["rank"] for r in ranks] == list(range(N_RANKS))
    assert [r["coordinate"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert {r["device"] for r in ranks} == {"cpu"}
    assert [r["leaked"] for r in ranks] == [[]] * N_RANKS


def test_sharded_lookup_and_gradient_match_jax(ranks, cases, jmesh):
    c = cases["lookup"]
    idx, w = jnp.asarray(c["idx"]), jnp.asarray(c["weight"])

    def loss(t):
        return jnp.sum(jnp.sin(j_lookup(t, idx, jmesh)) * w)

    table = _row_sharded(jmesh, c["table"])
    want_rows = np.asarray(j_lookup(table, idx, jmesh))
    want_grad = np.asarray(jax.grad(loss)(table))
    for r in ranks:
        np.testing.assert_allclose(r["lookup"]["rows"], want_rows, rtol=0, atol=1e-6)
    np.testing.assert_allclose(_model_blocks(ranks, "lookup"), want_grad, rtol=0, atol=1e-6)
    # the data replicas hold the same blocks
    np.testing.assert_array_equal(_model_blocks(ranks, "lookup"), np.concatenate(
        [r["lookup"]["grad"] for r in ranks if r["coordinate"][0] == 1]))


@pytest.mark.parametrize("case", ["a2a", "overflow"])
def test_a2a_lookup_and_gradient_match_jax(ranks, cases, jmesh, case):
    c = cases[case]
    idx, w = jnp.asarray(c["idx"]), jnp.asarray(c["weight"])
    factor = c.get("capacity_factor", 2.0)

    def loss(t):
        return jnp.sum(jnp.sin(j_a2a(t, idx, jmesh, factor)[0]) * w)

    table = _row_sharded(jmesh, c["table"])
    rows, overflow = j_a2a(table, idx, jmesh, factor)
    want_grad = np.asarray(jax.grad(loss)(table))
    assert {r[case]["overflow"] for r in ranks} == {int(overflow)}
    if case == "overflow":
        assert int(overflow) > 0
    else:
        assert int(overflow) == 0
    np.testing.assert_allclose(_model_blocks(ranks, case, "rows"), np.asarray(rows), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_model_blocks(ranks, case), want_grad, rtol=0, atol=1e-6)


def test_sharded_scatter_add_matches_jax(ranks, cases, jmesh):
    c = cases["scatter_add"]
    fn = jax.shard_map(lambda t, i, u: j_scatter_add(t, i, u, JP.MODEL_AXIS), mesh=jmesh,
                       in_specs=(P(JP.MODEL_AXIS, None), P(), P()),
                       out_specs=P(JP.MODEL_AXIS, None))
    want = np.asarray(fn(_row_sharded(jmesh, c["table"]), jnp.asarray(c["idx"]),
                         jnp.asarray(c["updates"])))
    np.testing.assert_allclose(_model_blocks(ranks, "scatter_add", "block"), want, rtol=0,
                               atol=1e-6)


def test_sharded_user_topk_matches_jax(ranks, cases, jmesh):
    c = cases["user_topk"]
    vals, ids = JP.sharded_user_topk(jmesh, jnp.asarray(c["users"]),
                                     _row_sharded(jmesh, c["items"]), jnp.asarray(c["rated"]),
                                     k=c["k"])
    for r in ranks:
        np.testing.assert_array_equal(r["user_topk"]["ids"], np.asarray(ids))
        np.testing.assert_allclose(r["user_topk"]["vals"], np.asarray(vals), rtol=1e-5)


def test_distributed_topk_matches_jax(ranks, cases, jmesh):
    c = cases["distributed_topk"]
    cols = c["scores"].shape[1] // MESH[1]

    def body(s):
        off = jax.lax.axis_index(JP.MODEL_AXIS) * cols
        return j_distributed_topk(s, c["k"], JP.MODEL_AXIS, off)

    fn = jax.shard_map(body, mesh=jmesh, in_specs=(P(None, JP.MODEL_AXIS),), out_specs=(P(), P()),
                       check_vma=False)
    vals, ids = fn(jnp.asarray(c["scores"]))
    for r in ranks:
        np.testing.assert_array_equal(r["distributed_topk"]["ids"], np.asarray(ids))
        np.testing.assert_allclose(r["distributed_topk"]["vals"], np.asarray(vals), rtol=1e-5)


def test_param_shardings_decide_as_jax(ranks, jmesh):
    want = JP.param_shardings({k: jnp.zeros(s) for k, s in PARAM_SHAPES.items()}, jmesh)
    decided = {k: "row" if v.spec == P(JP.MODEL_AXIS, None) else "replicated"
               for k, v in want.items()}
    assert decided["user_emb"] == "row" and decided["user_entity_emb"] == "replicated"
    for r in ranks:
        assert r["param_shardings"] == decided


def test_sharded_mf_steps_match_jax(ranks, cases, jax_mf):
    c = cases["sharded_mf"]
    losses = [jax_mf.train_step(*(jnp.asarray(c[k][s]) for k in ("users", "pos", "neg")))
              for s in range(2)]
    want_u, want_i = jax_mf.embeddings()
    for r in ranks:
        np.testing.assert_allclose(r["sharded_mf"]["losses"], losses, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["sharded_mf"]["user"], want_u, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["sharded_mf"]["item"], want_i, rtol=0, atol=1e-6)


def test_sharded_mf_learns(ranks):
    losses = ranks[0]["learns"]["losses"]
    assert np.mean(losses[-10:]) < losses[0] * 0.7, (losses[0], np.mean(losses[-10:]))
    assert {tuple(r["learns"]["losses"]) for r in ranks} == {tuple(losses)}


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_factors_as_jax(n):
    devices = jax.devices()[:n]
    for data in range(0, 9):
        for model in range(0, 9):
            try:
                want = tuple(JP.make_mesh(data, model, devices=devices).devices.shape)
            except AssertionError:
                with pytest.raises(ValueError):
                    mesh_shape(n, data, model)
                continue
            assert mesh_shape(n, data, model) == want, (n, data, model)


def test_pick_backend_follows_the_layout():
    assert pick_backend("cpu", 4, 0) == "gloo"
    assert pick_backend("cuda", 4, 1) == "gloo"  # four ranks share one card
    assert pick_backend("cuda", 4, 4) == "nccl"
    assert pick_backend("cuda", 1, 1) == "nccl"


def test_model_shard_needs_match_jax():
    assert set(MODEL_REGISTRY) == set(J_REGISTRY)
    for name in sorted(MODEL_REGISTRY):
        assert model_shard_needs(name) == j_shard_needs(name), name
    assert model_shard_needs("KHGRec") == frozenset({"adj", "kg"})
