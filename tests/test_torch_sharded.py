"""The port's sharded runtime (`parallel/sharded_adj.py`, `sharded_gcn.py`,
the mesh through the device data, `build_model`, `Trainer`, checkpoints and
`Retriever`) against the JAX package on the CPU.

One spawn of 4 gloo ranks runs every case once (`parallel.check.run_cases`,
module-scoped fixture, in a thread while the JAX side computes); a case
runs on a (1, 4) or a (2, 2) mesh. The JAX package runs on the conftest's 8
virtual CPU devices with `make_mesh(1, 4)` or `make_mesh(2, 2)`. Tolerances:

  * `shard_sparse` (window, balanced, auto; the zipf graph of
    tests/test_sharded_diffusion.py:87-107): `lrows`, `cols`, `vals`,
    `canon`, `rps`, `nnz`, `balanced` and e_pad bit for bit JAX's row s;
    each shard's packed fields (`cols`, `vals`, `local_rows`, `wmap`, `src`,
    `canon`, and `ucols`, `local_cols` of the dedup layout) bit for bit
    JAX's stacked shard s without its inert pad blocks; the pooled layout
    decision equal on every rank and to JAX's;
  * `sharded_spmm` (window and balanced, base and dedup, `HGDR_INT8` once):
    the product within 2e-5 of JAX's (its segment-sum path, the Pallas
    kernel's plain reference) and of scipy, the X-gradient of sum(y * w)
    (A^T w) within 1e-5 of JAX's;
  * `sharded_dropped`: masks bit for bit the unsharded port pair's and
    JAX's; `sharded_with_new_vals` bit for bit;
  * LightGCN, HGNN_HD3 and KHGRec trained with sharded adjacencies on a
    (2, 2) mesh against the replicated port path at
    tests/test_sharded_diffusion.py:239-277's tolerances (losses 1e-4,
    1e-3, 1e-3; metrics 1e-3, -, 1e-2), one epoch of every other model
    of `_MODEL_SHARD_NEEDS` (loss 1e-3, metrics 1e-2), and one epoch of
    every other registered model with its tables row-sharded (loss 1e-4,
    metrics 1e-3): the mesh path refuses no model;
  * `Trainer(mesh=)` for LightGCN, KHGRec (edge dropout off), SASRec and
    KGAT (dropout off, both phases) on (2, 2) against the JAX mesh trainer
    (whose `_dp_constrain` shards every step's batch over the data axis) on
    injected batches from JAX's initial parameters (SASRec's are the JAX
    trainer's own draws, recomputed from its keys): epoch losses within 1e-4
    relative over two epochs, `evaluate()` within 1e-6 of the
    single-device evaluation of the same embeddings, the row blocks'
    shapes (parameter and Adam state); the two data ranks' shares of the
    first step's loss differ and add up to the step's loss within 1e-6;
  * the data axis's split for every registered name (one build of each;
    the KHGRec_variation names are KHGRec's builder, each built on a data
    axis's shape alone): `data_split` on a (2, 2) mesh, the two data ranks'
    shares of the first step's loss (and of KGAT's first KG step) differ
    and add up to the step's loss within 1e-6;
  * `gather_shares` (even and uneven shares): its rows equal the whole
    batch's (and `all_gather_cat`'s for even shares); the data ranks'
    gradients of their InfoNCE shares (`info_nce(rows=)`) of the gathered
    rows make the gradient of the unsplit InfoNCE within 1e-6, and the
    shares of `info_nce` and `info_nce_masked` add up to the whole loss
    within 1e-6;
  * a data rank's step FLOPs at data 2 against one device's
    (`utils.profiling.cost_analysis` of `Trainer.train_step` on the same
    batch): at most 0.6 for SASRec, CL4SRec and KGAT's KG phase; printed for
    every other model;
  * `ShardedLightGCN`: two steps from JAX's initial table within 1e-6 of
    the JAX engine's tables and losses, the JAX engine run at lrate / S (its
    gradient is S times the dense one: ROADMAP.md, Queue 3); and the
    learning case of tests/test_sharded_gcn.py:64-88;
  * checkpoints (tests/test_checkpoint_mesh.py:53-89, MF): resumed losses
    within 1e-5 of the uninterrupted run (bit for bit here), a mesh
    checkpoint restored on one device and a single-device one on the mesh;
  * `Retriever(mesh=)`: ids equal to the single-device ids;
  * `dryrun_multichip`'s phases at the tiny sizes;
  * no rank loads JAX or the JAX package.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from hypergraph_diffusion_for_recommendation_tpu import parallel as JP
from hypergraph_diffusion_for_recommendation_tpu.core import make_config as j_make_config
from hypergraph_diffusion_for_recommendation_tpu.data import (
    build_cf_device_data as j_build_cf,
    build_interaction as j_build_interaction,
    build_kg_device_data as j_build_kg,
    build_knowledge as j_build_knowledge,
)
from hypergraph_diffusion_for_recommendation_tpu.data import device as j_devmod
from hypergraph_diffusion_for_recommendation_tpu.data.device import (
    adj_pair_from_scipy as j_adj_pair_from_scipy,
)
from hypergraph_diffusion_for_recommendation_tpu.models import build_model as j_build_model
from hypergraph_diffusion_for_recommendation_tpu.models import (
    model_data_needs as j_data_needs,
    model_shard_needs as j_shard_needs,
)
from hypergraph_diffusion_for_recommendation_tpu.ops import sampling as j_sampling
from hypergraph_diffusion_for_recommendation_tpu.ops.dropout import hash_keep_mask as j_keep
from hypergraph_diffusion_for_recommendation_tpu.train import trainer as j_trainer_mod
from hypergraph_diffusion_for_recommendation_tpu.parallel.sharded_adj import (
    shard_sparse as j_shard_sparse,
)
from hypergraph_diffusion_for_recommendation_tpu.parallel.sharded_adj import (
    sharded_spmm as j_sharded_spmm,
)
from hypergraph_diffusion_for_recommendation_tpu.train import Trainer as JTrainer
from hypergraph_diffusion_for_recommendation_tpu_torch.data.device import adj_pair_from_scipy
from hypergraph_diffusion_for_recommendation_tpu_torch.eval.serving import Retriever
from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.check import (
    DRYRUN_TINY,
    build_on_mesh,
    run_cases,
)
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer
from hypergraph_diffusion_for_recommendation_tpu_torch.utils.checkpoint import CheckpointManager
from hypergraph_diffusion_for_recommendation_tpu_torch.utils.platform import run_ranks
from hypergraph_diffusion_for_recommendation_tpu_torch.weights import (
    khgrec_params_from_jax,
    params_from_jax,
    sharded_lightgcn_from_jax,
)

N_RANKS = 4
DATA = dict(n_users=120, n_items=300, mean_degree=20.0, seed=3)
KG_DATA = dict(DATA, with_kg=True)
LGCN = dict(lrate=0.05, hyper_dim=16, embedding_size=16, n_layers=2, reg=0.01, batch_size=256,
            early_stopping_steps=100, eval_user_batch=64, shard_min_rows=16, sampler="exact")
KHG = dict(lrate=0.01, hyper_dim=16, relation_dim=8, reg=0.1, drop_rate=0.2, batch_size=256,
           batch_size_kg=512, temp=1.0, cl_rate=0.01, mode="full", early_stopping_steps=100,
           eval_user_batch=64, shard_min_rows=16)
HD3 = dict(lrate=0.01, hyper_dim=16, reg=0.1, drop_rate=0.2, batch_size=256, mode="local_only",
           early_stopping_steps=100, eval_user_batch=64, shard_min_rows=16)
MF = dict(lrate=0.05, hyper_dim=16, embedding_size=16, reg=0.01, batch_size=256,
          eval_user_batch=64, shard_min_rows=4)
GCN = dict(dim=16, n_layers=2, lrate=0.1)
SEQ = dict(lrate=0.01, embedding_size=16, n_layers=2, drop_rate=0.0, batch_size=64,
           eval_user_batch=64, shard_min_rows=16, early_stopping_steps=100)
KGAT_KW = dict(lrate=0.01, embedding_size=16, relation_dim=8, conv_dim_list=(16, 8),
               mess_dropout=(0.0, 0.0), batch_size=256, batch_size_kg=256, eval_user_batch=64,
               shard_min_rows=16, sampler="exact", early_stopping_steps=100)
# the models held against the JAX mesh trainer: (configuration, data)
JAX_MESH = {"LightGCN": (LGCN, DATA), "SASRec": (SEQ, DATA), "KGAT": (KGAT_KW, KG_DATA),
            "KHGRec": (dict(KHG, drop_rate=0.0, sampler="exact"), KG_DATA)}
# a data rank's step FLOPs at data 2 are at most this share of one device's for these
# (model, phase): their steps are per-example work
FLOPS_BOUND = {("SASRec", "cf"): 0.6, ("CL4SRec", "cf"): 0.6, ("KGAT", "kg"): 0.6}
# the rest of models.base._MODEL_SHARD_NEEDS: one epoch with their adjacencies sharded (at
# ZOO_SPEC's size)
OTHER_SHARDED = ("HCCF", "HGCN", "SHT", "HGNN_HD", "HGNN_HD4", "LocalEncoder", "WaveletHD",
                 "WaveletHD2")
# every other registered model (the KHGRec_variation names are KHGRec): an epoch with its
# tables row-sharded on a (2, 2) mesh
ZOO_SPEC = dict(n_users=60, n_items=90, mean_degree=10.0, seed=3, with_kg=True)
ZOO_KW = dict(hyper_dim=8, embedding_size=8, relation_dim=4, batch_size=64, batch_size_kg=64,
              eval_user_batch=64, item_ranking=(10, 20), shard_min_rows=8,
              early_stopping_steps=100)
SOCIAL = ("MHCN", "SEPT")


def _names():
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import MODEL_REGISTRY

    return sorted(n for n in MODEL_REGISTRY if not n.startswith("KHGRec_variation"))


NAMES = _names()  # every registered builder
ZOO = [n for n in NAMES if n not in {"LightGCN", "HGNN_HD3", "KHGRec", "MF", *OTHER_SHARDED}]
# the trainer case of each name whose first step is recorded
SPLIT_CASE = dict({n: f"zoo_{n}" for n in ZOO}, MF="mf_whole",
                  **{n: f"sharded_{n}" for n in ("LightGCN", "HGNN_HD3", "KHGRec",
                                                 *OTHER_SHARDED)})


def _f32(a):
    return np.asarray(a, np.float32)


def _rand_sparse(n, m, nnz, seed):
    rng = np.random.default_rng(seed)
    return sps.coo_matrix((rng.normal(size=nnz).astype(np.float32),
                           (rng.integers(0, n, nnz), rng.integers(0, m, nnz))),
                          shape=(n, m)).tocsr().tocoo()


def _skewed_sparse(n, m, nnz, seed):
    rng = np.random.default_rng(seed)
    rows = np.minimum(rng.zipf(1.3, nnz) - 1, n - 1)
    return sps.coo_matrix((rng.normal(size=nnz).astype(np.float32),
                           (rows, rng.integers(0, m, nnz))), shape=(n, m)).tocsr().tocoo()


# name: (matrix, mode, mesh, layout variables)
SPARSE = {
    "window": ("uniform", "window", (1, 4), {}),
    "balanced": ("uniform", "balanced", (1, 4), {}),
    "auto_zipf": ("zipf", "auto", (1, 4), {}),
    "auto_uniform": ("uniform", "auto", (2, 2), {}),
    "dedup_window": ("dense_cols", "window", (1, 4), {"HGDR_DEDUP": "1"}),
    "dedup_balanced": ("dense_cols", "balanced", (1, 4), {"HGDR_DEDUP": "1"}),
    "int8": ("uniform", "window", (1, 4), {"HGDR_INT8": "1"}),
}


def _matrices():
    return {"uniform": _rand_sparse(203, 117, 1500, 1), "zipf": _skewed_sparse(203, 117, 4000, 11),
            "dense_cols": _rand_sparse(180, 60, 1600, 6)}


def _dataset(spec):
    from hypergraph_diffusion_for_recommendation_tpu.data import synthetic_dataset

    return synthetic_dataset(**spec)


def _jax_build(name, cfg_kw, spec, jmesh, shard=True):
    train, test, kg_df = _dataset(spec)
    inter = j_build_interaction(train, test)
    needs = j_shard_needs(name) if shard else frozenset()
    cfg = j_make_config(name, max_epoch=2, **cfg_kw)
    cf = j_build_cf(inter, eval_user_multiple=cfg.eval_user_batch, needs=j_data_needs(name),
                    mesh=jmesh, shard_needs=needs)
    kg = None
    if kg_df is not None and cfg.use_knowledge:
        kg = j_build_kg(j_build_knowledge(kg_df, inter), mesh=jmesh, shard="kg" in needs)
    return cfg, j_build_model(cfg, cf, kg, mesh=jmesh), inter, kg_df


def _batches(inter, kg_df, cfg, n_batches, n_epochs, seed, n_kg_batches=None):
    """Injected epochs: (users, pos, neg[, h, r, pos_t, neg_t]), each [n_batches, B] (the KG
    batches [n_kg_batches, B_kg]: an alternating epoch draws its own number)."""
    rng = np.random.default_rng(seed)
    b, out = cfg.batch_size, []
    n_kg = n_batches if n_kg_batches is None else n_kg_batches
    for _ in range(n_epochs):
        e = rng.integers(0, inter.train_u.shape[0], (n_batches, b))
        ep = [inter.train_u[e], inter.train_i[e], rng.integers(0, inter.n_items, (n_batches, b))]
        if kg_df is not None and cfg.use_knowledge:
            kg = j_build_knowledge(kg_df, inter)
            t = rng.integers(0, kg.h.shape[0], (n_kg, cfg.batch_size_kg))
            ep += [kg.h[t], kg.r[t], kg.t[t],
                   rng.integers(0, kg.n_entities, (n_kg, cfg.batch_size_kg))]
        out.append(tuple(np.asarray(a, np.int32) for a in ep))
    return out


def _sequence_batches(trainer, n_epochs):
    """The sequence batches the JAX trainer draws in its next `n_epochs` epochs, from its
    keys: `run_epoch`'s split, then the epoch's (its first key samples the batches)."""
    rng, cfg, out = trainer.rng, trainer.cfg, []
    for _ in range(n_epochs):
        rng, k = jax.random.split(rng)
        k_cf = jax.random.split(k, 4)[0]
        ep = j_trainer_mod._sequence_epoch_batches(k_cf, trainer.bundle.seq, cfg.batch_size,
                                                   cfg.neg_resample_rounds)
        out.append(tuple(np.asarray(a) for a in ep))
    return out


def _jax_epochs(trainer, batches):
    """The JAX trainer's epochs on the injected batches (its exact host sampler
    hands them out)."""
    it = iter(batches)
    cur = {}

    def pairwise(self, seed, batch_size):
        cur["ep"] = next(it)
        return cur["ep"][:3]

    def kg_batches(self, seed, n_batches, batch_size_kg):
        return cur["ep"][3:]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_sampling.HostExactSampler, "pairwise", pairwise)
        mp.setattr(j_sampling.HostExactSampler, "kg_batches", kg_batches)
        return [trainer.run_epoch(ep)[0] for ep in range(len(batches))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's port runs on one intra-op thread (as each rank does): its
    tiny ops gain nothing from more, and the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jmeshes():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return {(1, 4): JP.make_mesh(1, 4), (2, 2): JP.make_mesh(2, 2)}


@pytest.fixture(scope="module")
def jax_trainers(jmeshes):
    """JAX mesh trainers (sharded builds; the exact sampler, but SASRec's) of JAX_MESH's
    models (dropout off), their initial parameters and the injected batches."""
    out = {}
    for name, (kw, spec) in JAX_MESH.items():
        cfg, bundle, inter, kg_df = _jax_build(name, kw, spec, jmeshes[(2, 2)])
        tr = JTrainer(bundle, mesh=jmeshes[(2, 2)])
        params = jax.tree_util.tree_map(np.asarray, tr.params["params"])
        state = (khgrec_params_from_jax(params, None, "cpu")[0] if name == "KHGRec"
                 else params_from_jax(params, "cpu"))
        if bundle.batch_kind == "sequence":
            batches = _sequence_batches(tr, 2)
        else:
            n_kg = bundle.kg.n_kg_train // cfg.batch_size_kg + 1 if bundle.alternating else None
            batches = _batches(inter, kg_df, cfg, tr.n_batches, 2, seed=5, n_kg_batches=n_kg)
        out[name] = dict(trainer=tr, cfg_kw=kw, spec=spec, state=state, batches=batches)
    return out


@pytest.fixture(scope="module")
def jax_gcn(jmeshes):
    from hypergraph_diffusion_for_recommendation_tpu.data import build_interaction

    train, test = _dataset(DATA)[:2]
    inter = build_interaction(train, test)
    model = JP.ShardedLightGCN(jmeshes[(2, 2)], inter.norm_adj, inter.n_users, inter.n_items,
                               GCN["dim"], n_layers=GCN["n_layers"], lrate=GCN["lrate"] / 2,
                               seed=3)
    rng = np.random.default_rng(0)
    ids = {k: rng.integers(0, inter.n_users if k == "users" else inter.n_items,
                           (2, 64)).astype(np.int32) for k in ("users", "pos", "neg")}
    return dict(model=model, inter=inter, table0=np.asarray(model.table).copy(), ids=ids)


@pytest.fixture(scope="module")
def single_ckpt(tmp_path_factory):
    """A single-device MF checkpoint after epoch 1, and that run's epochs."""
    d = tmp_path_factory.mktemp("single_ckpt")
    _, bundle = build_on_mesh("MF", MF, DATA, None, "cpu")
    tr = Trainer(bundle)
    losses = [tr.run_epoch(ep)[0] for ep in range(2)]
    ckpt = CheckpointManager(str(d), background=False)
    ckpt.save(1, tr.checkpoint_state(1))
    ckpt.close()
    losses += [tr.run_epoch(ep)[0] for ep in range(2, 4)]
    return dict(dir=str(d), losses=losses)


def _cases(jax_trainers, jax_gcn, single_ckpt, tmp):
    mats = _matrices()
    rng = np.random.default_rng(4)
    cases = {}
    for name, (mat, mode, mesh, env) in SPARSE.items():
        m = mats[mat]
        cases[name] = dict(kind="shard_sparse", rows=m.row, cols=m.col, vals=m.data,
                           shape=m.shape, mode=mode, attach=True, mesh=mesh, env=env, linear=True,
                           x=_f32(rng.standard_normal((m.shape[1], 8))),
                           weight=_f32(rng.standard_normal((m.shape[0], 8))))
    sq = _rand_sparse(120, 120, 900, 8)
    cases["pair"] = dict(kind="sharded_pair", rows=sq.row, cols=sq.col, vals=sq.data,
                         shape=sq.shape, mode="auto", attach=True, mesh=(1, 4),
                         x=_f32(rng.standard_normal((120, 8))), key=(42, 7), keep=0.7)
    for name, jt in jax_trainers.items():
        cases[f"jax_{name}"] = dict(kind="trainer", model=name, cfg=jt["cfg_kw"], data=jt["spec"],
                                    epochs=2, state=jt["state"], batches=jt["batches"],
                                    first_step=True, mesh=(2, 2))
    for name, kw, spec in (("LightGCN", LGCN, DATA), ("HGNN_HD3", HD3, DATA),
                           ("KHGRec", KHG, KG_DATA)):
        cases[f"sharded_{name}"] = dict(kind="trainer", model=name, cfg=kw, data=spec,
                                        epochs=2, mesh=(2, 2))
    for name in OTHER_SHARDED:
        cases[f"sharded_{name}"] = dict(kind="trainer", model=name, cfg=ZOO_KW, data=ZOO_SPEC,
                                        epochs=1, mesh=(2, 2))
    for name in ZOO:
        cases[f"zoo_{name}"] = dict(kind="trainer", model=name, cfg=ZOO_KW, data=ZOO_SPEC,
                                    epochs=1, social=name in SOCIAL, mesh=(2, 2))
    for name in NAMES:
        cases[f"flops_{name}"] = dict(kind="step_flops", model=name, cfg=ZOO_KW, data=ZOO_SPEC,
                                      social=name in SOCIAL, mesh=(2, 2))
    for n in (64, 63):  # even and uneven shares over the two data ranks
        cases[f"gather_{n}"] = dict(kind="gather_shares", x=_f32(rng.standard_normal((n, 16))),
                                    valid=rng.random(n) < 0.8, temp=0.2, mesh=(2, 2))
    ckpt = str(tmp / "mesh_ckpt")
    cases["mf_whole"] = dict(kind="trainer", model="MF", cfg=MF, data=DATA, epochs=4, mesh=(2, 2))
    for name in NAMES:  # each name's first step, its data ranks' shares
        cases[SPLIT_CASE[name]]["first_step"] = True
    cases["mf_save"] = dict(kind="trainer", model="MF", cfg=MF, data=DATA, epochs=2, save_at=1,
                            save_dir=ckpt, mesh=(2, 2))
    cases["mf_resume"] = dict(kind="trainer", model="MF", cfg=MF, data=DATA, epochs=4,
                              restore_dir=ckpt, mesh=(2, 2))
    cases["mf_from_single"] = dict(kind="trainer", model="MF", cfg=MF, data=DATA, epochs=4,
                                   restore_dir=single_ckpt["dir"], mesh=(2, 2))
    inter = jax_gcn["inter"]
    cases["gcn"] = dict(kind="sharded_lightgcn", norm_adj=inter.norm_adj, n_users=inter.n_users,
                        n_items=inter.n_items, dim=GCN["dim"], n_layers=GCN["n_layers"],
                        lrate=GCN["lrate"], table=sharded_lightgcn_from_jax(jax_gcn["table0"]),
                        mesh=(2, 2), **jax_gcn["ids"])
    learn = np.random.default_rng(2)
    idx = learn.integers(0, len(inter.train_u), (120, 256))
    cases["gcn_learns"] = dict(kind="sharded_lightgcn", norm_adj=inter.norm_adj,
                               n_users=inter.n_users, n_items=inter.n_items, dim=16, n_layers=2,
                               lrate=12.0, seed=1, mesh=(2, 2), users=inter.train_u[idx],
                               pos=inter.train_i[idx],
                               neg=learn.integers(0, inter.n_items, (120, 256)))
    emb = np.random.default_rng(9)
    rated = np.full((50, 4), -1, np.int32)
    rated[0] = [3, 57, 100, -1]
    rated[7] = [0, 1, 2, 98]
    cases["retriever"] = dict(kind="retriever", user_emb=_f32(emb.standard_normal((50, 8))),
                              item_emb=_f32(emb.standard_normal((101, 8))),
                              id2user=np.arange(1000, 1050), id2item=np.arange(2000, 2101),
                              rated_pad=rated, users=list(range(1000, 1050)), k=7,
                              mesh=(1, 4))
    cases["dryrun"] = dict(DRYRUN_TINY, kind="dryrun")
    return cases


@pytest.fixture(scope="module")
def pending(jax_trainers, jax_gcn, single_ckpt, tmp_path_factory):
    """The spawn of every case, started in a thread: the JAX side computes
    meanwhile."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases = _cases(jax_trainers, jax_gcn, single_ckpt, tmp)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run_ranks, N_RANKS, run_cases, (1, 4), "cpu", cases, device="cpu")
    yield cases, future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_epochs(pending, jax_trainers):
    return {name: _jax_epochs(jt["trainer"], jt["batches"]) for name, jt in jax_trainers.items()}


@pytest.fixture(scope="module")
def ranks(pending, jax_epochs):
    return pending[1].result()


@pytest.fixture(scope="module")
def cases(pending):
    return pending[0]


def _rank_of(ranks, mesh, coordinate):
    """The rank at `coordinate` of a (data, model) mesh over ranks 0..3."""
    return ranks[coordinate[0] * mesh[1] + coordinate[1]]


# -- the layouts -------------------------------------------------------------------------------
def _jax_sharded(name, jmeshes, attach_blocked=True):
    mat, mode, mesh, env = SPARSE[name]
    m = _matrices()[mat]
    with pytest.MonkeyPatch.context() as mp:
        if "HGDR_DEDUP" in env:
            mp.setattr(j_devmod, "PALLAS_DEDUP", env["HGDR_DEDUP"])
        if "HGDR_INT8" in env:
            mp.setattr(j_devmod, "PALLAS_INT8", True)
        return m, j_shard_sparse(m.row, m.col, m.data, m.shape, jmeshes[mesh],
                                 attach_blocked=attach_blocked, mode=mode)


@pytest.mark.parametrize("name", list(SPARSE))
def test_shard_sparse_fields_and_layout_match_jax(ranks, jmeshes, name):
    _, jsp = _jax_sharded(name, jmeshes)
    model = SPARSE[name][2][1]
    for rank in range(N_RANKS):
        got, s = ranks[rank][name], rank % model
        assert got["shard"] == s
        for f in ("lrows", "cols", "vals", "canon"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jsp, f))[s], err_msg=f)
        assert (got["rps"], got["nnz"], got["balanced"], got["e_pad"]) == (
            jsp.rps, jsp.nnz, jsp.balanced, jsp.lrows.shape[1])
        lay, jb = got["layout"], jsp.blocked
        assert lay["dedup"] == (jb.ucols is not None) and lay["int8"] == bool(jb.int8)
        nb = lay["n_blocks"]
        fields = ["cols", "vals", "local_rows", "wmap", "src", "canon"]
        fields += ["ucols", "local_cols"] if lay["dedup"] else []
        for f in fields:
            np.testing.assert_array_equal(lay[f], np.asarray(getattr(jb, f))[s][:nb], err_msg=f)
        # JAX's pad blocks beyond this shard's are inert: no live slot
        assert (np.asarray(jb.local_rows)[s][nb:] == jb.rb).all()
    if name == "auto_zipf":
        assert ranks[0][name]["balanced"]
    if name == "auto_uniform":
        assert not ranks[0][name]["balanced"]
    # one decision for every rank
    assert len({r[name]["layout"]["dedup"] for r in ranks}) == 1


@pytest.mark.parametrize("name", list(SPARSE))
def test_sharded_spmm_matches_jax_and_scipy(ranks, cases, jmeshes, name):
    # JAX's product through its plain segment sum (the Pallas kernel's reference; the
    # layouts themselves are held above), but the int8 layout's, which quantises X
    m, jsp = _jax_sharded(name, jmeshes, attach_blocked=name == "int8")
    c = cases[name]
    x, w = jnp.asarray(c["x"]), jnp.asarray(c["weight"])
    want = np.asarray(j_sharded_spmm(jsp, x))
    want_grad = np.asarray(jax.grad(lambda x: jnp.sum(j_sharded_spmm(jsp, x) * w))(x))
    for r in ranks:
        np.testing.assert_allclose(r[name]["y"], want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r[name]["grad"], want_grad, rtol=1e-5, atol=1e-5)
        if name != "int8":  # the quantised operand is ~1% off the exact product
            np.testing.assert_allclose(r[name]["y"], m.tocsr() @ c["x"], rtol=2e-5, atol=2e-5)


def test_sharded_pair_dropout_and_new_vals(ranks, cases):
    c = cases["pair"]
    mat = sps.coo_matrix((c["vals"], (c["rows"], c["cols"])), shape=c["shape"]).tocsr()
    plain = adj_pair_from_scipy(mat, "cpu")
    key = c["key"]
    x = torch.tensor(c["x"])
    drop = plain.dropped(key, c["keep"])
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.sparse import spmm

    want_y = spmm(drop.fwd, x).numpy()
    # the port's unsharded masks are JAX's (the key words are the JAX key's data)
    jkey = jax.random.wrap_key_data(jnp.asarray(np.array(key, np.uint32)))
    np.testing.assert_array_equal(
        drop.fwd.vals.numpy(),
        np.asarray(j_adj_pair_from_scipy(mat).dropped(jkey, c["keep"]).fwd.vals))
    dense = mat.toarray()
    for r in ranks:
        got = r["pair"]
        np.testing.assert_allclose(got["y_drop"], want_y, rtol=2e-5, atol=2e-5)
        for side in ("fwd", "bwd"):
            f = got[side]
            live = f["lrows"] < (f["rps"] * (4 if f["balanced"] else 1))
            ids = f["canon"][live]
            keep = np.asarray(j_keep(jkey, jnp.asarray(ids.astype(np.uint32)), c["keep"]))
            vals = f["vals"][live]
            want = np.where(keep, vals / np.float32(c["keep"]), 0.0)
            np.testing.assert_array_equal(got[f"drop_{side}"][live], want)
            lay, packed = f["layout"], got[f"drop_{side}_packed"]
            plive = lay["local_rows"] < 256
            pkeep = np.asarray(j_keep(jkey, jnp.asarray(lay["canon"][plive].astype(np.uint32)),
                                      c["keep"]))
            np.testing.assert_array_equal(
                packed[plive], np.where(pkeep, lay["vals"][plive] / np.float32(c["keep"]), 0.0))
        # with_new_vals: the packed mirror follows src
        lay = got["fwd"]["layout"]
        plive = lay["local_rows"] < 256
        np.testing.assert_array_equal(got["new_vals_packed"][plive],
                                      (got["fwd"]["vals"] * 2.0)[lay["src"][plive]])
        # A^T (A x) and its gradient
        z = dense.T @ (dense @ c["x"])
        np.testing.assert_allclose(got["z"], z, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["grad"], dense.T @ (dense @ np.cos(z)), rtol=1e-4,
                                   atol=1e-4)


# -- models, trainers ---------------------------------------------------------------------------
def _single(name, cfg_kw, spec):
    _, bundle = build_on_mesh(name, cfg_kw, spec, None, "cpu")
    tr = Trainer(bundle)
    return [tr.run_epoch(ep)[0] for ep in range(2)], tr.evaluate()


@pytest.mark.parametrize("name,loss_rtol,metric_rtol", [
    ("LightGCN", 1e-4, 1e-3), ("HGNN_HD3", 1e-3, None), ("KHGRec", 1e-3, 1e-2)])
def test_sharded_adjacency_trains_as_replicated(ranks, name, loss_rtol, metric_rtol):
    kw, spec = {"LightGCN": (LGCN, DATA), "HGNN_HD3": (HD3, DATA), "KHGRec": (KHG, KG_DATA)}[name]
    want_losses, want_metrics = _single(name, kw, spec)
    for r in ranks:
        got = r[f"sharded_{name}"]
        assert set(got["slots"]) == {"LightGCN": {"adj"}, "HGNN_HD3": {"adj", "b_hyper"},
                                     "KHGRec": {"adj", "kg_adj"}}[name]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=loss_rtol)
        if metric_rtol is not None:
            for n in want_metrics:
                for k, v in want_metrics[n].items():
                    np.testing.assert_allclose(got["metrics"][n][k], v, rtol=metric_rtol,
                                               atol=1e-6)


@pytest.mark.parametrize("name", OTHER_SHARDED)
def test_every_shardable_model_trains_on_the_mesh_as_on_one_device(ranks, name):
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import model_shard_needs

    _, bundle = build_on_mesh(name, ZOO_KW, ZOO_SPEC, None, "cpu")
    tr = Trainer(bundle)
    want, metrics = tr.run_epoch(0)[0], tr.evaluate()
    for r in ranks:
        got = r[f"sharded_{name}"]
        assert set(got["slots"]) == set(model_shard_needs(name))
        np.testing.assert_allclose(got["losses"], [want], rtol=1e-3)
        for k, v in metrics[20].items():
            np.testing.assert_allclose(got["metrics"][20][k], v, rtol=1e-2, atol=1e-5)


@pytest.mark.parametrize("name", ZOO)
def test_every_model_trains_on_the_mesh_as_on_one_device(ranks, name):
    _, bundle = build_on_mesh(name, ZOO_KW, ZOO_SPEC, None, "cpu", social=name in SOCIAL)
    tr = Trainer(bundle)
    want = [tr.run_epoch(0)[0]]
    metrics = tr.evaluate()
    for r in ranks:
        got = r[f"zoo_{name}"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        for k, v in metrics[20].items():
            np.testing.assert_allclose(got["metrics"][20][k], v, rtol=1e-3, atol=1e-6)
    # the trainer row-shards a table of each (all but HKGRippleNet's, whose rows
    # do not split over 2 at this size)
    assert bool(ranks[0][f"zoo_{name}"]["sharded"]) == (name != "HKGRippleNet")


def _assert_split(ranks, case, phases=("",)):
    """The two data ranks' shares of the first step's loss (of each phase) differ and add
    up to the step's loss, which both report, at each model coordinate."""
    for phase in phases:
        for m in range(2):
            a, b = (_rank_of(ranks, (2, 2), (d, m))[case] for d in range(2))
            assert a["data_split"] and b["data_split"]
            sa, sb = a[f"{phase}first_share"], b[f"{phase}first_share"]
            loss = a[f"{phase}first_loss"]
            assert sa != sb, (phase, m, sa)
            np.testing.assert_allclose(sa + sb, loss, rtol=1e-6, err_msg=phase)
            np.testing.assert_allclose(loss, b[f"{phase}first_loss"], rtol=1e-6)


@pytest.mark.parametrize("name", list(JAX_MESH))
def test_mesh_trainer_matches_the_jax_mesh_trainer(ranks, jax_epochs, jax_trainers, name):
    want = jax_epochs[name]
    state = jax_trainers[name]["state"]
    for r in ranks:
        got = r[f"jax_{name}"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        for n in got["metrics"]:
            for k, v in got["metrics"][n].items():
                assert abs(v - got["single"][n][k]) < 1e-6, (n, k)
        table = {"KHGRec": "user_entity_emb", "LightGCN": "user_emb"}.get(name)
        assert table is None or table in got["sharded"]
        for t in got["sharded"]:
            rows, d = state[t].shape
            assert got["shapes"][t] == (rows // 2, d) == got["adam_shapes"][t]
    # the data axis splits the step: the two data ranks' losses differ, and add up to
    # the step's loss, which every rank reports
    _assert_split(ranks, f"jax_{name}", ("", "kg_") if name == "KGAT" else ("",))


@pytest.mark.parametrize("name", NAMES)
def test_every_model_splits_its_batch_over_the_data_axis(ranks, name):
    _assert_split(ranks, SPLIT_CASE[name], ("", "kg_") if name == "KGAT" else ("",))


class _DataAxis:
    """A (2, 1) mesh's shape and names, as the builders read them (no process group)."""

    shape, mesh_dim_names = (2, 1), ("data", "model")


@pytest.mark.parametrize("name", [f"KHGRec_variation{i}" for i in range(1, 10)])
def test_the_khgrec_aliases_split_as_khgrec(name):
    # the aliases are KHGRec's builder (the ranks run KHGRec itself): each is built to split
    from hypergraph_diffusion_for_recommendation_tpu_torch.core.config import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model

    _, bundle = build_on_mesh("KHGRec", ZOO_KW, ZOO_SPEC, None, "cpu")
    split = build_model(make_config(name, **ZOO_KW), bundle.cf, bundle.kg, mesh=_DataAxis())
    assert not bundle.data_split and split.data_split and split.name == "KHGRec"


@pytest.mark.parametrize("n", [64, 63])
def test_gather_shares_and_split_info_nce_match_the_whole(ranks, cases, n):
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.losses import (
        info_nce,
        info_nce_masked,
    )

    c = cases[f"gather_{n}"]
    x = torch.tensor(c["x"], requires_grad=True)
    v1, v2 = x.chunk(2, dim=1)
    whole = info_nce(v1, v2, c["temp"])
    whole.backward()
    masked = float(info_nce_masked(v1, v2, torch.tensor(c["valid"]), c["temp"]).detach())
    for m in range(2):
        rs = [_rank_of(ranks, (2, 2), (d, m))[f"gather_{n}"] for d in range(2)]
        assert [r["rows"] for r in rs] == [(0, (n + 1) // 2), ((n + 1) // 2, n)]
        for r in rs:
            np.testing.assert_array_equal(r["gathered"], c["x"])
            if n % 2 == 0:
                np.testing.assert_array_equal(r["all_gather_cat"], c["x"])
        # each data rank's gradient holds the other rank's terms through the backward's sum
        grad = np.concatenate([r["grad"] for r in rs])
        np.testing.assert_allclose(grad, x.grad.numpy(), rtol=0,
                                   atol=1e-6 * float(np.abs(x.grad.numpy()).max()))
        np.testing.assert_allclose(sum(r["loss"] for r in rs), float(whole.detach()), rtol=1e-6)
        np.testing.assert_allclose(sum(r["masked"] for r in rs), masked, rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_a_data_rank_does_less_work(ranks, name):
    for r in ranks:
        got = r[f"flops_{name}"]
        assert got["data_split"]
        for phase in ("cf", "kg"):
            if phase not in got:
                continue
            split, whole = got[phase]["split"], got[phase]["whole"]
            ratio = split / whole if whole else float("nan")
            print(f"{name} {phase}: a data rank's step {split:.0f} FLOPs at data 2, one "
                  f"device's {whole:.0f}: {ratio:.3f}")
            assert split <= whole
            bound = FLOPS_BOUND.get((name, phase))
            assert bound is None or ratio <= bound, (phase, ratio)


def test_sharded_lightgcn_matches_jax(ranks, jax_gcn):
    model, ids = jax_gcn["model"], jax_gcn["ids"]
    losses = [model.train_step(*(jnp.asarray(ids[k][s]) for k in ("users", "pos", "neg")))
              for s in range(2)]
    want = np.asarray(model.table)
    got = np.concatenate([_rank_of(ranks, (2, 2), (0, m))["gcn"]["table"] for m in range(2)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r["gcn"]["losses"], losses, rtol=0, atol=1e-6)
    u, i = model.embeddings()
    np.testing.assert_allclose(ranks[0]["gcn"]["user"], u, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["gcn"]["item"], i, atol=1e-6)


def test_sharded_lightgcn_learns(ranks):
    got = ranks[0]["gcn_learns"]
    assert got["losses"][-1] < got["losses"][0] - 0.02, got["losses"][::20]
    assert got["user"].shape == (DATA["n_users"], 16)


def test_checkpoints_restore_across_layouts(ranks, cases, single_ckpt):
    whole = ranks[0]["mf_whole"]
    assert "user_emb" in whole["sharded"]
    resumed = [r["mf_resume"] for r in ranks]
    assert {r["start"] for r in resumed} == {2}
    for r in resumed:
        np.testing.assert_allclose(r["losses"], whole["losses"][2:], rtol=1e-5)
        np.testing.assert_array_equal(r["losses"], whole["losses"][2:])
    # the mesh checkpoint on one device
    _, bundle = build_on_mesh("MF", MF, DATA, None, "cpu")
    tr = Trainer(bundle)
    assert tr.restore(CheckpointManager(cases["mf_save"]["save_dir"], background=False)) == 2
    np.testing.assert_allclose([tr.run_epoch(ep)[0] for ep in (2, 3)], whole["losses"][2:],
                               rtol=1e-5)
    # the single-device checkpoint on the mesh
    for r in ranks:
        assert r["mf_from_single"]["start"] == 2
        np.testing.assert_allclose(r["mf_from_single"]["losses"], single_ckpt["losses"][2:],
                                   rtol=1e-5)


def test_retriever_on_a_mesh_equals_one_device(ranks, cases):
    c = cases["retriever"]
    r = Retriever(c["user_emb"], c["item_emb"], c["id2user"], c["id2item"], c["rated_pad"],
                  device="cpu")
    ids, scores = r.topk(c["users"], k=c["k"])
    for rank in ranks:
        np.testing.assert_array_equal(rank["retriever"]["ids"], ids)
        np.testing.assert_allclose(rank["retriever"]["scores"], scores, rtol=1e-6)
        assert rank["retriever"]["local_rows"] == 26  # 101 items over 4 ranks, padded


def test_dryrun_phases_pass_on_every_rank(ranks):
    for r in ranks:
        d = r["dryrun"]
        assert d["main"]["mesh"] == (2, 2) and d["balanced"]["mesh"] == (1, 4)
        assert d["main"]["cf_slots"] < d["main"]["cf_nnz"]
        assert d["cached"]["age"] > 0 and d["topk"]["model"] == 2


def test_ranks_run_gloo_without_jax(ranks):
    assert [r["rank"] for r in ranks] == list(range(N_RANKS))
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert [r["leaked"] for r in ranks] == [[]] * N_RANKS
