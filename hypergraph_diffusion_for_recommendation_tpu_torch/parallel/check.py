"""The collective layer run on every rank on given inputs: the target
that `utils.platform.run_ranks` starts for the tests (held against the
JAX package) and for `chip_smoke.py` (held against one device).

`run_cases(mesh_shape, device, cases, reps)` builds the (data, model)
mesh, runs each case and returns, per rank, numpy results (a table's
gradient as this rank's row block; the caller reassembles the blocks in
model-rank order), the rank's backend, device and mesh coordinate, the
modules of JAX it has loaded (none), and with `reps` > 0 the median
milliseconds of `reps` more calls of each case's function.

A case is a dict with "kind" and numpy inputs:
  * "lookup": table [E, d], idx [B], weight [B, d] — `spmd_sharded_lookup`
    rows and the gradient of sum(sin(rows) * weight) in this rank's block;
  * "a2a": the same inputs and "capacity_factor" — `spmd_a2a_lookup` rows
    of this rank's batch slice, the overflow count, and the gradient of its
    slice's sum(sin(rows) * weight) (the slices' losses add up to the
    whole batch's);
  * "scatter_add": table, idx, updates — `sharded_scatter_add` into this
    rank's block;
  * "user_topk": users [B, d], items [I, d], rated [B, m], k —
    `sharded_user_topk`;
  * "distributed_topk": scores [B, I] (I divisible by the model axis), k —
    `distributed_topk` over this rank's column slice;
  * "param_shardings": shapes {name: shape}, min_rows — each name's
    placement, "row" or "replicated";
  * "sharded_mf": n_users, n_items, dim, lrate, seed, optional tables (the
    full padded initial tables), users/pos/neg [steps, B] — the losses of
    `ShardedMF.train_step` and the final (user, item) embeddings;
  * "shard_sparse": rows, cols, vals, shape, mode, attach, x [ncols, d],
    weight [nrows, d], optional env (layout variables set around the build),
    bf16 and linear — this rank's `ShardedCOO` fields, its packed layout's
    fields and kernel, the pooled layout decision, `sharded_spmm`'s product
    and the X-gradient of sum(sin(y) * weight) (with `linear`, of
    sum(y * weight): A^T weight, whatever the forward's rounding), the
    wrapper's launches of one product and of its forward and backward;
  * "sharded_pair": rows, cols, vals, shape, mode, x, key, keep — through
    `shard_adj_pair`: A^T (A x) by `spmm_pair` and its X-gradient, the
    dropped values of both directions and their packed layouts, and
    `sharded_with_new_vals` (values doubled) on both;
  * "trainer": model, cfg (make_config overrides), data (synthetic_dataset
    arguments, with hub_users/hub_degree for a power-law head), shard, social,
    epochs, optional state (the module's initial state dict, host tensors),
    batches (per epoch, the injected batches: an alternating model's CF
    batches, then its KG batches), save_dir / save_at (rank 0 saves the
    checkpoint after that epoch), restore_dir, first_step (record every
    step's loss and this rank's share of it, per phase), steps (run only
    the first `steps` steps of each phase of epoch 0, not whole epochs) —
    the epoch losses, the recorded steps, `data_split`, `evaluate()`, the
    single-device evaluation of the same embeddings, the tables, the
    sharded names and the parameters' and Adam state's local shapes, the
    sharded adjacencies' local edge slots;
  * "step_flops": model, cfg, data, social — the FLOPs of one step of each
    phase (`utils.profiling.cost_analysis` of `Trainer.train_step`) on this
    rank, built for the mesh, and built for one device, on the same batch;
  * "gather_shares": x [n, d] (the whole), temp — `gather_shares` of this
    data rank's rows of x against `all_gather_cat`'s, and the gradient of
    this rank's share of an InfoNCE of the gathered rows (`info_nce(rows=)`)
    with respect to its rows;
  * "sharded_lightgcn": norm_adj (scipy), n_users, n_items, dim, n_layers,
    lrate, optional table, users/pos/neg [steps, B] — the losses and the
    final propagated tables of `ShardedLightGCN`;
  * "retriever": user_emb, item_emb, id2user, id2item, rated_pad, users,
    k — `Retriever(mesh=)` ids and scores;
  * "dryrun": the phases of `dryrun_multichip` at the sizes given.

A case may carry its own "mesh" (data, model); the others run on
`mesh_shape`.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, reps: int, device: torch.device):
    """fn() once for the result, then the median ms of `reps` more calls."""
    out = fn()
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, (statistics.median(times) if times else None)


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _lookup(mesh, device, case, reps):
    from .embedding import spmd_sharded_lookup
    from .mesh import row_block

    table = row_block(_t(case["table"], device, torch.float32), mesh).requires_grad_()
    idx = _t(case["idx"], device)
    w = _t(case["weight"], device, torch.float32)

    def step():
        table.grad = None
        rows = spmd_sharded_lookup(table, idx, mesh)
        (torch.sin(rows) * w).sum().backward()
        return rows

    rows, ms = _timed(step, reps, device)
    return dict(rows=rows.detach().cpu().numpy(), grad=table.grad.cpu().numpy(), ms=ms)


def _a2a(mesh, device, case, reps):
    from .embedding import spmd_a2a_lookup
    from .mesh import MODEL_AXIS, row_block

    table = row_block(_t(case["table"], device, torch.float32), mesh).requires_grad_()
    idx = _t(case["idx"], device)
    w = _t(case["weight"], device, torch.float32)
    b_loc = idx.shape[0] // mesh.shape[mesh.mesh_dim_names.index(MODEL_AXIS)]
    r = mesh.get_local_rank(MODEL_AXIS)
    w_loc = w[r * b_loc:(r + 1) * b_loc]

    def step():
        table.grad = None
        rows, overflow = spmd_a2a_lookup(table, idx, mesh, case.get("capacity_factor", 2.0))
        (torch.sin(rows) * w_loc).sum().backward()
        return rows, overflow

    (rows, overflow), ms = _timed(step, reps, device)
    return dict(rows=rows.detach().cpu().numpy(), overflow=int(overflow),
                grad=table.grad.cpu().numpy(), ms=ms)


def _scatter_add(mesh, device, case, reps):
    from .embedding import sharded_scatter_add
    from .mesh import MODEL_AXIS, row_block

    table = row_block(_t(case["table"], device, torch.float32), mesh)
    out, ms = _timed(lambda: sharded_scatter_add(
        table, _t(case["idx"], device), _t(case["updates"], device, torch.float32),
        mesh.get_group(MODEL_AXIS)), reps, device)
    return dict(block=out.cpu().numpy(), ms=ms)


def _user_topk(mesh, device, case, reps):
    from .mesh import row_block
    from .topk import sharded_user_topk

    items = np.asarray(case["items"])
    local = row_block(_t(items, device, torch.float32), mesh)
    users = _t(case["users"], device, torch.float32)
    rated = _t(case["rated"], device)
    (vals, ids), ms = _timed(lambda: sharded_user_topk(mesh, users, local, rated, case["k"],
                                                       items.shape[0]), reps, device)
    return dict(vals=vals.cpu().numpy(), ids=ids.cpu().numpy(), ms=ms)


def _distributed_topk(mesh, device, case, reps):
    from ..ops.topk import distributed_topk
    from .mesh import MODEL_AXIS

    scores = _t(case["scores"], device, torch.float32)
    group = mesh.get_group(MODEL_AXIS)
    cols = scores.shape[1] // dist.get_world_size(group)
    r = dist.get_rank(group)
    local = scores[:, r * cols:(r + 1) * cols]
    (vals, ids), ms = _timed(lambda: distributed_topk(local, case["k"], group, r * cols),
                             reps, device)
    return dict(vals=vals.cpu().numpy(), ids=ids.cpu().numpy(), ms=ms)


def _param_shardings(mesh, device, case, reps):
    from torch.distributed.tensor import Shard

    from .mesh import param_shardings

    params = {k: torch.empty(tuple(s), device="meta") for k, s in case["shapes"].items()}
    out = param_shardings(params, mesh, case.get("min_rows", 1024))
    return {k: "row" if any(isinstance(p, Shard) for p in v) else "replicated"
            for k, v in out.items()}


def _sharded_mf(mesh, device, case, reps):
    from .sharded_mf import ShardedMF

    tables = case.get("tables")
    mf = ShardedMF(mesh, case["n_users"], case["n_items"], case["dim"], lrate=case["lrate"],
                   seed=case.get("seed", 0), tables=tables, device=device)
    users, pos, neg = (np.asarray(case[k]) for k in ("users", "pos", "neg"))
    losses, times = [], []
    for s in range(users.shape[0]):
        _sync(device)
        t0 = time.perf_counter()
        losses.append(mf.train_step(users[s], pos[s], neg[s]))
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    u, i = mf.embeddings()
    return dict(losses=losses, user=u, item=i, ms=statistics.median(times))


def _launches() -> dict:
    from ..ops.kernels.segment_spmm import LAUNCHES

    return dict(LAUNCHES)


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


class layout_env:
    """Layout variables set around a build, restored after."""

    def __init__(self, env: dict | None):
        self.env = env or {}

    def __enter__(self):
        import os

        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


_LAYOUT_FIELDS = ("cols", "vals", "local_rows", "wmap", "src", "canon", "ucols", "local_cols")


def _layout(b) -> dict | None:
    if b is None:
        return None
    out = {f: _np(getattr(b, f)) for f in _LAYOUT_FIELDS}
    out.update(n_blocks=b.n_blocks, dedup=b.dedup, int8=b.int8, bf16=b.bf16, nrows=b.nrows)
    return out


def layout_bytes(b) -> int:
    """Bytes of a packed layout's tensors on its device."""
    return sum(t.numel() * t.element_size() for t in vars(b).values() if torch.is_tensor(t))


def _shard_fields(sp) -> dict:
    return dict(lrows=_np(sp.lrows), cols=_np(sp.cols), vals=_np(sp.vals), canon=_np(sp.canon),
                rps=sp.rps, nnz=sp.nnz, balanced=sp.balanced, e_pad=int(sp.lrows.shape[0]),
                shard=sp.shard, layout=_layout(sp.blocked),
                bytes=None if sp.blocked is None else layout_bytes(sp.blocked))


def _shard_sparse(mesh, device, case, reps):
    from .sharded_adj import shard_sparse, sharded_spmm

    with layout_env(case.get("env")):
        sp = shard_sparse(case["rows"], case["cols"], case["vals"], case["shape"], mesh,
                          attach_blocked=case.get("attach"), mode=case.get("mode", "auto"),
                          device=device, bf16=case.get("bf16", False))
    out = _shard_fields(sp)
    if not case.get("fields", True):  # the bytes, not the arrays
        out = {k: v for k, v in out.items() if k not in ("lrows", "cols", "vals", "canon")}
        out["layout"] = {k: v for k, v in (out["layout"] or {}).items()
                         if k not in _LAYOUT_FIELDS} or None
    x = _t(case["x"], device, torch.float32).requires_grad_()
    w = _t(case["weight"], device, torch.float32)
    before = _launches()
    y = sharded_spmm(sp, x)
    out["launches_fwd"] = _launched(before)
    ((y if case.get("linear") else torch.sin(y)) * w).sum().backward()
    out["launches_step"] = _launched(before)
    if case.get("outputs", True) or dist.get_rank() == 0:
        out.update(y=_np(y), grad=_np(x.grad))
    if reps:
        from ..ops.kernels.segment_spmm import blocked_spmm

        with torch.no_grad():
            _, out["ms"] = _timed(lambda: sharded_spmm(sp, x), reps, device)
            if sp.blocked is not None:
                local = lambda: blocked_spmm(sp.blocked, x)  # noqa: E731
                _, out["local_ms"] = _timed(local, reps, device)
                # and with the card to itself: the ranks take turns, the
                # others waiting at a barrier
                for r in range(dist.get_world_size()):
                    dist.barrier()
                    if r == dist.get_rank():
                        _, out["local_alone_ms"] = _timed(local, reps, device)
                dist.barrier()
    return out


def _sharded_pair(mesh, device, case, reps):
    from ..ops.sparse import spmm, spmm_pair
    from .sharded_adj import shard_adj_pair, sharded_with_new_vals

    with layout_env(case.get("env")):
        pair = shard_adj_pair(case["rows"], case["cols"], case["vals"], case["shape"], mesh,
                              mode=case.get("mode", "auto"), device=device,
                              attach_blocked=case.get("attach"))
    x = _t(case["x"], device, torch.float32).requires_grad_()
    z = spmm_pair(pair.bwd, pair.fwd, spmm_pair(pair.fwd, pair.bwd, x))
    torch.sin(z).sum().backward()
    key = tuple(int(k) for k in case["key"])
    dropped = pair.dropped(key, case["keep"])
    with torch.no_grad():
        y_drop = spmm(dropped.fwd, x)
    out = dict(z=_np(z), grad=_np(x.grad), y_drop=_np(y_drop),
               fwd=_shard_fields(pair.fwd), bwd=_shard_fields(pair.bwd),
               drop_fwd=_np(dropped.fwd.vals), drop_bwd=_np(dropped.bwd.vals),
               drop_fwd_packed=_np(getattr(dropped.fwd.blocked, "vals", None)),
               drop_bwd_packed=_np(getattr(dropped.bwd.blocked, "vals", None)))
    new = sharded_with_new_vals(pair.fwd, pair.fwd.vals * 2.0)
    out["new_vals_packed"] = _np(getattr(new.blocked, "vals", None))
    return out


def _dataset(spec: dict):
    """synthetic_dataset(**spec), with `hub_users` users given `hub_degree`
    extra train edges each (the power-law head of the JAX
    `_build_flagship`, __graft_entry__.py:39-54)."""
    from ..data import synthetic_dataset

    spec = dict(spec)
    hub_users, hub_degree = spec.pop("hub_users", 0), spec.pop("hub_degree", 0)
    train, test, kg_df = synthetic_dataset(**spec)
    if hub_users:
        rng = np.random.default_rng(123)
        offset = int(min(train[:, 0].min(), test[:, 0].min()))
        hubs = np.repeat(np.arange(hub_users) + offset, hub_degree)
        items = rng.integers(0, spec["n_items"], hubs.shape[0])
        train = np.unique(np.concatenate([train, np.stack([hubs, items], axis=1)]), axis=0)
    return train, test, kg_df


def build_on_mesh(name: str, cfg_kw: dict, data: dict, mesh, device, shard: bool = True,
                  social: bool = False):
    """(cfg, bundle) of `name` on synthetic data, built for `mesh` with the
    adjacencies of `model_shard_needs(name)` sharded when `shard`; with
    `social`, on the synthetic trust network of `data.synthetic_social`."""
    from ..core.config import make_config
    from ..data import (
        build_cf_device_data,
        build_interaction,
        build_kg_device_data,
        build_knowledge,
        build_social,
        synthetic_social,
    )
    from ..models import build_model, model_data_needs, model_shard_needs

    cfg = make_config(name, **cfg_kw)
    train, test, kg_df = _dataset(data)
    inter = build_interaction(train, test)
    needs = model_shard_needs(name) if shard and mesh is not None else frozenset()
    layout = dict(bf16=cfg.compute_dtype == "bfloat16", gather_layout=cfg.gather_layout)
    cf = build_cf_device_data(inter, device, eval_user_multiple=cfg.eval_user_batch,
                              needs=model_data_needs(name), mesh=mesh, shard_needs=needs,
                              **layout)
    kg = None
    if cfg.use_knowledge and kg_df is not None:
        kg = build_kg_device_data(build_knowledge(kg_df, inter), device, mesh=mesh,
                                  shard="kg" in needs, **layout)
    soc = build_social(synthetic_social(inter), inter) if social else None
    return cfg, build_model(cfg, cf, kg, social=soc, mesh=mesh)


def _local_slots(bundle) -> dict:
    """Edge slots this rank holds of each sharded adjacency."""
    from .sharded_adj import ShardedCOO

    out = {}
    for holder, fields in ((bundle.cf, ("adj", "b_hyper")), (bundle.kg, ("kg_adj",))):
        for f in fields:
            pair = getattr(holder, f, None) if holder is not None else None
            if pair is not None and isinstance(pair.fwd, ShardedCOO):
                out[f] = int(pair.fwd.lrows.shape[0])
    return out


def _trainer(mesh, device, case, reps):
    from ..eval.metrics import metrics_to_host, ranking_metrics
    from ..train import Trainer
    from ..utils.checkpoint import CheckpointManager

    cfg, bundle = build_on_mesh(case["model"], case["cfg"], case["data"], mesh, device,
                                case.get("shard", True), case.get("social", False))
    extras = None
    if case.get("state") is not None:
        extras = bundle.init(torch.Generator().manual_seed(cfg.seed))
        bundle.module.load_state_dict(case["state"])
    trainer = Trainer(bundle, extras=extras, mesh=mesh)
    start = 0
    if case.get("restore_dir"):
        start = trainer.restore(CheckpointManager(case["restore_dir"], background=False))
    batches = case.get("batches")
    steps = None
    if case.get("first_step"):
        steps = record_steps(trainer, timed=bool(case.get("steps")))
    losses, times, launches = [], [], {}
    for ep in range(start, case["epochs"]):
        if batches is not None:
            inject_batches(trainer, tuple(_t(b, device) for b in batches[ep]))
        before = _launches()
        _sync(device)
        t0 = time.perf_counter()
        if case.get("steps"):
            losses.append(run_steps(trainer, case["steps"]))
            n_steps = case["steps"] * len(trainer._phases)
        else:
            losses.append(trainer.run_epoch(ep)[0])
            n_steps = trainer.n_batches
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3 / n_steps)
        launches = _launched(before)
        if case.get("save_at") == ep:
            state = trainer.checkpoint_state(ep)
            if dist.get_rank() == 0:
                ckpt = CheckpointManager(case["save_dir"], background=False)
                ckpt.save(ep, state)
                ckpt.close()
            dist.barrier()  # the file is whole before any rank reads it
    metrics = trainer.evaluate()
    u, i = trainer.encode()
    single = metrics_to_host(ranking_metrics(u, i, bundle.cf.rated_pad, bundle.cf.eval_data,
                                             tuple(cfg.top_ns), block=cfg.eval_user_batch),
                             tuple(cfg.top_ns))
    adam = trainer.opt.state
    steps = None if steps is None else steps_on_host(steps)
    first = {k: (v[0] if v else None) for k, v in (steps or {}).items()}
    return dict(losses=losses, first_loss=first.get("cf"), first_share=first.get("cf_share"),
                kg_first_loss=first.get("kg"), kg_first_share=first.get("kg_share"),
                steps=steps, data_split=bundle.data_split, metrics=metrics,
                single=single, user=_np(u), item=_np(i),
                sharded=list(trainer.sharded), start=start, step_ms=times,
                epoch_launches=launches,
                shapes={n: tuple(p.shape) for n, p in zip(trainer._param_names, trainer._params)},
                adam_shapes={n: tuple(adam[p]["exp_avg"].shape)
                             for n, p in zip(trainer._param_names, trainer._params) if p in adam},
                slots=_local_slots(bundle), n_batches=trainer.n_batches,
                extras={k: v for k, v in trainer.extras.items() if not torch.is_tensor(v)})


def record_steps(trainer, timed: bool = False) -> dict:
    """Record, from now on, every step's loss ("cf", "kg": the trainer's, summed
    over the data group) and this rank's share of it ("cf_share", "kg_share": what
    the bundle's loss returned), per phase, as copies on the device (no sync:
    `steps_on_host` after the steps); with `timed`, also each step's wall
    milliseconds ("cf_ms", "kg_ms"; a sync a step)."""
    bundle = trainer.bundle
    rec = {f"{p}{k}": [] for p in ("cf", "kg") for k in ("", "_share", "_ms")}
    step = trainer.train_step

    def recorded(batch, edge_keys, phase="cf"):
        t0 = time.perf_counter()
        loss, aux = step(batch, edge_keys, phase)
        rec[phase].append(loss.detach().clone())
        if timed:
            _sync(loss.device)
            rec[f"{phase}_ms"].append((time.perf_counter() - t0) * 1e3)
        return loss, aux

    def shared(fn, phase):
        def wrapped(*a, **kw):
            loss, aux = fn(*a, **kw)
            rec[f"{phase}_share"].append(loss.detach().clone())
            return loss, aux

        return wrapped

    trainer.train_step = recorded
    bundle.batch_loss = shared(bundle.batch_loss, "cf")
    if bundle.kg_batch_loss is not None:
        bundle.kg_batch_loss = shared(bundle.kg_batch_loss, "kg")
    return rec


def steps_on_host(rec: dict) -> dict:
    """`record_steps`' record as host floats."""
    return {k: [float(x) for x in v] for k, v in rec.items()}


def inject_batches(trainer, epoch: tuple) -> None:
    """The trainer's next epoch runs on `epoch` (an alternating model's CF
    batches, then its KG batches) instead of sampling."""
    if trainer.bundle.alternating:
        trainer.sample_epoch = lambda: epoch[:3]
        trainer.sample_kg_epoch = lambda: epoch[3:]
    else:
        trainer.sample_epoch = lambda: epoch


def run_steps(trainer, n: int) -> float:
    """The first `n` steps of each phase of an epoch, as `run_epoch` begins it
    (no `end_epoch`); returns the sum of the phases' mean losses."""
    trainer.begin_epoch()
    total = trainer.run_phase(tuple(t[:n] for t in trainer.sample_epoch()))[0]
    if trainer.bundle.alternating:
        total += trainer.run_phase(tuple(t[:n] for t in trainer.sample_kg_epoch()), "kg")[0]
    return total


def _step_flops(mesh, device, case, reps):
    from ..train import Trainer
    from ..utils.profiling import cost_analysis

    out = {}
    for key, m in (("split", mesh), ("whole", None)):
        _, bundle = build_on_mesh(case["model"], case["cfg"], case["data"], m, device,
                                  shard=False, social=case.get("social", False))
        trainer = Trainer(bundle, mesh=m, graphs=False)
        # the first batch of each phase, the same on both sides: the trainers'
        # generators are seeded alike
        batches = {"cf": trainer.sample_epoch()}
        if bundle.alternating:
            batches["kg"] = trainer.sample_kg_epoch()
        keys = trainer.edge_keys()
        for phase, epoch in batches.items():
            cost = cost_analysis(trainer.train_step, tuple(t[0] for t in epoch), keys, phase)
            out.setdefault(phase, {})[key] = cost["flops"]
        if m is not None:
            out["data_split"] = bundle.data_split
    return out


def _gather_shares(mesh, device, case, reps):
    from ..ops.losses import info_nce, info_nce_masked
    from .mesh import DATA_AXIS, all_gather_cat, data_ranks, data_share, gather_shares

    x = _t(case["x"], device, torch.float32)
    n = x.shape[0]
    share = data_share(mesh, n)
    mine = x[share.rows].clone().requires_grad_()
    whole = gather_shares(mine, mesh, n)
    v1, v2 = whole.chunk(2, dim=1)
    loss = info_nce(v1, v2, case["temp"], rows=share.rows)
    loss.backward()
    with torch.no_grad():
        masked = info_nce_masked(v1, v2, _t(case["valid"], device), case["temp"], share.rows)
    out = dict(gathered=_np(whole), loss=float(loss.detach()), masked=float(masked),
               grad=_np(mine.grad), rows=(share.rows.start, share.rows.stop))
    if n % data_ranks(mesh) == 0:  # equal shares: the plain all-gather's rows
        out["all_gather_cat"] = _np(all_gather_cat(mine.detach(), mesh.get_group(DATA_AXIS)))
    return out


def _sharded_lightgcn(mesh, device, case, reps):
    from .sharded_gcn import ShardedLightGCN

    model = ShardedLightGCN(mesh, case["norm_adj"], case["n_users"], case["n_items"],
                            case["dim"], case.get("n_layers", 2), lrate=case["lrate"],
                            seed=case.get("seed", 0), table=case.get("table"), device=device)
    users, pos, neg = (np.asarray(case[k]) for k in ("users", "pos", "neg"))
    losses, times = [], []
    before = _launches()
    for s in range(users.shape[0]):
        _sync(device)
        t0 = time.perf_counter()
        losses.append(model.train_step(users[s], pos[s], neg[s]))
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _launched(before)
    u, i = model.embeddings()
    return dict(losses=losses, user=u, item=i, table=_np(model.table), launches=launches,
                ms=statistics.median(times))


def _retriever(mesh, device, case, reps):
    from ..eval.serving import Retriever

    r = Retriever(case["user_emb"], case["item_emb"], case["id2user"], case["id2item"],
                  case.get("rated_pad"), block=case.get("block", 1024), device=device,
                  mesh=mesh)
    ids, scores = r.topk(case["users"], k=case["k"])
    return dict(ids=ids, scores=scores, local_rows=int(r.item_emb.shape[0]))


def _dryrun(mesh, device, case, reps):
    return dryrun_phases(device, case)


_CASES = {"lookup": _lookup, "a2a": _a2a, "scatter_add": _scatter_add, "user_topk": _user_topk,
          "distributed_topk": _distributed_topk, "param_shardings": _param_shardings,
          "sharded_mf": _sharded_mf, "shard_sparse": _shard_sparse,
          "sharded_pair": _sharded_pair, "trainer": _trainer,
          "sharded_lightgcn": _sharded_lightgcn, "retriever": _retriever, "dryrun": _dryrun,
          "step_flops": _step_flops, "gather_shares": _gather_shares}

# the sizes of `dryrun_multichip`'s phases: the JAX package's
# (__graft_entry__.py:97-238) and a CPU-test cut
DRYRUN_FULL = dict(
    main=dict(data=dict(n_users=768, n_items=1536, mean_degree=16.0),
              cfg=dict(batch_size=512, batch_size_kg=1024)),
    balanced=dict(data=dict(n_users=384, n_items=768, mean_degree=12.0, hub_users=32,
                            hub_degree=288), cfg=dict(batch_size=512, batch_size_kg=512)),
    cached=dict(data=dict(n_users=256, n_items=512, mean_degree=10.0),
                cfg=dict(batch_size=256, batch_size_kg=512, prop_cache_steps=4)),
    hyper_dim=32)
DRYRUN_TINY = dict(
    main=dict(data=dict(n_users=96, n_items=160, mean_degree=8.0),
              cfg=dict(batch_size=128, batch_size_kg=256)),
    balanced=dict(data=dict(n_users=96, n_items=160, mean_degree=6.0, hub_users=8,
                            hub_degree=96), cfg=dict(batch_size=128, batch_size_kg=256)),
    cached=dict(data=dict(n_users=64, n_items=128, mean_degree=6.0),
                cfg=dict(batch_size=64, batch_size_kg=128, prop_cache_steps=4)),
    hyper_dim=16)


def _flagship(mesh, device, phase: dict, hyper_dim: int, shard: bool = True):
    data = dict(phase["data"], seed=0, with_kg=True)
    cfg = dict(phase["cfg"], hyper_dim=hyper_dim, relation_dim=hyper_dim, item_ranking=(10, 20),
               eval_user_batch=64, shard_min_rows=16)
    return build_on_mesh("KHGRec", cfg, data, mesh, device, shard)


def dryrun_phases(device, sizes: dict) -> dict:
    """`dryrun_multichip`'s phases on this rank (every rank runs them):
      1. the flagship KHGRec with the CF and KG adjacencies sharded over the
         auto-factored mesh, two epochs, then `evaluate()` equal to the
         single-device evaluation of the same embeddings within 1e-6;
      2. the power-law graph on a (world / 4, 4) mesh: auto must pick the
         balanced mode; one epoch and the same evaluation check;
      3. cached propagation (prop_cache_steps 4) over the mesh, two epochs,
         the age threaded through them;
      4. the distributed top-k's ids bit for bit against the plain ranking
         (`score_topk_reference`: the scores, the mask and a stable sort).
    Returns what each phase measured."""
    from ..eval.metrics import metrics_to_host, ranking_metrics
    from ..ops.kernels.score_topk import score_topk_reference
    from ..train import Trainer
    from .mesh import MODEL_AXIS, make_mesh, row_block
    from .sharded_adj import ShardedCOO
    from .topk import sharded_user_topk

    world = dist.get_world_size()
    mesh = make_mesh(device=device)
    out = {}

    def same_eval(trainer, bundle, cfg, tag):
        got = trainer.evaluate()
        u, i = trainer.encode()
        ref = metrics_to_host(ranking_metrics(u, i, bundle.cf.rated_pad, bundle.cf.eval_data,
                                              tuple(cfg.top_ns), block=cfg.eval_user_batch),
                              tuple(cfg.top_ns))
        for n in got:
            for k, v in got[n].items():
                if abs(v - ref[n][k]) >= 1e-6:
                    raise AssertionError(f"{tag}: evaluate() {n} {k} {v} != {ref[n][k]}")
        return got

    cfg, bundle = _flagship(mesh, device, sizes["main"], sizes["hyper_dim"])
    if not (isinstance(bundle.cf.adj.fwd, ShardedCOO)
            and isinstance(bundle.kg.kg_adj.fwd, ShardedCOO)):
        raise AssertionError("the CF and KG adjacencies were not sharded")
    trainer = Trainer(bundle, mesh=mesh)
    losses = [trainer.run_epoch(ep)[0] for ep in range(2)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    out["main"] = dict(mesh=tuple(mesh.shape), losses=losses,
                       recall=same_eval(trainer, bundle, cfg, "main")[20]["recall"],
                       cf_nnz=bundle.cf.adj.fwd.nnz, cf_slots=int(bundle.cf.adj.fwd.lrows.shape[0]),
                       kg_nnz=bundle.kg.kg_adj.fwd.nnz,
                       kg_slots=int(bundle.kg.kg_adj.fwd.lrows.shape[0]))

    mesh_b = make_mesh(max(world // 4, 1), min(4, world), device=device)
    cfg_b, bundle_b = _flagship(mesh_b, device, sizes["balanced"], sizes["hyper_dim"])
    if not bundle_b.cf.adj.fwd.balanced:
        raise AssertionError("auto did not pick the balanced mode on the power-law graph")
    trainer_b = Trainer(bundle_b, mesh=mesh_b)
    loss_b = trainer_b.run_epoch(0)[0]
    if not np.isfinite(loss_b):
        raise AssertionError(f"non-finite balanced loss {loss_b}")
    out["balanced"] = dict(mesh=tuple(mesh_b.shape), loss=loss_b,
                           recall=same_eval(trainer_b, bundle_b, cfg_b, "balanced")[20]["recall"],
                           cf_nnz=bundle_b.cf.adj.fwd.nnz)

    cfg_c, bundle_c = _flagship(mesh, device, sizes["cached"], sizes["hyper_dim"], shard=False)
    trainer_c = Trainer(bundle_c, mesh=mesh)
    loss_c = [trainer_c.run_epoch(ep)[0] for ep in range(2)]
    if not all(np.isfinite(loss_c)) or trainer_c.extras["prop_age"] != 2 * trainer_c.n_batches:
        raise AssertionError(f"cached propagation over the mesh: losses {loss_c}, age "
                             f"{trainer_c.extras['prop_age']}")
    out["cached"] = dict(losses=loss_c, age=trainer_c.extras["prop_age"])

    u, i = trainer.encode()
    users = bundle.cf.eval_data.test_users[:64].long()
    rated = bundle.cf.rated_pad
    _, ids = sharded_user_topk(mesh, u[users], row_block(i, mesh), rated[users], 10, i.shape[0])
    _, ref = score_topk_reference(u, users, i, rated, 10)
    if not torch.equal(ids, ref):
        raise AssertionError("distributed top-k differs from the plain ranking")
    out["topk"] = dict(users=int(users.shape[0]), model=mesh.shape[mesh.mesh_dim_names.index(
        MODEL_AXIS)])
    return out


def dryrun_multichip(n: int, device: str | None = None, sizes: dict | None = None) -> list:
    """The port's counterpart of the JAX `__graft_entry__.dryrun_multichip`:
    `n` ranks (`utils.platform.run_ranks`) run `dryrun_phases` at `sizes`
    (default `DRYRUN_FULL`); returns each rank's results, or raises with the
    first failed rank's error."""
    from ..core.device import resolve_device
    from ..utils.platform import run_ranks

    case = dict(DRYRUN_FULL if sizes is None else sizes, kind="dryrun")
    device = resolve_device(device).type
    return run_ranks(n, run_cases, (0, 0), device, {"dryrun": case}, device=device)


def run_cases(mesh_shape: tuple[int, int], device: str, cases: dict, reps: int = 0) -> dict:
    """The target of `run_ranks`: every case on this rank (see the module)."""
    from .mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    meshes = {tuple(mesh_shape): make_mesh(*mesh_shape, device=dev)}
    mesh = meshes[tuple(mesh_shape)]
    out = dict(rank=dist.get_rank(), backend=dist.get_backend(), device=str(dev),
               coordinate=tuple(mesh.get_coordinate()))
    for name, case in cases.items():
        shape = tuple(case.get("mesh", mesh_shape))
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device=dev)
        out[name] = _CASES[case["kind"]](meshes[shape], dev, case, reps)
    out["leaked"] = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "hypergraph_diffusion_for_recommendation_tpu"))
    return out
