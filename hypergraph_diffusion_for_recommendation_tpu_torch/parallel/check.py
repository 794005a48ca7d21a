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
    `ShardedMF.train_step` and the final (user, item) embeddings.
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


_CASES = {"lookup": _lookup, "a2a": _a2a, "scatter_add": _scatter_add, "user_topk": _user_topk,
          "distributed_topk": _distributed_topk, "param_shardings": _param_shardings,
          "sharded_mf": _sharded_mf}


def run_cases(mesh_shape: tuple[int, int], device: str, cases: dict, reps: int = 0) -> dict:
    """The target of `run_ranks`: every case on this rank (see the module)."""
    from .mesh import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(*mesh_shape, device=dev)
    out = dict(rank=dist.get_rank(), backend=dist.get_backend(), device=str(dev),
               coordinate=tuple(mesh.get_coordinate()))
    for name, case in cases.items():
        out[name] = _CASES[case["kind"]](mesh, dev, case, reps)
    out["leaked"] = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "hypergraph_diffusion_for_recommendation_tpu"))
    return out
