"""Fully explicit sharded graph training engine — the port of the JAX
package's `parallel/sharded_gcn.py` (its `shard_map` LightGCN).

  layout:   the node table's rows as row blocks over the `model` axis; the
            normalised adjacency split by row window, each rank owning the
            edges whose DESTINATION rows it owns, packed for the
            segment-SpMM kernels
  step:     per layer, an all-gather of the row blocks over the model
            group, then this rank's window product into its own rows
            (`blocked_spmm`: kernel 1 on the card, its plain version on the
            CPU); the final embeddings are the mean over the layers'
            outputs (LightGCN.py:129-140)
  loss:     BPR on this data rank's slice of the batch, read from the
            all-gathered propagated table
  grads:    autograd through the collectives (`parallel.mesh`), summed over
            the data group and divided by its size; a local SGD step on the
            row block

Every model rank computes the same loss, so an all-gather's backward keeps
this rank's block of the gradient (`gather_rows`), and the window
product's operand sums its gradient over the group (`copy_to_group`): the
step is the dense single-device step. The JAX engine takes `jax.grad`
inside its `shard_map` body, where the all-gather transposes to a
`psum_scatter` that adds the model ranks' identical cotangents: its
gradient is the model-axis size times the dense one (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.losses import bpr_loss
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_reduce_,
    axis_size,
    copy_to_group,
    gather_rows,
    row_block,
)


def shard_rows_coo(rows, cols, vals, n_rows_pad: int, shards: int):
    """Split row-sorted COO into per-shard row windows (host-side).

    Returns (local_rows, cols, vals) each [shards, e_pad]: window-local
    destination rows (pad = rows_per_shard), source cols in GLOBAL ids,
    values (pad 0)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    live = rows < n_rows_pad
    rows, cols, vals = rows[live], cols[live], vals[live]
    rps = n_rows_pad // shards
    starts = np.searchsorted(rows, np.arange(shards) * rps)
    ends = np.append(starts[1:], rows.shape[0])
    e_pad = max(int((ends - starts).max()), 1)
    lr = np.full((shards, e_pad), rps, np.int32)
    cc = np.zeros((shards, e_pad), np.int32)
    vv = np.zeros((shards, e_pad), np.float32)
    for s in range(shards):
        lo, hi = int(starts[s]), int(ends[s])
        n = hi - lo
        lr[s, :n] = rows[lo:hi] - s * rps
        cc[s, :n] = cols[lo:hi]
        vv[s, :n] = vals[lo:hi]
    return lr, cc, vv


class ShardedLightGCN:
    """LightGCN with an explicitly sharded node table and row-split
    adjacency. `table`: the full initial node table, [padded nodes, dim]
    (the JAX package's, through `weights.sharded_lightgcn_from_jax`);
    without it the table is drawn from flax's Xavier-uniform with a
    generator seeded with `seed` (the same draw on every rank). `device`:
    where this rank keeps its block and computes."""

    def __init__(self, mesh, norm_adj, n_users: int, n_items: int, dim: int,
                 n_layers: int = 2, lrate: float = 0.05, seed: int = 0, table=None,
                 device=None):
        from ..core.device import resolve_device
        from ..ops.kernels.segment_spmm import pack_blocked
        from ..weights import _xavier_uniform

        self.device = resolve_device(device)
        self.mesh = mesh
        self.shards = axis_size(mesh, MODEL_AXIS)
        self.n_data = axis_size(mesh, DATA_AXIS)
        self.n_users = n_users
        self.n_items = n_items
        self.n_layers = n_layers
        self.lrate = lrate
        n_nodes = n_users + n_items
        self.n_pad = -(-n_nodes // self.shards) * self.shards
        self.rows_per_shard = self.n_pad // self.shards

        coo = norm_adj.tocoo()
        order = np.lexsort((coo.col, coo.row))
        lr, cc, vv = shard_rows_coo(coo.row[order], coo.col[order], coo.data[order],
                                    self.n_pad, self.shards)
        s = mesh.get_local_rank(MODEL_AXIS)
        # this rank's window, packed for the kernel (pad rows = rps drop out)
        self.adj = pack_blocked(lr[s], cc[s], vv[s], (self.rows_per_shard, self.n_pad),
                                device=self.device)
        if table is None:
            table = _xavier_uniform((self.n_pad, dim), torch.Generator().manual_seed(seed))
        table = torch.as_tensor(table, dtype=torch.float32)
        if table.shape != (self.n_pad, dim):
            raise ValueError(f"table {tuple(table.shape)}; expected {(self.n_pad, dim)}")
        self.table = row_block(table, mesh).to(self.device)
        self.model_group = mesh.get_group(MODEL_AXIS)
        self.data_group = mesh.get_group(DATA_AXIS)
        self.data_rank = mesh.get_local_rank(DATA_AXIS)

    def _propagate(self, tbl_loc: torch.Tensor) -> torch.Tensor:
        """The mean of the K layers' outputs, this rank's rows: [N / S, d]."""
        from ..ops.kernels.segment_spmm import blocked_spmm

        g = self.model_group
        acc = tbl_loc
        x_full = gather_rows(tbl_loc, g)
        for _ in range(self.n_layers):
            y_loc = blocked_spmm(self.adj, copy_to_group(x_full, g))
            acc = acc + y_loc
            x_full = gather_rows(y_loc, g)
        return acc / (self.n_layers + 1)

    def _data_slice(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(ids), device=self.device).long()
        if ids.shape[0] % self.n_data:
            raise ValueError(f"a batch of {ids.shape[0]} does not split over {self.n_data} "
                             "data ranks")
        b = ids.shape[0] // self.n_data
        return ids[self.data_rank * b:(self.data_rank + 1) * b]

    def train_step(self, users, pos, neg) -> float:
        """One SGD step on the global batch (the same ids on every rank; each
        data rank takes its slice). Returns the loss averaged over the data
        axis."""
        users, pos, neg = (self._data_slice(t) for t in (users, pos, neg))
        tbl = self.table.detach().requires_grad_()
        out = gather_rows(self._propagate(tbl), self.model_group)
        nu = self.n_users
        loss = bpr_loss(out[users], out[nu + pos], out[nu + neg])
        (grad,) = torch.autograd.grad(loss, (tbl,))
        with torch.no_grad():
            grad = all_reduce_(grad, self.data_group) / self.n_data
            self.table = self.table - self.lrate * grad
            mean = all_reduce_(loss.detach().clone(), self.data_group) / self.n_data
        return float(mean)

    @torch.no_grad()
    def embeddings(self) -> tuple[np.ndarray, np.ndarray]:
        """The propagated (user, item) tables, [n_users, d] and [n_items, d]
        (every rank of the mesh calls it)."""
        out = gather_rows(self._propagate(self.table), self.model_group).cpu().numpy()
        return out[: self.n_users], out[self.n_users : self.n_users + self.n_items]
