"""Fully explicit sharded embedding training engine — the port of the JAX
package's `parallel/sharded_mf.py`.

User and item tables are row-sharded over the `model` axis (each rank
holds its padded row block), batches are split over the `data` axis, and
each training step does

  lookup:   local-window gather + sum over the model axis
            (parallel/embedding.sharded_lookup — O(B*d) comms)
  grads:    per-rank scatter-add of the embedding gradients into the local
            table window (sharded_scatter_add), then a sum over the DATA
            axis only (each data replica saw different batch rows),
            divided by its size
  update:   plain SGD on the local windows — no table gather ever

and the loss is averaged over the data axis. The collective schedule is
exactly what is written, as in the JAX `shard_map` step. Used for BPR-MF
(the reference's base model).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.losses import bpr_loss
from .embedding import sharded_lookup, sharded_scatter_add
from .mesh import DATA_AXIS, MODEL_AXIS, all_gather_cat, all_reduce_, axis_size, row_block


def _pad_rows(n: int, shards: int) -> int:
    return -(-n // shards) * shards


class ShardedMF:
    """BPR-MF with explicitly sharded tables and collectives. `tables`:
    the full initial (user, item) tables, [padded rows, dim] each (the JAX
    package's, through `weights.sharded_mf_from_jax`); without them the
    tables are drawn from flax's Xavier-uniform with a generator seeded
    with `seed` (the same draw on every rank). `device`: where this rank
    keeps its blocks and computes (default: its card)."""

    def __init__(self, mesh, n_users: int, n_items: int, dim: int,
                 lrate: float = 0.05, seed: int = 0, tables=None, device=None):
        from ..core.device import resolve_device
        from ..weights import _xavier_uniform

        device = resolve_device(device)
        self.mesh = mesh
        self.shards = axis_size(mesh, MODEL_AXIS)
        self.n_data = axis_size(mesh, DATA_AXIS)
        self.n_users = n_users
        self.n_items = n_items
        self.dim = dim
        self.lrate = lrate
        u_rows = _pad_rows(n_users, self.shards)
        i_rows = _pad_rows(n_items, self.shards)
        if tables is None:
            gen = torch.Generator().manual_seed(seed)
            tables = (_xavier_uniform((u_rows, dim), gen), _xavier_uniform((i_rows, dim), gen))
        user_table, item_table = (torch.as_tensor(t, dtype=torch.float32) for t in tables)
        if user_table.shape != (u_rows, dim) or item_table.shape != (i_rows, dim):
            raise ValueError(f"tables {tuple(user_table.shape)}, {tuple(item_table.shape)}; "
                             f"expected {(u_rows, dim)}, {(i_rows, dim)}")
        self.user_table = row_block(user_table, mesh).to(device)
        self.item_table = row_block(item_table, mesh).to(device)
        self.model_group = mesh.get_group(MODEL_AXIS)
        self.data_group = mesh.get_group(DATA_AXIS)
        self.data_rank = mesh.get_local_rank(DATA_AXIS)

    def _data_slice(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(ids, device=self.user_table.device)
        if ids.shape[0] % self.n_data:
            raise ValueError(f"a batch of {ids.shape[0]} does not split over {self.n_data} "
                             "data ranks")
        b = ids.shape[0] // self.n_data
        return ids[self.data_rank * b:(self.data_rank + 1) * b]

    def train_step(self, users, pos, neg) -> float:
        """One SGD step on the global batch (the same ids on every rank;
        each data rank takes its slice). Returns the loss averaged over the
        data axis."""
        users, pos, neg = (self._data_slice(t) for t in (users, pos, neg))
        g = self.model_group
        with torch.no_grad():
            ue = sharded_lookup(self.user_table, users, g)
            pe = sharded_lookup(self.item_table, pos, g)
            ne = sharded_lookup(self.item_table, neg, g)
        ue, pe, ne = (t.requires_grad_() for t in (ue, pe, ne))
        loss = bpr_loss(ue, pe, ne)
        d_ue, d_pe, d_ne = torch.autograd.grad(loss, (ue, pe, ne))
        with torch.no_grad():
            # scatter embedding grads into the LOCAL table windows; each
            # data replica contributes its batch slice -> summed over data
            du = sharded_scatter_add(torch.zeros_like(self.user_table), users, d_ue, g)
            di = sharded_scatter_add(torch.zeros_like(self.item_table), pos, d_pe, g)
            di = sharded_scatter_add(di, neg, d_ne, g)
            du = all_reduce_(du, self.data_group) / self.n_data
            di = all_reduce_(di, self.data_group) / self.n_data
            self.user_table = self.user_table - self.lrate * du
            self.item_table = self.item_table - self.lrate * di
            mean = all_reduce_(loss.detach().clone(), self.data_group) / self.n_data
        return float(mean)

    def embeddings(self) -> tuple[np.ndarray, np.ndarray]:
        """The full tables [n_users, d], [n_items, d], gathered over the model
        axis (every rank of the axis calls it)."""
        g = self.model_group
        return (all_gather_cat(self.user_table, g).cpu().numpy()[: self.n_users],
                all_gather_cat(self.item_table, g).cpu().numpy()[: self.n_items])
