"""HGCN — a transformer over the node set, then the two-hop hypergraph
conv, per layer (the port of the JAX package's `models/hgcn.py`;
reference model/graph/HGCN.py:100-166): a two-head
`TransformerEncoderLayer` over every user and item row, then `hgcn_conv`
on the edge-dropped adjacency (activation off on the last layer); the ego
tables are added to the last layer's output only. Loss = BPR + L2 over
the batch rows / batch size (HGCN.py:51-53).

Training drops the adjacency's edges with one key a step (`n_edge_keys`
1) and the transformer's feature dropout draws from the trainer's
generator. The attention is [heads, N, N] over all U + I rows: stock
matmuls and a softmax, as XLA computes it.

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes BPR over its share of the batch (`parallel.mesh.data_share`),
from the propagation every rank runs whole (its draws included); the L2
norms, which couple the batch's rows, are computed whole at weight
1 / data ranks.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from ..data.device import CFDeviceData
from ..ops.losses import bpr_l2_share
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model
from .layers import FlaxNamed, TransformerEncoderLayer, hgcn_conv


class HGCNModule(FlaxNamed):
    """`user_emb`, `item_emb` and, in flax's names, `TransformerEncoderLayer_k`."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_layers: int, slope: float,
                 drop_rate: float):
        super().__init__()
        self.n_users, self.slope = n_users, slope
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.layers = [self._new("TransformerEncoderLayer",
                                 TransformerEncoderLayer(dim, 2, 32, drop_rate))
                       for _ in range(n_layers)]

    def forward(self, cf: CFDeviceData, keep_rate: float = 1.0, edge_key=None,
                generator: torch.Generator | None = None):
        """`edge_key` (training): edge dropout at `keep_rate` and the
        transformer's feature dropout from `generator`; None: the full
        graph, no dropout."""
        train = edge_key is not None
        ego = torch.cat([self.user_emb, self.item_emb])
        res = ego
        adj = cf.adj.dropped(edge_key, keep_rate) if train and keep_rate < 1.0 else cf.adj
        last = len(self.layers) - 1
        for k, name in enumerate(self.layers):
            ego = getattr(self, name)(ego, train, generator)
            ego = hgcn_conv(adj, ego, self.slope, act=k != last)
        ego = ego + res
        return ego[: self.n_users], ego[self.n_users :]


@register_model("HGCN")
def build_hgcn(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
    module = HGCNModule(cf.n_users, cf.n_items, cfg.hyper_dim, cfg.n_layers, cfg.p,
                        cfg.drop_rate).to(cf.edge_u.device)
    keep = 1.0 - cfg.drop_rate

    def batch_loss(extras: Extras, batch, edge_keys, generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        u_emb, i_emb = module(cf, keep, edge_keys[0], generator)
        rec, reg = bpr_l2_share(data_share(mesh, users.shape[0]), cfg.reg, cfg.batch_size,
                                u_emb[users], i_emb[pos], i_emb[neg])
        return rec + reg, {"rec_loss": rec.detach(), "reg_loss": reg.detach()}

    return ModelBundle(name="HGCN", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=flax_init(module), encode_eval=torch.no_grad()(lambda extras: module(cf)),
                       batch_loss=batch_loss, n_edge_keys=1, data_split=data_ranks(mesh) > 1)
