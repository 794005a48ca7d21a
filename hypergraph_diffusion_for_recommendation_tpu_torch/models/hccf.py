"""HCCF — hypergraph-contrastive collaborative filtering (the port of the
JAX package's `models/hccf.py`; reference model/graph/HCCF.py:135-226):

  * GCN branch: the one-hop A_drop @ h on the edge-dropped normalised
    adjacency, a fresh drop each layer (one edge key a layer,
    `n_edge_keys = n_layers`), through the one-sided `spmm`: a kernel
    forward, a torch-ops backward (the JAX `blocked_spmm` VJP), so a step
    launches n_layers kernels;
  * hyperedge branch: the learnable dense incidence E_u = U W_u [U, E]
    (and E_i), feature-dropped from the trainer's generator, applied as
    H (H^T h) (HGNNLayer :203-211);
  * hidden_{k+1} = gcn_k + hgnn_k; the tables are the sum of all hidden;
  * loss = BPR + cl_rate * sum_k contrast(gcn_k.detach(), hgnn_k) over the
    batch's unique users and items (:59-68); the gradients are clipped to
    a global norm of 4 (:94), and the early-stopping patience doubles.

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes BPR over its share of the batch and the contrasts' terms of its
share of the unique rows over every row's denominator
(`parallel.mesh.data_share`), from the propagation every rank runs whole
(its draws included).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from ..data.device import CFDeviceData
from ..ops import sparse as _sp
from ..ops.dropout import feature_dropout
from ..ops.losses import bpr_loss, contrast_loss_pregathered, unique_mask
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model


class HCCFModule(nn.Module):
    """Parameters under flax's names: `user_emb`, `item_emb` [n, d],
    `user_w`, `item_w` [d, n_edges]."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_edges: int, n_layers: int,
                 drop_rate: float):
        super().__init__()
        self.n_users, self.n_layers, self.drop_rate = n_users, n_layers, drop_rate
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.user_w = nn.Parameter(torch.empty(dim, n_edges))
        self.item_w = nn.Parameter(torch.empty(dim, n_edges))

    def forward(self, cf: CFDeviceData, keep_rate: float = 1.0, edge_keys=None,
                generator: torch.Generator | None = None):
        """`edge_keys` (training): one edge-dropout key a layer, and the
        incidences' feature dropout from `generator`; None: the full
        graph, no dropout. Returns (users, items, gcn_k list, hgnn_k list)."""
        train = edge_keys is not None
        n_u = self.n_users
        hyper_uu = self.user_emb @ self.user_w
        hyper_ii = self.item_emb @ self.item_w
        hidden = [torch.cat([self.user_emb, self.item_emb])]
        gcn_hidden, hgnn_hidden = [], []
        for k in range(self.n_layers):
            adj = cf.adj.dropped(edge_keys[k], keep_rate) if train and keep_rate < 1.0 else cf.adj
            gcn_emb = _sp.spmm(adj.fwd, hidden[-1])
            huu = feature_dropout(hyper_uu, self.drop_rate, generator, train)
            hii = feature_dropout(hyper_ii, self.drop_rate, generator, train)
            hu = huu @ (huu.T @ hidden[-1][:n_u])
            hi = hii @ (hii.T @ hidden[-1][n_u:])
            hyper_emb = torch.cat([hu, hi])
            gcn_hidden.append(gcn_emb)
            hgnn_hidden.append(hyper_emb)
            hidden.append(gcn_emb + hyper_emb)
        total = sum(hidden)
        return total[:n_u], total[n_u:], gcn_hidden, hgnn_hidden


@register_model("HCCF")
def build_hccf(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
    module = HCCFModule(cf.n_users, cf.n_items, cfg.embedding_size, cfg.hyper_dim, cfg.n_layers,
                        cfg.drop_rate).to(cf.edge_u.device)
    keep = 1.0 - cfg.drop_rate

    def batch_loss(extras: Extras, batch, edge_keys, generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        share = data_share(mesh, users.shape[0])
        rows = share.rows
        u_emb, i_emb, gcn_h, hgnn_h = module(cf, keep, edge_keys, generator)
        rec = share.part * bpr_loss(u_emb[users[rows]], i_emb[pos[rows]], i_emb[neg[rows]])
        uu, um = unique_mask(users)
        iu, im = unique_mask(pos)
        # one gather a view a layer, users and items stacked; the GCN side
        # is detached, as the reference detaches it (:63)
        ids = torch.cat([uu, cf.n_users + iu])
        b = users.shape[0]
        ssl = 0.0
        for g, h in zip(gcn_h, hgnn_h):
            gv, hv = g.detach()[ids], h[ids]
            ssl = ssl + contrast_loss_pregathered(gv[:b], hv[:b], um, cfg.temp, rows)
            ssl = ssl + contrast_loss_pregathered(gv[b:], hv[b:], im, cfg.temp, rows)
        ssl = cfg.cl_rate * ssl
        return rec + ssl, {"rec_loss": rec.detach(), "cl_loss": ssl.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module(cf)[:2]

    return ModelBundle(name="HCCF", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss,
                       n_edge_keys=cfg.n_layers, grad_clip_norm=4.0, early_stop_patience_scale=2,
                       data_split=data_ranks(mesh) > 1)
