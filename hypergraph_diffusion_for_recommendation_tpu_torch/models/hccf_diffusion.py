"""HCCF_diffusion — HCCF with the hyperedge branch replaced by ED-HNN
diffusion over the dense learnable incidence (the port of the JAX
package's `models/hccf_diffusion.py`; reference
model/graph/HCCF_diffusion.py:130-216).

The GCN branch and the loss are HCCF's (`models/hccf.py`): the one-hop
product on the edge-dropped normalised adjacency, a fresh drop each layer
(one edge key a layer), through the one-sided `spmm` (a kernel forward, a
torch-ops backward: a step launches n_layers kernels, an encode as many).
Each layer's user and item hyper embeddings come from one shared
`DenseEquivSetGNN` over hidden[:U] with the incidence dropout(U W_u)
(and the items'), in place of HCCF's two dense products. The reference
extracts dynamic V/E lists from `nonzero(H > 0)` (:317-341); the static
form is the masked dense scatter mean. Loss = BPR + cl_rate * the per-layer
contrast of the detached GCN side against the hyper side; gradients
clipped to a global norm of 4.

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
from .layers import DenseEquivSetGNN, FlaxNamed


class HCCFDiffusionModule(FlaxNamed):
    """Parameters under flax's names: `user_emb`, `item_emb` [n, d],
    `user_w`, `item_w` [d, n_edges], `DenseEquivSetGNN_0`."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_edges: int, n_layers: int,
                 drop_rate: float):
        super().__init__()
        self.n_users, self.n_layers, self.drop_rate = n_users, n_layers, drop_rate
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.user_w = nn.Parameter(torch.empty(dim, n_edges))
        self.item_w = nn.Parameter(torch.empty(dim, n_edges))
        self._new("DenseEquivSetGNN", DenseEquivSetGNN(dim, input_dropout=0.6, dropout=0.5,
                                                       alpha=0.0))

    def forward(self, cf: CFDeviceData, keep_rate: float = 1.0, edge_keys=None,
                generator: torch.Generator | None = None):
        """`edge_keys` (training): one edge-dropout key a layer, and feature
        dropout from `generator`; None: the full graph, no dropout. Returns
        (users, items, gcn_k list, hgnn_k list)."""
        train = edge_keys is not None
        n_u = self.n_users
        edhnn = self.DenseEquivSetGNN_0
        hyper_uu = self.user_emb @ self.user_w
        hyper_ii = self.item_emb @ self.item_w
        hidden = [torch.cat([self.user_emb, self.item_emb])]
        gcn_hidden, hgnn_hidden = [], []
        for k in range(self.n_layers):
            adj = cf.adj.dropped(edge_keys[k], keep_rate) if train and keep_rate < 1.0 else cf.adj
            gcn_emb = _sp.spmm(adj.fwd, hidden[-1])
            hu = edhnn(hidden[-1][:n_u],
                       feature_dropout(hyper_uu, self.drop_rate, generator, train), train,
                       generator)
            hi = edhnn(hidden[-1][n_u:],
                       feature_dropout(hyper_ii, self.drop_rate, generator, train), train,
                       generator)
            hyper_emb = torch.cat([hu, hi])
            gcn_hidden.append(gcn_emb)
            hgnn_hidden.append(hyper_emb)
            hidden.append(gcn_emb + hyper_emb)
        total = sum(hidden)
        return total[:n_u], total[n_u:], gcn_hidden, hgnn_hidden


@register_model("HCCF_diffusion")
def build_hccf_diffusion(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
    module = HCCFDiffusionModule(cf.n_users, cf.n_items, cfg.embedding_size, cfg.hyper_dim,
                                 cfg.n_layers, cfg.drop_rate).to(cf.edge_u.device)
    keep = 1.0 - cfg.drop_rate

    def batch_loss(extras: Extras, batch, edge_keys, generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        share = data_share(mesh, users.shape[0])
        rows = share.rows
        u_emb, i_emb, gcn_h, hgnn_h = module(cf, keep, edge_keys, generator)
        rec = share.part * bpr_loss(u_emb[users[rows]], i_emb[pos[rows]], i_emb[neg[rows]])
        uu, um = unique_mask(users)
        iu, im = unique_mask(pos)
        # one gather a view a layer, users and items stacked (as in HCCF)
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

    return ModelBundle(name="HCCF_diffusion", cfg=cfg, cf=cf, kg=None, uses_kg=False,
                       module=module, init=flax_init(module), encode_eval=encode_eval,
                       batch_loss=batch_loss, n_edge_keys=cfg.n_layers, grad_clip_norm=4.0,
                       data_split=data_ranks(mesh) > 1)
