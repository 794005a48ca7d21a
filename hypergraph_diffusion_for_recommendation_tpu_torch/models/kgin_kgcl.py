"""KGIN and KGCL — the port of the JAX package's `models/kgin_kgcl.py`
(the reference has them only as notebooks, KGIN.ipynb and KGCL.ipynb; the
JAX package wrote compact forms of the papers' mechanisms):

  KGIN  K latent intents as softmax mixtures over the relation embeddings;
        entities aggregate relational KG messages (r * e_t, a segment mean
        per head) over n_layers hops; users add their intent gate times the
        row-normalised sum of their items' tables (`spmm_pair` on the U x I
        `int_norm`: one kernel launch forward, one backward); BPR + L2 /
        batch + cl_rate * intent independence (mean pairwise |cosine|).
  KGCL  items enriched with a one-hop relational KG summary, LightGCN over
        the CF adjacency from [users, enriched items], two edge-dropped
        views (two edge keys) contrasted with InfoNCE on the batch's unique
        users and items; three passes of `spmm_pair`, so 6K launches a step.

The KG segment means run over the sorted `att_*` edge list; its pads
(head == n_entities) clamp into the last entity with a zero message, and
count in that entity's mean, as in JAX.

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes BPR over its share of the batch and KGCL's InfoNCE terms of its
share of the unique rows over every row's denominator
(`parallel.mesh.data_share`), from the propagation every rank runs whole
(the views' edge dropout included, keyed alike on every rank); the L2
norms and KGIN's intent independence, which reads no batch row, are
computed whole at weight 1 / data ranks.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from ..data.device import CFDeviceData, KGDeviceData
from ..ops.losses import bpr_l2_share, info_nce_masked, unique_mask
from ..ops.sparse import gather_rows_hubs, scatter_sum_hubs, spmm_pair
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model

N_INTENTS = 4


def _kg_message(kg: KGDeviceData, rel: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """mean over each head's KG edges of r * e_tail ([n_entities, d]).

    A relation id repeats over tens of thousands of KG edges, and an
    attribute entity over thousands: the gathers' backward and the sums go
    through the hub-safe forms (`ops.sparse`), which cut those runs on the
    card (the index backward into `relation_emb` took 118 ms of a 121 ms
    KGIN step at the LastFM shape without them, on an H100); on the CPU
    they are the plain ops (`scatter_mean`'s sum over counts)."""
    n = kg.n_entities
    live = (kg.att_h < n).to(e.dtype)[:, None]
    msg = (gather_rows_hubs(rel, kg.att_r.long())
           * gather_rows_hubs(e, kg.att_t.long().clamp(0, n - 1)) * live)
    heads = kg.att_h.long().clamp(0, n - 1)
    counts = scatter_sum_hubs(msg.new_ones((msg.shape[0], 1)), heads, n)
    return scatter_sum_hubs(msg, heads, n) / torch.clamp(counts, min=1.0)


class KGINModule(nn.Module):
    """`user_emb`, `entity_emb`, `relation_emb`, `intent_att` [K, R]."""

    def __init__(self, n_users: int, n_entities: int, n_relations: int, dim: int, n_hops: int):
        super().__init__()
        self.n_hops = n_hops
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.entity_emb = nn.Parameter(torch.empty(n_entities, dim))
        self.relation_emb = nn.Parameter(torch.empty(n_relations, dim))
        self.intent_att = nn.Parameter(torch.empty(N_INTENTS, n_relations))

    def forward(self, cf: CFDeviceData, kg: KGDeviceData):
        rel = self.relation_emb
        # intents: softmax mixtures over the relation embeddings (KGIN eq. 2)
        intents = torch.softmax(self.intent_att, dim=1) @ rel  # [K, d]
        layers = [self.entity_emb]
        for _ in range(self.n_hops):
            layers.append(_kg_message(kg, rel, layers[-1]))
        item_emb = (sum(layers) / len(layers))[kg.item_idx.long()]
        # users: intent-gated aggregation of the items they interacted with
        gate = torch.softmax(self.user_emb @ intents.T, dim=1)  # [U, K]
        agg_items = spmm_pair(cf.int_norm.fwd, cf.int_norm.bwd, item_emb)
        return self.user_emb + (gate @ intents) * agg_items, item_emb, intents


@register_model("KGIN")
def build_kgin(cfg: Config, cf: CFDeviceData, kg: KGDeviceData, mesh=None) -> ModelBundle:
    if kg is None:
        raise ValueError("KGIN requires knowledge data")
    module = KGINModule(cf.n_users, kg.n_entities, kg.n_relations, cfg.embedding_size,
                        cfg.n_layers).to(cf.edge_u.device)

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        share = data_share(mesh, users.shape[0])
        u_emb, i_emb, intents = module(cf, kg)
        rec, reg = bpr_l2_share(share, cfg.reg, cfg.batch_size, u_emb[users], i_emb[pos],
                                i_emb[neg])
        # intent independence: mean pairwise |cosine| (a KGIN eq. 10 variant)
        z = intents / torch.clamp(torch.linalg.vector_norm(intents, dim=1, keepdim=True),
                                  min=1e-12)
        k = z.shape[0]
        ind = share.whole * cfg.cl_rate * ((torch.abs(z @ z.T).sum() - k) / max(k * (k - 1), 1))
        return rec + reg + ind, {"rec_loss": rec.detach(), "ind_loss": ind.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module(cf, kg)[:2]

    return ModelBundle(name="KGIN", cfg=cfg, cf=cf, kg=kg, uses_kg=True, module=module,
                       init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss,
                       data_split=data_ranks(mesh) > 1)


class KGCLModule(nn.Module):
    """`user_emb`, `item_emb`, `entity_emb`, `relation_emb`."""

    def __init__(self, n_users: int, n_items: int, n_entities: int, n_relations: int, dim: int,
                 n_layers: int):
        super().__init__()
        self.n_users, self.n_layers = n_users, n_layers
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.entity_emb = nn.Parameter(torch.empty(n_entities, dim))
        self.relation_emb = nn.Parameter(torch.empty(n_relations, dim))

    def forward(self, cf: CFDeviceData, kg: KGDeviceData, keep_rate: float = 1.0,
                edge_key=None):
        """`edge_key`: the adjacency is edge-dropped with it (a view);
        None: the full adjacency."""
        item_kg = _kg_message(kg, self.relation_emb, self.entity_emb)[kg.item_idx.long()]
        adj = cf.adj
        if edge_key is not None and keep_rate < 1.0:
            adj = adj.dropped(edge_key, keep_rate)
        outs = [torch.cat([self.user_emb, self.item_emb + item_kg])]
        for _ in range(self.n_layers):
            outs.append(spmm_pair(adj.fwd, adj.bwd, outs[-1]))
        emb = torch.stack(outs, dim=1).mean(dim=1)
        return emb[: self.n_users], emb[self.n_users :]


@register_model("KGCL")
def build_kgcl(cfg: Config, cf: CFDeviceData, kg: KGDeviceData, mesh=None) -> ModelBundle:
    if kg is None:
        raise ValueError("KGCL requires knowledge data")
    module = KGCLModule(cf.n_users, cf.n_items, kg.n_entities, kg.n_relations,
                        cfg.embedding_size, cfg.n_layers).to(cf.edge_u.device)
    keep = 1.0 - cfg.drop_rate

    def batch_loss(extras: Extras, batch, edge_keys, generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        share = data_share(mesh, users.shape[0])
        u_emb, i_emb = module(cf, kg)
        rec, reg = bpr_l2_share(share, cfg.reg, cfg.batch_size, u_emb[users], i_emb[pos],
                                i_emb[neg])
        u1, i1 = module(cf, kg, keep, edge_keys[0])
        u2, i2 = module(cf, kg, keep, edge_keys[1])
        uu, um = unique_mask(users)
        iu, im = unique_mask(pos)
        cl = info_nce_masked(u1[uu], u2[uu], um, cfg.temp, share.rows)
        cl = cfg.cl_rate * (cl + info_nce_masked(i1[iu], i2[iu], im, cfg.temp, share.rows))
        return rec + reg + cl, {"rec_loss": rec.detach(), "cl_loss": cl.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module(cf, kg)

    return ModelBundle(name="KGCL", cfg=cfg, cf=cf, kg=kg, uses_kg=True, module=module,
                       init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss,
                       n_edge_keys=2, data_split=data_ranks(mesh) > 1)
