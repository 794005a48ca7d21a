"""KGAT — knowledge-graph attention network, the port of the JAX package's
`models/kgat.py` (reference model/graph/KGAT.py):

  * embeddings: the entity-user table [n_entities, d], the relation table
    [R, dr], the TransR projections trans_M [R, d, dr] (:259-276);
  * CF embeddings: one aggregator per entry of `conv_dim_list` over the
    attentive adjacency A_in (`att_matvec` over the triple list), each
    output L2-row-normalised, all layers concatenated (:286-297); the
    aggregators gcn, graphsage and bi-interaction, each Dense -> LeakyReLU
    (slope 0.01) -> LayerNorm (flax's epsilon), message dropout after
    (:176-231);
  * A_in starts at zeros over the padded triple list (:283-285) and is
    refreshed once an epoch, after both phases, from the full triple list:
    tanh-scored TransR attention and a row softmax (`epoch_update_extras`,
    :349-389, the training loop :128-133);
  * training alternates (`alternating`): a CF phase (BPR + reg *
    `l2_loss_mean` of the batch rows) with its own Adam, then a KG phase
    (alpha * (TransR loss + reg_kg * `l2_loss_mean`)) with a second Adam,
    both clipped at global norm 4 (:66-125);
  * the eval tables are the concatenated embeddings at the user and item
    entity rows (:391-402).

KGAT reaches no segment-SpMM kernel: its propagation is a gather and a
fixed-order segment sum over the triple list, in either phase and in the
encode. The KG loss's relation rows go through `kg_common.relation_lookup`,
a one-hot matmul (a KG batch holds runs of thousands of one relation id,
which the index backward would add one after another).

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes the per-example terms of its share of each batch
(`parallel.mesh.data_share`): in the CF phase the scores and row means of
its share of the (user, pos, neg) rows, over the propagation every rank
runs whole; in the KG phase its share of the triples, split before the
relation lookup and the projections, which are the phase's whole work.
Every term is a mean over rows, so the shares add up to the batch's loss.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from ..data.device import CFDeviceData, KGDeviceData
from ..ops.dropout import feature_dropout
from ..ops.losses import l2_loss_mean
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, register_model
from .kg_common import (
    att_matvec,
    attention_softmax,
    attention_values,
    project_by_relation,
    relation_lookup,
)
from .layers import LN_EPS, FlaxNamed

AGG_TYPES = ("gcn", "graphsage", "bi-interaction")


def _leaky(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.leaky_relu(x, 0.01)`, whose gradient at 0 is 1 (torch's
    `leaky_relu` gives the slope there). It matters here: with the zero
    attention of the first epoch, the bi-interaction branch's input is 0
    and its Dense layer's output is exactly its bias, 0 at initialisation."""
    return torch.where(x >= 0, x, 0.01 * x)


class Aggregator(FlaxNamed):
    """One KGAT layer (Equations 6-8): its flax submodules `Dense_k` and
    `LayerNorm_k` in flax's creation order."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float, agg_type: str):
        super().__init__()
        if agg_type not in AGG_TYPES:
            raise ValueError(f"aggregation_type {agg_type!r} is not one of {AGG_TYPES}")
        self.agg_type, self.dropout = agg_type, dropout
        n = 2 if agg_type == "bi-interaction" else 1
        width = 2 * in_dim if agg_type == "graphsage" else in_dim
        self.branches = [(self._new("Dense", nn.Linear(width, out_dim)),
                          self._new("LayerNorm", nn.LayerNorm(out_dim, eps=LN_EPS)))
                         for _ in range(n)]

    def _branch(self, k: int, x: torch.Tensor) -> torch.Tensor:
        dense, ln = self.branches[k]
        return getattr(self, ln)(_leaky(getattr(self, dense)(x)))

    def forward(self, ego: torch.Tensor, side: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.agg_type == "gcn":
            out = self._branch(0, ego + side)
        elif self.agg_type == "graphsage":
            out = self._branch(0, torch.cat([ego, side], dim=1))
        else:  # bi-interaction (Equation 8)
            out = self._branch(0, ego + side) + self._branch(1, ego * side)
        return feature_dropout(out, self.dropout, generator, train)


class KGATModule(nn.Module):
    """`entity_user_embed`, `relation_embed`, `trans_M` and `aggregators_k`."""

    def __init__(self, n_entities: int, n_relations: int, embed_dim: int, relation_dim: int,
                 conv_dims: tuple, mess_dropout: tuple, agg_type: str):
        super().__init__()
        self.n_entities = n_entities
        self.entity_user_embed = nn.Parameter(torch.empty(n_entities, embed_dim))
        self.relation_embed = nn.Parameter(torch.empty(n_relations, relation_dim))
        self.trans_M = nn.Parameter(torch.empty(n_relations, embed_dim, relation_dim))
        dims = (embed_dim,) + tuple(conv_dims)
        layers = list(zip(dims[:-1], dims[1:], mess_dropout))  # flax's zip: the shorter list
        self.n_layers = len(layers)
        for k, (d_in, d_out, p) in enumerate(layers):
            self.add_module(f"aggregators_{k}", Aggregator(d_in, d_out, p, agg_type))

    def forward(self, kg: KGDeviceData, att_vals: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """The layer-concatenated embeddings [n_entities, d + sum(conv_dims)]
        over the attentive adjacency (:286-297)."""
        ego = self.entity_user_embed
        outs = [ego]
        for k in range(self.n_layers):
            side = att_matvec(kg.att_h, kg.att_t, att_vals, ego, self.n_entities)
            ego = getattr(self, f"aggregators_{k}")(ego, side, train, generator)
            norm = torch.clamp(torch.linalg.vector_norm(ego, dim=1, keepdim=True), min=1e-12)
            outs.append(ego / norm)
        return torch.cat(outs, dim=1)


@register_model("KGAT")
def build_kgat(cfg: Config, cf: CFDeviceData, kg: KGDeviceData, mesh=None) -> ModelBundle:
    if kg is None:
        raise ValueError("KGAT requires knowledge data (use_knowledge=true)")
    device = cf.edge_u.device
    module = KGATModule(kg.n_entities, kg.n_relations, cfg.embedding_size, cfg.relation_dim,
                        tuple(cfg.conv_dim_list), tuple(cfg.mess_dropout),
                        cfg.aggregation_type).to(device)

    def init(generator: torch.Generator) -> Extras:
        from ..weights import init_flax

        module.load_state_dict(init_flax(module, generator))
        # A_in starts empty (KGAT.py:283-285): zero weights over the triple list
        return {"att_vals": torch.zeros(kg.att_h.shape[0], dtype=torch.float32, device=device)}

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        share = data_share(mesh, users.shape[0])
        users, pos, neg = (t[share.rows] for t in (users, pos, neg))
        all_emb = module(kg, extras["att_vals"], True, generator)
        # one merged user/pos/neg row gather (one backward scatter)
        upn = all_emb[torch.cat([kg.user_idx[users], kg.item_idx[pos],
                                 kg.item_idx[neg]]).long()]
        u_emb, p_emb, n_emb = upn.chunk(3)
        pos_score = torch.sum(u_emb * p_emb, dim=1)
        neg_score = torch.sum(u_emb * n_emb, dim=1)
        cf_loss = share.part * torch.mean(-torch.nn.functional.logsigmoid(pos_score - neg_score))
        l2 = share.part * (l2_loss_mean(u_emb) + l2_loss_mean(p_emb) + l2_loss_mean(n_emb))
        return cf_loss + cfg.reg * l2, {"rec_loss": cf_loss.detach()}

    def kg_batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        share = data_share(mesh, batch[0].shape[0])
        h, r, pos_t, neg_t = (t[share.rows].long() for t in batch[:4])
        r_emb = relation_lookup(module.relation_embed, r)
        # one merged h/pos/neg gather and one batched projection (same r)
        proj3 = project_by_relation(module.entity_user_embed[torch.cat([h, pos_t, neg_t])],
                                    module.trans_M, torch.cat([r, r, r]))
        r_mul_h, r_mul_pos, r_mul_neg = proj3.chunk(3)
        pos_score = torch.sum(torch.square(r_mul_h + r_emb - r_mul_pos), dim=1)
        neg_score = torch.sum(torch.square(r_mul_h + r_emb - r_mul_neg), dim=1)
        kg_loss = share.part * torch.mean(-torch.nn.functional.logsigmoid(neg_score - pos_score))
        l2 = share.part * (l2_loss_mean(r_mul_h) + l2_loss_mean(r_emb)
                           + l2_loss_mean(r_mul_pos) + l2_loss_mean(r_mul_neg))
        return cfg.alpha * (kg_loss + cfg.reg_kg * l2), {"kg_loss": kg_loss.detach()}

    @torch.no_grad()
    def epoch_update_extras(extras: Extras, generator=None) -> Extras:
        vals = attention_values(module.entity_user_embed, module.relation_embed, module.trans_M,
                                kg.att_h, kg.att_t, kg.att_r)
        return {"att_vals": attention_softmax(vals, kg.att_h, kg.n_entities, kg.att_valid)}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        all_emb = module(kg, extras["att_vals"])
        return all_emb[kg.user_idx.long()], all_emb[kg.item_idx.long()]

    return ModelBundle(name="KGAT", cfg=cfg, cf=cf, kg=kg, uses_kg=True, module=module,
                       init=init, encode_eval=encode_eval, batch_loss=batch_loss,
                       kg_batch_loss=kg_batch_loss, epoch_update_extras=epoch_update_extras,
                       alternating=True, grad_clip_norm=4.0, data_split=data_ranks(mesh) > 1)
