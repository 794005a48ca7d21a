"""KTUP and RippleNet (HKGRippleNet) — the port of the JAX package's
`models/ktup_ripplenet.py` (the reference has them only as a notebook,
KTUP.ipynb, and a registry name, main.py:102; the JAX package wrote compact
forms of the papers' mechanisms):

  KTUP       TransH-style joint model: entities projected onto relation
             hyperplanes for the KG loss; CF preferences are soft attention
             mixtures over relations, users translated by their preference
             vector toward items; joint hinge (softplus) losses over the
             joint CF + KG batch.
  RippleNet  per-user multi-hop ripple sets over the KG (host-drawn, padded
             [U, hops, mem] triples); per-hop attention p ∝ softmax(v^T R h),
             o = Σ p · t; BCE of σ(o · v).

Neither reaches a segment-SpMM kernel. RippleNet's R_r h runs in the
relation-batched form of `project_by_relation` (one product per relation,
then each row picks its own), never as the [U, hops, mem, d, d] gather of
relation matrices; its entity gathers hold long runs of one id and sum
their backward through the hub-safe `gather_rows_hubs` (`ops.sparse`; on
the CPU plain indexing). KTUP's relation rows are one-hot matmuls
(`kg_common.relation_lookup`).

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes the per-example terms of its share of the batch
(`parallel.mesh.data_share`): KTUP's CF terms over its share of the CF
batch and its KG terms over its share of the KG batch, RippleNet's ripple
projections and scores over its share's users; the L2 norms, which couple
the batch's rows, are computed whole at weight 1 / data ranks.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.config import Config
from ..data.device import CFDeviceData, KGDeviceData
from ..ops.losses import l2_reg_loss
from ..ops.sparse import gather_rows_hubs
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model
from .kg_common import project_by_relation, relation_lookup


class KTUPModule(nn.Module):
    """`user_emb`, `entity_emb`, `relation_emb`, `relation_norm`, `pref_emb`."""

    def __init__(self, n_users: int, n_entities: int, n_relations: int, dim: int):
        super().__init__()
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.entity_emb = nn.Parameter(torch.empty(n_entities, dim))
        self.relation_emb = nn.Parameter(torch.empty(n_relations, dim))
        self.relation_norm = nn.Parameter(torch.empty(n_relations, dim))
        self.pref_emb = nn.Parameter(torch.empty(n_relations, dim))


def _transh_project(e: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    w = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-12)
    return e - torch.sum(e * w, dim=-1, keepdim=True) * w


@register_model("KTUP")
def build_ktup(cfg: Config, cf: CFDeviceData, kg: KGDeviceData, mesh=None) -> ModelBundle:
    if kg is None:
        raise ValueError("KTUP requires knowledge data")
    m = KTUPModule(cf.n_users, kg.n_entities, kg.n_relations,
                   cfg.embedding_size).to(cf.edge_u.device)
    item_ids = kg.item_idx.long()

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg, h, r, pt, nt = (t.long() for t in batch)
        share, kg_share = data_share(mesh, users.shape[0]), data_share(mesh, h.shape[0])
        item_emb = m.entity_emb[item_ids]
        ue, pe, ne = m.user_emb[users], item_emb[pos], item_emb[neg]
        reg = share.whole * l2_reg_loss(cfg.reg, ue, pe, ne) / cfg.batch_size
        rows = share.rows
        ue = ue[rows]
        # soft preference: attention over relations (KTUP eq. 5-6)
        att = torch.softmax(ue @ m.pref_emb.T, dim=1)  # [B, R]
        p_vec = att @ m.pref_emb
        p_norm = att @ m.relation_norm
        u_proj = _transh_project(ue, p_norm)
        pos_proj = _transh_project(pe[rows], p_norm)
        neg_proj = _transh_project(ne[rows], p_norm)
        pos_s = -torch.sum(torch.abs(u_proj + p_vec - pos_proj), dim=1)
        neg_s = -torch.sum(torch.abs(u_proj + p_vec - neg_proj), dim=1)
        cf_loss = share.part * torch.mean(torch.nn.functional.softplus(1.0 - pos_s + neg_s))

        # TransH KG loss on the batch triples
        h, r, pt, nt = (t[kg_share.rows] for t in (h, r, pt, nt))
        w_r = relation_lookup(m.relation_norm, r)
        h_p = _transh_project(m.entity_emb[h], w_r)
        pt_p = _transh_project(m.entity_emb[pt], w_r)
        nt_p = _transh_project(m.entity_emb[nt], w_r)
        d_r = relation_lookup(m.relation_emb, r)
        pos_k = -torch.sum(torch.abs(h_p + d_r - pt_p), dim=1)
        neg_k = -torch.sum(torch.abs(h_p + d_r - nt_p), dim=1)
        kg_loss = kg_share.part * torch.mean(torch.nn.functional.softplus(1.0 - pos_k + neg_k))
        loss = cf_loss + cfg.alpha * kg_loss + reg
        return loss, {"rec_loss": cf_loss.detach(), "kg_loss": kg_loss.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        # a dot product for the shared ranking path: the user translated by
        # its mean preference (the JAX package's documented simplification of
        # the per-pair translation distance)
        att = torch.softmax(m.user_emb @ m.pref_emb.T, dim=1)
        return m.user_emb + att @ m.pref_emb, m.entity_emb[item_ids]

    return ModelBundle(name="KTUP", cfg=cfg, cf=cf, kg=kg, uses_kg=True, module=m,
                       init=flax_init(m), encode_eval=encode_eval, batch_loss=batch_loss,
                       data_split=data_ranks(mesh) > 1)


# ----------------------------------------------------------- RippleNet
N_HOPS = 2
N_MEM = 16


def build_ripple_sets(cf: CFDeviceData, kg: KGDeviceData, seed: int = 0) -> np.ndarray:
    """Padded per-user ripple sets [U, hops, mem, 3] (h, r, t), int32, on the
    host: the JAX package's draws from `default_rng(seed)`, bit for bit.

    Hop 1 seeds from the user's interacted item entities; hop k+1 from
    hop-k tails; each hop uniformly subsampled to N_MEM triples (pads
    repeat the first sample; users with no triples get zero-entity
    self-loops with relation 0).
    """
    rng = np.random.default_rng(seed)
    h = kg.att_h.cpu().numpy()
    r = kg.att_r.cpu().numpy()
    t = kg.att_t.cpu().numpy()
    live = h < kg.n_entities
    h, r, t = h[live], r[live], t[live]
    order = np.argsort(h, kind="stable")
    h, r, t = h[order], r[order], t[order]
    starts = np.searchsorted(h, np.arange(kg.n_entities))
    ends = np.append(starts[1:], h.shape[0])

    item_ids = kg.item_idx.cpu().numpy()
    edge_u = cf.edge_u.cpu().numpy()
    edge_i = cf.edge_i.cpu().numpy()
    hist: list[list[int]] = [[] for _ in range(cf.n_users)]
    for u, i in zip(edge_u, edge_i):
        hist[u].append(item_ids[i])

    out = np.zeros((cf.n_users, N_HOPS, N_MEM, 3), np.int32)
    for u in range(cf.n_users):
        seeds = hist[u]
        for hop in range(N_HOPS):
            cand = []
            for s in seeds[:64]:
                lo, hi = starts[s], ends[s]
                if hi > lo:
                    take = min(hi - lo, 8)
                    sel = rng.choice(hi - lo, take, replace=False) + lo
                    cand.extend(sel.tolist())
            if not cand:
                out[u, hop, :, :] = 0
                seeds = []
                continue
            pick = rng.choice(len(cand), N_MEM, replace=len(cand) < N_MEM)
            idx = np.asarray(cand)[pick]
            out[u, hop, :, 0] = h[idx]
            out[u, hop, :, 1] = r[idx]
            out[u, hop, :, 2] = t[idx]
            seeds = t[idx].tolist()
    return out


class RippleNetModule(nn.Module):
    """`entity_emb` [E, d] and `relation_mat` [R, d, d]."""

    def __init__(self, n_entities: int, n_relations: int, dim: int):
        super().__init__()
        self.entity_emb = nn.Parameter(torch.empty(n_entities, dim))
        self.relation_mat = nn.Parameter(torch.empty(n_relations, dim, dim))

    def forward(self, kg: KGDeviceData, ripple: torch.Tensor):
        """(item table [I, d], R_r h [N, H, M, d], t [N, H, M, d]) over N
        users' ripple sets [N, H, M, 3] (every user's, or a batch's)."""
        ent = self.entity_emb
        item_emb = ent[kg.item_idx.long()]
        lead = ripple.shape[:-1]
        flat = ripple.reshape(-1, 3).long()
        rh = gather_rows_hubs(ent, flat[:, 0])
        rt = gather_rows_hubs(ent, flat[:, 2])
        rh_proj = project_by_relation(rh, self.relation_mat, flat[:, 1])
        return item_emb, rh_proj.reshape(*lead, -1), rt.reshape(*lead, -1)


def _user_repr(rh_proj: torch.Tensor, rt: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v: [B, d] candidate item rows; the batch users' ripple tensors.
    Returns o = Σ_h Σ_m softmax_m(v^T R h) t."""
    probs = torch.softmax(torch.einsum("bd,bhmd->bhm", v, rh_proj), dim=-1)
    return torch.einsum("bhm,bhmd->bd", probs, rt)


@register_model("HKGRippleNet")
def build_ripplenet(cfg: Config, cf: CFDeviceData, kg: KGDeviceData, mesh=None) -> ModelBundle:
    if kg is None:
        raise ValueError("RippleNet requires knowledge data")
    module = RippleNetModule(kg.n_entities, kg.n_relations,
                             cfg.embedding_size).to(cf.edge_u.device)
    ripple = torch.as_tensor(build_ripple_sets(cf, kg, cfg.seed), device=cf.edge_u.device)

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        share = data_share(mesh, users.shape[0])
        rows = share.rows
        # the ripple sets of the share's users only
        item_emb, rh_b, rt_b = module(kg, ripple[users[rows]])
        v_pos, v_neg = item_emb[pos], item_emb[neg]
        s_pos = torch.sum(_user_repr(rh_b, rt_b, v_pos[rows]) * v_pos[rows], dim=1)
        s_neg = torch.sum(_user_repr(rh_b, rt_b, v_neg[rows]) * v_neg[rows], dim=1)
        # BCE: clicked 1, negative 0, with the JAX package's +1e-8 inside the logs
        loss = -share.part * torch.mean(torch.log(torch.sigmoid(s_pos) + 1e-8)
                                        + torch.log(1 - torch.sigmoid(s_neg) + 1e-8))
        reg = share.whole * l2_reg_loss(cfg.reg, v_pos, v_neg) / cfg.batch_size
        return loss + reg, {"rec_loss": loss.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        item_emb, rh_proj, rt = module(kg, ripple)
        # the user against a mean item probe (full per-pair attention is
        # O(U * I * M); the JAX package's documented simplification)
        probe = torch.mean(item_emb, dim=0)
        probs = torch.softmax(torch.einsum("d,uhmd->uhm", probe, rh_proj), dim=-1)
        return torch.einsum("uhm,uhmd->ud", probs, rt), item_emb

    return ModelBundle(name="HKGRippleNet", cfg=cfg, cf=cf, kg=kg, uses_kg=True, module=module,
                       init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss,
                       data_split=data_ranks(mesh) > 1)
