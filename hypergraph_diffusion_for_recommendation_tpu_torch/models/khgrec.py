"""The KHGRec family — the KG-aware hypergraph recommenders of one skeleton.

The port of the JAX package's `models/khgrec.py` (`_build_khgrec_like`;
reference model/graph/KHGRec.py):
  * one shared user-entity embedding table [n_entities, hyper_dim]
    (:277-282); CF ego = table[user raw ids] ++ table[item raw ids];
  * SelfAwareEncoder (CF): per layer LN(HGCNConv(A)) + residual, the
    activation off on the last conv (:374-417); with `use_self_att` a
    `SelfAttentionBlock` over the node set before each conv; with
    `use_hyper` off a one-hop A X in place of the two-hop conv;
  * RelationalAwareEncoder (KG): per layer LN(AttHGCNConv(K, A_att)) +
    residual (:419-453), AttHGCNConv(X) = M (M^T X) with M = A_att K,
    computed as the 4-product chain A_att K K^T A_att^T X; with
    `use_att_adj` off the plain two-hop K (K^T X);
  * attention fusion of the CF and KG item views (:466-480).

The family:

  model          self-attention  KG conv   SSL       CF conv
  KHGRec         no              A_att K   per mode  two-hop
  HGNN           yes             K         per mode  two-hop
  HD2            yes             A_att K   never     two-hop
  HGNNAblation   no              A_att K   per mode  one-hop in mode wohyper

Training (`full_loss`, the JAX package's `full_loss`): edge dropout on
both adjacencies, each with its own key (:169-183); the self-attention
blocks' feature dropout from the generator the trainer passes; BPR + L2
(:341-345), TransR + L2 (:347-365), the cross-view SSL (:367-372) in modes
full / woatt; and the attention for the NEXT batch scored under `no_grad`
from this step's KG forward (:120-126, `attention_extras`). LayerNorms use
epsilon 1e-6, flax's default. The self-attention models double the
early-stopping patience.

Cached propagation (`cfg.prop_cache_steps` = K > 1, the JAX package's
`cached_loss`): every K-th step (`prop_age % K == 0`, so the first) runs
`full_loss`, which also leaves this forward's propagated tables in the
extras (`prop_u`, `prop_icf`, `prop_fused`, `prop_ent`); the steps between
run `cached_loss` on them, with the straight-through
`st(prop, ego) = prop + ego - ego.detach()` into the shared entity table,
and no SpMM. `prop_age` is a host integer: choosing the branch reads
nothing from the card (`ModelBundle.step_branch`). Neither loss reads
anything back to the host, so both run inside a CUDA graph.

The joint encode (`HGDR_JOINT` set, the JAX package's opt-in; KHGRec and
HGNNAblation outside mode wohyper: the two-hop CF conv, no
self-attention): the two encoders' product chains run as one chain over
`blockdiag_pair(A, K)`, packed under the configured layout (the JAX
`joint_encode`, khgrec.py:192-228, builder :286-302). Each side keeps
its own encoder's LayerNorms. Edge dropout draws one key for the joint
matrix (`n_edge_keys` 1), where the unfused path draws one per matrix; at
keep rate 1 the two paths compute the same tables. A step launches 8
SpMM kernels, against 16 unfused.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..core.config import Config
from ..data.device import AdjPair, CFDeviceData, KGDeviceData, blockdiag_pair
from ..ops import sparse as _sp
from ..ops.losses import bpr_l2_share, contrast_loss_pregathered, l2_reg_loss, unique_mask
from ..parallel.mesh import MODEL_AXIS, axis_size, data_ranks, data_share, local_table
from .base import Extras, ModelBundle, register_model
from .kg_common import (
    att_matvec,
    att_matvec_t,
    attention_softmax,
    attention_values,
    project_by_relation,
)
from .layers import LN_EPS, AttentionFusion, SelfAttentionBlock, hgcn_conv, leaky


class SelfAwareEncoder(nn.Module):
    def __init__(self, n_users: int, dim: int, n_layers: int, slope: float,
                 use_self_att: bool = False, use_hyper: bool = True):
        super().__init__()
        self.n_users = n_users
        self.slope = slope
        self.use_hyper = use_hyper
        self.lns = nn.ModuleList(nn.LayerNorm(dim, eps=LN_EPS) for _ in range(n_layers))
        self.att_blocks = nn.ModuleList(
            SelfAttentionBlock(dim) for _ in range(n_layers)) if use_self_att else None

    def forward(self, ego: torch.Tensor, adj: AdjPair, train: bool = False,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        res = ego
        last = len(self.lns) - 1
        for k, ln in enumerate(self.lns):
            if self.att_blocks is not None:
                ego = self.att_blocks[k](ego, train, generator)
            if self.use_hyper:
                conv = hgcn_conv(adj, ego, self.slope, act=k != last)
            else:  # HGNNAblation's wohyper: one hop
                conv = _sp.spmm_pair(adj.fwd, adj.bwd, ego)
                conv = leaky(conv, self.slope) if k != last else conv
            ego = ln(conv) + res
        return ego[: self.n_users], ego[self.n_users :]


class RelationalAwareEncoder(nn.Module):
    def __init__(self, dim: int, n_layers: int, slope: float, use_att_adj: bool = True):
        super().__init__()
        self.slope = slope
        self.use_att_adj = use_att_adj
        self.lns = nn.ModuleList(nn.LayerNorm(dim, eps=LN_EPS) for _ in range(n_layers))

    def forward(self, embs: torch.Tensor, kg_adj: AdjPair, att) -> torch.Tensor:
        att_h, att_t, att_v = att
        n = embs.shape[0]

        def att_conv(x, act: bool):
            # M (M^T x) with M = A_att K: A_att K K^T A_att^T x; HGNN leaves
            # A_att out: K (K^T x)
            if self.use_att_adj:
                x = att_matvec_t(att_h, att_t, att_v, x, n)
            y = _sp.spmm_pair(kg_adj.bwd, kg_adj.fwd, x)
            y = _sp.spmm_pair(kg_adj.fwd, kg_adj.bwd, y)
            if self.use_att_adj:
                y = att_matvec(att_h, att_t, att_v, y, n)
            return leaky(y, self.slope) if act else y

        res = embs
        last = len(self.lns) - 1
        for k, ln in enumerate(self.lns):
            embs = ln(att_conv(embs, act=k != last)) + res
        return embs


class KHGRecModule(nn.Module):
    """Parameter names follow the flax module's (`user_entity_emb`,
    `relation_emb`, `trans_M`, `cf_encoder.lns.k`, `kg_encoder.lns.k`,
    `attention_item.dense0/1`, `cf_encoder.att_blocks.k.*`);
    `weights.khgrec_params_from_jax` maps one onto the other."""

    def __init__(self, n_entities: int, n_relations: int, n_users: int, hyper_dim: int,
                 relation_dim: int, n_layers: int, slope: float, use_self_att: bool = False,
                 use_hyper: bool = True, kg_use_att_adj: bool = True, lookup_mesh=None):
        super().__init__()
        self.n_entities = n_entities
        self.n_users = n_users
        # the (data, model) mesh whose model axis row-shards the entity table
        # (the trainer's `parallel.mesh.shard_tables`), or None
        self.lookup_mesh = lookup_mesh
        self.user_entity_emb = nn.Parameter(torch.empty(n_entities, hyper_dim))
        self.relation_emb = nn.Parameter(torch.empty(n_relations, relation_dim))
        self.trans_M = nn.Parameter(torch.empty(n_relations, hyper_dim, relation_dim))
        self.cf_encoder = SelfAwareEncoder(n_users, hyper_dim, n_layers, slope, use_self_att,
                                           use_hyper)
        self.kg_encoder = RelationalAwareEncoder(hyper_dim, n_layers, slope, kg_use_att_adj)
        self.attention_item = AttentionFusion(hyper_dim, hyper_dim)

    def table_lookup(self, idx: torch.Tensor) -> torch.Tensor:
        """`user_entity_emb[idx]`: with the table row-sharded over the
        lookup mesh's model axis, the explicit collective of
        `parallel.embedding.spmd_sharded_lookup` on this rank's block (the
        JAX `table_lookup`, khgrec.py:140-147); else a plain gather."""
        block = None if self.lookup_mesh is None else local_table(self, "user_entity_emb")
        if block is None:
            return self.user_entity_emb[idx]
        from ..parallel.embedding import spmd_sharded_lookup

        return spmd_sharded_lookup(block, idx, self.lookup_mesh)

    def fuse_items(self, item_cf, item_kg, use_attention: bool):
        stacked = torch.stack([item_cf, item_kg], dim=1)
        if use_attention:
            return self.attention_item(stacked)[0]
        return stacked.mean(dim=1)

    def joint_encode(self, cf: CFDeviceData, kg: KGDeviceData, att, joint_adj: AdjPair):
        """Both encoders' forward over the block-diagonal adjacency
        blockdiag(A, K) (the JAX `joint_encode`, khgrec.py:192-228): per
        layer, the CF two-hop and the KG conv's two products run as two
        products over the stacked [CF nodes; entities] rows, A_att applied
        to the entity rows on either side; each side keeps its own encoder's
        LayerNorm and residual. At keep rate 1 the unfused encoders' values,
        with half the products. `joint_adj` is already edge-dropped when
        training (one key for the joint matrix)."""
        att_h, att_t, att_v = att
        n_nodes, n_ent = cf.n_nodes, kg.n_entities
        slope = self.cf_encoder.slope
        ui = torch.cat([kg.user_idx, kg.item_idx]).long()
        x = torch.cat([self.table_lookup(ui), self.user_entity_emb])
        res = x
        last = len(self.cf_encoder.lns) - 1
        for k, (ln_cf, ln_kg) in enumerate(zip(self.cf_encoder.lns, self.kg_encoder.lns)):
            z = att_matvec_t(att_h, att_t, att_v, x[n_nodes:], n_ent)
            y = _sp.spmm_pair(joint_adj.bwd, joint_adj.fwd, torch.cat([x[:n_nodes], z]))
            y = _sp.spmm_pair(joint_adj.fwd, joint_adj.bwd, y)
            w = att_matvec(att_h, att_t, att_v, y[n_nodes:], n_ent)
            conv_cf, conv_kg = y[:n_nodes], w
            if k != last:
                conv_cf, conv_kg = leaky(conv_cf, slope), leaky(conv_kg, slope)
            x = torch.cat([ln_cf(conv_cf) + res[:n_nodes], ln_kg(conv_kg) + res[n_nodes:]])
        return x[: self.n_users], x[self.n_users : n_nodes], x[n_nodes:]

    def forward(self, cf: CFDeviceData, kg: KGDeviceData, att, use_attention: bool = True,
                keep_rate: float = 1.0, edge_keys=None, generator: torch.Generator | None = None,
                joint_adj: AdjPair | None = None):
        """`edge_keys` (training): the (cf, kg) pair of dropout keys, each
        two uint32 words, for edge dropout at `keep_rate` on each
        adjacency (with `joint_adj`, one key for the joint matrix), and the
        self-attention blocks' feature dropout from `generator`; None runs
        on the full graphs, without dropout."""
        train = edge_keys is not None
        ui = torch.cat([kg.user_idx, kg.item_idx]).long()
        if joint_adj is not None:
            if train and keep_rate < 1.0:
                joint_adj = joint_adj.dropped(edge_keys[0], keep_rate)
            u_cf, i_cf, ent_kg = self.joint_encode(cf, kg, att, joint_adj)
        else:
            adj, kg_adj = cf.adj, kg.kg_adj
            if train and keep_rate < 1.0:
                adj = adj.dropped(edge_keys[0], keep_rate)
                kg_adj = kg_adj.dropped(edge_keys[1], keep_rate)
            # CF view over the shared table's user and item rows
            u_cf, i_cf = self.cf_encoder(self.table_lookup(ui), adj, train, generator)
            ent_kg = self.kg_encoder(self.user_entity_emb, kg_adj, att)
        uikg = ent_kg[ui]
        u_kg, i_kg = uikg[: self.n_users], uikg[self.n_users :]
        fused = self.fuse_items(i_cf, i_kg, use_attention)
        return u_cf, i_cf, ent_kg, u_kg, i_kg, fused


@torch.no_grad()
def attention_extras(module: KHGRecModule, ent_kg: torch.Tensor, h: torch.Tensor,
                     r: torch.Tensor, t: torch.Tensor) -> Extras:
    """The attention adjacency a training step leaves for the next batch:
    TransR tanh scores of the batch triples (h, r, t) over the KG-encoded
    entity table, row-softmaxed per head (reference KHGRec.py:120-126,
    309-331)."""
    vals = attention_values(ent_kg, module.relation_emb, module.trans_M, h, t, r)
    return {"att_h": h, "att_t": t, "att_v": attention_softmax(vals, h, module.n_entities)}


def _att(extras: Extras):
    return (extras["att_h"], extras["att_t"], extras["att_v"])


def _build_khgrec_like(name: str, use_self_att: bool = False, force_no_ssl: bool = False,
                       hyper_from_mode: bool = False, kg_att_adj: bool = True):
    """The factory of one member of the family (the JAX `_build_khgrec_like`):
    `use_self_att` adds the CF self-attention blocks, `force_no_ssl` drops
    the SSL term in every mode, `hyper_from_mode` makes mode "wohyper" take
    the one-hop CF conv, `kg_att_adj` folds A_att into the KG conv."""

    def builder(cfg: Config, cf: CFDeviceData, kg: KGDeviceData, mesh=None) -> ModelBundle:
        if kg is None:
            raise ValueError(f"{name} requires knowledge data (use_knowledge=true)")
        use_ssl = not force_no_ssl and cfg.mode in ("full", "woatt", "wo_attention")
        use_att = cfg.mode in ("full", "wossl", "wo_ssl")
        use_hyper = cfg.mode != "wohyper" if hyper_from_mode else True
        keep = 1.0 - cfg.drop_rate
        device = cf.edge_u.device
        # the joint (block-diagonal) encode: opt-in through HGDR_JOINT, as in
        # the JAX package, and only where the two encoders' chains are the
        # plain two-hop ones
        joint = None
        if use_hyper and not use_self_att and os.environ.get("HGDR_JOINT"):
            joint = blockdiag_pair(cf.adj, kg.kg_adj, device, cfg.pad_multiple,
                                   bf16=cfg.compute_dtype == "bfloat16",
                                   gather_layout=cfg.gather_layout)
        k_cache = max(int(cfg.prop_cache_steps or 0), 0)
        use_prop_cache = k_cache > 1
        # the explicit-collective entity lookups when the build's mesh
        # row-shards the entity table (`parallel.mesh.param_shardings`'
        # conditions; the JAX builder's, khgrec.py:265-284)
        lookup_mesh = None
        if mesh is not None:
            model = axis_size(mesh, MODEL_AXIS)
            if model > 1 and kg.n_entities % model == 0 and kg.n_entities >= cfg.shard_min_rows:
                lookup_mesh = mesh
        module = KHGRecModule(
            kg.n_entities, kg.n_relations, cf.n_users,
            cfg.hyper_dim, cfg.relation_dim, cfg.n_layers, cfg.p,
            use_self_att=use_self_att, use_hyper=use_hyper, kg_use_att_adj=kg_att_adj,
            lookup_mesh=lookup_mesh,
        ).to(device)

        def init(generator: torch.Generator) -> Extras:
            from ..weights import init_flax

            module.load_state_dict(init_flax(module, generator))
            # the JAX bundle's initial attention: b self-loops of weight 1
            b = cfg.batch_size_kg
            idx = torch.arange(b, dtype=torch.int32, device=device) % kg.n_entities
            extras = {"att_h": idx, "att_t": idx.clone(),
                      "att_v": torch.ones(b, dtype=torch.float32, device=device)}
            if use_prop_cache:
                # age 0: the first step takes the full branch and fills the tables
                zeros = lambda n: torch.zeros(n, cfg.hyper_dim, device=device)  # noqa: E731
                extras.update(prop_age=0, prop_u=zeros(cf.n_users), prop_icf=zeros(cf.n_items),
                              prop_fused=zeros(cf.n_items), prop_ent=zeros(kg.n_entities))
            return extras

        @torch.no_grad()
        def encode_eval(extras: Extras):
            u_cf, _, _, _, _, fused = module(cf, kg, _att(extras), use_att, joint_adj=joint)
            return u_cf, fused

        def transr_loss(hpn_rows: torch.Tensor, r: torch.Tensor, share) -> torch.Tensor:
            """TransR KG loss + L2 (:347-365) of the stacked [head; pos tail;
            neg tail] entity rows, one batched projection: the loss's mean
            over the share's rows, the L2 norms (which couple the rows) over
            the whole batch (`parallel.mesh.data_share`)."""
            r_emb = module.relation_emb[r]
            proj3 = project_by_relation(hpn_rows, module.trans_M, torch.cat([r, r, r]))
            r_mul_h, r_mul_pos, r_mul_neg = proj3.chunk(3)
            rows = share.rows
            h_r = r_mul_h[rows] + r_emb[rows]
            pos_score = torch.sum(torch.square(h_r - r_mul_pos[rows]), dim=1)
            neg_score = torch.sum(torch.square(h_r - r_mul_neg[rows]), dim=1)
            kg_loss = share.part * torch.mean(
                -torch.nn.functional.logsigmoid(neg_score - pos_score))
            return kg_loss + share.whole * l2_reg_loss(cfg.reg_kg, r_mul_h, r_emb, r_mul_pos,
                                                       r_mul_neg) / cfg.batch_size_kg

        def full_loss(extras: Extras, batch, edge_keys, generator=None):
            """(loss, aux) of one training batch; aux holds the loss terms
            (detached) and, under "_new_extras", the attention for the
            next batch (and the refreshed cached tables). Only the
            self-attention blocks draw from `generator`. Built for a mesh
            with a data axis, the per-example terms are this data rank's
            share of the batch (`data_split`); the attention, from the whole
            KG batch, is the same on every rank."""
            users, pos, neg, h, r, pt, nt = (t.long() for t in batch)
            share, kg_share = data_share(mesh, users.shape[0]), data_share(mesh, h.shape[0])
            u_cf, i_cf, ent_kg, u_kg, i_kg, fused = module(
                cf, kg, _att(extras), use_att, keep, edge_keys, generator, joint)
            # CF loss: user and pos/neg item rows in one gather over [u_cf; fused]
            n_users = cf.n_users
            upn = torch.cat([u_cf, fused])[torch.cat([users, n_users + pos, n_users + neg])]
            ue, pe, ne = upn.chunk(3)
            rec, reg = bpr_l2_share(share, cfg.reg, cfg.batch_size, ue, pe, ne)
            cf_loss = rec + reg
            kg_loss = transr_loss(ent_kg[torch.cat([h, pt, nt])], r, kg_share)
            loss = cf_loss + kg_loss
            # scored from THIS forward's KG embeddings, without gradient
            new_extras = attention_extras(module, ent_kg.detach(), batch[3], batch[4], batch[5])
            if use_prop_cache:
                # the tables of THIS forward (the step's edge-dropout draw
                # included), as in the JAX package
                new_extras.update(prop_age=extras["prop_age"] + 1, prop_u=u_cf.detach(),
                                  prop_icf=i_cf.detach(), prop_fused=fused.detach(),
                                  prop_ent=ent_kg.detach())
            aux = {"rec_loss": rec.detach(), "cf_loss": cf_loss.detach(),
                   "kg_loss": kg_loss.detach(), "_new_extras": new_extras}
            if use_ssl:
                uu, um = unique_mask(users)
                iu, im = unique_mask(pos)
                b = users.shape[0]
                ids = torch.cat([uu, n_users + iu])
                cf_view = torch.cat([u_cf, i_cf])[ids]
                kg_view = torch.cat([u_kg, i_kg])[ids]
                ssl = contrast_loss_pregathered(cf_view[:b], kg_view[:b], um, cfg.temp,
                                                share.rows)
                ssl = ssl + contrast_loss_pregathered(cf_view[b:], kg_view[b:], im, cfg.temp,
                                                      share.rows)
                ssl = cfg.cl_rate * ssl
                aux["cl_loss"] = ssl.detach()
                loss = loss + ssl
            return loss, aux

        def cached_loss(extras: Extras, batch, edge_keys, generator=None):
            """The between-refresh step: full_loss's formulas on the cached
            tables, each row with a straight-through identity path into
            its own entry of the entity table (the encoders' per-layer
            `LN(conv) + res` residual makes that a true Jacobian term).
            The LayerNorms and the attention fusion get gradients only on
            full steps; relation_emb and trans_M train as in full_loss."""
            users, pos, neg, h, r, pt, nt = (t.long() for t in batch)
            share, kg_share = data_share(mesh, users.shape[0]), data_share(mesh, h.shape[0])
            table = module.user_entity_emb

            def st(prop_rows, ego_rows):
                return prop_rows + ego_rows - ego_rows.detach()

            user_idx, item_idx = kg.user_idx.long(), kg.item_idx.long()
            upn_ids = torch.cat([user_idx[users], item_idx[pos], item_idx[neg]])
            ego_u, ego_p, ego_n = table[upn_ids].chunk(3)
            ue = st(extras["prop_u"][users], ego_u)
            pe = st(extras["prop_fused"][pos], ego_p)
            ne = st(extras["prop_fused"][neg], ego_n)
            rec, reg = bpr_l2_share(share, cfg.reg, cfg.batch_size, ue, pe, ne)
            cf_loss = rec + reg
            hpn = torch.cat([h, pt, nt])
            kg_loss = transr_loss(st(extras["prop_ent"][hpn], table[hpn]), r, kg_share)
            loss = cf_loss + kg_loss
            # the next batch's attention, scored from the cached entity table
            new_extras = attention_extras(module, extras["prop_ent"], batch[3], batch[4],
                                          batch[5])
            new_extras.update({k: extras[k] for k in ("prop_u", "prop_icf", "prop_fused",
                                                      "prop_ent")},
                              prop_age=extras["prop_age"] + 1)
            aux = {"rec_loss": rec.detach(), "cf_loss": cf_loss.detach(),
                   "kg_loss": kg_loss.detach(), "_new_extras": new_extras}
            if use_ssl:
                uu, um = unique_mask(users)
                iu, im = unique_mask(pos)
                u_ent, i_ent = user_idx[uu], item_idx[iu]
                u_cf_v = st(extras["prop_u"][uu], table[u_ent])
                i_cf_v = st(extras["prop_icf"][iu], table[i_ent])
                u_kg_v = st(extras["prop_ent"][u_ent], table[u_ent])
                i_kg_v = st(extras["prop_ent"][i_ent], table[i_ent])
                ssl = contrast_loss_pregathered(u_cf_v, u_kg_v, um, cfg.temp, share.rows)
                ssl = ssl + contrast_loss_pregathered(i_cf_v, i_kg_v, im, cfg.temp, share.rows)
                ssl = cfg.cl_rate * ssl
                aux["cl_loss"] = ssl.detach()
                loss = loss + ssl
            return loss, aux

        step_branch = None
        if use_prop_cache:

            def step_branch(extras: Extras) -> str:
                return "full" if extras["prop_age"] % k_cache == 0 else "cached"

            def batch_loss(extras: Extras, batch, edge_keys, generator=None):
                step = full_loss if step_branch(extras) == "full" else cached_loss
                return step(extras, batch, edge_keys, generator)

        else:
            batch_loss = full_loss

        return ModelBundle(name=name, cfg=cfg, cf=cf, kg=kg, uses_kg=True,
                           module=module, init=init, encode_eval=encode_eval,
                           batch_loss=batch_loss, n_edge_keys=1 if joint is not None else 2,
                           early_stop_patience_scale=2 if use_self_att else 1,
                           step_branch=step_branch, data_split=data_ranks(mesh) > 1)

    return builder


register_model("KHGRec")(_build_khgrec_like("KHGRec"))
# the reference advertises KHGRec_variation1..9 with no code of their own;
# the JAX package registers them as aliases of KHGRec
for _i in range(1, 10):
    register_model(f"KHGRec_variation{_i}")(_build_khgrec_like("KHGRec"))
register_model("HGNN")(_build_khgrec_like("HGNN", use_self_att=True, kg_att_adj=False))
register_model("HD2")(_build_khgrec_like("HD2", use_self_att=True, force_no_ssl=True))
register_model("HGNNAblation")(_build_khgrec_like("HGNNAblation", hyper_from_mode=True))
