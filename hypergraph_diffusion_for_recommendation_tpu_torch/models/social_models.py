"""Social recommenders MHCN and SEPT — the port of the JAX package's
`models/social_models.py` (registered in the reference CLI, main.py:102,
whose model files were not committed; the JAX package wrote compact forms
of the upstream formulations):

  MHCN  three motif channels over the user graph (social: S + S^T
        binarised; joint: the mutual follows S ⊙ S^T plus self-loops;
        purchase: users who share an item, plus self-loops), each
        propagated LightGCN-style (`spmm_pair`, in `sorted(channels)`
        order), a softmax channel attention, items aggregating their
        raters' fused rows through `inv_int_norm`; BPR + L2 / batch +
        cl_rate * Σ_c InfoNCE(fused user, channel view) on the batch's
        unique users. A step launches 14 segment-SpMM kernels with 2 layers
        (3 channels x 2 layers and `inv_int_norm`, forward and backward),
        an encode 7.
  SEPT  a main LightGCN view over the CF adjacency and friend and sharing
        views over user-user graphs, contrasted with InfoNCE on the batch's
        unique users. A step launches 12 kernels with 2 layers; the encode
        computes the main view only (2): the social views are dead there.

The user-user matrices are built on the host with scipy at model build time
and packed by `adj_pair_from_scipy` on the CF data's device, with the
configuration's operand type and gather layout (`compute_dtype`,
`gather_layout`), as `Recommender.build` packs the CF adjacency.

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes BPR over its share of the batch and the InfoNCE terms of its share
of the unique users over every row's denominator
(`parallel.mesh.data_share`), from the propagation every rank runs whole;
the L2 norms are computed whole at weight 1 / data ranks.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..core.config import Config
from ..data.device import AdjPair, CFDeviceData, adj_pair_from_scipy
from ..data.normalize import normalize_graph_mat
from ..ops.losses import bpr_l2_share, info_nce_masked, unique_mask
from ..ops.sparse import spmm_pair
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model


def cf_interaction_csr(cf: CFDeviceData) -> sp.csr_matrix:
    """The binary U x I interaction matrix of the training edges."""
    u = cf.edge_u.cpu().numpy()
    i = cf.edge_i.cpu().numpy()
    return sp.csr_matrix((np.ones(len(u), np.float32), (u, i)), shape=(cf.n_users, cf.n_items))


def sharing_mat(cf: CFDeviceData) -> sp.csr_matrix:
    """Users who share an item, binarised, without self-loops."""
    r = cf_interaction_csr(cf)
    co = (r @ r.T).tocsr()
    co.setdiag(0)
    co.eliminate_zeros()
    co.data[:] = 1.0
    return co


def social_channel_mats(cf: CFDeviceData, social_mat) -> dict[str, sp.csr_matrix]:
    """MHCN's three normalised channel matrices on the host."""
    s = social_mat.tocsr()
    s_sym = (s + s.T).tocsr()
    s_sym.data[:] = 1.0
    mutual = s.multiply(s.T).tocsr()
    eye = sp.eye(cf.n_users)
    return {"social": normalize_graph_mat(s_sym),
            "joint": normalize_graph_mat(mutual + eye),
            "purchase": normalize_graph_mat(sharing_mat(cf) + eye)}


def sept_view_mats(cf: CFDeviceData, social_mat) -> dict[str, sp.csr_matrix]:
    """SEPT's normalised friend and sharing matrices on the host."""
    s = social_mat
    friend = ((s + s.T) != 0).astype(np.float32).tocsr()
    return {"friend": normalize_graph_mat(friend),
            "sharing": normalize_graph_mat(sharing_mat(cf) + sp.eye(cf.n_users))}


def _pairs(cfg: Config, cf: CFDeviceData, mats: dict) -> dict[str, AdjPair]:
    """The matrices as AdjPairs on the CF data's device, with the
    configuration's operand type and gather layout."""
    return {k: adj_pair_from_scipy(m, cf.edge_u.device, bf16=cfg.compute_dtype == "bfloat16",
                                   gather_layout=cfg.gather_layout) for k, m in mats.items()}


def _mean_prop(adj: AdjPair, h: torch.Tensor, n_layers: int) -> torch.Tensor:
    """The mean of [h, A h, ..., A^K h]."""
    hs = [h]
    for _ in range(n_layers):
        hs.append(spmm_pair(adj.fwd, adj.bwd, hs[-1]))
    return torch.stack(hs, dim=1).mean(dim=1)


class MHCNModule(nn.Module):
    """`user_emb`, `item_emb`, `channel_att` [C, d]."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_layers: int, n_channels: int):
        super().__init__()
        self.n_layers = n_layers
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.channel_att = nn.Parameter(torch.empty(n_channels, dim))

    def forward(self, cf: CFDeviceData, channels: dict[str, AdjPair]):
        u = self.user_emb
        chan_outs = [_mean_prop(adj, u, self.n_layers) for _, adj in sorted(channels.items())]
        stack = torch.stack(chan_outs, dim=1)  # [U, C, d]
        w = torch.softmax(torch.einsum("ucd,cd->uc", stack, self.channel_att), dim=1)
        user_final = torch.einsum("uc,ucd->ud", w, stack) + u
        # items aggregate their raters' fused rows
        item_final = self.item_emb + spmm_pair(cf.inv_int_norm.fwd, cf.inv_int_norm.bwd,
                                               user_final)
        return user_final, item_final, chan_outs


@register_model("MHCN")
def build_mhcn(cfg: Config, cf: CFDeviceData, kg=None, social=None, mesh=None) -> ModelBundle:
    if social is None:
        raise ValueError("MHCN requires social data (pass social=SocialData)")
    channels = _pairs(cfg, cf, social_channel_mats(cf, social.social_mat))
    module = MHCNModule(cf.n_users, cf.n_items, cfg.embedding_size, cfg.n_layers,
                        len(channels)).to(cf.edge_u.device)

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        share = data_share(mesh, users.shape[0])
        u_emb, i_emb, chans = module(cf, channels)
        rec, reg = bpr_l2_share(share, cfg.reg, cfg.batch_size, u_emb[users], i_emb[pos],
                                i_emb[neg])
        # hierarchical mutual information: the fused user against each channel
        uu, um = unique_mask(users)
        ssl = sum(info_nce_masked(u_emb[uu], c[uu], um, cfg.temp, share.rows) for c in chans)
        ssl = cfg.cl_rate * ssl
        return rec + reg + ssl, {"rec_loss": rec.detach(), "cl_loss": ssl.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module(cf, channels)[:2]

    return ModelBundle(name="MHCN", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss,
                       data_split=data_ranks(mesh) > 1)


class SEPTModule(nn.Module):
    """`user_emb`, `item_emb`."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_layers: int):
        super().__init__()
        self.n_users, self.n_layers = n_users, n_layers
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))

    def forward(self, cf: CFDeviceData, views: dict[str, AdjPair] | None = None):
        """(user table, item table) of the main view, then, with `views`,
        the friend and the sharing view of the users."""
        main = _mean_prop(cf.adj, torch.cat([self.user_emb, self.item_emb]), self.n_layers)
        out = (main[: self.n_users], main[self.n_users :])
        if views is None:
            return out
        return out + tuple(_mean_prop(views[k], self.user_emb, self.n_layers)
                           for k in ("friend", "sharing"))


@register_model("SEPT")
def build_sept(cfg: Config, cf: CFDeviceData, kg=None, social=None, mesh=None) -> ModelBundle:
    if social is None:
        raise ValueError("SEPT requires social data (pass social=SocialData)")
    views = _pairs(cfg, cf, sept_view_mats(cf, social.social_mat))
    module = SEPTModule(cf.n_users, cf.n_items, cfg.embedding_size,
                        cfg.n_layers).to(cf.edge_u.device)

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        share = data_share(mesh, users.shape[0])
        u_emb, i_emb, fr, sh = module(cf, views)
        rec, reg = bpr_l2_share(share, cfg.reg, cfg.batch_size, u_emb[users], i_emb[pos],
                                i_emb[neg])
        uu, um = unique_mask(users)
        ssl = info_nce_masked(u_emb[uu], fr[uu], um, cfg.temp, share.rows)
        ssl = cfg.cl_rate * (ssl + info_nce_masked(u_emb[uu], sh[uu], um, cfg.temp, share.rows))
        return rec + reg + ssl, {"rec_loss": rec.detach(), "cl_loss": ssl.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module(cf)

    return ModelBundle(name="SEPT", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss,
                       data_split=data_ranks(mesh) > 1)
