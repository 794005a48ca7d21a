"""The hypergraph-diffusion (HD) family: HD, HGNN_HD, HGNN_HD2, HGNN_HD3,
HGNN_HD4, WaveletHD, WaveletHD2, LocalEncoder.

The port of the JAX package's `models/hd_family.py` (reference
HGNN_HD3.py:268-523 and its siblings). All variants share one skeleton:
  * LocalAwareEncoder: per layer an ED-HNN step + the ego residual, the
    last layer optionally LN(HGCNConv(act=False)) + residual (the "cap");
  * GroupAwareEncoder: n_layers - 1 x [user-side and item-side HWNN
    wavelet + residuals], last layer LN(HGCNConv(act=False)) + residual;
  * modes full / local_only / group_only / wossl for the dual-view
    variants (HGNN_HD3, HGNN_HD4); the others run the local view alone;
  * eval tables: the mean of the views;
  * loss: BPR + l2 / batch + cl_rate * the cross-view contrast of users and
    of items (the JAX package's repair of the reference's item term).

  variant     ED-HNN form            cap   views
  HD          scatter                no    local
  HGNN_HD     SpMM                   no    local
  HGNN_HD2    scatter                yes   local
  HGNN_HD3    SpMM                   yes   local + group
  HGNN_HD4    SpMM                   no    local + group
  WaveletHD   SpMM, HWNN inner conv  no    local
  WaveletHD2  SpMM, HWNN inner conv  yes   local
  LocalEncoder SpMM                  yes   local

Training drops edges of the CF adjacency with ONE key a step (both views
see the same draw, as the JAX views' `make_rng("edges")` give the same
key) and applies the ED-HNN's feature dropout (fixed rates 0.6 / 0.5) from
the generator the trainer passes. The HWNN layers of the group view run
on the undropped `b_hyper`.

Cached propagation (`cfg.prop_cache_steps` = K > 1), as in the JAX
package: every K-th step (`prop_age % K == 0`, so the first) runs the full
loss and leaves the view tables in the extras; the steps between run
`cached_loss` on those tables, with the straight-through
`st(prop, ego) = prop + ego - ego.detach()` into the embedding tables.
`prop_age` is a host integer, so choosing the branch reads nothing from
the card (`ModelBundle.step_branch`), and neither loss reads anything back
to the host, so both run inside a CUDA graph.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from ..data.device import AdjPair, CFDeviceData
from ..ops.losses import bpr_loss, contrast_loss_pregathered, l2_reg_loss, unique_mask
from .base import Extras, ModelBundle, register_model
from .layers import LN_EPS, EquivSetConvScatter, EquivSetGNN, FlaxNamed, HWNNLayer, hgcn_conv


class LocalAwareEncoder(FlaxNamed):
    """Submodules under flax's names: `EquivSetGNN_k` or
    `EquivSetConvScatter_k` per diffusion layer, `LayerNorm_0` for the
    cap."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_layers: int, drop_rate: float,
                 conv_form: str = "spmm", last_hgcn: bool = True):
        super().__init__()
        if conv_form not in ("spmm", "scatter", "wavelet"):
            raise ValueError(f"conv_form {conv_form!r} is not 'spmm', 'scatter' or 'wavelet'")
        self.n_users = n_users
        n_nodes = n_users + n_items
        self.layers = []  # (kind, submodule name) per layer
        for k in range(n_layers):
            if last_hgcn and k == n_layers - 1:
                self.layers.append(("cap", self._new("LayerNorm", nn.LayerNorm(dim, eps=LN_EPS))))
            elif conv_form == "scatter":
                self.layers.append(("scatter", self._new("EquivSetConvScatter", EquivSetConvScatter(
                    dim, n_edges=n_nodes, aggr="mean", mlp1_layers=0, mlp2_layers=0,
                    mlp3_layers=1, alpha=0.0, dropout=drop_rate, normalization="ln",
                    input_norm=True))))
            else:
                self.layers.append(("gnn", self._new("EquivSetGNN", EquivSetGNN(
                    n_nodes, dim, n_conv_layers=1, input_dropout=0.6, dropout=0.5, alpha=0.0,
                    mlp1_layers=0, mlp2_layers=0, mlp3_layers=1,
                    inner="wavelet" if conv_form == "wavelet" else "hgcn"))))

    def forward(self, ego: torch.Tensor, adj: AdjPair, train: bool = False,
                generator: torch.Generator | None = None):
        res = ego
        for kind, name in self.layers:
            layer = getattr(self, name)
            if kind == "cap":
                ego = layer(hgcn_conv(adj, ego, 0.3, act=False)) + res
            elif kind == "scatter":
                ego = layer(ego, adj, ego, train, generator) + res
            else:
                ego = layer(ego, adj, train, generator) + res
        return ego[: self.n_users], ego[self.n_users :]


class GroupAwareEncoder(FlaxNamed):
    """Submodules under flax's names: `HWNNLayer_{2k}` (users) and
    `HWNNLayer_{2k+1}` (items) per wavelet layer, `LayerNorm_0` last."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_layers: int):
        super().__init__()
        self.n_users = n_users
        self.pairs = [(self._new("HWNNLayer", HWNNLayer(n_users, dim, dim, side="u")),
                       self._new("HWNNLayer", HWNNLayer(n_items, dim, dim, side="i")))
                      for _ in range(n_layers - 1)]
        self._new("LayerNorm", nn.LayerNorm(dim, eps=LN_EPS))

    def forward(self, ego: torch.Tensor, b_hyper: AdjPair, adj: AdjPair):
        u = self.n_users
        res, res_u, res_i = ego, ego[:u], ego[u:]
        for name_u, name_i in self.pairs:
            ego = torch.cat([getattr(self, name_u)(ego[:u], b_hyper) + res_u,
                             getattr(self, name_i)(ego[u:], b_hyper) + res_i])
        ego = self.LayerNorm_0(hgcn_conv(adj, ego, 0.5, act=False)) + res
        return ego[:u], ego[u:]


class HDModule(nn.Module):
    """Parameters under the flax module's names: `user_emb`, `item_emb`,
    `local_enc.*`, `group_enc.*` (`weights.params_from_jax`)."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_layers: int, drop_rate: float,
                 conv_form: str, last_hgcn: bool, use_local: bool, use_group: bool):
        super().__init__()
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.local_enc = LocalAwareEncoder(n_users, n_items, dim, n_layers, drop_rate, conv_form,
                                           last_hgcn) if use_local else None
        self.group_enc = GroupAwareEncoder(n_users, n_items, dim, n_layers) if use_group else None

    def ego(self) -> torch.Tensor:
        return torch.cat([self.user_emb, self.item_emb])

    def views(self, cf: CFDeviceData, adj: AdjPair, train: bool = False,
              generator: torch.Generator | None = None):
        """[(users, items)] of the local view and/or the group view, over
        `adj` (the dropped adjacency in training)."""
        out = []
        if self.local_enc is not None:
            out.append(self.local_enc(self.ego(), adj, train, generator))
        if self.group_enc is not None:
            out.append(self.group_enc(self.ego(), cf.b_hyper, adj))
        return out


def _build_hd_variant(name: str, conv_form: str, last_hgcn: bool, dual_view_default: bool):
    def builder(cfg: Config, cf: CFDeviceData, kg=None) -> ModelBundle:
        if dual_view_default:
            use_local = cfg.mode != "group_only"
            use_group = cfg.mode != "local_only"
            use_ssl = cfg.mode not in ("local_only", "group_only", "wossl")
        else:
            use_local, use_group, use_ssl = True, False, False
        if use_group and cf.b_hyper is None:
            raise ValueError(f"{name}'s group view needs the b_hyper incidence in the device data")
        device = cf.edge_u.device
        module = HDModule(cf.n_users, cf.n_items, cfg.hyper_dim, cfg.n_layers, cfg.drop_rate,
                          conv_form, last_hgcn, use_local, use_group).to(device)
        keep = 1.0 - cfg.drop_rate
        k_cache = max(int(cfg.prop_cache_steps or 0), 0)
        use_prop_cache = k_cache > 1
        ssl_two_views = use_ssl and use_local and use_group

        def encode(train: bool, edge_key=None, generator=None):
            adj = cf.adj
            if train and keep < 1.0:
                adj = adj.dropped(edge_key, keep)
            views = module.views(cf, adj, train, generator)
            if len(views) == 1:
                return views[0], views
            u = torch.stack([v[0] for v in views], dim=1).mean(dim=1)
            i = torch.stack([v[1] for v in views], dim=1).mean(dim=1)
            return (u, i), views

        def init(generator: torch.Generator) -> Extras:
            from ..weights import init_hd

            module.load_state_dict(init_hd(module, generator))
            if not use_prop_cache:
                return {}
            zeros = lambda n: torch.zeros(n, cfg.hyper_dim, device=device)  # noqa: E731
            extras = {"prop_age": 0, "prop_u": zeros(cf.n_users), "prop_i": zeros(cf.n_items)}
            if ssl_two_views:
                extras.update(prop_lu=zeros(cf.n_users), prop_li=zeros(cf.n_items),
                              prop_gu=zeros(cf.n_users), prop_gi=zeros(cf.n_items))
            return extras

        @torch.no_grad()
        def encode_eval(extras: Extras):
            return encode(train=False)[0]

        def full_loss(extras: Extras, batch, edge_keys, generator=None):
            """(loss, aux) of one batch through the full dual-view diffusion;
            with cached propagation, aux["_new_extras"] holds this
            forward's tables."""
            users, pos, neg = (t.long() for t in batch[:3])
            (u_emb, i_emb), views = encode(True, edge_keys[0], generator)
            ue, pe, ne = u_emb[users], i_emb[pos], i_emb[neg]
            rec = bpr_loss(ue, pe, ne)
            reg = l2_reg_loss(cfg.reg, ue, pe, ne) / cfg.batch_size
            aux = {"rec_loss": rec.detach(), "reg_loss": reg.detach()}
            loss = rec + reg
            if use_ssl and len(views) == 2:
                (lu, li), (gu, gi) = views
                uu, um = unique_mask(users)
                iu, im = unique_mask(pos)
                ids = torch.cat([uu, lu.shape[0] + iu])
                b = users.shape[0]
                lv = torch.cat([lu, li])[ids]
                gv = torch.cat([gu, gi])[ids]
                ssl = contrast_loss_pregathered(lv[:b], gv[:b], um, cfg.temp)
                ssl = ssl + contrast_loss_pregathered(lv[b:], gv[b:], im, cfg.temp)
                ssl = cfg.cl_rate * ssl
                aux["cl_loss"] = ssl.detach()
                loss = loss + ssl
            if use_prop_cache:
                new = {"prop_age": extras["prop_age"] + 1,
                       "prop_u": u_emb.detach(), "prop_i": i_emb.detach()}
                if ssl_two_views:
                    (lu, li), (gu, gi) = views
                    new.update(prop_lu=lu.detach(), prop_li=li.detach(),
                               prop_gu=gu.detach(), prop_gi=gi.detach())
                aux["_new_extras"] = new
            return loss, aux

        def cached_loss(extras: Extras, batch, edge_keys, generator=None):
            """The between-refresh step: the same losses on the cached view
            rows, with a straight-through identity path into the embedding
            tables (each view carries the ego residual, so the own-row
            component is a true Jacobian term)."""
            users, pos, neg = (t.long() for t in batch[:3])
            u_tab, i_tab = module.user_emb, module.item_emb

            def st(prop_rows, ego_rows):
                return prop_rows + ego_rows - ego_rows.detach()

            ue = st(extras["prop_u"][users], u_tab[users])
            pe = st(extras["prop_i"][pos], i_tab[pos])
            ne = st(extras["prop_i"][neg], i_tab[neg])
            rec = bpr_loss(ue, pe, ne)
            reg = l2_reg_loss(cfg.reg, ue, pe, ne) / cfg.batch_size
            aux = {"rec_loss": rec.detach(), "reg_loss": reg.detach()}
            loss = rec + reg
            if ssl_two_views:
                uu, um = unique_mask(users)
                iu, im = unique_mask(pos)
                lu_v = st(extras["prop_lu"][uu], u_tab[uu])
                gu_v = st(extras["prop_gu"][uu], u_tab[uu])
                li_v = st(extras["prop_li"][iu], i_tab[iu])
                gi_v = st(extras["prop_gi"][iu], i_tab[iu])
                ssl = contrast_loss_pregathered(lu_v, gu_v, um, cfg.temp)
                ssl = ssl + contrast_loss_pregathered(li_v, gi_v, im, cfg.temp)
                ssl = cfg.cl_rate * ssl
                aux["cl_loss"] = ssl.detach()
                loss = loss + ssl
            aux["_new_extras"] = dict(extras, prop_age=extras["prop_age"] + 1)
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

        return ModelBundle(name=name, cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                           init=init, encode_eval=encode_eval, batch_loss=batch_loss,
                           n_edge_keys=1, step_branch=step_branch)

    return builder


register_model("HD")(_build_hd_variant("HD", "scatter", last_hgcn=False, dual_view_default=False))
register_model("HGNN_HD")(_build_hd_variant("HGNN_HD", "spmm", last_hgcn=False,
                                            dual_view_default=False))
register_model("HGNN_HD2")(_build_hd_variant("HGNN_HD2", "scatter", last_hgcn=True,
                                             dual_view_default=False))
register_model("HGNN_HD3")(_build_hd_variant("HGNN_HD3", "spmm", last_hgcn=True,
                                             dual_view_default=True))
register_model("HGNN_HD4")(_build_hd_variant("HGNN_HD4", "spmm", last_hgcn=False,
                                             dual_view_default=True))
register_model("WaveletHD")(_build_hd_variant("WaveletHD", "wavelet", last_hgcn=False,
                                              dual_view_default=False))
register_model("WaveletHD2")(_build_hd_variant("WaveletHD2", "wavelet", last_hgcn=True,
                                               dual_view_default=False))
register_model("LocalEncoder")(_build_hd_variant("LocalEncoder", "spmm", last_hgcn=True,
                                                 dual_view_default=False))
