"""SHT — the sparse hypergraph transformer (the port of the JAX package's
`models/sht.py`; reference model/graph/SHT.py:144-272):

  * a GCN backbone: K one-hop products over the CF adjacency, summed
    (`lats`, :195-201);
  * the hyperedge transform hyper = embeds.detach() @ (H^T H) with
    learnable H [hyperedge_num, d] per side (:192-203);
  * the eval tables are the HYPER embeddings (predict, :265-267);
  * loss = BPR(base) + BPR(hyper) + reg + the prediction-alignment SSL on
    randomly sampled (user, item) pairs, each view's sigmoid the other's
    detached target (:241-263), written with `logsigmoid` as the JAX
    package writes it (`log(1 - sigmoid(d) + 1e-8)` reaches log(0) on
    saturated scores once XLA reassociates it).

`cfg.sht_reg` "batch" (the default) squares the batch rows of both views
and the hyperedge tables; "full" squares every parameter (the reference's
calcRegLoss, :234-239). The sampled pairs come from `_sample_pairs`, from
the generator the trainer passes.

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes both BPR terms and the batch rows' squares of the "batch"
regulariser over its share of the batch (`parallel.mesh.data_share`), from
the propagation every rank runs whole; the sampled pairs' self-supervised
terms and the parameter squares, which read no batch row, are computed
whole at weight 1 / data ranks (every rank samples the same pairs).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.functional import logsigmoid

from ..core.config import Config
from ..data.device import CFDeviceData
from ..ops.losses import bpr_loss
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model
from .lightgcn import propagate


def _sample_pairs(n: int, n_users: int, n_items: int, generator: torch.Generator | None,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """n random user ids and n random item ids (`jax.random.randint`)."""
    u = torch.randint(0, n_users, (n,), generator=generator, device=device)
    return u, torch.randint(0, n_items, (n,), generator=generator, device=device)


class SHTModule(nn.Module):
    """Parameters under flax's names: `user_emb`, `item_emb` [n, d],
    `user_hyper`, `item_hyper` [hyperedge_num, d]."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_layers: int, n_hyperedges: int):
        super().__init__()
        self.n_users, self.n_layers = n_users, n_layers
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.user_hyper = nn.Parameter(torch.empty(n_hyperedges, dim))
        self.item_hyper = nn.Parameter(torch.empty(n_hyperedges, dim))

    def forward(self, cf: CFDeviceData):
        embeds = sum(propagate(cf, self.user_emb, self.item_emb, self.n_layers))
        base = embeds.detach()
        hyper_u = base[: self.n_users] @ (self.user_hyper.T @ self.user_hyper)
        hyper_i = base[self.n_users :] @ (self.item_hyper.T @ self.item_hyper)
        return embeds, hyper_u, hyper_i


@register_model("SHT")
def build_sht(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
    module = SHTModule(cf.n_users, cf.n_items, cfg.hyper_dim, cfg.n_layers,
                       cfg.hyperedge_num).to(cf.edge_u.device)
    edge_samp = int(0.1 * cf.adj.fwd.nnz)
    edge_samp += edge_samp % 2  # even, as the reference keeps it (:211-212)
    half = edge_samp // 2
    if cfg.sht_reg not in ("batch", "full"):
        raise ValueError(f"sht_reg {cfg.sht_reg!r} is not 'batch' or 'full'")

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        share = data_share(mesh, users.shape[0])
        b = users.shape[0]
        users, pos, neg = (t[share.rows] for t in (users, pos, neg))
        embeds, hyper_u, hyper_i = module(cf)
        u_emb, i_emb = embeds[: cf.n_users], embeds[cf.n_users :]
        rows = (u_emb[users], i_emb[pos], i_emb[neg], hyper_u[users], hyper_i[pos], hyper_i[neg])
        rec = share.part * (bpr_loss(*rows[:3]) + bpr_loss(*rows[3:]))
        if cfg.sht_reg == "full":
            reg = share.whole * cfg.reg * sum(torch.sum(torch.square(p))
                                              for p in module.parameters())
        else:
            w = torch.sum(torch.square(module.user_hyper)) + torch.sum(
                torch.square(module.item_hyper))
            reg = cfg.reg * (sum(torch.sum(torch.square(e)) for e in rows) / b
                             + share.whole * w)
        pck_u, pck_i = _sample_pairs(edge_samp, cf.n_users, cf.n_items, generator, users.device)
        s1 = torch.sum(hyper_u[pck_u] * hyper_i[pck_i], dim=-1)
        s2 = torch.sum(u_emb[pck_u] * i_emb[pck_i], dim=-1)
        d1 = (s1[:half] - s1[half:]) / cfg.temp
        d2 = (s2[:half] - s2[half:]) / cfg.temp
        t1, t2 = torch.sigmoid(d1).detach(), torch.sigmoid(d2).detach()
        ssl1 = -torch.mean(t2 * logsigmoid(d1) + (1 - t2) * logsigmoid(-d1))
        ssl2 = -torch.mean(t1 * logsigmoid(d2) + (1 - t1) * logsigmoid(-d2))
        ssl = share.whole * cfg.cl_rate * (ssl1 + ssl2)
        return rec + reg + ssl, {"rec_loss": rec.detach(), "cl_loss": ssl.detach(),
                                 "reg_loss": reg.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module(cf)[1:]

    return ModelBundle(name="SHT", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss,
                       data_split=data_ranks(mesh) > 1)
