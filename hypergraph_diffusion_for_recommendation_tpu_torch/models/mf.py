"""BPR matrix factorisation (the port of the JAX package's `models/mf.py`;
the reference's `MF`, conf/MF.conf): the two embedding tables, BPR + L2
over the batch rows, full-catalog eval. No graph, no kernel launch."""

from __future__ import annotations

import torch

from ..core.config import Config
from ..data.device import CFDeviceData
from ..ops.losses import bpr_l2_share
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model
from .layers import Tables


@register_model("MF")
def build_mf(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
    module = Tables(cf.n_users, cf.n_items, cfg.embedding_size).to(cf.edge_u.device)

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module.user_emb.detach().clone(), module.item_emb.detach().clone()

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        u_emb, i_emb = module()
        rec, reg = bpr_l2_share(data_share(mesh, users.shape[0]), cfg.reg, cfg.batch_size,
                                u_emb[users], i_emb[pos], i_emb[neg])
        return rec + reg, {"rec_loss": rec.detach(), "reg_loss": reg.detach()}

    return ModelBundle(name="MF", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss,
                       data_split=data_ranks(mesh) > 1)
