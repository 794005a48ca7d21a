"""BPR matrix factorisation (the port of the JAX package's `models/mf.py`;
the reference's `MF`, conf/MF.conf): the two embedding tables, BPR + L2
over the batch rows, full-catalog eval. No graph, no kernel launch."""

from __future__ import annotations

import torch

from ..core.config import Config
from ..data.device import CFDeviceData
from ..ops.losses import bpr_loss, l2_reg_loss
from .base import Extras, ModelBundle, flax_init, register_model
from .layers import Tables


@register_model("MF")
def build_mf(cfg: Config, cf: CFDeviceData, kg=None) -> ModelBundle:
    module = Tables(cf.n_users, cf.n_items, cfg.embedding_size).to(cf.edge_u.device)

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module.user_emb.detach().clone(), module.item_emb.detach().clone()

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        ue, pe, ne = module.user_emb[users], module.item_emb[pos], module.item_emb[neg]
        rec = bpr_loss(ue, pe, ne)
        reg = l2_reg_loss(cfg.reg, ue, pe, ne) / cfg.batch_size
        return rec + reg, {"rec_loss": rec.detach(), "reg_loss": reg.detach()}

    return ModelBundle(name="MF", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss)
