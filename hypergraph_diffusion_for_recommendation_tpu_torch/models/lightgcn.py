"""LightGCN — K-layer propagation over the normalised CF adjacency, the
mean of the layer outputs (the port of the JAX package's
`models/lightgcn.py`; reference model/graph/LightGCN.py:104-140).

Each layer is one `spmm_pair` (a segment-SpMM kernel launch forward, one
backward), so a training step launches 2K kernels and an encode K. The
loss is BPR + L2 over the batch rows, divided by the batch size. The
reference never steps the plateau scheduler it imports (LightGCN.py:37):
plain Adam at a fixed rate.
"""

from __future__ import annotations

import torch

from ..core.config import Config
from ..data.device import CFDeviceData
from ..ops.losses import bpr_l2_share
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model
from .layers import Tables, gcn_prop


def propagate(cf: CFDeviceData, u: torch.Tensor, i: torch.Tensor, n_layers: int,
              adj=None) -> list[torch.Tensor]:
    """[ego, layer 1, ..., layer K] of LightGCN's propagation over `adj`
    (default: the CF adjacency), each [U + I, d]."""
    adj = cf.adj if adj is None else adj
    outs = [torch.cat([u, i])]
    for _ in range(n_layers):
        outs.append(gcn_prop(adj, outs[-1]))
    return outs


def mean_split(cf: CFDeviceData, outs: list[torch.Tensor], skip_first: bool = False):
    """The mean over the layer outputs (without the ego with
    `skip_first`), split into the user and the item table."""
    emb = torch.stack(outs[1:] if skip_first else outs, dim=1).mean(dim=1)
    return emb[: cf.n_users], emb[cf.n_users :]


@register_model("LightGCN")
def build_lightgcn(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
    module = Tables(cf.n_users, cf.n_items, cfg.embedding_size).to(cf.edge_u.device)

    def encode(extras: Extras = None):
        return mean_split(cf, propagate(cf, *module(), cfg.n_layers))

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        u_emb, i_emb = encode()
        rec, reg = bpr_l2_share(data_share(mesh, users.shape[0]), cfg.reg, cfg.batch_size,
                                u_emb[users], i_emb[pos], i_emb[neg])
        return rec + reg, {"rec_loss": rec.detach(), "reg_loss": reg.detach()}

    return ModelBundle(name="LightGCN", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=flax_init(module), encode_eval=torch.no_grad()(encode), batch_loss=batch_loss,
                       lr_plateau=False, data_split=data_ranks(mesh) > 1)
