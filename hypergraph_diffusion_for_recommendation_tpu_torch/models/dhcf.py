"""DHCF — dual-channel hypergraph collaborative filtering (the port of the
JAX package's `models/dhcf.py`; reference model/graph/DHCF.py:135-199).

Each layer gives the users a two-hop conv through the RAW U x I incidence,
leaky(H (H^T u)), and the items leaky(H^T (H i)); the layer outputs are
concatenated with the ego tables ([d * (K + 1)] columns). As in the
reference, every layer convolves the ORIGINAL ego tables (the layers are
not chained, DHCF.py:176-181), and the dead fc_u / fc_i Linears are left
out. Every product is an `spmm_pair` over `raw_int` (a kernel launch
forward and one backward): a step launches 8K kernels, an encode 4K.
Loss: BPR + L2 over the batch rows, divided by the batch size.

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes BPR over its share of the batch (`parallel.mesh.data_share`),
from the propagation every rank runs whole (its draws included); the L2
norms, which couple the batch's rows, are computed whole at weight
1 / data ranks.
"""

from __future__ import annotations

import torch

from ..core.config import Config
from ..data.device import CFDeviceData
from ..ops.losses import bpr_l2_share
from ..ops.sparse import two_hop
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model
from .layers import Tables, leaky


@register_model("DHCF")
def build_dhcf(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
    module = Tables(cf.n_users, cf.n_items, cfg.hyper_dim).to(cf.edge_u.device)
    h = cf.raw_int

    def encode(extras: Extras = None):
        u, i = module()
        users, items = [u], [i]
        for _ in range(cfg.n_layers):
            users.append(leaky(two_hop(h.fwd, h.bwd, u), cfg.p))
            items.append(leaky(two_hop(h.bwd, h.fwd, i), cfg.p))
        return torch.cat(users, dim=1), torch.cat(items, dim=1)

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        u_emb, i_emb = encode()
        rec, reg = bpr_l2_share(data_share(mesh, users.shape[0]), cfg.reg, cfg.batch_size,
                                u_emb[users], i_emb[pos], i_emb[neg])
        return rec + reg, {"rec_loss": rec.detach(), "reg_loss": reg.detach()}

    return ModelBundle(name="DHCF", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=flax_init(module), encode_eval=torch.no_grad()(encode),
                       batch_loss=batch_loss, data_split=data_ranks(mesh) > 1)
