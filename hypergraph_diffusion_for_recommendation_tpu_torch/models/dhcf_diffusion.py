"""DHCF_diffusion — DHCF with ED-HNN diffusion channels (the port of the
JAX package's `models/dhcf_diffusion.py`; reference
model/graph/DHCF_diffusion.py:131-190, its intended semantics).

Each layer runs an `EquivSetGNNScatter` over the raw U x I interaction
incidence for the users (users the vertices, items the hyperedges) and
another over its transpose for the items; the layer outputs are
concatenated with the ego tables. The reference's forward passes its
arguments swapped (DHCF_diffusion.py:179) and cannot run; this is the
call it evidently intends, as in the JAX package. The convs are scatter
means over the incidence's (row, col) lists: no SpMM kernel runs. Feature
dropout (ED-HNN's input 0.6 and 0.5) draws from the trainer's generator
in training. Loss: BPR + L2 over the batch rows, divided by the batch size.

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
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model
from .layers import EquivSetGNNScatter, FlaxNamed


class DHCFDiffusionModule(FlaxNamed):
    """`user_emb`, `item_emb` and, per layer, the user channel's and the item
    channel's `EquivSetGNNScatter_<2k>` and `_<2k + 1>` (flax's names)."""

    def __init__(self, n_users: int, n_items: int, dim: int, n_layers: int):
        super().__init__()
        self.user_emb = torch.nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = torch.nn.Parameter(torch.empty(n_items, dim))
        self.channels = [(self._new("EquivSetGNNScatter", EquivSetGNNScatter(dim, n_items)),
                          self._new("EquivSetGNNScatter", EquivSetGNNScatter(dim, n_users)))
                         for _ in range(n_layers)]

    def forward(self, cf: CFDeviceData, train: bool = False,
                generator: torch.Generator | None = None):
        inc = cf.raw_int
        inc_t = inc.replace(fwd=inc.bwd, bwd=inc.fwd)  # items the vertices
        users, items = [self.user_emb], [self.item_emb]
        for gnn_u, gnn_i in self.channels:
            users.append(getattr(self, gnn_u)(self.user_emb, inc, train, generator))
            items.append(getattr(self, gnn_i)(self.item_emb, inc_t, train, generator))
        return torch.cat(users, dim=1), torch.cat(items, dim=1)


@register_model("DHCF_diffusion")
def build_dhcf_diffusion(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
    module = DHCFDiffusionModule(cf.n_users, cf.n_items, cfg.hyper_dim,
                                 cfg.n_layers).to(cf.edge_u.device)

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        u_emb, i_emb = module(cf, True, generator)
        rec, reg = bpr_l2_share(data_share(mesh, users.shape[0]), cfg.reg, cfg.batch_size,
                                u_emb[users], i_emb[pos], i_emb[neg])
        return rec + reg, {"rec_loss": rec.detach(), "reg_loss": reg.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module(cf)

    return ModelBundle(name="DHCF_diffusion", cfg=cfg, cf=cf, kg=None, uses_kg=False,
                       module=module, init=flax_init(module), encode_eval=encode_eval,
                       batch_loss=batch_loss, data_split=data_ranks(mesh) > 1)
