"""SGL — self-supervised graph learning on LightGCN (the port of the JAX
package's `models/sgl.py`; reference model/graph/SGL.py).

Two augmented graph views are drawn once an epoch (`epoch_setup`, eagerly,
from the trainer's card generator): node or edge dropout on the
interaction matrix, carried to both bipartite directions through
`bip_src`, then the bipartite matrix re-normalised on the device
(`renormalize_sym`; SGL.py:61-62, 131-147). Their values reach the
segment-SpMM kernels through `with_new_vals` on `raw_adj`'s layout. Each
step runs LightGCN over the clean adjacency and over both views, InfoNCE
between the batch's unique users and items across the views (:168-180);
loss = BPR + L2 (NOT divided by the batch) + cl_rate * CL, gradients
clipped to a global norm of 4 (:76), a fixed learning rate. Every product
is the one-sided `spmm` (a kernel forward, a torch-ops backward): a step
launches 3K kernels, an encode K.

The Bernoulli draws go through `_keep_mask`, which tests replace with the
JAX draws (torch cannot reproduce JAX's streams).

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes BPR over its share of the batch and the InfoNCE terms of its share
of the unique-row buffer over every row's denominator
(`parallel.mesh.data_share`); the L2 norms are computed whole at weight
1 / data ranks. The views are drawn whole, once an epoch, on every rank.
"""

from __future__ import annotations

import torch

from ..core.config import Config
from ..core.types import with_new_vals
from ..data.device import CFDeviceData
from ..ops.losses import bpr_l2_share, info_nce_masked, unique_mask
from ..ops.sparse import renormalize_sym, spmm
from ..parallel.mesh import data_ranks, data_share
from .base import Extras, ModelBundle, flax_init, register_model
from .layers import Tables


def _keep_mask(shape: tuple, keep: float, generator: torch.Generator | None,
               device) -> torch.Tensor:
    """Bernoulli(keep) booleans (`jax.random.bernoulli`)."""
    return torch.rand(shape, generator=generator, device=device) < keep


def _augmented_view_vals(generator: torch.Generator | None, cf: CFDeviceData, drop_rate: float,
                         aug_type: int) -> torch.Tensor:
    """The re-normalised bipartite values of one augmented view."""
    h = cf.raw_int.fwd
    dev = h.vals.device
    if aug_type == 0:
        # node dropout on the interaction matrix (augmentor.py:11-25)
        keep_u = _keep_mask((cf.n_users,), 1.0 - drop_rate, generator, dev)
        keep_i = _keep_mask((cf.n_items,), 1.0 - drop_rate, generator, dev)
        edge_keep = (keep_u[h.rows.long().clamp(0, cf.n_users - 1)]
                     & keep_i[h.cols.long().clamp(0, cf.n_items - 1)])
    else:
        # edge dropout, NO rescale (augmentor.py:27-40)
        edge_keep = _keep_mask(tuple(h.vals.shape), 1.0 - drop_rate, generator, dev)
    int_vals = h.vals * edge_keep.to(h.vals.dtype)
    bip_vals = int_vals[cf.bip_src.long()]
    return renormalize_sym(with_new_vals(cf.raw_adj.fwd, bip_vals)).vals


@register_model("SGL")
def build_sgl(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
    device = cf.edge_u.device
    module = Tables(cf.n_users, cf.n_items, cfg.embedding_size).to(device)
    tables_init = flax_init(module)

    def encode(view_vals: torch.Tensor | None = None):
        """LightGCN's layer mean over the clean adjacency, or over the
        raw bipartite structure with a view's values."""
        adj = cf.adj.fwd if view_vals is None else with_new_vals(cf.raw_adj.fwd, view_vals)
        outs = [torch.cat(module())]
        for _ in range(cfg.n_layers):
            outs.append(spmm(adj, outs[-1]))
        emb = torch.stack(outs, dim=1).mean(dim=1)
        return emb[: cf.n_users], emb[cf.n_users :]

    def init(generator: torch.Generator) -> Extras:
        tables_init(generator)
        zeros = lambda: torch.zeros(cf.raw_adj.fwd.nnz_pad, device=device)  # noqa: E731
        return {"view1": zeros(), "view2": zeros()}

    def epoch_setup(extras: Extras, generator: torch.Generator | None) -> Extras:
        return {k: _augmented_view_vals(generator, cf, cfg.drop_rate, cfg.aug_type)
                for k in ("view1", "view2")}

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        u_emb, i_emb = encode()
        # the L2 is not divided by the batch (SGL.py)
        rec, reg = bpr_l2_share(data_share(mesh, users.shape[0]), cfg.reg, 1, u_emb[users],
                                i_emb[pos], i_emb[neg])
        u1, i1 = encode(extras["view1"])
        u2, i2 = encode(extras["view2"])
        uu, um = unique_mask(users)
        iu, im = unique_mask(pos)
        view1 = torch.cat([u1[uu], i1[iu]])
        view2 = torch.cat([u2[uu], i2[iu]])
        cl = cfg.cl_rate * info_nce_masked(view1, view2, torch.cat([um, im]), cfg.temp,
                                           data_share(mesh, view1.shape[0]).rows)
        return rec + reg + cl, {"rec_loss": rec.detach(), "cl_loss": cl.detach()}

    return ModelBundle(name="SGL", cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                       init=init, encode_eval=torch.no_grad()(lambda extras=None: encode()),
                       batch_loss=batch_loss, epoch_setup=epoch_setup, grad_clip_norm=4.0,
                       # the reference never steps a scheduler (a fixed-rate Adam)
                       lr_plateau=False, data_split=data_ranks(mesh) > 1)
