"""The SELFRec SSL baselines — the port of the JAX package's
`models/ssl_family.py` (the reference registers them, main.py:99-104, and
ships their conf files, but not their model files; the JAX package wrote
them from the upstream SELFRec formulations):

  DirectAU  alignment + uniformity on the MF tables
  SimGCL    LightGCN with per-layer signed random noise, two noisy views
            contrasted (InfoNCE)
  XSimGCL   one noisy pass, its final layer mean contrasted with layer 1
  NCL       LightGCN + structural (layer 2 vs ego) and prototype (k-means
            centroids, refreshed each epoch by `epoch_setup`) terms
  MixGCF    LightGCN + hop-mixed hardest synthetic negatives
  SSL4Rec   two towers over the tables, item-side feature-dropout InfoNCE
  BUIR      online tables + predictor against EMA target tables
            (`update_extras`), negative-free
  SelfCF    one LightGCN encoder + predictor against its own edge-dropped,
            gradient-free output

Every random draw the JAX code makes inside the loss (SimGCL's noise,
MixGCF's candidates and mixing weights, SSL4Rec's feature-dropout mask,
NCL's initial centroids) goes through one small function here
(`_uniform`, `_randint`, `_keep_mask`, `_initial_centroids`) from the
generator the trainer passes (on the card, registered with the step
graph); torch cannot reproduce JAX's streams, so tests replace these
functions and the JAX calls with one numpy draw.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from ..data.device import CFDeviceData
from ..ops.losses import (
    _l2_normalize,
    batch_softmax_loss,
    bpr_loss,
    info_nce_masked,
    l2_reg_loss,
    unique_mask,
)
from .base import Extras, ModelBundle, flax_init, register_model
from .layers import Tables, gcn_prop
from .lightgcn import mean_split, propagate


def _uniform(shape: tuple, generator: torch.Generator | None, device) -> torch.Tensor:
    """U[0, 1) float32 draws (`jax.random.uniform`)."""
    return torch.rand(shape, generator=generator, device=device)


def _randint(shape: tuple, high: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """Integers from [0, high) (`jax.random.randint`)."""
    return torch.randint(0, high, shape, generator=generator, device=device)


def _keep_mask(shape: tuple, keep: float, generator: torch.Generator | None,
               device) -> torch.Tensor:
    """Bernoulli(keep) booleans (`jax.random.bernoulli`)."""
    return torch.rand(shape, generator=generator, device=device) < keep


def _initial_centroids(n: int, k: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """k distinct row ids of [0, n) (`jax.random.choice(..., replace=False)`)."""
    return torch.randperm(n, generator=generator, device=device)[:k]


def _lightgcn_forward(cf: CFDeviceData, u: torch.Tensor, i: torch.Tensor, n_layers: int,
                      generator: torch.Generator | None = None,
                      eps: float = 0.0) -> list[torch.Tensor]:
    """LightGCN's propagation; with eps > 0, SimGCL's per-layer noise
    e += eps * sign(e) * l2_normalize(uniform noise) after each layer."""
    if eps == 0.0:
        return propagate(cf, u, i, n_layers)
    outs = [torch.cat([u, i])]
    for _ in range(n_layers):
        ego = gcn_prop(cf.adj, outs[-1])
        noise = _l2_normalize(_uniform(tuple(ego.shape), generator, ego.device))
        outs.append(ego + eps * torch.sign(ego) * noise)
    return outs


def _unit(x: torch.Tensor) -> torch.Tensor:
    """Row-normalised x (jax.lax.rsqrt of the clamped squared norm)."""
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=1e-12))


def _cos_reg(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean(2 - 2 cos(pred, target)), the BUIR / SelfCF regression loss."""
    return torch.mean(2.0 - 2.0 * torch.sum(_unit(pred) * _unit(target), dim=-1))


def _bundle(name: str, cfg: Config, cf: CFDeviceData, module: nn.Module, **kw) -> ModelBundle:
    return ModelBundle(name=name, cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module, **kw)


# ---------------------------------------------------------------- DirectAU
@register_model("DirectAU")
def build_directau(cfg: Config, cf: CFDeviceData, kg=None) -> ModelBundle:
    module = Tables(cf.n_users, cf.n_items, cfg.embedding_size).to(cf.edge_u.device)
    gamma = cfg.cl_rate if cfg.cl_rate > 0 else 1.0

    def uniformity(x: torch.Tensor) -> torch.Tensor:
        d2 = torch.sum(torch.square(x[:, None, :] - x[None, :, :]), dim=-1)
        n = x.shape[0]
        off_diag = ~torch.eye(n, dtype=torch.bool, device=x.device)
        return torch.log(torch.sum(torch.exp(-2.0 * d2) * off_diag) / max(n * (n - 1), 1))

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos = (t.long() for t in batch[:2])
        un, pn = _unit(module.user_emb[users]), _unit(module.item_emb[pos])
        align = torch.mean(torch.sum(torch.square(un - pn), dim=1))
        unif = (uniformity(un[:256]) + uniformity(pn[:256])) / 2.0
        return align + gamma * unif, {"rec_loss": align.detach(), "cl_loss": unif.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        return module.user_emb.detach().clone(), module.item_emb.detach().clone()

    return _bundle("DirectAU", cfg, cf, module, init=flax_init(module),
                   encode_eval=encode_eval, batch_loss=batch_loss)


def _lightgcn_encode(cf: CFDeviceData, module: Tables, n_layers: int):
    @torch.no_grad()
    def encode_eval(extras: Extras):
        return mean_split(cf, propagate(cf, *module(), n_layers))

    return encode_eval


# ---------------------------------------------------------------- SimGCL
SIMGCL_EPS = 0.1


def _build_simgcl_like(name: str, single_pass: bool):
    def builder(cfg: Config, cf: CFDeviceData, kg=None) -> ModelBundle:
        module = Tables(cf.n_users, cf.n_items, cfg.embedding_size).to(cf.edge_u.device)
        n_u = cf.n_users

        def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
            users, pos, neg = (t.long() for t in batch[:3])
            u, i = module()
            u_emb, i_emb = mean_split(cf, _lightgcn_forward(cf, u, i, cfg.n_layers))
            ue, pe, ne = u_emb[users], i_emb[pos], i_emb[neg]
            rec = bpr_loss(ue, pe, ne)
            reg = l2_reg_loss(cfg.reg, ue, pe, ne) / cfg.batch_size
            uu, um = unique_mask(users)
            iu, im = unique_mask(pos)
            if single_pass:
                # XSimGCL: one noisy pass; its final mean against its layer 1
                noisy = _lightgcn_forward(cf, u, i, cfg.n_layers, generator, SIMGCL_EPS)
                fu, fi = mean_split(cf, noisy)
                lu, li = noisy[1][:n_u], noisy[1][n_u:]
                cl = info_nce_masked(fu[uu], lu[uu], um, cfg.temp)
                cl = cl + info_nce_masked(fi[iu], li[iu], im, cfg.temp)
            else:
                v1 = _lightgcn_forward(cf, u, i, cfg.n_layers, generator, SIMGCL_EPS)
                v2 = _lightgcn_forward(cf, u, i, cfg.n_layers, generator, SIMGCL_EPS)
                u1, i1 = mean_split(cf, v1, skip_first=True)
                u2, i2 = mean_split(cf, v2, skip_first=True)
                cl = info_nce_masked(u1[uu], u2[uu], um, cfg.temp)
                cl = cl + info_nce_masked(i1[iu], i2[iu], im, cfg.temp)
            cl = cfg.cl_rate * cl
            return rec + reg + cl, {"rec_loss": rec.detach(), "cl_loss": cl.detach()}

        return _bundle(name, cfg, cf, module, init=flax_init(module),
                       encode_eval=_lightgcn_encode(cf, module, cfg.n_layers),
                       batch_loss=batch_loss)

    return builder


register_model("SimGCL")(_build_simgcl_like("SimGCL", single_pass=False))
register_model("XSimGCL")(_build_simgcl_like("XSimGCL", single_pass=True))


# ---------------------------------------------------------------- NCL
N_CLUSTERS = 32
KMEANS_ITERS = 5
PROTO_REG = 1e-7


def kmeans(x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """Lloyd's iterations from N_CLUSTERS distinct rows of x (the JAX
    `_kmeans`, which replaces upstream faiss): argmin ties go to the first
    centroid, as `jnp.argmin` breaks them; an empty cluster's centroid is 0."""
    cent = x[_initial_centroids(x.shape[0], N_CLUSTERS, generator, x.device)]
    for _ in range(KMEANS_ITERS):
        d = torch.sum(torch.square(x[:, None] - cent[None]), dim=-1)
        one_hot = nn.functional.one_hot(torch.argmin(d, dim=1), N_CLUSTERS).to(x.dtype)
        counts = torch.clamp(one_hot.sum(0), min=1.0)
        cent = (one_hot.T @ x) / counts[:, None]
    return cent


@register_model("NCL")
def build_ncl(cfg: Config, cf: CFDeviceData, kg=None) -> ModelBundle:
    device = cf.edge_u.device
    module = Tables(cf.n_users, cf.n_items, cfg.embedding_size).to(device)
    n_u = cf.n_users
    tables_init = flax_init(module)

    def init(generator: torch.Generator) -> Extras:
        tables_init(generator)
        zeros = lambda: torch.zeros(N_CLUSTERS, cfg.embedding_size, device=device)  # noqa: E731
        return {"user_centroids": zeros(), "item_centroids": zeros()}

    def epoch_setup(extras: Extras, generator: torch.Generator | None) -> Extras:
        return {"user_centroids": kmeans(module.user_emb.detach(), generator),
                "item_centroids": kmeans(module.item_emb.detach(), generator)}

    def proto(x, cent, nodes, valid):
        xn = x[nodes]
        d = torch.sum(torch.square(xn[:, None] - cent[None]), dim=-1)
        return info_nce_masked(xn, cent[torch.argmin(d, dim=1)], valid, cfg.temp)

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos, neg = (t.long() for t in batch[:3])
        u, i = module()
        outs = _lightgcn_forward(cf, u, i, cfg.n_layers)
        u_emb, i_emb = mean_split(cf, outs)
        ue, pe, ne = u_emb[users], i_emb[pos], i_emb[neg]
        rec = bpr_loss(ue, pe, ne)
        reg = l2_reg_loss(cfg.reg, ue, pe, ne) / cfg.batch_size
        uu, um = unique_mask(users)
        iu, im = unique_mask(pos)
        # structural: the even-hop layer (2) against the ego layer
        hop, ego = outs[min(2, len(outs) - 1)], outs[0]
        ssl = info_nce_masked(hop[:n_u][uu], ego[:n_u][uu], um, cfg.temp)
        ssl = cfg.cl_rate * (ssl + info_nce_masked(hop[n_u:][iu], ego[n_u:][iu], im, cfg.temp))
        # prototype: each picked row against its nearest centroid
        pl = proto(u, extras["user_centroids"], uu, um) + proto(i, extras["item_centroids"],
                                                                iu, im)
        pl = PROTO_REG * pl
        loss = rec + reg + ssl + pl
        return loss, {"rec_loss": rec.detach(), "cl_loss": ssl.detach(),
                      "proto_loss": pl.detach()}

    return _bundle("NCL", cfg, cf, module, init=init,
                   encode_eval=_lightgcn_encode(cf, module, cfg.n_layers),
                   batch_loss=batch_loss, epoch_setup=epoch_setup)


# ---------------------------------------------------------------- MixGCF
N_CAND_NEGS = 8


@register_model("MixGCF")
def build_mixgcf(cfg: Config, cf: CFDeviceData, kg=None) -> ModelBundle:
    module = Tables(cf.n_users, cf.n_items, cfg.embedding_size).to(cf.edge_u.device)

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos = (t.long() for t in batch[:2])
        u_emb, i_emb = mean_split(cf, _lightgcn_forward(cf, *module(), cfg.n_layers))
        ue, pe = u_emb[users], i_emb[pos]
        # hop mixing: N_CAND_NEGS candidates mixed with the positive, the
        # hardest (largest inner product) taken as the negative
        b = users.shape[0]
        cands = _randint((b, N_CAND_NEGS), cf.n_items, generator, ue.device)
        alpha = _uniform((b, N_CAND_NEGS, 1), generator, ue.device)
        mixed = alpha * i_emb[cands] + (1 - alpha) * pe[:, None, :]
        hardest = torch.argmax(torch.einsum("bd,bmd->bm", ue, mixed), dim=1)
        ne = torch.take_along_dim(mixed, hardest[:, None, None], dim=1)[:, 0]
        rec = bpr_loss(ue, pe, ne)
        reg = l2_reg_loss(cfg.reg, ue, pe, ne) / cfg.batch_size
        return rec + reg, {"rec_loss": rec.detach(), "reg_loss": reg.detach()}

    return _bundle("MixGCF", cfg, cf, module, init=flax_init(module),
                   encode_eval=_lightgcn_encode(cf, module, cfg.n_layers), batch_loss=batch_loss)


# ---------------------------------------------------------------- SSL4Rec
class Towers(nn.Module):
    """The tables and a Dense tower on each side (`user_tower`,
    `item_tower`); the item tower's input may be feature-dropped."""

    def __init__(self, n_users: int, n_items: int, dim: int):
        super().__init__()
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.user_tower = nn.Linear(dim, dim)
        self.item_tower = nn.Linear(dim, dim)

    def items(self, drop_rate: float = 0.0, generator: torch.Generator | None = None):
        i = self.item_emb
        if drop_rate > 0.0:
            keep = _keep_mask(tuple(i.shape), 1.0 - drop_rate, generator, i.device)
            i = torch.where(keep, i, 0.0) / (1.0 - drop_rate)
        return self.item_tower(i)

    def forward(self):
        return self.user_tower(self.user_emb), self.items()


@register_model("SSL4Rec")
def build_ssl4rec(cfg: Config, cf: CFDeviceData, kg=None) -> ModelBundle:
    module = Towers(cf.n_users, cf.n_items, cfg.embedding_size).to(cf.edge_u.device)

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos = (t.long() for t in batch[:2])
        u_emb, i_emb = module()
        rec = batch_softmax_loss(u_emb[users], i_emb[pos], cfg.temp)
        # item-side contrast between two feature-dropped towers
        i1 = module.items(cfg.drop_rate, generator)
        i2 = module.items(cfg.drop_rate, generator)
        iu, im = unique_mask(pos)
        cl = cfg.cl_rate * info_nce_masked(i1[iu], i2[iu], im, cfg.temp)
        reg = l2_reg_loss(cfg.reg, u_emb[users], i_emb[pos]) / cfg.batch_size
        return rec + cl + reg, {"rec_loss": rec.detach(), "cl_loss": cl.detach()}

    return _bundle("SSL4Rec", cfg, cf, module, init=flax_init(module),
                   encode_eval=torch.no_grad()(lambda extras: module()), batch_loss=batch_loss)


# ---------------------------------------------------------------- BUIR
BUIR_MOMENTUM = 0.995


class Predicted(nn.Module):
    """The tables and one Dense `predictor` applied to either side (BUIR's
    online encoder), or to SelfCF's propagated tables."""

    def __init__(self, n_users: int, n_items: int, dim: int):
        super().__init__()
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.predictor = nn.Linear(dim, dim)


@register_model("BUIR")
def build_buir(cfg: Config, cf: CFDeviceData, kg=None) -> ModelBundle:
    """BUIR-ID: the online tables and predictor regress the slowly moving
    EMA target tables (extras, `update_extras` each step before the loss),
    both directions; no negatives."""
    module = Predicted(cf.n_users, cf.n_items, cfg.embedding_size).to(cf.edge_u.device)
    tables_init = flax_init(module)
    m = BUIR_MOMENTUM

    def init(generator: torch.Generator) -> Extras:
        tables_init(generator)
        # copies: an alias would make the EMA write into the parameters
        return {"target_u": module.user_emb.detach().clone(),
                "target_i": module.item_emb.detach().clone()}

    def update_extras(extras: Extras, batch) -> Extras:
        return {"target_u": m * extras["target_u"] + (1 - m) * module.user_emb.detach(),
                "target_i": m * extras["target_i"] + (1 - m) * module.item_emb.detach()}

    def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
        users, pos = (t.long() for t in batch[:2])
        u, i = module.user_emb, module.item_emb
        pu, pi = module.predictor(u), module.predictor(i)
        tu, ti = extras["target_u"].detach(), extras["target_i"].detach()
        loss = _cos_reg(pu[users], ti[pos]) + _cos_reg(pi[pos], tu[users])
        reg = l2_reg_loss(cfg.reg, u[users], i[pos]) / cfg.batch_size
        return loss + reg, {"rec_loss": loss.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        # BUIR eq. 7's symmetric online/target scores, folded into single
        # representations u + pred(u), i + pred(i)
        u, i = module.user_emb, module.item_emb
        return u + module.predictor(u), i + module.predictor(i)

    return _bundle("BUIR", cfg, cf, module, init=init, encode_eval=encode_eval,
                   batch_loss=batch_loss, update_extras=update_extras)


# ---------------------------------------------------------------- SelfCF
@register_model("SelfCF")
def build_selfcf(cfg: Config, cf: CFDeviceData, kg=None) -> ModelBundle:
    """SelfCF-ed: one LightGCN encoder and a predictor; the target is the
    same encoder's output on the edge-dropped adjacency, without gradient
    (no momentum network). The target pass runs under `no_grad`, so it
    launches no backward products."""
    module = Predicted(cf.n_users, cf.n_items, cfg.embedding_size).to(cf.edge_u.device)
    keep = 1.0 - cfg.drop_rate

    def encode(adj=None):
        outs = propagate(cf, module.user_emb, module.item_emb, cfg.n_layers, adj)
        return mean_split(cf, outs)

    def batch_loss(extras: Extras, batch, edge_keys, generator=None):
        users, pos = (t.long() for t in batch[:2])
        u, i = encode()
        pu, pi = module.predictor(u), module.predictor(i)
        with torch.no_grad():
            adj = cf.adj.dropped(edge_keys[0], keep) if keep < 1.0 else cf.adj
            tu, ti = encode(adj)
        loss = _cos_reg(pu[users], ti[pos]) + _cos_reg(pi[pos], tu[users])
        reg = l2_reg_loss(cfg.reg, u[users], i[pos]) / cfg.batch_size
        return loss + reg, {"rec_loss": loss.detach()}

    @torch.no_grad()
    def encode_eval(extras: Extras):
        u, i = encode()
        return u + module.predictor(u), i + module.predictor(i)

    return _bundle("SelfCF", cfg, cf, module, init=flax_init(module),
                   encode_eval=encode_eval, batch_loss=batch_loss, n_edge_keys=1)
