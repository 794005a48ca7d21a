"""AutoCF — the graph masked autoencoder — and LRMRec (AutoCF with frozen
profile embeddings and a reconstruction term): the port of the JAX
package's `models/autocf.py` (reference model/graph/AutoCF.py, LRMRec.py).

  * seed scoring (`_local_graph_scores`, AutoCF.py:256-281): the two-hop
    mean neighbourhood embedding against the ego embedding, plus Gumbel
    noise; the SEED_NUM best are the seeds;
  * subgraph masking (`_mask_subgraphs`, :283-355): every edge touching
    the (MASK_DEPTH - 1)-hop ball around the seeds leaves the encoder
    graph, which is re-normalised; the decoder's edges are random pairs
    among the masked nodes (the ball and KEEP_RATE * N random nodes; a
    proposal outside it falls back to the first seed), self loops and the
    kept edges, with a validity mask (the JAX package's static-shape form);
  * `GTLayer` (:222-255): per-edge multi-head attention over the decoder
    edges, a segment softmax per row and head;
  * loss: -mean(u . pos) + L2 / batch + the denominator-only contrast over
    the batch's unique nodes (`_contrast_reg`, :131-139), and, at the steps
    that refresh the subgraphs, minus the mean seed score (:85-93);
  * LRMRec: NodeMask (MASK_RATIO of the node embeddings replaced by a
    learned mask token), a projection MLP and InfoNCE reconstruction
    against the frozen profiles (LRMRec.py:248-262), read from
    `<data_dir>/<dataset>/{usr,itm}_emb_np.pkl` when both exist, else the
    JAX package's seeded random matrix. The profiles are a buffer, not a
    parameter: Adam's decay would move them.

The subgraphs are refreshed every FIX_STEPS steps, the first included
(AutoCF.py:71-73). Where JAX picks with `lax.cond` on a traced step count,
the port keeps the count as a host integer in the extras (`step`) and
names the two paths (`step_branch`: "refresh", "keep"), so the trainer
captures a CUDA graph of each; `update_extras` draws the refresh from the
trainer's card generator inside the refresh graph. The encoder graph's
values, in `raw_adj`'s edge order, replace `adj`'s through `with_new_vals`:
the two matrices share one edge order and padding (checked at build).
Products: the encoder's two one-sided `spmm`s a step (a kernel forward, a
torch-ops backward) and five more at a refresh (four for the seed scores,
two of width 1, and one width-1 product for the ball). The random draws
go through `_uniform`, `_randint` and `_choice` (capture-safe: `torch.rand`
then `topk`), which tests replace with the JAX draws.

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
computes the per-example terms of its share of the batch
(`parallel.mesh.data_share`): the score mean and the contrast's terms of
its share's picks, each over every node's denominator; the L2 norms, the
seed score and LRMRec's reconstruction, which read no batch row or couple
the rows, are computed whole at weight 1 / data ranks. The subgraph
refresh draws from tables, not the batch, so every rank draws alike.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch import nn

from ..core.config import Config
from ..core.types import with_new_vals
from ..data.device import CFDeviceData
from ..ops.losses import l2_reg_loss, unique_mask
from ..parallel.mesh import data_ranks, data_share
from ..ops.sparse import (
    gather_rows_hubs,
    renormalize_sym,
    scatter_sum_hubs,
    segment_softmax,
    spmm,
)
from .base import Extras, ModelBundle, register_model

# conf/AutoCF.conf values (the reference reads them from the conf file)
GT_LAYERS = 1
GCN_LAYERS = 2
SSL_REG = 0.5
FIX_STEPS = 10
HEAD_NUM = 4
SEED_NUM = 100
MASK_DEPTH = 2
KEEP_RATE = 0.2
# conf/LRMRec.conf's additions
MASK_RATIO = 0.1
RECON_WEIGHT = 0.01
RE_TEMPERATURE = 0.2


def _uniform(shape: tuple, generator: torch.Generator | None, device) -> torch.Tensor:
    """U[0, 1) float32 draws (`jax.random.uniform`)."""
    return torch.rand(shape, generator=generator, device=device)


def _randint(shape: tuple, high: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """Integers from [0, high) (`jax.random.randint`)."""
    return torch.randint(0, high, shape, generator=generator, device=device)


def _choice(n: int, k: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """k distinct ids of [0, n) (`jax.random.choice(..., replace=False)`):
    the top k of n uniform draws, which a CUDA graph can capture."""
    return torch.rand(n, generator=generator, device=device).topk(k).indices


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)


class GTLayer(nn.Module):
    """Edge-list graph-transformer attention (AutoCF.py:222-255): per edge
    and head, q_row . k_col clipped to [-10, 10], a softmax over each row's
    valid edges, the weighted v_col summed into the row."""

    def __init__(self, head_num: int, dim: int):
        super().__init__()
        self.head_num, self.dim = head_num, dim
        self.qTrans = nn.Parameter(torch.empty(dim, dim))
        self.kTrans = nn.Parameter(torch.empty(dim, dim))
        self.vTrans = nn.Parameter(torch.empty(dim, dim))

    def forward(self, embeds: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        n = embeds.shape[0]
        heads = (-1, self.head_num, self.dim // self.head_num)
        safe_rows = rows.long().clamp(0, n - 1)
        safe_cols = cols.long().clamp(0, n - 1)
        # the first seed's row and column hold most of the decoder's edges:
        # the sums over rows, and the gathers' backward, cut its runs
        at_cols = gather_rows_hubs(embeds, safe_cols)
        q = (gather_rows_hubs(embeds, safe_rows) @ self.qTrans).reshape(heads)
        k = (at_cols @ self.kTrans).reshape(heads)
        v = (at_cols @ self.vTrans).reshape(heads)
        att = torch.clamp(torch.sum(q * k, dim=-1), -10.0, 10.0)  # [E, H]
        att = segment_softmax(att, safe_rows, n, valid[:, None].expand(att.shape), hubs=True)
        res = (att[:, :, None] * v).reshape(-1, self.dim) * valid[:, None].to(v.dtype)
        return scatter_sum_hubs(res, safe_rows, n)


class ReconMLP(nn.Module):
    """flax's `nn.Sequential([Dense(mid), leaky_relu(0.01), Dense(out)])`,
    its layers under flax's names `layers_0` and `layers_2`."""

    def __init__(self, dim: int, mid: int, out: int):
        super().__init__()
        self.layers_0 = nn.Linear(dim, mid)
        self.layers_2 = nn.Linear(mid, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_2(nn.functional.leaky_relu(self.layers_0(x), 0.01))


class AutoCFModule(nn.Module):
    """`user_emb`, `item_emb`, `gt_layers_<k>` and, with profiles,
    `mask_token` [1, d], `recon_mlp` and the `profiles` buffer."""

    def __init__(self, n_users: int, n_items: int, dim: int,
                 profiles: torch.Tensor | None = None):
        super().__init__()
        self.n_users = n_users
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))
        self.gt_layers = [f"gt_layers_{k}" for k in range(GT_LAYERS)]
        for name in self.gt_layers:
            self.add_module(name, GTLayer(HEAD_NUM, dim))
        if profiles is not None:
            self.mask_token = nn.Parameter(torch.empty(1, dim))
            p_dim = profiles.shape[1]
            self.recon_mlp = ReconMLP(dim, (p_dim + dim) // 2, p_dim)
            # frozen, and out of the state dict: not a weight
            self.register_buffer("profiles", profiles, persistent=False)

    def ego(self) -> torch.Tensor:
        return torch.cat([self.user_emb, self.item_emb])

    def forward(self, enc_adj, dec=None, ego: torch.Tensor | None = None):
        """The sum of the ego table, GCN_LAYERS products on the encoder
        graph and, with `dec` (rows, cols, valid), the GT layers on the
        decoder edges; split into the user and the item table."""
        outs = [self.ego() if ego is None else ego]
        for _ in range(GCN_LAYERS):
            outs.append(spmm(enc_adj, outs[-1]))
        if dec is not None:
            for name in self.gt_layers:
                outs.append(getattr(self, name)(outs[-1], *dec))
        total = sum(outs)
        return total[: self.n_users], total[self.n_users :]

    def masked_ego(self, generator: torch.Generator | None, mask_ratio: float):
        """LRMRec's NodeMask: mask_ratio * N node embeddings replaced by the
        mask token; returns (the masked ego table, the masked ids)."""
        embeds = self.ego()
        n, d = embeds.shape
        seeds = _choice(n, int(n * mask_ratio), generator, embeds.device).long()
        return embeds.index_put((seeds,), self.mask_token.expand(seeds.shape[0], d)), seeds

    def reconstruct(self, embeds: torch.Tensor, seeds: torch.Tensor, temp: float) -> torch.Tensor:
        x = _unit_rows(self.recon_mlp(embeds[seeds]))
        y = _unit_rows(self.profiles[seeds])
        mole = torch.exp(torch.sum(x * y, dim=1) / temp)
        deno = torch.sum(torch.exp(x @ y.T / temp), dim=1)
        return -torch.mean(torch.log(mole / (deno + 1e-8) + 1e-8))


def _local_graph_scores(generator: torch.Generator | None, all_one, ego: torch.Tensor):
    """(noisy seed scores [N], the SEED_NUM seeds) of LocalGraph
    (AutoCF.py:256-281), over the raw bipartite matrix `all_one`."""
    order = spmm(all_one, ego.new_ones(all_one.ncols, 1))
    fst = spmm(all_one, ego) - ego
    fst_num = order
    scd = (spmm(all_one, fst) - fst) - order * ego
    scd_num = (spmm(all_one, fst_num) - fst_num) - order
    sub = _unit_rows((fst + scd) / (fst_num + scd_num + 1e-8))
    scores = torch.sigmoid(torch.sum(sub * _unit_rows(ego), dim=-1))
    noise = torch.clamp(_uniform(tuple(scores.shape), generator, ego.device), 1e-8, 1.0)
    noisy = torch.log(scores) - torch.log(-torch.log(noise))
    return noisy, torch.topk(noisy, SEED_NUM).indices


def _mask_subgraphs(generator: torch.Generator | None, cf: CFDeviceData, seeds: torch.Tensor):
    """(the re-normalised encoder values in raw_adj's order, the decoder's
    (rows, cols, valid) int32 / bool lists) of RandomMaskSubgraphs
    (AutoCF.py:283-355) in the JAX package's static-shape form."""
    n = cf.n_users + cf.n_items
    raw = cf.raw_adj.fwd
    dev = raw.vals.device
    ball = torch.zeros(n, dtype=torch.bool, device=dev).index_fill_(0, seeds.long(), True)
    for _ in range(MASK_DEPTH - 1):
        ball = ball | (spmm(raw, ball.float()[:, None])[:, 0] > 0)
    rows = raw.rows.long().clamp(0, n - 1)
    cols = raw.cols.long().clamp(0, n - 1)
    removed = ball[rows] | ball[cols]
    enc = renormalize_sym(with_new_vals(raw, torch.where(removed, 0.0, raw.vals)))

    # the masked-node pool: the ball and KEEP_RATE * N random nodes
    samp = _randint((int(n * KEEP_RATE),), n, generator, dev).long()
    pool = ball.index_fill(0, samp, True)
    # random decoder pairs: a uniform proposal, kept inside the pool, else
    # the first seed (the static stand-in for drawing from the masked list)
    nnz = raw.nnz_pad
    cand_r = _randint((nnz,), n, generator, dev).long()
    cand_c = _randint((nnz,), n, generator, dev).long()
    fb = seeds[0].long()
    tem_rows = torch.where(pool[cand_r], cand_r, fb)
    tem_cols = torch.where(pool[cand_c], cand_c, fb)
    self_loop = torch.arange(n, device=dev)
    dec_rows = torch.cat([tem_rows, tem_cols, self_loop, rows]).int()
    dec_cols = torch.cat([tem_cols, tem_rows, self_loop, cols]).int()
    dec_valid = torch.cat([torch.ones(2 * nnz + n, dtype=torch.bool, device=dev),
                           (raw.rows < n) & ~removed])
    return enc.vals, (dec_rows, dec_cols, dec_valid)


def _contrast_reg(nodes: torch.Tensor, valid: torch.Tensor | None, embeds: torch.Tensor,
                  embeds2: torch.Tensor | None = None,
                  rows: slice = slice(None)) -> torch.Tensor:
    """AutoCF's denominator-only contrast (AutoCF.py:131-139): the mean over
    the (valid) picked nodes of log sum exp(pick . all). `rows`: the picks
    whose terms are added (a data rank's share); the mean stays over every
    (valid) pick."""
    pck = embeds[nodes[rows]]
    if embeds2 is None:
        scores = torch.log(torch.sum(torch.exp(pck @ embeds.T), dim=-1))
        vf = valid.to(scores.dtype)
        return torch.sum(scores * vf[rows]) / torch.clamp(torch.sum(vf), min=1.0)
    return torch.sum(torch.log(torch.sum(torch.exp(pck @ embeds2.T), dim=-1))) / nodes.shape[0]


def _load_profiles(cfg: Config, n_users: int, n_items: int) -> np.ndarray:
    """LRMRec's [U + I, p] profile embeddings: the LLM-derived pickles when
    both are there, else the JAX package's seeded stand-in."""
    base = os.path.join(cfg.data_dir, cfg.dataset)
    up, ip = os.path.join(base, "usr_emb_np.pkl"), os.path.join(base, "itm_emb_np.pkl")
    if os.path.exists(up) and os.path.exists(ip):
        with open(up, "rb") as f:
            usr = np.asarray(pickle.load(f), np.float32)
        with open(ip, "rb") as f:
            itm = np.asarray(pickle.load(f), np.float32)
    else:
        rng = np.random.default_rng(0)
        usr = rng.standard_normal((n_users, 64)).astype(np.float32)
        itm = rng.standard_normal((n_items, 64)).astype(np.float32)
    return np.concatenate([usr, itm], axis=0)


def _check_shared_order(cf: CFDeviceData) -> None:
    """The encoder's values, computed over raw_adj, are written into adj's
    layout: both must hold the same edges in the same order and padding."""
    a, r = cf.adj, cf.raw_adj
    same = (a.fwd.nnz_pad == r.fwd.nnz_pad and a.host is not None and r.host is not None
            and np.array_equal(a.host.rows, r.host.rows)
            and np.array_equal(a.host.cols, r.host.cols))
    if not same:
        raise ValueError("AutoCF: adj and raw_adj do not share one edge order and padding")


def _build_autocf_like(name: str, use_profiles: bool):
    def builder(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
        _check_shared_order(cf)
        device = cf.edge_u.device
        profiles = (torch.as_tensor(_load_profiles(cfg, cf.n_users, cf.n_items), device=device)
                    if use_profiles else None)
        module = AutoCFModule(cf.n_users, cf.n_items, cfg.embedding_size, profiles).to(device)
        n = cf.n_nodes
        n_dec = 3 * cf.raw_adj.fwd.nnz_pad + n

        def init(generator: torch.Generator) -> Extras:
            from ..weights import init_flax

            module.load_state_dict(init_flax(module, generator))
            zeros = lambda dtype: torch.zeros(n_dec, dtype=dtype, device=device)  # noqa: E731
            return {"enc_vals": cf.adj.fwd.vals.clone(), "dec_rows": zeros(torch.int32),
                    "dec_cols": zeros(torch.int32), "dec_valid": zeros(torch.bool),
                    "samp_score": torch.zeros((), device=device), "step": 0}

        def step_branch(extras: Extras) -> str:
            return "refresh" if extras["step"] % FIX_STEPS == 0 else "keep"

        def update_extras(extras: Extras, batch, generator=None) -> Extras:
            """Resample the masked subgraphs on the refresh steps
            (AutoCF.py:71-73)."""
            if step_branch(extras) == "keep":
                return {}
            scores, seeds = _local_graph_scores(generator, cf.raw_adj.fwd, module.ego().detach())
            enc_vals, (rows, cols, valid) = _mask_subgraphs(generator, cf, seeds)
            return {"enc_vals": enc_vals, "dec_rows": rows, "dec_cols": cols,
                    "dec_valid": valid, "samp_score": scores.mean()}

        def batch_loss(extras: Extras, batch, edge_keys=(), generator=None):
            users, pos, neg = (t.long() for t in batch[:3])
            share = data_share(mesh, users.shape[0])
            rows = share.rows
            enc_adj = with_new_vals(cf.adj.fwd, extras["enc_vals"])
            dec = (extras["dec_rows"], extras["dec_cols"], extras["dec_valid"])
            recon = 0.0
            if use_profiles:
                mego, seeds = module.masked_ego(generator, MASK_RATIO)
                u_emb, i_emb = module(enc_adj, dec, mego)
                recon = share.whole * RECON_WEIGHT * module.reconstruct(
                    torch.cat([u_emb, i_emb]), seeds, RE_TEMPERATURE)
            else:
                u_emb, i_emb = module(enc_adj, dec)
            ue, pe, ne = u_emb[users], i_emb[pos], i_emb[neg]
            rec = -share.part * torch.mean(torch.sum(ue[rows] * pe[rows], dim=-1))
            reg = share.whole * l2_reg_loss(cfg.reg, ue, pe, ne) / cfg.batch_size
            uu, um = unique_mask(users)
            iu, im = unique_mask(pos)
            cl = ((_contrast_reg(uu, um, u_emb, rows=rows)
                   + _contrast_reg(iu, im, i_emb, rows=rows)) * SSL_REG
                  + _contrast_reg(users, None, u_emb, i_emb, rows))
            # the seed-score term, at the steps that refreshed (AutoCF.py:89-91)
            lg = (-share.whole * extras["samp_score"] if step_branch(extras) == "refresh"
                  else 0.0)
            loss = rec + reg + cl + lg + recon
            aux = {"rec_loss": rec.detach(), "cl_loss": cl.detach(), "reg_loss": reg.detach(),
                   "_new_extras": {"step": extras["step"] + 1}}
            if use_profiles:
                aux["recon_loss"] = recon.detach()
            return loss, aux

        @torch.no_grad()
        def encode_eval(extras: Extras):
            # the clean normalised adjacency, no decoder (AutoCF.py:116-121)
            return module(cf.adj.fwd)

        return ModelBundle(name=name, cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
                           init=init, encode_eval=encode_eval, batch_loss=batch_loss,
                           update_extras=update_extras, step_branch=step_branch,
                           # the reference imports ReduceLROnPlateau, never builds it
                           lr_plateau=False, data_split=data_ranks(mesh) > 1)

    return builder


register_model("AutoCF")(_build_autocf_like("AutoCF", use_profiles=False))
register_model("LRMRec")(_build_autocf_like("LRMRec", use_profiles=True))
