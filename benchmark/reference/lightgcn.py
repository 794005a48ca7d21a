"""LightGCN in plain PyTorch: the benchmark's reference for the
`lightgcn-*` configurations. It imports nothing of the program.

The model (He et al., SIGIR 2020, §3.1): E0 = [user table; item table],
E_{k+1} = A E_k over the normalised user-item adjacency A, the tables the
mean of E_0..E_K. The loss, as the SELFRec code that the program follows
writes it: BPR on (user, positive, negative), -log(1e-5 + sigmoid(u.p -
u.n)), plus `reg` x the unsquared L2 norms of the batch's propagated rows
over the batch size (the paper: the squared norms of the layer-0 rows).
Adam with coupled decay `weight_decay`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .common import CF, Sparse, bpr, bipartite, cf_ids, dense_precision, l2_norms, \
    planted_rows, spmm


@dataclass
class Graph:
    cf: CF
    adj: Sparse | None = None  # on the device, from `attach`


def derive(train: np.ndarray, test: np.ndarray, kg) -> Graph:
    return Graph(cf_ids(train, test))


def attach(g: Graph, device) -> None:
    g.adj = bipartite(g.cf, device)


def sizes(g: Graph, settings: dict) -> dict:
    """The configuration's settings with the graph's sizes beside them (the
    matrix's entries once it is attached)."""
    out = dict(settings, n_users=g.cf.n_users, n_items=g.cf.n_items,
               n_train=len(g.cf.train_u), n_test_users=int(np.unique(g.cf.test_u).shape[0]))
    if g.adj is not None:
        out["cf_nnz"] = int(g.adj.vals.shape[0])
    return out


def param_shapes(s: dict) -> dict:
    d = s["embedding_size"]
    return {"user_emb": (s["n_users"], d), "item_emb": (s["n_items"], d)}


def make_weights(s: dict, generator: torch.Generator, device) -> dict:
    """Both tables Xavier-uniform (fan: rows + width), in one draw."""
    shapes = param_shapes(s)
    n = sum(int(np.prod(v)) for v in shapes.values())
    u = torch.rand(n, generator=generator, device=device) * 2 - 1
    out, o = {}, 0
    for name, shape in shapes.items():
        k = int(np.prod(shape))
        out[name] = (u[o:o + k] * (6.0 / (shape[0] + shape[1])) ** 0.5).reshape(shape)
        o += k
    return out


def trained_weights(g: Graph, s: dict, latent: dict, strength: float,
                    generator: torch.Generator, device) -> dict:
    """Tables as training leaves them: `make_weights`'s, each row drawn
    towards the generator's planted structure (`planted_rows`)."""
    w = make_weights(s, generator, device)
    users, items = planted_rows(latent, g.cf, s["embedding_size"], strength, generator, device)
    return dict(w, user_emb=w["user_emb"] + users, item_emb=w["item_emb"] + items)


def initial_extras(g: Graph, s: dict, device) -> dict:
    return {}


def trained_extras(g: Graph, s: dict, generator: torch.Generator, device) -> dict:
    return {}


def draw_batches(g: Graph, s: dict, n: int, generator: torch.Generator, device) -> list:
    """`n` batches in the program's form (int32), on rows that all differ:
    consecutive slices of one permutation of the training pairs; negatives
    uniform over the items."""
    b = s["batch_size"]
    pairs = torch.randperm(len(g.cf.train_u), generator=generator, device=device)[: n * b]
    tu = torch.as_tensor(g.cf.train_u, device=device)
    ti = torch.as_tensor(g.cf.train_i, device=device)
    out = []
    for k in range(n):
        p = pairs[k * b:(k + 1) * b]
        neg = torch.randint(0, g.cf.n_items, (b,), generator=generator, device=device)
        out.append(tuple(x.int() for x in (tu[p], ti[p], neg)))
    return out


def forward(p: dict, g: Graph, s: dict, precision: str):
    x = torch.cat([p["user_emb"], p["item_emb"]])
    outs = [x]
    for _ in range(s["n_layers"]):
        outs.append(spmm(g.adj, outs[-1], precision))
    emb = torch.stack(outs, dim=1).mean(dim=1)
    return emb[: g.cf.n_users], emb[g.cf.n_users:]


def loss(p: dict, extras: dict, batch, keys, g: Graph, s: dict, precision: str,
         generator: torch.Generator | None = None):
    """(the step's loss, the next step's extras); LightGCN draws nothing
    from `generator`."""
    users, pos, neg = (x.long() for x in batch)
    with dense_precision(precision):
        u, i = forward(p, g, s, precision)
        ue, pe, ne = u[users], i[pos], i[neg]
        total = bpr(ue, pe, ne) + l2_norms(s["reg"], ue, pe, ne) / s["batch_size"]
    return total, {}


@torch.no_grad()
def encode(p: dict, extras: dict, g: Graph, s: dict, precision: str):
    with dense_precision(precision):
        return forward(p, g, s, precision)


def n_edge_keys() -> int:
    return 0
