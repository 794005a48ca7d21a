"""HGNN_HD3 in plain PyTorch: the benchmark's reference for the `hgnn_hd3-*`
configurations. It imports nothing of the program.

The model (HD_SELFRec model/graph/HGNN_HD3.py, mode "full", 2 layers),
over the tables E = [users; items] [U + I, d]:
  * the local view (`LocalAwareEncoder`, :352-427): one ED-HNN layer
    (its `EquivSetGNN`, :555-610, and `EquivSetConv`, model/layers/
    EquivSetConv.py:86-107) and the ego residual, then the cap,
        X  = relu(drop_0.6(E) W_lift + b)
        X1 = drop_0.5(X)
        Xe = LN_0(leaky_0.2(A (A^T X1))) + X1
        Xev = AdaptiveAvgPool1d(d)([X1, Xe])            (:72,100)
        Xv = LN_1(leaky_0.2(A (A^T Xev))) + Xev
        L  = drop_0.5(relu(MLP(Xv))) + E                 MLP: LN_in, then Dense
        L  = LN_cap(A (A^T L)) + E
    with A the normalised (U + I)^2 user-item adjacency;
  * the group view (`GroupAwareEncoder`, :451-523): one HWNN wavelet
    layer a side (model/layers/wavelet.py:109-154) over the normalised
    incidence B = D_v^-1/2 H D_e^-1/2 [U, I], Theta_u = B B^T for the users
    and Theta_i = B^T B for the items,
        hwnn(X) = poly_1(Theta) diag(w) poly_2(Theta) X W,
        poly_1 = sum_{k<3} par[k] Theta^k,  poly_2 = sum_{k<3} par[3 + k] Theta^k,
        G = [hwnn_u(E_u) + E_u; hwnn_i(E_i) + E_i]
        G = LN_g(A (A^T G)) + E;
  * the tables the loss and the ranking read: the mean of the two views;
  * the loss: BPR on (user, positive, negative), -log(1e-5 + sigmoid(u.p -
    u.n)), plus `reg` x the rows' unsquared L2 norms over the batch size,
    plus `cl_rate` x the cross-view contrast (temperature `temp`) of the
    batch's distinct users (local against group user rows) and of its
    distinct positive items (local against group item rows);
  * training drops the edges of A at rate `drop_rate` with the step's one
    key: the local view and the group view's last conv see the same draw;
    the HWNN layers run on the undropped B. The feature dropouts (rates 0.6,
    0.5, 0.5, the model's own) draw their masks from the step's generator,
    in that order, each a [U + I, d] `torch.rand(..) < keep`, the kept
    values divided by keep: the program's form.
`p` reaches no activation: the caps' convs are linear and the ED-HNN's
leaky ReLU has its own slope, 0.2.

Departures from the published code, which the program shares:
  * the item contrast compares the local with the group item rows; the
    published :348-349 compares the group rows with themselves (the JAX
    package's repair);
  * one `EquivSetGNN` signature (the published file carries its own copy
    beside model/layers/EquivSetGNN.py, whose constructor differs);
  * Theta is never a dense matrix: the published :386-387 materialise H
    dense; here a power of Theta is two sparse products;
  * each side's HWNN takes its own side's rows (the published group path
    multiplies the (U + I)^2 polynomial into U-sized features);
  * LayerNorm epsilon 1e-6; the contrast's rows are shifted by 1e-8 before
    they are normalised.

Sparse products run at the configuration's precision (`common.spmm`);
every other sum in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .common import CF, Sparse, bipartite, bpr, cf_ids, dense_mm, dense_precision, dropped, \
    l2_norms, planted_rows, sparse_from_coo, spmm

LN_EPS = 1e-6
INPUT_DROPOUT, DROPOUT = 0.6, 0.5  # EquivSetGNN's fixed rates (HGNN_HD3.py:555-610)
LEAKY = 0.2  # EquivSetConv's leaky ReLU slope
K1 = K2 = 3  # HWNN's polynomial orders (wavelet.py:109-154)
LIFT = "local_enc.EquivSetGNN_0.Dense_0"
CONV = "local_enc.EquivSetGNN_0.EquivSetConvSpMM_0"


@dataclass
class Graph:
    cf: CF
    # on the device, from `attach`:
    adj: Sparse | None = None  # the normalised (U + I)^2 user-item adjacency
    b: Sparse | None = None  # D_v^-1/2 H D_e^-1/2 [U, I]


def derive(train: np.ndarray, test: np.ndarray, kg) -> Graph:
    return Graph(cf_ids(train, test))


def incidence(cf: CF, device) -> Sparse:
    """B = D_v^-1/2 H D_e^-1/2 of the [U, I] interaction counts H, D_v and
    D_e its row and column sums (data/graph.py:27-42)."""
    h = sparse_from_coo(cf.train_u, cf.train_i, np.ones(len(cf.train_u)),
                        (cf.n_users, cf.n_items), device)
    v = h.vals.double()
    dv = torch.zeros(h.shape[0], dtype=torch.float64, device=v.device).index_add_(0, h.rows, v)
    de = torch.zeros(h.shape[1], dtype=torch.float64, device=v.device).index_add_(0, h.cols, v)
    return h.with_vals((v * dv[h.rows].rsqrt() * de[h.cols].rsqrt()).float())


def attach(g: Graph, device) -> None:
    """Build the graph's matrices on `device`."""
    g.adj, g.b = bipartite(g.cf, device), incidence(g.cf, device)


def sizes(g: Graph, settings: dict) -> dict:
    """The configuration's settings with the graph's sizes beside them (the
    matrices' entries once they are attached)."""
    out = dict(settings, n_users=g.cf.n_users, n_items=g.cf.n_items, n_train=len(g.cf.train_u),
               n_test_users=int(np.unique(g.cf.test_u).shape[0]))
    if g.adj is not None:
        out.update(cf_nnz=int(g.adj.vals.shape[0]), b_hyper_nnz=int(g.b.vals.shape[0]))
    return out


def param_shapes(s: dict) -> dict:
    """The parameters, under the program's state-dict names."""
    d, u, i = s["hyper_dim"], s["n_users"], s["n_items"]
    shapes = {"user_emb": (u, d), "item_emb": (i, d),
              f"{LIFT}.weight": (d, d), f"{LIFT}.bias": (d,)}
    for ln in (f"{CONV}.LayerNorm_0", f"{CONV}.LayerNorm_1", f"{CONV}.MLP_0.LayerNorm_0"):
        shapes.update({f"{ln}.weight": (d,), f"{ln}.bias": (d,)})
    shapes.update({f"{CONV}.MLP_0.Dense_0.weight": (d, d), f"{CONV}.MLP_0.Dense_0.bias": (d,),
                   "local_enc.LayerNorm_0.weight": (d,), "local_enc.LayerNorm_0.bias": (d,)})
    for k, n in enumerate((u, i)):
        hw = f"group_enc.HWNNLayer_{k}"
        shapes.update({f"{hw}.par": (K1 + K2,), f"{hw}.diagonal_weight_filter": (n,),
                       f"{hw}.weight_matrix": (d, d)})
    shapes.update({"group_enc.LayerNorm_0.weight": (d,), "group_enc.LayerNorm_0.bias": (d,)})
    return shapes


def make_weights(s: dict, generator: torch.Generator, device) -> dict:
    """Weights drawn from `generator` (on `device`) in two calls, as the
    published initialisers: the tables and HWNN's `weight_matrix`
    Xavier-uniform, HWNN's `par` uniform on [0, 0.99) and its filter on
    [0.99, 1.01); the Dense kernels LeCun normal clamped at two standard
    deviations; biases 0, LayerNorm scales 1."""
    shapes = param_shapes(s)
    xavier = ["user_emb", "item_emb"] + [n for n in shapes if n.endswith(".weight_matrix")]
    uniform = xavier + [n for n in shapes if n.endswith((".par", ".diagonal_weight_filter"))]
    dense = [f"{LIFT}.weight", f"{CONV}.MLP_0.Dense_0.weight"]
    u = torch.rand(sum(int(np.prod(shapes[n])) for n in uniform), generator=generator, device=device)
    z = torch.randn(sum(int(np.prod(shapes[n])) for n in dense), generator=generator, device=device)
    out, ou, oz = {}, 0, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        if name in uniform:
            v = u[ou:ou + n].reshape(shape)
            ou += n
            if name in xavier:
                out[name] = (v * 2 - 1) * (6.0 / (shape[0] + shape[1])) ** 0.5
            elif name.endswith(".par"):
                out[name] = v * 0.99
            else:
                out[name] = 0.99 + 0.02 * v
        elif name in dense:
            std = (1.0 / shape[1]) ** 0.5 / 0.87962566103423978
            out[name] = (z[oz:oz + n] * std).clamp(-2 * std, 2 * std).reshape(shape)
            oz += n
        elif name.endswith(".weight"):  # a LayerNorm scale
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def trained_weights(g: Graph, s: dict, latent: dict, strength: float,
                    generator: torch.Generator, device) -> dict:
    """Weights as training leaves them: `make_weights`'s, the tables' rows
    drawn towards the generator's planted structure (`planted_rows`)."""
    w = make_weights(s, generator, device)
    users, items = planted_rows(latent, g.cf, s["hyper_dim"], strength, generator, device)
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


def _drop(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Feature dropout, the mask drawn from `generator`; none without one."""
    if generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[1],), p[name + ".weight"], p[name + ".bias"], LN_EPS)


def _dense(x, p, name, precision):
    return dense_mm(x, p[name + ".weight"].T, precision) + p[name + ".bias"]


def _conv(a: Sparse, a_t: Sparse, x: torch.Tensor, precision: str) -> torch.Tensor:
    """A (A^T X)."""
    return spmm(a, spmm(a_t, x, precision), precision)


def _local(p, ego, adj, adj_t, precision, generator):
    x = torch.relu(_dense(_drop(ego, INPUT_DROPOUT, generator), p, LIFT, precision))
    x = _drop(x, DROPOUT, generator)
    xe = _ln(F.leaky_relu(_conv(adj, adj_t, x, precision), LEAKY), p, f"{CONV}.LayerNorm_0") + x
    xev = F.adaptive_avg_pool1d(torch.cat([x, xe], dim=1)[:, None, :], x.shape[1])[:, 0, :]
    xv = _ln(F.leaky_relu(_conv(adj, adj_t, xev, precision), LEAKY), p, f"{CONV}.LayerNorm_1") + xev
    h = _dense(_ln(xv, p, f"{CONV}.MLP_0.LayerNorm_0"), p, f"{CONV}.MLP_0.Dense_0", precision)
    x = _drop(torch.relu(h), DROPOUT, generator) + ego
    return _ln(_conv(adj, adj_t, x, precision), p, "local_enc.LayerNorm_0") + ego


def _hwnn(p, name, x, theta, precision):
    """poly_1(Theta) diag(w) poly_2(Theta) X W."""
    par = p[name + ".par"]
    y, term = par[K1] * x, x
    for k in range(1, K2):
        term = theta(term)
        y = y + par[K1 + k] * term
    y = p[name + ".diagonal_weight_filter"][:, None] * y
    out, term = par[0] * y, y
    for k in range(1, K1):
        term = theta(term)
        out = out + par[k] * term
    return dense_mm(out, p[name + ".weight_matrix"], precision)


def _group(p, ego, b, adj, adj_t, n_users, precision):
    b_t = b.transposed()
    eu, ei = ego[:n_users], ego[n_users:]
    gu = _hwnn(p, "group_enc.HWNNLayer_0", eu, lambda v: _conv(b, b_t, v, precision), precision)
    gi = _hwnn(p, "group_enc.HWNNLayer_1", ei, lambda v: _conv(b_t, b, v, precision), precision)
    x = torch.cat([gu + eu, gi + ei])
    return _ln(_conv(adj, adj_t, x, precision), p, "group_enc.LayerNorm_0") + ego


def forward(p: dict, g: Graph, s: dict, precision: str, key=None, generator=None):
    """(local view, group view), each [U + I, d]; in training (`key` given)
    with A's edges dropped by `key` and the feature masks drawn from
    `generator`."""
    adj = g.adj if key is None else dropped(g.adj, key, 1.0 - s["drop_rate"])
    adj_t = adj.transposed()
    ego = torch.cat([p["user_emb"], p["item_emb"]])
    local = _local(p, ego, adj, adj_t, precision, generator)
    return local, _group(p, ego, g.b, adj, adj_t, g.cf.n_users, precision)


def _contrast(a: torch.Tensor, b: torch.Tensor, temp: float, precision: str) -> torch.Tensor:
    """Cross-view InfoNCE of rows a_k, b_k (the rows +1e-8, then unit length)."""
    a = F.normalize(a + 1e-8, dim=1, eps=1e-12)
    b = F.normalize(b + 1e-8, dim=1, eps=1e-12)
    nume = torch.exp((a * b).sum(1) / temp)
    deno = torch.exp(dense_mm(a, b.T, precision) / temp).sum(1) + 1e-8
    return -torch.mean(torch.log(nume / deno))


def loss(p: dict, extras: dict, batch, keys, g: Graph, s: dict, precision: str,
         generator: torch.Generator | None = None):
    """(the step's loss, the next step's extras): the edge dropout from
    `keys[0]`, the three feature masks from `generator`."""
    users, pos, neg = (x.long() for x in batch)
    n_u = g.cf.n_users
    with dense_precision(precision):
        local, group = forward(p, g, s, precision, keys[0], generator)
        tables = (local + group) / 2
        ue, pe, ne = tables[users], tables[n_u + pos], tables[n_u + neg]
        total = bpr(ue, pe, ne) + l2_norms(s["reg"], ue, pe, ne) / s["batch_size"]
        uu, iu = torch.unique(users), n_u + torch.unique(pos)
        ssl = _contrast(local[uu], group[uu], s["temp"], precision) \
            + _contrast(local[iu], group[iu], s["temp"], precision)
        total = total + s["cl_rate"] * ssl
    return total, {}


@torch.no_grad()
def encode(p: dict, extras: dict, g: Graph, s: dict, precision: str):
    """(user table, item table) that ranking reads: the views' mean."""
    with dense_precision(precision):
        local, group = forward(p, g, s, precision)
    tables = (local + group) / 2
    return tables[: g.cf.n_users], tables[g.cf.n_users:]


def n_edge_keys() -> int:
    return 1
