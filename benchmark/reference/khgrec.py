"""KHGRec in plain PyTorch: the benchmark's reference for the `khgrec-*`
configurations. It imports nothing of the program.

The model (reference model/graph/KHGRec.py, mode "full"), over one shared
user-entity table T [E, d]:
  * the CF view: X0 = T[users ++ items]; per layer k, X = LN_k(act(A (A^T
    X))) + X0, with A the normalised user-item adjacency, act a leaky ReLU
    of slope `p`, left out on the last layer;
  * the KG view: Y0 = T; per layer, Y = LN_k(act(M (M^T Y))) + Y0 with M =
    A_att K, K the normalised entity adjacency of the KG triples (the CF
    pairs among them) and A_att the attention adjacency over the last KG
    batch's (head, tail) pairs;
  * the item table fuses the two item views by a 2-way softmax gate,
    beta = softmax_views(W1 tanh(W0 z + b0));
  * the loss: BPR on (user, positive, negative) over the CF user rows and
    the fused item rows, plus `reg` x the rows' unsquared L2 norms over the
    batch size; TransR on (head, relation, positive tail, negative tail),
    -logsigmoid(||h W_r + r - t_neg W_r||^2 - ||h W_r + r - t_pos W_r||^2),
    plus `reg_kg` x the projections' norms over the KG batch size; and
    `cl_rate` x the cross-view contrast (temperature `temp`) of the batch's
    distinct users and distinct positive items;
  * training drops each adjacency's edges at rate `drop_rate`, each with a
    key of its own; the next step's attention is the tanh TransR score of
    this batch's (head, relation, positive tail) from this step's KG view,
    softmaxed over each head's triples.
Departures from the published code, which the program shares: LayerNorm
epsilon 1e-6; the contrast's rows are shifted by 1e-8 before they are
normalised; BPR adds 1e-5 inside the log.

Sparse products run at the configuration's precision (`common.spmm`); the
attention adjacency's products and every other sum in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .common import CF, Sparse, bpr, cf_ids, bipartite, dense_mm, dense_precision, dropped, \
    l2_norms, planted_rows, sparse_from_coo, spmm, sym_normalized

LN_EPS = 1e-6


@dataclass
class Graph:
    cf: CF
    triples: np.ndarray  # [n, 3] (h, r, t): the KG's training triples
    n_entities: int
    n_relations: int
    # on the device, from `attach`:
    adj: Sparse | None = None  # the normalised (U + I)^2 user-item adjacency
    kg: Sparse | None = None  # the normalised E x E KG adjacency
    ui: torch.Tensor | None = None  # entity ids of the users, then of the items


def derive(train: np.ndarray, test: np.ndarray, kg: np.ndarray) -> Graph:
    """The graphs from the generated pairs and item-attribute triples, as
    the reference's Knowledge.construct_data builds them: each triple with
    its inverse (relation + R0), all relations shifted by 2, the inverse
    block appended once more unshifted, and the CF pairs as relation 0
    (user -> item) and 1 (item -> user), raw ids as entity ids; the entity
    count rounded up to a multiple of 16; duplicate (head, tail) pairs
    summed in K."""
    cf = cf_ids(train, test)
    r0 = int(kg[:, 1].max()) + 1
    inverse = kg[:, [2, 1, 0]].copy()
    inverse[:, 1] += r0
    both = np.concatenate([kg, inverse])
    both[:, 1] += 2
    u_raw, i_raw = cf.user_raw[cf.train_u], cf.item_raw[cf.train_i]
    triples = np.concatenate([both, inverse,
                              np.stack([u_raw, np.zeros_like(u_raw), i_raw], 1),
                              np.stack([i_raw, np.ones_like(i_raw), u_raw], 1)]).astype(np.int64)
    n_ent = (int(max(triples[:, 0].max(), triples[:, 2].max())) + 1 + 15) // 16 * 16
    return Graph(cf, triples, n_ent, int(triples[:, 1].max()) + 1)


def attach(g: Graph, device) -> None:
    """Build the graph's matrices on `device`."""
    t = g.triples
    k = sparse_from_coo(t[:, 0], t[:, 2], np.ones(len(t)), (g.n_entities, g.n_entities), device)
    g.adj, g.kg = bipartite(g.cf, device), sym_normalized(k)
    g.ui = torch.as_tensor(np.concatenate([g.cf.user_raw, g.cf.item_raw]), device=device)


def sizes(g: Graph, settings: dict) -> dict:
    """The configuration's settings with the graph's sizes beside them (the
    matrices' entries once they are attached)."""
    out = dict(settings, n_users=g.cf.n_users, n_items=g.cf.n_items, n_entities=g.n_entities,
               n_relations=g.n_relations, n_train=len(g.cf.train_u),
               n_test_users=int(np.unique(g.cf.test_u).shape[0]))
    if g.adj is not None:
        out.update(cf_nnz=int(g.adj.vals.shape[0]), kg_nnz=int(g.kg.vals.shape[0]))
    return out


def param_shapes(s: dict) -> dict:
    """The parameters, under the program's state-dict names."""
    d, dr, r = s["hyper_dim"], s["relation_dim"], s["n_relations"]
    shapes = {"user_entity_emb": (s["n_entities"], d), "relation_emb": (r, dr),
              "trans_M": (r, d, dr)}
    for enc in ("cf_encoder", "kg_encoder"):
        for k in range(s["n_layers"]):
            shapes[f"{enc}.lns.{k}.weight"] = (d,)
            shapes[f"{enc}.lns.{k}.bias"] = (d,)
    shapes.update({"attention_item.dense0.weight": (d, d), "attention_item.dense0.bias": (d,),
                   "attention_item.dense1.weight": (d, d)})
    return shapes


def make_weights(s: dict, generator: torch.Generator, device) -> dict:
    """Weights drawn from `generator` (on `device`) in two calls: the tables
    Xavier-uniform with the fan of their last two axes times any leading
    ones, the dense kernels LeCun normal clamped at two standard
    deviations, biases 0, LayerNorm scales 1."""
    shapes = param_shapes(s)
    tables = ["user_entity_emb", "relation_emb", "trans_M"]
    dense = ["attention_item.dense0.weight", "attention_item.dense1.weight"]
    u = torch.rand(sum(int(np.prod(shapes[n])) for n in tables), generator=generator, device=device)
    z = torch.randn(sum(int(np.prod(shapes[n])) for n in dense), generator=generator, device=device)
    out, ou, oz = {}, 0, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        if name in tables:
            rec = int(np.prod(shape[:-2]))
            limit = (6.0 / (shape[-2] * rec + shape[-1] * rec)) ** 0.5
            out[name] = ((u[ou:ou + n] * 2 - 1) * limit).reshape(shape)
            ou += n
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
    """Weights as training leaves them: `make_weights`'s, the users' and
    items' rows of the shared table drawn towards the generator's planted
    structure (`planted_rows`)."""
    w = make_weights(s, generator, device)
    users, items = planted_rows(latent, g.cf, s["hyper_dim"], strength, generator, device)
    table = w["user_entity_emb"].clone()
    table[torch.as_tensor(g.cf.user_raw, device=device)] += users
    table[torch.as_tensor(g.cf.item_raw, device=device)] += items
    return dict(w, user_entity_emb=table)


def initial_extras(g: Graph, s: dict, device) -> dict:
    """The attention before the first step: a self-loop of weight 1 on each
    of the first `batch_kg` entities (modulo the entity count)."""
    idx = torch.arange(s["batch_size_kg"], dtype=torch.int32, device=device) % g.n_entities
    return {"att_h": idx, "att_t": idx.clone(),
            "att_v": torch.ones(s["batch_size_kg"], dtype=torch.float32, device=device)}


def trained_extras(g: Graph, s: dict, generator: torch.Generator, device) -> dict:
    """An attention as training leaves it: `batch_kg` triples drawn from the
    KG's, each head's values a softmax of standard normal scores."""
    pick = torch.randint(0, len(g.triples), (s["batch_size_kg"],), generator=generator, device=device)
    tri = torch.as_tensor(g.triples, device=device)[pick]
    h, t = tri[:, 0], tri[:, 2]
    v = torch.randn(s["batch_size_kg"], generator=generator, device=device)
    return {"att_h": h.int(), "att_t": t.int(), "att_v": head_softmax(v, h, g.n_entities)}


def draw_batches(g: Graph, s: dict, n: int, generator: torch.Generator, device) -> list:
    """`n` batches in the program's form (int32 on `device`), on rows that
    all differ: consecutive slices of one permutation of the training pairs
    and of one of the KG triples; negatives uniform over items and
    entities."""
    b, bk = s["batch_size"], s["batch_size_kg"]
    pairs = torch.randperm(len(g.cf.train_u), generator=generator, device=device)[: n * b]
    trips = torch.randperm(len(g.triples), generator=generator, device=device)[: n * bk]
    tu = torch.as_tensor(g.cf.train_u, device=device)
    ti = torch.as_tensor(g.cf.train_i, device=device)
    tr = torch.as_tensor(g.triples, device=device)
    out = []
    for k in range(n):
        p = pairs[k * b:(k + 1) * b]
        t = tr[trips[k * bk:(k + 1) * bk]]
        neg = torch.randint(0, g.cf.n_items, (b,), generator=generator, device=device)
        neg_t = torch.randint(0, g.n_entities, (bk,), generator=generator, device=device)
        out.append(tuple(x.int() for x in (tu[p], ti[p], neg, t[:, 0], t[:, 1], t[:, 2], neg_t)))
    return out


def head_softmax(v: torch.Tensor, h: torch.Tensor, n: int) -> torch.Tensor:
    """Softmax of `v` over the entries of each head."""
    h = h.long()
    m = torch.full((n,), -torch.inf, device=v.device).scatter_reduce(0, h, v, "amax")
    e = torch.exp(v - m[h])
    return e / torch.zeros(n, device=v.device).index_add_(0, h, e)[h]


def _att(h, t, v, x, n):
    """A_att @ X: row h sums v X[t] over its (h, t) pairs."""
    return torch.zeros(n, x.shape[1], device=x.device).index_add_(0, h.long(), v[:, None] * x[t.long()])


def _att_t(h, t, v, x, n):
    """A_att^T @ X."""
    return torch.zeros(n, x.shape[1], device=x.device).index_add_(0, t.long(), v[:, None] * x[h.long()])


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[1],), p[name + ".weight"], p[name + ".bias"], LN_EPS)


def _project(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor, precision: str) -> torch.Tensor:
    """x[b] @ w[r[b]], one matmul per relation."""
    out = torch.zeros(x.shape[0], w.shape[2], device=x.device)
    for rel in torch.unique(r).tolist():
        rows = torch.nonzero(r == rel).squeeze(1)
        out = out.index_put((rows,), dense_mm(x[rows], w[rel], precision))
    return out


def forward(p: dict, extras: dict, g: Graph, s: dict, precision: str, keys=None,
            keep: float = 1.0):
    """(user CF table, item CF table, KG entity table, fused item table)."""
    adj, kg = g.adj, g.kg
    if keys is not None:
        adj, kg = dropped(adj, keys[0], keep), dropped(kg, keys[1], keep)
    adj_t, kg_t = adj.transposed(), kg.transposed()
    slope, last = s["p"], s["n_layers"] - 1
    table = p["user_entity_emb"]
    x0 = x = table[g.ui]
    for k in range(s["n_layers"]):
        conv = spmm(adj, spmm(adj_t, x, precision), precision)
        conv = F.leaky_relu(conv, slope) if k != last else conv
        x = _ln(conv, p, f"cf_encoder.lns.{k}") + x0
    u_cf, i_cf = x[: g.cf.n_users], x[g.cf.n_users:]
    h, t, v = extras["att_h"], extras["att_t"], extras["att_v"]
    e = table
    for k in range(s["n_layers"]):
        y = _att_t(h, t, v, e, g.n_entities)
        y = spmm(kg, spmm(kg_t, y, precision), precision)
        y = _att(h, t, v, y, g.n_entities)
        y = F.leaky_relu(y, slope) if k != last else y
        e = _ln(y, p, f"kg_encoder.lns.{k}") + table
    i_kg = e[g.ui][g.cf.n_users:]
    z = torch.stack([i_cf, i_kg], dim=1)  # [I, 2, d]
    w0, b0 = p["attention_item.dense0.weight"], p["attention_item.dense0.bias"]
    hid = torch.tanh(dense_mm(z.reshape(-1, z.shape[2]), w0.T, precision) + b0)
    w = dense_mm(hid, p["attention_item.dense1.weight"].T, precision).reshape(z.shape)
    fused = (torch.softmax(w, dim=1) * z).sum(dim=1)
    return u_cf, i_cf, e, fused


def _contrast(a: torch.Tensor, b: torch.Tensor, temp: float, precision: str) -> torch.Tensor:
    """Cross-view InfoNCE of rows a_k, b_k (the rows +1e-8, then unit length)."""
    a = F.normalize(a + 1e-8, dim=1, eps=1e-12)
    b = F.normalize(b + 1e-8, dim=1, eps=1e-12)
    nume = torch.exp((a * b).sum(1) / temp)
    deno = torch.exp(dense_mm(a, b.T, precision) / temp).sum(1) + 1e-8
    return -torch.mean(torch.log(nume / deno))


def loss(p: dict, extras: dict, batch, keys, g: Graph, s: dict, precision: str,
         generator: torch.Generator | None = None):
    """(the step's loss, the next step's extras). KHGRec's edge dropout
    comes from `keys`; it draws nothing from `generator`."""
    users, pos, neg, h, r, pt, nt = (x.long() for x in batch)
    with dense_precision(precision):
        u_cf, i_cf, ent, fused = forward(p, extras, g, s, precision, keys, 1.0 - s["drop_rate"])
        ue, pe, ne = u_cf[users], fused[pos], fused[neg]
        cf_loss = bpr(ue, pe, ne) + l2_norms(s["reg"], ue, pe, ne) / s["batch_size"]
        wm, re = p["trans_M"], p["relation_emb"][r]
        rh, rp, rn = (_project(ent[x], wm, r, precision) for x in (h, pt, nt))
        hr = rh + re
        kg_score = ((hr - rn) ** 2).sum(1) - ((hr - rp) ** 2).sum(1)
        kg_loss = torch.mean(-F.logsigmoid(kg_score)) + l2_norms(s["reg_kg"], rh, re, rp, rn) / s["batch_size_kg"]
        n_u = g.cf.n_users
        uu, iu = torch.unique(users), torch.unique(pos)
        e_ui = ent[g.ui]
        ssl = _contrast(u_cf[uu], e_ui[uu], s["temp"], precision) \
            + _contrast(i_cf[iu], e_ui[n_u + iu], s["temp"], precision)
        total = cf_loss + kg_loss + s["cl_rate"] * ssl
        with torch.no_grad():
            e = ent.detach()
            ah = _project(e[h], wm, r, precision)
            at = _project(e[pt], wm, r, precision)
            v = ((at * torch.tanh(ah + p["relation_emb"][r])).sum(1))
            new = {"att_h": batch[3], "att_t": batch[5], "att_v": head_softmax(v, h, g.n_entities)}
    return total, new


@torch.no_grad()
def encode(p: dict, extras: dict, g: Graph, s: dict, precision: str):
    """(user table, item table) that ranking reads: the CF user view and the
    fused items."""
    with dense_precision(precision):
        u_cf, _, _, fused = forward(p, extras, g, s, precision)
    return u_cf, fused


def n_edge_keys() -> int:
    return 2
