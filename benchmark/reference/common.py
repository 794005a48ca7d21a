"""Plain PyTorch and NumPy pieces that the references share. Nothing here
imports the program: every array the program derives from the generated
pairs and triples (dense ids, normalised adjacencies, dropout masks,
optimiser state) is worked out again here from their published semantics.

Precision. A sparse product rounds its operand and the matrix's values to
the precision a configuration states and sums in float32: "float32"
rounds nothing, "bfloat16" rounds to bf16 (the bf16 gathered operand with
bf16 edge values), "tf32" to TF32's 10-bit mantissa (what a TF32 tensor
core product would read). The gradient of a product rounds the cotangent
as the forward rounds the operand. Dense matmuls run with TF32 off unless
the precision is "tf32".
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

PRECISIONS = ("float32", "bfloat16", "tf32")


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` (float32) rounded to `precision`, to nearest, ties to even,
    returned as float32."""
    if precision == "float32":
        return x
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":
        bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        shift = 13  # 23 - 10 mantissa bits
        bits = (bits + ((1 << (shift - 1)) - 1 + ((bits >> shift) & 1))) & ~((1 << shift) - 1)
        bits = bits & 0xFFFFFFFF
        return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(torch.float32)
    raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")


@contextlib.contextmanager
def dense_precision(precision: str):
    """Dense float32 matmuls in TF32 for "tf32", in full float32 otherwise."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def dense_mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b; in "tf32" both sides rounded to TF32 first (a CPU has no TF32)."""
    if precision == "tf32":
        return round_to(a, "tf32") @ round_to(b, "tf32")
    return a @ b


# -- sparse matrices ------------------------------------------------------

@dataclass
class Sparse:
    """A sparse [nrows, ncols] matrix: its entries sorted by (row, col), so
    that entry k is the matrix's edge k (the id its dropout key hashes)."""

    rows: torch.Tensor  # int64
    cols: torch.Tensor  # int64
    vals: torch.Tensor  # float32
    shape: tuple

    def with_vals(self, vals: torch.Tensor) -> "Sparse":
        return Sparse(self.rows, self.cols, vals, self.shape)

    def transposed(self) -> "Sparse":
        return Sparse(self.cols, self.rows, self.vals, (self.shape[1], self.shape[0]))


def sparse_from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape,
                    device) -> Sparse:
    """Duplicate (row, col) entries summed, the entries sorted by (row, col)."""
    key = rows.astype(np.int64) * shape[1] + cols.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.zeros(uniq.shape[0], np.float64)
    np.add.at(summed, inv, vals)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return Sparse(t(uniq // shape[1], torch.int64), t(uniq % shape[1], torch.int64),
                  t(summed.astype(np.float32), torch.float32), tuple(shape))


def sym_normalized(a: Sparse) -> Sparse:
    """D^-1/2 A D^-1/2 with D the row sums (the reference's normalisation of
    a square matrix, on the rows' sums even where A is not symmetric)."""
    deg = torch.zeros(a.shape[0], dtype=torch.float64, device=a.vals.device)
    deg.index_add_(0, a.rows, a.vals.double())
    d = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    return a.with_vals((a.vals.double() * d[a.rows] * d[a.cols]).float())


def product(a: Sparse, x: torch.Tensor, precision: str) -> torch.Tensor:
    """A @ X, with X and A's values rounded to `precision`, summed in float32."""
    vals = round_to(a.vals, precision)
    xr = round_to(x.float(), precision)
    out = torch.zeros(a.shape[0], x.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add_(0, a.rows, vals[:, None] * xr[a.cols])


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, precision):
        ctx.a, ctx.precision = a, precision
        return product(a, x, precision)

    @staticmethod
    def backward(ctx, g):
        return product(ctx.a.transposed(), g, ctx.precision), None, None


def spmm(a: Sparse, x: torch.Tensor, precision: str) -> torch.Tensor:
    """A @ X, differentiable in X (dX = A^T g, at the same precision)."""
    return _Spmm.apply(x, a, precision)


# -- edge dropout -----------------------------------------------------------

_M32 = 0xFFFFFFFF


def _times(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for z < 2^32, in int64 without overflow."""
    return (z * (c & 0xFFFF) + (((z * (c >> 16)) & 0xFFFF) << 16)) & _M32


def keep_mask(key: tuple[int, int], n: int, keep_rate: float, device) -> torch.Tensor:
    """The edge dropout's draw for edges 0..n-1 under the two 32-bit key
    words: a counter hash (a multiply-xorshift finaliser) of (key, edge id),
    whose top 24 bits, as a fraction of 2^24, are below the keep rate."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    z = torch.arange(n, dtype=torch.int64, device=device) ^ k0
    z = _times(z, 0x9E3779B9)
    z = z ^ (z >> 16)
    z = _times(z, 0x85EBCA6B)
    z = z ^ k1
    z = z ^ (z >> 13)
    z = _times(z, 0xC2B2AE35)
    z = z ^ (z >> 16)
    return (z >> 8).to(torch.float32) / float(1 << 24) < float(np.float32(keep_rate))


def dropped(a: Sparse, key, keep_rate: float) -> Sparse:
    """Edge dropout: each edge kept with probability `keep_rate` by
    `keep_mask`, the kept ones divided by the rate (in float32)."""
    if keep_rate >= 1.0:
        return a
    keep = torch.tensor(keep_rate, dtype=torch.float32, device=a.vals.device)
    mask = keep_mask(key, a.vals.shape[0], keep_rate, a.vals.device)
    return a.with_vals(torch.where(mask, a.vals / keep, torch.zeros_like(a.vals)))


# -- ids and graphs -----------------------------------------------------------

def first_appearance(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dense id of each element, the raw ids in dense order, the dense id of
    each sorted distinct raw id): ids numbered in the order of their first
    appearance."""
    uniq, first, inv = np.unique(raw, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return rank[inv].astype(np.int64), uniq[order], rank


def _lookup(uniq: np.ndarray, rank: np.ndarray, query: np.ndarray, missing: int) -> np.ndarray:
    pos = np.minimum(np.searchsorted(uniq, query), len(uniq) - 1)
    return np.where(uniq[pos] == query, rank[pos], missing).astype(np.int64)


@dataclass
class CF:
    """The interactions in dense ids: users and items numbered by first
    appearance in the training pairs; test pairs of users seen in training,
    an item unseen there as -2 (never ranked, but counted)."""

    n_users: int
    n_items: int
    user_raw: np.ndarray  # [n_users] raw ids in dense order
    item_raw: np.ndarray
    train_u: np.ndarray  # [n_train] dense, in the pairs' order
    train_i: np.ndarray
    test_u: np.ndarray
    test_i: np.ndarray


def cf_ids(train: np.ndarray, test: np.ndarray) -> CF:
    tu, user_raw, u_rank = first_appearance(train[:, 0])
    ti, item_raw, i_rank = first_appearance(train[:, 1])
    te_u = _lookup(np.sort(user_raw), u_rank, test[:, 0], -1)
    keep = te_u >= 0
    te_i = _lookup(np.sort(item_raw), i_rank, test[keep, 1], -2)
    return CF(len(user_raw), len(item_raw), user_raw, item_raw, tu, ti, te_u[keep], te_i)


def bipartite(cf: CF, device) -> Sparse:
    """The normalised (U + I)^2 user-item adjacency, items after users."""
    n = cf.n_users + cf.n_items
    rows = np.concatenate([cf.train_u, cf.train_i + cf.n_users])
    cols = np.concatenate([cf.train_i + cf.n_users, cf.train_u])
    return sym_normalized(sparse_from_coo(rows, cols, np.ones(rows.shape[0]), (n, n), device))


def planted_rows(latent: dict, cf: CF, d: int, strength: float, generator: torch.Generator,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """(user rows [U, d], item rows [I, d]) in dense order that carry the
    generator's planted structure, as trained tables would: a centre of
    norm about 1 a cluster and one popularity direction of norm 1; a user
    is its main cluster's centre plus half its second's plus the popularity
    direction, an item its cluster's centre plus the direction times its
    log popularity over the largest; all times `strength`. `latent` (by raw
    id): user_raw, user_clusters [n, 2], item_raw, item_cluster,
    item_pop, n_clusters."""
    def by_raw(raw, values, query):
        order = np.argsort(raw, kind="stable")
        pos = np.searchsorted(raw[order], query)
        if not np.array_equal(raw[order][np.minimum(pos, len(raw) - 1)], query):
            raise ValueError("a user or item the generator did not draw")
        return values[order][pos]

    centres = torch.randn(latent["n_clusters"], d, generator=generator, device=device) / d ** 0.5
    pop_dir = torch.randn(d, generator=generator, device=device)
    pop_dir = pop_dir / torch.linalg.vector_norm(pop_dir)
    uc = torch.as_tensor(by_raw(latent["user_raw"], latent["user_clusters"], cf.user_raw),
                         device=device)
    ic = torch.as_tensor(by_raw(latent["item_raw"], latent["item_cluster"], cf.item_raw),
                         device=device)
    log_pop = np.log(latent["item_pop"])
    lp = torch.as_tensor(by_raw(latent["item_raw"], log_pop / log_pop.max(), cf.item_raw),
                         dtype=torch.float32, device=device)
    users = centres[uc[:, 0]] + 0.5 * centres[uc[:, 1]] + pop_dir
    items = centres[ic] + lp[:, None] * pop_dir
    return strength * users, strength * items


# -- Adam ---------------------------------------------------------------------

class Adam:
    """Adam with coupled weight decay (the decay added to the gradient before
    the moments), betas (0.9, 0.999), eps 1e-8."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, lr: float, weight_decay: float):
        self.lr, self.wd, self.t = lr, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        """The new parameters; returns the gradients as the update used
        them (with the decay), keyed like `params`."""
        self.t += 1
        used = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            used[k] = g
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            params[k] = p - self.lr * m_hat / (v_hat.sqrt() + self.eps)
        return used


def bpr(u: torch.Tensor, p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """-log(1e-5 + sigmoid(u.p - u.n)), mean over the batch."""
    return -torch.mean(torch.log(1e-5 + torch.sigmoid((u * p).sum(1) - (u * n).sum(1))))


def l2_norms(reg: float, *xs: torch.Tensor) -> torch.Tensor:
    """reg times the sum of the tensors' (unsquared) L2 norms."""
    return reg * sum(torch.sqrt((x * x).sum() + 1e-24) for x in xs)


# -- ranking ------------------------------------------------------------------

def ranking_metrics(user_tab: torch.Tensor, item_tab: torch.Tensor, cf: CF, top_ns,
                    precision: str = "float32", block: int = 2048, mask: bool = True) -> dict:
    """{N: {hit_ratio, precision, recall, ndcg}} over the test users, every
    item scored by a dense product at `precision` (float32: TF32 off) in
    blocks of `block` users in ascending order (the last block filled with
    user 0), the user's training items excluded (left in without `mask`, a
    fault), ties broken by the item's index; sums in float64 on the host."""
    top_ns = [int(n) for n in top_ns]
    k = max(top_ns)
    dev = user_tab.device
    users = np.unique(cf.test_u)
    tests: dict[int, list] = {}
    for u, i in zip(cf.test_u.tolist(), cf.test_i.tolist()):
        tests.setdefault(u, []).append(i)
    order = np.argsort(cf.train_u, kind="stable")
    tr_u, tr_i = cf.train_u[order], cf.train_i[order]
    starts = np.searchsorted(tr_u, users)
    ends = np.searchsorted(tr_u, users, side="right")
    hits = {n: [] for n in top_ns}
    dcg = {n: [] for n in top_ns}
    counts = []
    with dense_precision(precision):
        for s in range(0, users.shape[0], block):
            ub = users[s:s + block]
            rows = np.concatenate([ub, np.zeros(block - len(ub), ub.dtype)])
            scores = dense_mm(user_tab[torch.as_tensor(rows, device=dev)], item_tab.T,
                              precision)[: len(ub)]
            rr = np.concatenate([np.full(e - b, j) for j, (b, e) in
                                 enumerate(zip(starts[s:s + block], ends[s:s + block]))])
            cc = np.concatenate([tr_i[b:e] for b, e in zip(starts[s:s + block], ends[s:s + block])])
            if mask:
                rated = torch.as_tensor(rr, device=dev), torch.as_tensor(cc, device=dev)
                scores[rated] = -torch.inf
            # a stable descending sort: equal scores in index order
            top = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k].cpu().numpy()
            for j, u in enumerate(ub.tolist()):
                t = set(tests[u])
                hit = np.fromiter((int(x) in t for x in top[j]), bool, k)
                counts.append(len(tests[u]))
                for n in top_ns:
                    hits[n].append(hit[:n].sum())
                    dcg[n].append((hit[:n] / np.log2(np.arange(n) + 2.0)).sum())
    counts = np.asarray(counts, np.float64)
    out = {}
    for n in top_ns:
        h = np.asarray(hits[n], np.float64)
        idcg = np.array([(1.0 / np.log2(np.arange(min(c, n)) + 2.0)).sum() for c in counts])
        out[n] = {"hit_ratio": h.sum() / counts.sum(),
                  "precision": h.sum() / (len(counts) * n),
                  "recall": float(np.mean(h / np.maximum(counts, 1))),
                  "ndcg": float(np.mean(np.where(idcg > 0, np.asarray(dcg[n]) / np.maximum(idcg, 1e-300), 0.0)))}
    return out
