"""Shared neural building blocks — the port of the JAX package's
`models/layers.py` (the blocks the KHGRec family, the HD family and the
zoo use: the ED-HNN wrappers of DHCF_diffusion and HCCF_diffusion among
them), and HGCN's `TransformerEncoderLayer`.

The parameterised blocks of the HD family name their submodules after
flax's `@nn.compact` auto-names (`Dense_0`, `LayerNorm_1`, `MLP_0`,
`HWNNLayer_0`, ...), so a state-dict name is the flax parameter path with
`kernel` / `scale` read as `weight` (`weights.params_from_jax`).
LayerNorms take flax's epsilon, 1e-6.
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.device import AdjPair
from ..ops.dropout import feature_dropout
from ..ops.sparse import scatter_mean, scatter_sum, spmm_pair, two_hop

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon (torch defaults to 1e-5)


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, negative_slope=slope)


def hgcn_conv(adj: AdjPair, x: torch.Tensor, slope: float = 0.3, act: bool = True) -> torch.Tensor:
    """act(A @ (A^T @ X)) — the two-hop hypergraph conv (reference
    HGCNConv, KHGRec.py:455-464)."""
    out = two_hop(adj.fwd, adj.bwd, x)
    return leaky(out, slope) if act else out


def gcn_prop(adj: AdjPair, x: torch.Tensor) -> torch.Tensor:
    """One-hop propagation A @ X (LightGCN.py:133, HCCF GCNLayer)."""
    return spmm_pair(adj.fwd, adj.bwd, x)


def mean_pool_feature(x: torch.Tensor, out_dim: int) -> torch.Tensor:
    """AdaptiveAvgPool1d(out_dim) over the feature axis, for a width that
    is a multiple of out_dim: [X, Xe] of width 2d averages adjacent pairs
    (model/layers/EquivSetConv.py:72,100)."""
    n, d = x.shape
    if d % out_dim:
        raise ValueError(f"mean_pool_feature: width {d} is not a multiple of {out_dim}")
    return x.reshape(n, out_dim, d // out_dim).mean(dim=-1)


class FlaxNamed(nn.Module):
    """Creates submodules under flax's per-type counters (`Dense_0`,
    `Dense_1`, `LayerNorm_0`, ...), in the order flax's compact body
    creates them."""

    def _new(self, kind: str, module: nn.Module) -> str:
        """Register `module` as the next `<kind>_<k>`; returns that name
        (kept as a string: a second attribute holding the module would
        register it twice)."""
        counts = self.__dict__.setdefault("_kind_counts", {})
        k = counts.get(kind, 0)
        counts[kind] = k + 1
        self.add_module(f"{kind}_{k}", module)
        return f"{kind}_{k}"

    def _mlp(self, name: str | None, x: torch.Tensor, train: bool,
             generator: torch.Generator | None) -> torch.Tensor:
        """The MLP registered as `name`, or the identity for None."""
        return x if name is None else getattr(self, name)(x, train, generator)


class AttentionFusion(nn.Module):
    """2-way softmax gating over stacked views (reference Attention,
    KHGRec.py:466-480): z [N, V, D] -> (sum(beta * z), beta).

    Like the JAX module (flax `Dense` layers `Dense_0`, `Dense_1`), the
    second projection has `hidden` outputs and the softmax runs over the
    VIEW axis."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.dense0 = nn.Linear(dim, hidden)
        self.dense1 = nn.Linear(hidden, hidden, bias=False)

    def forward(self, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        w = self.dense1(torch.tanh(self.dense0(z)))
        beta = torch.softmax(w, dim=1)
        return torch.sum(beta * z, dim=1), beta


class MLP(FlaxNamed):
    """n-layer MLP with optional LayerNorm input norm and hidden norm
    (reference model/layers/MLP.py:29-117; the JAX `MLP`): [LN] ->
    (Dense -> [LN] -> relu -> dropout) x (n - 1) -> Dense. 0 layers is
    the identity."""

    def __init__(self, in_dim: int, hidden: int, out: int, n_layers: int = 1,
                 dropout: float = 0.0, normalization: str = "None", input_norm: bool = False):
        super().__init__()
        self.n_layers, self.dropout = n_layers, dropout
        if n_layers == 0:
            return
        self.steps = []  # submodule names in call order; None = relu + dropout
        if input_norm:
            self.steps.append(self._new("LayerNorm", nn.LayerNorm(in_dim, eps=LN_EPS)))
        width = in_dim
        for _ in range(n_layers - 1):
            self.steps.append(self._new("Dense", nn.Linear(width, hidden)))
            if normalization == "ln":
                self.steps.append(self._new("LayerNorm", nn.LayerNorm(hidden, eps=LN_EPS)))
            self.steps.append(None)
            width = hidden
        self.steps.append(self._new("Dense", nn.Linear(width, out)))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.n_layers == 0:
            return x
        for name in self.steps:
            if name is None:
                x = feature_dropout(torch.relu(x), self.dropout, generator, train)
            else:
                x = getattr(self, name)(x)
        return x


class HWNNLayer(nn.Module):
    """Hypergraph wavelet conv with the K1/K2 polynomial approximation
    (model/layers/wavelet.py:109-154; the JAX `HWNNLayer`):

      out = poly(Theta) @ diag(w) @ poly(Theta) @ X @ W
      poly(Theta) = par[0] I + sum_{k=1..K1-1} par[k] Theta^k  (and par[K1..])

    Theta is never a dense matrix: it is applied as a `two_hop` over the
    normalised incidence B, two rectangular products a power. `side`
    picks the vertex side: 'u' -> Theta = B B^T, 'i' -> B^T B, 'adj' ->
    S S^T of the square adjacency passed in. Parameters: `par` [K1 + K2],
    `diagonal_weight_filter` [n_nodes], `weight_matrix` [in, dim] (flax's
    layout: `out @ weight_matrix`)."""

    def __init__(self, n_nodes: int, in_dim: int, dim: int, k1: int = 3, k2: int = 3,
                 side: str = "u"):
        super().__init__()
        if side not in ("u", "i", "adj"):
            raise ValueError(f"HWNNLayer: side {side!r} is not 'u', 'i' or 'adj'")
        self.k1, self.k2, self.side = k1, k2, side
        self.par = nn.Parameter(torch.empty(k1 + k2))
        self.diagonal_weight_filter = nn.Parameter(torch.empty(n_nodes))
        self.weight_matrix = nn.Parameter(torch.empty(in_dim, dim))

    def theta(self, b: AdjPair, v: torch.Tensor) -> torch.Tensor:
        if self.side in ("u", "adj"):
            return two_hop(b.fwd, b.bwd, v)
        return two_hop(b.bwd, b.fwd, v)

    def forward(self, x: torch.Tensor, b: AdjPair) -> torch.Tensor:
        par = self.par
        y = par[self.k1] * x
        term = x
        for k in range(1, self.k2):
            term = self.theta(b, term)
            y = y + par[self.k1 + k] * term
        y = self.diagonal_weight_filter[:, None] * y
        out = par[0] * y
        term = y
        for k in range(1, self.k1):
            term = self.theta(b, term)
            out = out + par[k] * term
        return out @ self.weight_matrix


class EquivSetConvSpMM(FlaxNamed):
    """ED-HNN diffusion step, SpMM form (model/layers/EquivSetConv.py:86-107;
    the JAX `EquivSetConvSpMM`):

      Xve = MLP1(X)
      Xe  = LN(conv(Xve)) + Xve          conv = HGCN, or HWNN ('wavelet')
      Xev = mean_pool(MLP2([X, Xe]))
      Xv  = LN(conv(Xev)) + Xev
      X   = MLP3((1 - alpha) Xv + alpha X0)
    """

    def __init__(self, n_nodes: int, dim: int, mlp1_layers: int = 0, mlp2_layers: int = 0,
                 mlp3_layers: int = 1, alpha: float = 0.0, dropout: float = 0.5,
                 normalization: str = "ln", input_norm: bool = True, leaky_slope: float = 0.2,
                 inner: str = "hgcn"):
        super().__init__()
        d = dim
        self.dim, self.alpha, self.leaky_slope = dim, alpha, leaky_slope
        mlp = lambda in_dim, n: MLP(in_dim, d, d, n, dropout, normalization, input_norm)  # noqa: E731
        # submodule names, registered in flax's call order: MLP1, LN, [HWNN], MLP2,
        # LN, [HWNN], MLP3
        self.mlp1 = self._new("MLP", mlp(d, mlp1_layers)) if mlp1_layers > 0 else None
        self.ln_e = self._new("LayerNorm", nn.LayerNorm(d, eps=LN_EPS))
        self.conv_e = self._new("HWNNLayer", HWNNLayer(n_nodes, d, d, side="adj")) \
            if inner == "wavelet" else None
        self.mlp2 = self._new("MLP", mlp(2 * d, mlp2_layers)) if mlp2_layers > 0 else None
        self.ln_v = self._new("LayerNorm", nn.LayerNorm(d, eps=LN_EPS))
        self.conv_v = self._new("HWNNLayer", HWNNLayer(n_nodes, d, d, side="adj")) \
            if inner == "wavelet" else None
        self.mlp3 = self._new("MLP", mlp(d, mlp3_layers)) if mlp3_layers > 0 else None

    def _conv(self, hwnn: str | None, adj: AdjPair, v: torch.Tensor) -> torch.Tensor:
        if hwnn is not None:
            return getattr(self, hwnn)(v, adj)
        return hgcn_conv(adj, v, self.leaky_slope, act=True)

    def forward(self, x: torch.Tensor, adj: AdjPair, x0: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        xve = self._mlp(self.mlp1, x, train, generator)
        xe = getattr(self, self.ln_e)(self._conv(self.conv_e, adj, xve)) + xve
        xev = self._mlp(self.mlp2, torch.cat([x, xe], dim=-1), train, generator)
        xev = mean_pool_feature(xev, self.dim)
        xv = getattr(self, self.ln_v)(self._conv(self.conv_v, adj, xev)) + xev
        x = (1.0 - self.alpha) * xv + self.alpha * x0
        return self._mlp(self.mlp3, x, train, generator)


class EquivSetConvScatter(FlaxNamed):
    """Canonical ED-HNN diffusion operator, scatter form
    (model/layers/layers2/EquivSetConv2.py:85-100; the JAX
    `EquivSetConvScatter`), over the (row, col) lists of an AdjPair whose
    fwd matrix is the V x E incidence (edge values are not read):

      Xve = MLP1(X)[vertex]                       # [nnz, d]
      Xe  = scatter(Xve, edges, reduce=aggr)      # V -> E
      Xev = MLP2([X[vertex], Xe[edges]])          # [nnz, d]
      Xv  = scatter(Xev, vertex, dim_size=N)      # E -> V
      X   = MLP3((1 - alpha) Xv + alpha X0)

    Without MLP2, Xev is Xe[edges]. Pad entries (row == N) are zeroed and
    leave the E -> V scatter; as in JAX they still count in hyperedge 0's
    mean (their column is 0)."""

    def __init__(self, dim: int, n_edges: int, aggr: str = "mean", mlp1_layers: int = 1,
                 mlp2_layers: int = 1, mlp3_layers: int = 1, alpha: float = 0.5,
                 dropout: float = 0.0, normalization: str = "None", input_norm: bool = False):
        super().__init__()
        d = dim
        self.dim, self.n_edges, self.alpha = dim, n_edges, alpha
        self.reduce = scatter_mean if aggr == "mean" else scatter_sum
        mlp = lambda in_dim, n: MLP(in_dim, d, d, n, dropout, normalization, input_norm)  # noqa: E731
        self.mlp1 = self._new("MLP", mlp(d, mlp1_layers)) if mlp1_layers > 0 else None
        self.mlp2 = self._new("MLP", mlp(2 * d, mlp2_layers)) if mlp2_layers > 0 else None
        self.mlp3 = self._new("MLP", mlp(d, mlp3_layers)) if mlp3_layers > 0 else None

    def forward(self, x: torch.Tensor, inc: AdjPair, x0: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        n = x.shape[0]
        rows = inc.fwd.rows.long()
        vertex = rows.clamp(0, n - 1)  # pad rows clamp; zeroed by `live`
        edges = inc.fwd.cols.long()
        live = (rows < n).to(x.dtype)[:, None]
        xw = self._mlp(self.mlp1, x, train, generator)
        xe = self.reduce(xw[vertex] * live, edges, self.n_edges)
        if self.mlp2 is not None:
            xev_in = torch.cat([x[vertex], xe[edges]], dim=-1) * live
            xev = self._mlp(self.mlp2, xev_in, train, generator)
        else:
            xev = xe[edges] * live
        xv = self.reduce(xev * live, rows, n)
        x = (1.0 - self.alpha) * xv + self.alpha * x0
        return self._mlp(self.mlp3, x, train, generator)


class EquivSetGNN(FlaxNamed):
    """ED-HNN wrapper (model/layers/EquivSetGNN.py:83-144; the JAX
    `EquivSetGNN`): input dropout -> Dense lift -> relu ->
    n x (dropout -> conv -> relu) -> dropout. One conv, shared by the n
    steps, as in flax."""

    def __init__(self, n_nodes: int, dim: int, n_conv_layers: int = 1, input_dropout: float = 0.6,
                 dropout: float = 0.5, alpha: float = 0.0, mlp1_layers: int = 0,
                 mlp2_layers: int = 0, mlp3_layers: int = 1, leaky_slope: float = 0.2,
                 inner: str = "hgcn"):
        super().__init__()
        self.n_conv_layers, self.input_dropout, self.dropout = n_conv_layers, input_dropout, dropout
        self._new("Dense", nn.Linear(dim, dim))
        self._new("EquivSetConvSpMM", EquivSetConvSpMM(
            n_nodes, dim, mlp1_layers, mlp2_layers, mlp3_layers, alpha, dropout,
            leaky_slope=leaky_slope, inner=inner))

    def forward(self, x: torch.Tensor, adj: AdjPair, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = feature_dropout(x, self.input_dropout, generator, train)
        x = torch.relu(self.Dense_0(x))
        x0 = x
        for _ in range(self.n_conv_layers):
            x = feature_dropout(x, self.dropout, generator, train)
            x = torch.relu(self.EquivSetConvSpMM_0(x, adj, x0, train, generator))
        return feature_dropout(x, self.dropout, generator, train)


class EquivSetGNNScatter(FlaxNamed):
    """ED-HNN wrapper around the scatter-form conv for a RECTANGULAR
    incidence (vertices x hyperedges; the JAX `EquivSetGNNScatter`, the
    DHCF_diffusion channels, reference DHCF_diffusion.py:171-185): input
    dropout -> Dense lift -> relu -> n x (dropout -> conv -> relu) ->
    dropout, the conv with a LayerNorm-input MLP3 only (`Dense_0`,
    `EquivSetConvScatter_0`)."""

    def __init__(self, dim: int, n_edges: int, n_conv_layers: int = 1,
                 input_dropout: float = 0.6, dropout: float = 0.5, alpha: float = 0.0,
                 aggr: str = "mean"):
        super().__init__()
        self.n_conv_layers, self.input_dropout, self.dropout = n_conv_layers, input_dropout, dropout
        self._new("Dense", nn.Linear(dim, dim))
        self._new("EquivSetConvScatter", EquivSetConvScatter(
            dim, n_edges, aggr, mlp1_layers=0, mlp2_layers=0, mlp3_layers=1, alpha=alpha,
            dropout=dropout, normalization="ln", input_norm=True))

    def forward(self, x: torch.Tensor, inc: AdjPair, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = feature_dropout(x, self.input_dropout, generator, train)
        x = torch.relu(self.Dense_0(x))
        x0 = x
        for _ in range(self.n_conv_layers):
            x = feature_dropout(x, self.dropout, generator, train)
            x = torch.relu(self.EquivSetConvScatter_0(x, inc, x0, train, generator))
        return feature_dropout(x, self.dropout, generator, train)


class DenseEquivSetGNN(FlaxNamed):
    """ED-HNN over a DENSE learnable incidence H [V, E] (the JAX
    `DenseEquivSetGNN`, HCCF_diffusion's hyperedge branch, reference
    HCCF_diffusion.py:193-211 and 291-317). The scatter means over the
    positive entries of H are two masked dense products, M = (H > 0):

        Xe = (M^T @ X) / colsum(M),   Xv = (M @ Xe) / rowsum(M)

    H reaches the output only through M, so it gets no gradient (as in
    JAX). Submodules `Dense_0` and `MLP_0` (LayerNorm input, one layer)."""

    def __init__(self, dim: int, input_dropout: float = 0.6, dropout: float = 0.5,
                 alpha: float = 0.0, n_conv_layers: int = 1, mlp3_layers: int = 1):
        super().__init__()
        self.input_dropout, self.dropout, self.alpha = input_dropout, dropout, alpha
        self.n_conv_layers = n_conv_layers
        self._new("Dense", nn.Linear(dim, dim))
        self._new("MLP", MLP(dim, dim, dim, mlp3_layers, dropout, "ln", True))

    def forward(self, x: torch.Tensor, incidence: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        mask = (incidence > 0).to(x.dtype)  # [V, E]
        col = torch.clamp(mask.sum(dim=0), min=1.0)  # [E]
        row = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)  # [V, 1]
        x = feature_dropout(x, self.input_dropout, generator, train)
        x = torch.relu(self.Dense_0(x))
        x0 = x
        for _ in range(self.n_conv_layers):
            x = feature_dropout(x, self.dropout, generator, train)
            xe = (mask.T @ x) / col[:, None]
            xv = (mask @ xe) / row
            x = (1.0 - self.alpha) * xv + self.alpha * x0
            x = torch.relu(self.MLP_0(x, train, generator))
        return feature_dropout(x, self.dropout, generator, train)


class MultiHeadAttention(nn.Module):
    """flax `MultiHeadDotProductAttention(num_heads, qkv_features=dim)` as
    self-attention over one set of rows, with flax's attention dropout rate
    0: q, k, v projections with bias, per head softmax(q k^T /
    sqrt(head_dim)) v, then the output projection (`query`, `key`, `value`,
    `out`; flax's [in, heads, head_dim] and [heads, head_dim, out] kernels
    are torch [out, in] weights here, head-major)."""

    def __init__(self, dim: int, n_heads: int = 1):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"MultiHeadAttention: width {dim} is not a multiple of {n_heads} heads")
        self.n_heads, self.head_dim = n_heads, dim // n_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]

        def heads(t):  # [N, dim] -> [heads, N, head_dim]
            return t.reshape(n, self.n_heads, self.head_dim).transpose(0, 1)

        # flax scales the query before the product; the [heads, N, N] scores
        # are plain matmuls and a softmax, as XLA computes them in the JAX package
        q = heads(self.query(x)) / torch.full((), float(self.head_dim), device=x.device).sqrt()
        weights = torch.softmax(q @ heads(self.key(x)).transpose(1, 2), dim=-1)
        return self.out((weights @ heads(self.value(x))).transpose(0, 1).reshape(n, -1))


class SelfAttentionBlock(FlaxNamed):
    """Single-head transformer encoder layer over the node set (the JAX
    `SelfAttentionBlock`, reference KHGRec.py:393-408): x = LN(x +
    dropout(attn(x))); x = LN(x + dropout(Dense(relu-dropout(Dense(x)))))
    with a feed-forward width of 32 and dropout 0.2. Submodules under
    flax's names: `MultiHeadDotProductAttention_0`, `LayerNorm_0`,
    `Dense_0`, `Dense_1`, `LayerNorm_1`. O(N^2) in the rows."""

    def __init__(self, dim: int, ff_dim: int = 32, dropout: float = 0.2, n_heads: int = 1):
        super().__init__()
        self.dropout = dropout
        self._new("MultiHeadDotProductAttention", MultiHeadAttention(dim, n_heads))
        self._new("LayerNorm", nn.LayerNorm(dim, eps=LN_EPS))
        self._new("Dense", nn.Linear(dim, ff_dim))
        self._new("Dense", nn.Linear(ff_dim, dim))
        self._new("LayerNorm", nn.LayerNorm(dim, eps=LN_EPS))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        def drop(v):
            return feature_dropout(v, self.dropout, generator, train)

        x = self.LayerNorm_0(x + drop(self.MultiHeadDotProductAttention_0(x)))
        ff = self.Dense_1(drop(torch.relu(self.Dense_0(x))))
        return self.LayerNorm_1(x + drop(ff))


class TransformerEncoderLayer(SelfAttentionBlock):
    """HGCN's `torch.nn.TransformerEncoderLayer` in its post-norm form
    inside a `TransformerEncoder(norm=LayerNorm)` (the JAX
    `TransformerEncoderLayer`, reference HGCN.py:100-127): the
    `SelfAttentionBlock` with two heads, then the encoder's own LayerNorm
    (`LayerNorm_2`)."""

    def __init__(self, dim: int, n_heads: int = 2, ff_dim: int = 32, dropout: float = 0.2):
        super().__init__(dim, ff_dim, dropout, n_heads)
        self._new("LayerNorm", nn.LayerNorm(dim, eps=LN_EPS))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.LayerNorm_2(super().forward(x, train, generator))


class Tables(nn.Module):
    """The user and item embedding tables (`user_emb` [U, d], `item_emb`
    [I, d], flax's names), the parameters of MF, LightGCN and the SSL
    family's encoders."""

    def __init__(self, n_users: int, n_items: int, dim: int):
        super().__init__()
        self.user_emb = nn.Parameter(torch.empty(n_users, dim))
        self.item_emb = nn.Parameter(torch.empty(n_items, dim))

    def forward(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.user_emb, self.item_emb
