"""Sparse products and segment reductions on padded COO — the port of the
JAX package's `ops/sparse.py`.

With row-sorted COO (rows, cols, vals), (A @ X)[r] = sum over the row's
edges of vals * X[cols]. JAX's segment ops drop out-of-range segment ids
(the pads' `row == nrows`) and clamp out-of-range gathers; torch raises
on both. So every segment sum here adds into `num_segments + 1` rows and
drops the last, and every gather by a segment id clamps explicitly.
"""

from __future__ import annotations

import torch

from ..core.types import SparseCOO, with_new_vals
from .kernels.segment_spmm import blocked_spmm


def scatter_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum: ids outside [0, num_segments) are dropped. Each
    segment sums in one fixed order, so that a training step or an encode
    repeats bit for bit and its CUDA graph's replay equals it: on the card
    `index_put_` accumulates over a stable sort of the ids (`index_add_`'s
    atomics add in an order that changes from run to run), on the CPU
    `index_add_` adds in id order."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    if out.is_cuda:
        return out.index_put_((ids,), values, accumulate=True)[:num_segments]
    return out.index_add_(0, ids, values)[:num_segments]


# the longest run of one id that `scatter_sum_hubs` adds one element after another
RUN_CHUNK = 512


def _chunked_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 chunk: int = RUN_CHUNK) -> torch.Tensor:
    """`scatter_sum` in two fixed-order levels, on any device: the ids are
    sorted (stably) and cut into runs of at most `chunk` equal ids, each run
    is summed, and the runs' sums are summed per id. No id's elements are
    added more than about max(chunk, count / chunk) after one another."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    tail = tuple(values.shape[1:])
    out = values.new_zeros((num_segments + 1,) + tail)
    e = ids.shape[0]
    if e == 0:
        return out[:num_segments]
    sorted_ids, perm = torch.sort(ids, stable=True)
    pos = torch.arange(e, device=ids.device)
    start = torch.ones(e, dtype=torch.bool, device=ids.device)
    start[1:] = (sorted_ids[1:] != sorted_ids[:-1]) | (pos[1:] % chunk == 0)
    run = torch.cumsum(start, 0) - 1  # each element's run, in sorted order
    # at most one run per id and one more per chunk boundary: a bound known on
    # the host, so the second level sums no more slots than that
    m = min(e, num_segments + 1 + -(-e // chunk))
    partial = values.new_zeros((m,) + tail).index_put_((run,), values[perm], accumulate=True)
    seg = ids.new_zeros(m).scatter_reduce_(0, run, sorted_ids, "amax", include_self=False)
    # the slots past the last run hold zeros: spread them over the rows
    slot = pos[:m]
    seg = torch.where(slot <= run[-1], seg, slot % (num_segments + 1))
    return out.index_put_((seg,), partial, accumulate=True)[:num_segments]


def scatter_sum_hubs(values: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """`scatter_sum` for ids of which one may repeat hundreds of thousands of
    times (AutoCF's decoder edges: a proposal outside the masked pool falls
    back to the first seed; a KG relation over its edges). On the card `index_put_` adds a run of equal
    ids one element after another, so the longest run sets its time; here
    the runs are cut at RUN_CHUNK (`_chunked_sum`), in one fixed order still.
    On the CPU, `scatter_sum`."""
    if not values.is_cuda:
        return scatter_sum(values, segment_ids, num_segments)
    return _chunked_sum(values, segment_ids, num_segments)


class _GatherRows(torch.autograd.Function):
    """x[ids] for ids of any shape, whose backward sums through
    `_chunked_sum` over the flattened ids."""

    @staticmethod
    def forward(ctx, x, ids):
        ctx.save_for_backward(ids)
        ctx.n = x.shape[0]
        return x[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        return _chunked_sum(g.reshape((flat.numel(),) + g.shape[ids.dim():]), flat, ctx.n), None


def gather_rows_hubs(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[ids] (ids in range, of any shape) for ids with long runs of one id: on the card
    the backward, a sum into x's rows, goes through `_chunked_sum` instead
    of the index backward's `index_put_`; on the CPU plain indexing."""
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, ids)
    return x[ids]


def scatter_mean(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment mean (the JAX `scatter_mean`, torch_scatter's reduce='mean'
    in the reference's ED-HNN operator): sums over counts, an empty
    segment 0. Every value with an id in range counts, zeros included."""
    sums = scatter_sum(values, segment_ids, num_segments)
    counts = scatter_sum(values.new_ones((values.shape[0], 1)), segment_ids, num_segments)
    return sums / torch.clamp(counts, min=1.0)


def spmm(a: SparseCOO, x: torch.Tensor) -> torch.Tensor:
    """A @ X for padded row-sorted COO A: [n, m] x [m, d] -> [n, d].

    With a packed layout attached (every matrix on a CUDA device, see
    `data/device.py`) this is the CUDA segment-SpMM kernel. Without one it
    is a gather and a segment sum, for tensors on the CPU only.
    """
    if a.blocked is not None:
        return blocked_spmm(a.blocked, x)
    if x.device.type != "cpu":
        raise ValueError(f"spmm: a matrix without a kernel layout multiplies only on the CPU, "
                         f"got X on {x.device}")
    gathered = x[a.cols.long()] * a.vals[:, None].to(x.dtype)
    return scatter_sum(gathered, a.rows, a.nrows)


def spmm_t(a: SparseCOO, x: torch.Tensor) -> torch.Tensor:
    """A.T @ X without the transpose's structure: [m, d] from [n, d]. The
    segment ids (a.cols) are not sorted and the pads all add (zeros) into
    column 0, so the sum goes through `scatter_sum_hubs`: in one fixed
    order, which repeats bit for bit on the card. Models that apply A.T
    repeatedly carry the transposed matrix instead (an AdjPair's `bwd`)."""
    gathered = x[a.rows.long().clamp(0, a.nrows - 1)] * a.vals[:, None].to(x.dtype)
    return scatter_sum_hubs(gathered, a.cols, a.ncols)


def sp_dense_left(x: torch.Tensor, a: SparseCOO) -> torch.Tensor:
    """X @ A for dense X: [d, n] x [n, m] -> [d, m], as (A.T @ X.T).T."""
    return spmm_t(a, x.T).T


class _SpmmPair(torch.autograd.Function):
    """The JAX `spmm_pair` custom VJP (sparse.py:57-81): the backward is
    A^T @ g on the transposed structure's own layout, so the segment-SpMM
    kernels serve both directions. Adjacency values get no gradient."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        ctx.a_t = a_t
        return spmm(a, x)

    @staticmethod
    def backward(ctx, g):
        # the kernels take a contiguous float32 operand; gradients arriving
        # through slices and LayerNorms often are not contiguous
        return spmm(ctx.a_t, g.contiguous().float()), None, None


def spmm_pair(a: SparseCOO, a_t: SparseCOO, x: torch.Tensor) -> torch.Tensor:
    """A @ X where the caller also supplies A^T (an AdjPair's two
    directions); differentiable in X, with dX = A^T @ g through `a_t`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SpmmPair.apply(x, a, a_t)
    return spmm(a, x)


def two_hop(a: SparseCOO, a_t: SparseCOO, x: torch.Tensor) -> torch.Tensor:
    """A @ (A.T @ X) — the `HGCNConv` hypergraph convolution primitive
    (reference model/graph/KHGRec.py:455-464)."""
    return spmm_pair(a, a_t, spmm_pair(a_t, a, x))


def renormalize_sym(a: SparseCOO) -> SparseCOO:
    """D^-1/2 A D^-1/2 of a square matrix from its current values (after
    edge dropout, say), the degrees summed on the device in the fixed order
    of `scatter_sum` (the JAX `renormalize_sym`; SGL re-normalises after
    augmenting, reference SGL.py:145-147)."""
    deg = scatter_sum(a.vals, a.rows, a.nrows)
    d_inv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)), 0.0)
    vals = a.vals * d_inv[a.rows.long().clamp(0, a.nrows - 1)] \
        * d_inv[a.cols.long().clamp(0, a.ncols - 1)]
    return with_new_vals(a, vals)


def segment_softmax(
    scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    valid: torch.Tensor | None = None, hubs: bool = False,
) -> torch.Tensor:
    """Numerically-stable softmax over segments (rows of a sparse matrix),
    for scores [E] or [E, ...] (one softmax per trailing index: AutoCF's
    [E, heads]). `valid`, of the scores' shape, masks padded entries out
    of both max and sum; an empty segment's max (-inf) is taken as 0, as
    in the JAX package. `hubs`: the ids may hold very long runs of one id,
    so the sums and the gathers' backward go through `scatter_sum_hubs` and
    `gather_rows_hubs` (the same values; on the CPU the same code)."""
    gather = gather_rows_hubs if hubs else (lambda t, i: t[i])
    sum_into = scatter_sum_hubs if hubs else scatter_sum
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    ids = segment_ids.long()
    in_range = (ids >= 0) & (ids < num_segments)
    into = torch.where(in_range, ids, num_segments)
    into = into.reshape((-1,) + (1,) * (scores.dim() - 1)).expand(scores.shape)
    seg_max = scores.new_full((num_segments + 1,) + tuple(scores.shape[1:]),
                              -torch.inf).scatter_reduce_(
        0, into, scores, reduce="amax"
    )[:num_segments]
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    gather_ids = ids.clamp(0, num_segments - 1)
    expd = torch.exp(scores - gather(seg_max, gather_ids))
    if valid is not None:
        expd = torch.where(valid, expd, 0.0)
    denom = gather(sum_into(expd, ids, num_segments), gather_ids)
    return expd / torch.clamp(denom, min=1e-12)
