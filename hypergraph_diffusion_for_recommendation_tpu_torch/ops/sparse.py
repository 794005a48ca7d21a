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

from ..core.types import SparseCOO
from .kernels.segment_spmm import blocked_spmm


def scatter_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum: ids outside [0, num_segments) are dropped."""
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = values.new_zeros((num_segments + 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, ids, values)[:num_segments]


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


def segment_softmax(
    scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Numerically-stable softmax over segments (rows of a sparse matrix).
    `valid` masks padded entries out of both max and sum; an empty
    segment's max (-inf) is taken as 0, as in the JAX package."""
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    ids = segment_ids.long()
    in_range = (ids >= 0) & (ids < num_segments)
    seg_max = scores.new_full((num_segments + 1,), -torch.inf).scatter_reduce_(
        0, torch.where(in_range, ids, num_segments), scores, reduce="amax"
    )[:num_segments]
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    gather_ids = ids.clamp(0, num_segments - 1)
    expd = torch.exp(scores - seg_max[gather_ids])
    if valid is not None:
        expd = torch.where(valid, expd, 0.0)
    denom = scatter_sum(expd, ids, num_segments)[gather_ids]
    return expd / torch.clamp(denom, min=1e-12)
