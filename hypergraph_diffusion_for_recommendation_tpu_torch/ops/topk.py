"""Top-K retrieval — the port of the JAX package's `ops/topk.py`.

`lax.top_k` orders equal scores by ascending index; `torch.topk` makes no
such promise on CUDA. `topk_ids` and `masked_topk` take
`ops/kernels/topk_select.topk_select`, which returns what a stable
descending sort returns, equal scores in index order, so both packages
return the same ids: on the card a CUDA kernel that reads each score once
and masks as it reads, on the CPU the mask and the stable sort.

`exact_scores` is the [B, d] x [d, I] scoring product of eval and
serving in exact float32 (the JAX package's `precision="highest"`): it
runs with `torch.backends.cuda.matmul.allow_tf32 = False`, whatever the
process set, since TF32 keeps about three decimal digits and reorders
near-ties. The port ranks users through `eval.metrics.top_items`, which
scores and selects in one kernel instead where it takes the tables
(`ops/kernels/score_topk.py`).

`distributed_topk` merges the top-k of item shards held by the ranks of
a process group (`parallel/topk.py`).
"""

from __future__ import annotations

import contextlib

import torch

from .kernels.topk_select import topk_select

NEG_INF = -1e9  # reference masks rated items with -10e8 (base/main_recommender.py:88)


@contextlib.contextmanager
def exact_f32():
    """Matmuls in full float32 inside the block (TF32 off), whatever the
    process set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def exact_scores(user_rows: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
    """user_rows @ item_emb.T in full float32: [B, d] x [I, d] -> [B, I]."""
    with exact_f32():
        return user_rows.float() @ item_emb.float().T


def mask_rated(scores: torch.Tensor, rated_pad: torch.Tensor) -> torch.Tensor:
    """NEG_INF into each user's already-rated item slots (a new tensor).

    scores: [B, I]; rated_pad: [B, max_deg] item ids, pad = -1. An id
    outside [0, I) is ignored (it is written into a spare column that is
    then dropped), and a repeated id is harmless."""
    b, n_items = scores.shape
    out = torch.cat([scores, scores.new_zeros(b, 1)], dim=1)
    cols = torch.where((rated_pad >= 0) & (rated_pad < n_items), rated_pad, n_items).long()
    out.scatter_(1, cols, NEG_INF)
    return out[:, :n_items]


def topk_ids(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the item axis, ties to the lower index:
    ([B, I]) -> values, ids each [B, min(k, I)]."""
    return topk_select(scores, None, k)


def masked_topk(
    scores: torch.Tensor, rated_pad: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """`topk_ids` after NEG_INF into each row's rated items (`rated_pad`
    [B, max_deg], pad -1), which stay candidates at that value."""
    return topk_select(scores, rated_pad, k)


def distributed_topk(
    local_scores: torch.Tensor,
    k: int,
    group,
    item_shard_offset: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k across an item axis sharded over the ranks of `group` (a
    `torch.distributed` process group; the JAX function's axis name).

    Each rank computes the top-k of its item slice, converts ids to
    global ids by its offset, all-gathers k * n_ranks candidates (in group
    rank order), and takes the top-k of the merged set, ties to the lower
    candidate position as `lax.top_k`. Communication is O(B * k * n_ranks)
    instead of O(B * I)."""
    from ..parallel.mesh import all_gather_cat

    loc_vals, loc_ids = topk_ids(local_scores, k)
    glob_ids = loc_ids + item_shard_offset
    all_vals = all_gather_cat(loc_vals, group, dim=1)
    all_ids = all_gather_cat(glob_ids, group, dim=1)
    m_vals, m_pos = topk_ids(all_vals, k)
    return m_vals, all_ids.gather(1, m_pos)
