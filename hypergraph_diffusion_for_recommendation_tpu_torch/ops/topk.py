"""Top-K retrieval — the port of the JAX package's `ops/topk.py`.

`lax.top_k` orders equal scores by ascending index; `torch.topk` makes no
such promise on CUDA. `topk_ids` therefore takes a stable descending
sort, which keeps equal scores in index order, so both packages return
the same ids.

`exact_scores` is the [B, d] x [d, I] scoring product of eval and
serving in exact float32 (the JAX package's `precision="highest"`): it
runs with `torch.backends.cuda.matmul.allow_tf32 = False`, whatever the
process set, since TF32 keeps about three decimal digits and reorders
near-ties.
"""

from __future__ import annotations

import contextlib

import torch

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

    scores: [B, I]; rated_pad: [B, max_deg] item ids, pad = -1 (pads are
    written into a spare column that is then dropped)."""
    b, n_items = scores.shape
    out = torch.cat([scores, scores.new_zeros(b, 1)], dim=1)
    cols = torch.where(rated_pad >= 0, rated_pad, n_items).long()
    out.scatter_(1, cols, NEG_INF)
    return out[:, :n_items]


def topk_ids(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the item axis, ties to the lower index:
    ([B, I]) -> values, ids each [B, k]."""
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def masked_topk(
    scores: torch.Tensor, rated_pad: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    return topk_ids(mask_rated(scores, rated_pad), k)
