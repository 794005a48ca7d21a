"""Sharded full-catalog scoring + distributed top-k — the port of the JAX
package's `parallel/topk.py`.

The item table is row-sharded over the model axis: each rank scores its
item slice (in exact float32, `ops.topk.exact_scores`), masks the pad
rows and the rated items that fall in its slice, computes a local top-k,
then k * S candidates are all-gathered and merged — communication
O(B * k * S), never the full [B, I] score matrix.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.topk import NEG_INF, distributed_topk, exact_scores, mask_rated
from .mesh import MODEL_AXIS


def sharded_user_topk(
    mesh,
    user_emb: torch.Tensor,  # [B, d], the same on every rank
    local_items: torch.Tensor,  # [I_pad/S, d], this rank's row block (mesh.row_block)
    rated_pad: torch.Tensor,  # [B, max_deg] global item ids, pad -1 (the same on every rank)
    k: int,
    n_items: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k item scores and ids per user across the item shards, the same
    on every rank. `n_items`: the catalogue's size, the item table's rows
    before they were padded to a multiple of the model axis (pad rows can
    never be retrieved)."""
    group = mesh.get_group(MODEL_AXIS)
    rows = local_items.shape[0]
    offset = dist.get_rank(group) * rows
    scores = exact_scores(user_emb, local_items)  # [B, I/S]
    glob_cols = offset + torch.arange(rows, device=scores.device)
    scores = torch.where(glob_cols[None, :] < n_items, scores, NEG_INF)
    # mask rated items that fall in this shard
    local_rated = rated_pad.long() - offset
    ok = (local_rated >= 0) & (local_rated < rows)
    scores = mask_rated(scores, torch.where(ok, local_rated, -1))
    return distributed_topk(scores, k, group, offset)
