"""Row-sharded embedding table with explicit collective lookup — the port
of the JAX package's `parallel/embedding.py`.

Each model-axis rank holds a contiguous row block of the table
(`mesh.row_block`); a lookup gathers locally with out-of-range masking and
sums the partial rows over the axis — communication O(B * d) instead of
O(E * d). The JAX functions run inside `shard_map` and take an axis name;
here they run on every rank of a process group and take the group
(`mesh.get_group(MODEL_AXIS)`).

Gradients. Under `shard_map` the JAX `psum` of the lookup transposes to
the identity: every shard computes the same loss on the summed rows, and
each shard's cotangent goes straight to its partial rows.
`torch.distributed.nn.functional.all_reduce` would sum the gradient over
the group again, S times too large, so the sum here is `_SumOverGroup`:
all_reduce forward, identity backward. The all-to-all of
`a2a_sharded_lookup` is its own transpose (`_AllToAll`: the reverse
exchange backward), and the local gathers transpose to scatter-adds into
the local table.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, all_reduce_, all_to_all


class _SumOverGroup(torch.autograd.Function):
    """all_reduce (sum) over a group; the backward passes the gradient on
    unchanged (JAX's psum under shard_map)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all over the leading axis; its backward is the same
    exchange of the gradient (the all-to-all transposes to itself)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def _local_ids(idx: torch.Tensor, rows: int, group) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's row ids of global ids, and which fall in its block."""
    local = idx.long() - dist.get_rank(group) * rows
    return local, (local >= 0) & (local < rows)


def _gather_local(local_table: torch.Tensor, local: torch.Tensor,
                  keep: torch.Tensor) -> torch.Tensor:
    """Rows of `local_table` at `local` where `keep`, zero rows elsewhere.
    Only the kept positions are gathered, so the backward sums each row's
    gradient over the same positions, in the same order, as the dense
    gather `table[idx]` does: on the card the lookup's gradient equals the
    dense one bit for bit."""
    out = local_table.new_zeros(tuple(local.shape) + tuple(local_table.shape[1:]))
    pos = keep.nonzero(as_tuple=True)
    out[pos] = local_table[local[pos]]
    return out


def sharded_lookup(local_table: torch.Tensor, idx: torch.Tensor, group) -> torch.Tensor:
    """Lookup rows of a row-sharded table on every rank of `group`.

    local_table: [E/S, d] — this rank's contiguous row block;
    idx: [B] global row ids (the same on every rank);
    returns [B, d] — full rows, identical on every rank (summed)."""
    local, in_range = _local_ids(idx, local_table.shape[0], group)
    return _SumOverGroup.apply(_gather_local(local_table, local, in_range), group)


def spmd_sharded_lookup(local_table: torch.Tensor, idx: torch.Tensor, mesh) -> torch.Tensor:
    """`table[idx]` over the mesh's model axis: each rank gathers from its
    own row block and the partial rows are summed over the axis. Gradients
    reach each rank's block as the dense gather's rows of that block."""
    return sharded_lookup(local_table, idx, mesh.get_group(MODEL_AXIS))


def a2a_sharded_lookup(
    local_table: torch.Tensor,
    idx_local: torch.Tensor,
    group,
    n_shards: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-to-all lookup exchange on a row-sharded table.

    Where `sharded_lookup` sums FULL [B, d] partial rows over the group,
    this routes each id to the one rank that owns its row and ships only
    the requested rows back:

        bucket ids by owner rank  ->  all_to_all [S, C] id requests
        -> local gather of my rows ->  all_to_all [S, C, d] responses
        -> unpermute into batch order

    at the price of a STATIC per-bucket `capacity` C (ids beyond capacity
    return zero rows). Returns (rows [B_loc, d], overflow count, summed
    over the group): size capacity from the id distribution and alarm on
    overflow > 0. Differentiable in `local_table`.

    `idx_local` is THIS rank's slice of the batch ([B/S] ids)."""
    rows, d = local_table.shape
    b_loc = idx_local.shape[0]
    idx = idx_local.long()
    dest = torch.clamp(idx // rows, 0, n_shards - 1)  # [B]
    # slot of each id inside its destination bucket
    onehot = dest[:, None] == torch.arange(n_shards, device=idx.device)[None, :]  # [B, S]
    pos = torch.cumsum(onehot.long(), dim=0) - 1  # [B, S]
    slot = pos.gather(1, dest[:, None])[:, 0]  # [B]
    ok = slot < capacity
    overflow = all_reduce_((~ok).sum(), group)  # the same on every rank

    send_ids = torch.full((n_shards, capacity), -1, dtype=torch.long, device=idx.device)
    send_ids[dest[ok], slot[ok]] = idx[ok]
    # requests for MY rows, one [1, C] tile from each source rank
    recv_ids = all_to_all(send_ids, group)
    local, in_range = _local_ids(recv_ids, rows, group)
    gathered = _gather_local(local_table, local, in_range & (recv_ids >= 0))  # [S, C, d]
    # ship rows back: response bucket s holds rows served by rank s
    back = _AllToAll.apply(gathered, group)  # [S, C, d]
    out = back[dest, slot.clamp(max=capacity - 1)] * ok[:, None].to(back.dtype)
    return out.reshape(b_loc, d), overflow


def spmd_a2a_lookup(
    local_table: torch.Tensor, idx: torch.Tensor, mesh, capacity_factor: float = 2.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """`table[idx]` as the all-to-all exchange over the mesh's model axis:
    the batch [B] (the same on every rank) is split over the axis, and this
    rank routes its slice, `idx[r * B/S:(r + 1) * B/S]` for model rank r.
    Returns (this slice's rows [B/S, d], overflow count).

    B and the table rows must divide the model-axis size. capacity =
    ceil(B/S^2 * factor), rounded up to a multiple of 8 and at least 8 —
    factor 2 covers uniform id streams, raise it for skewed ones."""
    group = mesh.get_group(MODEL_AXIS)
    n_shards = dist.get_world_size(group)
    b = idx.shape[0]
    if b % n_shards:
        raise ValueError(f"a batch of {b} ids does not split over {n_shards} model ranks")
    capacity = max(-(-b // (n_shards * n_shards)) * capacity_factor, 8)
    capacity = int(-(-capacity // 8) * 8)
    b_loc = b // n_shards
    r = dist.get_rank(group)
    return a2a_sharded_lookup(local_table, idx[r * b_loc:(r + 1) * b_loc], group, n_shards,
                              capacity)


def sharded_scatter_add(
    local_table: torch.Tensor, idx: torch.Tensor, updates: torch.Tensor, group
) -> torch.Tensor:
    """Scatter-add [B, d] updates into a row-sharded table (the backward
    of `sharded_lookup`): each rank keeps only its rows' updates."""
    local, in_range = _local_ids(idx, local_table.shape[0], group)
    return local_table.index_add(0, local[in_range], updates[in_range].to(local_table.dtype))
