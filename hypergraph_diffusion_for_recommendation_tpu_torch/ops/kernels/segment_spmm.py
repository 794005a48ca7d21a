"""Row-window segment SpMM: out = A @ X over a packed edge layout.

The port's counterpart of the JAX package's `ops/pallas/segment_spmm.py`.
The packers build the same row-window edge-block layouts, bit for bit
(`cols`, `vals`, `local_rows`, `wmap`, `src`, `canon`, and for the dedup
layout `ucols` and `local_cols`), so `src` and `canon` keep their meaning
per slot. The forward runs on four CUDA kernels written for Hopper
(`csrc/segment_spmm.cu`):

  * `segment_spmm_rows` for the base layout (`pack_blocked`), the port of
    `_segment_matmul_kernel`: each warp of a 256-thread CTA sums a run
    of consecutive rows of at most `ROW_SLOTS` slots in all, a row
    longer than that gets a CTA of its own whose warps reduce through
    shared memory (`warp_rows`, `row_start`, `row_end`: port-only fields
    the packer adds); every row is written once, with no atomics;
  * `segment_spmm_dedup` for the dedup layout (`pack_blocked_dedup`), the
    port of `_segment_matmul_dedup_kernel`: a CTA per (part of a row
    window's blocks, feature slice) stages each block's distinct X rows
    in shared memory, and each warp sums the (row, distinct column) runs
    of its 16 rows in registers: in bf16 as its rows' W tile times the
    staged rows on the tensor cores, in f32 with multiply-adds
    (`order_rc`, `order_slot`, `block_meta`, `window_blocks`: port-only
    fields; `dedup_parts` cuts the blocks into parts); the parts of a
    window cut into several are summed by a second pass in part order;
  * `segment_spmm_rows_int8` and `segment_spmm_dedup_int8`, the ports of
    `_segment_matmul_int8_kernel` and `_segment_matmul_dedup_int8_kernel`
    on an int8-quantised X (`BlockedCOO.int8`): the first walks the base
    layout's work lists summing in integers (in f64 where a warp's edge
    values span more than 7 binades), the second runs on the dedup
    kernel's parts (`dedup_parts` with `dedup_int8_block_cost`) and work
    lists, its sums in f64 registers; both dequantise as they write. On the card X is
    quantised by a kernel of two launches (`quantize_int8_fused`), bit for
    bit with the plain `quantize_int8`.

`blocked_spmm_reference` is the plain PyTorch version of all four and
rounds where the kernels round. `blocked_spmm` takes it only for tensors
on the CPU; for a CUDA tensor it launches the kernel or raises.
`blocked_spmm` is differentiable with the JAX custom VJP: dx = A^T g by a
segment sum over the columns and, when runtime `vals` are given, dvals
through `src`, both plain torch ops (XLA ops in JAX) that sum in a fixed
order, so that the backward repeats bit for bit on the card.

bf16 mode (`BlockedCOO.bf16`) mirrors the TPU kernels: the X table is
cast to bf16 once, each edge value is rounded to bf16, the dedup
kernel's per-(row, distinct column) weight is rounded to bf16, and every
sum is accumulated in f32. int8 mode (`BlockedCOO.int8`, which overrides
bf16) quantises X per column (`quantize_int8`), rounds the edge values
and W to bf16 as bf16 mode does, sums in f64, where every bf16 x int8
product and so every sum is exact (the TPU kernel sums in f32; see the
CUDA source for why exact), and scales the sum, rounded to f32, by the
column's scale. The int8 kernels sum exactly too (kernel 3 in integers
where they are exact, else in f64), and the f32 rounding of an exact sum
does not depend on how it was formed: they agree with the plain version
bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ...core.device import resolve_device

# default tiles, as in the JAX package (eb 512 / rb 256 / ub 256)
EDGE_BLOCK = 512
ROW_BLOCK = 256
UNIQUE_BLOCK = 256
# the base kernel's work list: a warp sums consecutive rows of at most
# ROW_SLOTS slots in all and ROWS_PER_WARP rows; a longer row takes a CTA
# of WARPS_PER_CTA warps (as many as the kernel's CTA has)
ROW_SLOTS = 64
ROWS_PER_WARP = 2
WARPS_PER_CTA = 8
_BATCH_COST = 32  # a row's slot load, counted as slots when the packer orders the CTAs
# the dedup kernels: 16 warps a CTA, warp w owning the window rows
# s * 16 + w, s < DEDUP_ROWS_PER_WARP, so a row window has at most 256 rows
DEDUP_WARPS = 16
DEDUP_ROWS_PER_WARP = 16

# the most dynamic shared memory a Hopper CTA may use (227 KB), and an SM
# holds (228 KB)
_MAX_SMEM = 232448
_SM_SMEM = 233472

# launches of each CUDA kernel, counted by `blocked_spmm` where it launches: a
# count of Python calls, so a CUDA graph's capture counts once and its replays,
# which run the captured launches without Python, not at all
LAUNCHES = {"segment_spmm_rows": 0, "segment_spmm_dedup": 0,
            "segment_spmm_rows_int8": 0, "segment_spmm_dedup_int8": 0, "quantize_int8": 0}
# kernel calls whose X was padded to a width the kernel takes (`_launch`)
PADDED = {"calls": 0}


@dataclass(frozen=True)
class BlockedCOO:
    """Row-window aligned edge-block layout (see the JAX `BlockedCOO`)."""

    cols: torch.Tensor  # [n_blocks, eb] int32 (pad 0 with val 0)
    vals: torch.Tensor  # [n_blocks, eb] f32
    local_rows: torch.Tensor  # [n_blocks, eb] int32 in [0, rb); pad = rb
    wmap: torch.Tensor  # [n_blocks] int32 window of each block (non-decreasing)
    src: torch.Tensor  # [n_blocks, eb] int32 slot -> index in the source padded COO
    canon: torch.Tensor  # [n_blocks, eb] int32 slot -> canonical (fwd) edge id
    nrows: int
    ncols: int
    n_blocks: int
    n_windows: int
    bf16: bool = False
    # int8 gathered operand: X quantised per column, dequantised on the
    # output (the TPU int8 kernels); takes precedence over bf16
    int8: bool = False
    eb: int = EDGE_BLOCK
    rb: int = ROW_BLOCK
    # live (packed) edges; a layout without any launches no kernel
    n_live: int = 0
    # base layout only (port-only): warp k of CTA c sums the rows
    # [warp_rows[c, k], warp_rows[c, k + 1]); a CTA whose first warp holds
    # one row of more than ROW_SLOTS slots gives all its warps to that row.
    # Row r's slots are the flat range [row_start[r], row_end[r]) of the
    # [n_blocks * eb] slot arrays
    warp_rows: torch.Tensor | None = None  # [n_ctas, WARPS_PER_CTA + 1] int32
    row_start: torch.Tensor | None = None  # [nrows] int32
    row_end: torch.Tensor | None = None  # [nrows] int32
    # dedup layout only: distinct columns per block and each slot's rank
    ucols: torch.Tensor | None = None  # [n_blocks, ub] int32 (pad 0)
    local_cols: torch.Tensor | None = None  # [n_blocks, eb] int32 in [0, ub); pad = ub
    ub: int = 0
    # dedup layout only (port-only): each block's live slots in the order
    # (row % 16, row, slot): (local row << 16) | local column, and the flat
    # slot; block_meta[b] = the 257 offsets of the groups
    # (row % 16) * 16 + row // 16 in that order (warp w sums the rows of
    # groups 16 w .. 16 w + 15), then the block's distinct columns in use;
    # window w's blocks are [window_blocks[w], window_blocks[w + 1])
    order_rc: torch.Tensor | None = None  # [n_blocks, eb] int32
    order_slot: torch.Tensor | None = None  # [n_blocks, eb] int32
    block_meta: torch.Tensor | None = None  # [n_blocks, 258] int32
    window_blocks: tuple[int, ...] = ()
    # what the wrapper checked and derived once (shared by `replace` copies)
    cache: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def dedup(self) -> bool:
        return self.ucols is not None

    def replace(self, **kw) -> "BlockedCOO":
        return dataclasses.replace(self, **kw)


def _pad_blocks8(cols, vals, lrows, src, wmap, rb, lcols=None, ucols=None, ub=0):
    """Pad the block axis to a multiple of 8 with inert all-pad blocks, as
    the JAX packers do (kept so the layouts agree bit for bit)."""
    nb = cols.shape[0]
    pad = (-nb) % 8
    if pad == 0:
        out = (cols, vals, lrows, src, wmap)
        return out if lcols is None else out + (lcols, ucols)
    bp = ((0, pad), (0, 0))
    cols = np.pad(cols, bp)
    vals = np.pad(vals, bp)
    lrows = np.pad(lrows, bp, constant_values=rb)
    src = np.pad(src, bp)
    wmap = np.pad(wmap, (0, pad), mode="edge")
    out = (cols, vals, lrows, src, wmap)
    if lcols is None:
        return out
    return out + (np.pad(lcols, bp, constant_values=ub), np.pad(ucols, bp))


def _row_work(counts: np.ndarray) -> np.ndarray:
    """The base kernel's work list, `warp_rows` [n_ctas, WARPS_PER_CTA + 1]:
    CTA c's warp k takes the rows [warp_rows[c, k], warp_rows[c, k + 1]).
    Greedy over the rows in order, a warp takes consecutive rows (empty
    ones too) while they add up to at most ROW_SLOTS slots and
    ROWS_PER_WARP rows; a row longer than ROW_SLOTS closes the CTA being
    filled (its remaining warps get no rows) and takes a CTA of its own,
    one row in its first warp and none in the others. Every row lies in
    exactly one warp. The CTAs are listed costliest first (a hub CTA's
    eighth of its row, a packed CTA's busiest warp), so that the long ones
    do not start last and leave the card waiting on a tail."""
    n = counts.shape[0]
    bounds = [0]  # warp k takes the rows [bounds[k], bounds[k + 1])
    rows = slots = 0  # in the warp being filled, which starts at bounds[-1]

    def close_cta(r):
        bounds.extend([r] * (-(len(bounds) - 1) % WARPS_PER_CTA))

    for r, c in enumerate(counts.tolist()):
        if c > ROW_SLOTS:
            if rows:
                bounds.append(r)
            close_cta(r)
            bounds.extend([r + 1] * WARPS_PER_CTA)
            rows = slots = 0
            continue
        if rows and (slots + c > ROW_SLOTS or rows == ROWS_PER_WARP):
            bounds.append(r)
            rows = slots = 0
        rows += 1
        slots += c
    if rows:
        bounds.append(n)
    close_cta(n)
    bounds = np.asarray(bounds, np.int64)
    n_ctas = (bounds.shape[0] - 1) // WARPS_PER_CTA
    ctas = bounds[np.arange(n_ctas)[:, None] * WARPS_PER_CTA + np.arange(WARPS_PER_CTA + 1)]
    # cost in slots: a warp's slots plus a batch load a row; a hub CTA's warp sums an eighth
    row_slot = np.concatenate([[0], np.cumsum(counts)])
    warp_cost = (row_slot[ctas[:, 1:]] - row_slot[ctas[:, :-1]]
                 + _BATCH_COST * (ctas[:, 1:] - ctas[:, :-1]))
    hub = (ctas[:, 1] == ctas[:, 0] + 1) & (counts[np.minimum(ctas[:, 0], n - 1)] > ROW_SLOTS)
    cost = np.where(hub, warp_cost[:, 0] / WARPS_PER_CTA + _BATCH_COST, warp_cost.max(axis=1))
    return ctas[np.argsort(-cost, kind="stable")]


def _dedup_order(lrows: np.ndarray, lcols: np.ndarray, rb: int, eb: int):
    """The dedup kernel's per-block work lists (see `BlockedCOO`) from the
    padded [n_blocks, eb] local rows and columns: (order_rc, order_slot,
    block_meta)."""
    if rb > DEDUP_WARPS * DEDUP_ROWS_PER_WARP or lcols.max(initial=0) > 65535:
        raise ValueError("pack_blocked_dedup: the CUDA kernel takes row_block <= 256 and "
                         "unique_block <= 65535")
    nb = lrows.shape[0]
    b_idx, pos = np.nonzero(lrows < rb)
    lr, lc = lrows[b_idx, pos], lcols[b_idx, pos]
    group = (lr % DEDUP_WARPS) * DEDUP_ROWS_PER_WARP + lr // DEDUP_WARPS
    order = np.lexsort((pos, group, b_idx))
    b_s, lr_s, lc_s, pos_s = b_idx[order], lr[order], lc[order], pos[order]
    count = np.bincount(b_idx, minlength=nb)
    rank = np.arange(b_s.shape[0]) - np.repeat(np.cumsum(count) - count, count)
    order_rc = np.zeros((nb, eb), np.int64)
    order_slot = np.zeros((nb, eb), np.int64)
    order_rc[b_s, rank] = (lr_s << 16) | lc_s
    order_slot[b_s, rank] = b_s * eb + pos_s
    n_groups = DEDUP_WARPS * DEDUP_ROWS_PER_WARP
    per_group = np.bincount(b_idx * n_groups + group, minlength=nb * n_groups)
    meta = np.zeros((nb, n_groups + 2), np.int64)
    meta[:, 1: n_groups + 1] = np.cumsum(per_group.reshape(nb, n_groups), axis=1)
    np.maximum.at(meta[:, n_groups + 1], b_idx, lc + 1)  # distinct columns in use
    return order_rc, order_slot, meta


def _window_bounds(wmap: np.ndarray, n_windows: int) -> tuple[int, ...]:
    """Block boundaries of the windows over the non-decreasing `wmap` (the
    trailing pad blocks repeat, and so join, the last window)."""
    starts = np.searchsorted(wmap, np.arange(n_windows), side="left")
    return tuple(int(b) for b in starts) + (int(wmap.shape[0]),)


def dedup_parts(window_blocks, target: int,
                cost=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The dedup kernel's parts (a CTA each per feature slice): each
    window's blocks cut into consecutive ranges of near-equal `cost` (one a
    block by default), at most `target` parts in all where the windows
    allow it. Returns (part_window [n_parts], part_blocks [n_parts + 1]:
    part p takes the blocks [part_blocks[p], part_blocks[p + 1]),
    window_parts [n_windows + 1]: window w's parts are [window_parts[w],
    window_parts[w + 1]))."""
    wb = np.asarray(window_blocks, np.int64)
    n_blocks = int(wb[-1])
    cost = np.ones(n_blocks) if cost is None else np.asarray(cost, np.float64)
    cum = np.concatenate([[0.0], np.cumsum(cost)])
    w_cost = cum[wb[1:]] - cum[wb[:-1]]
    budget = max(cum[-1] / max(target, 1), cost.max(initial=1.0))
    while True:
        parts = np.maximum(1, np.ceil(w_cost / budget - 1e-9).astype(np.int64))
        if parts.sum() <= target or (parts == 1).all():
            break
        budget *= 1.05
    starts = []
    for w in range(wb.shape[0] - 1):
        lo, hi = int(wb[w]), int(wb[w + 1])
        # part k of the window starts at the block holding the k-th of its
        # `parts` evenly spaced cost marks
        marks = cum[lo] + w_cost[w] * np.arange(parts[w]) / parts[w]
        first = np.searchsorted(cum[lo:hi], marks, side="right") - 1 + lo
        starts.append(np.maximum.accumulate(first))
    starts = np.concatenate(starts) if starts else np.zeros(0, np.int64)
    keep = np.concatenate([[True], starts[1:] != starts[:-1]])  # drop empty parts
    starts = starts[keep]
    part_window = np.searchsorted(wb, starts, side="right") - 1
    window_parts = np.searchsorted(part_window, np.arange(wb.shape[0]), side="left")
    return part_window, np.append(starts, n_blocks), window_parts


def _i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)


def pack_blocked(
    rows, cols, vals, shape, bf16: bool = False,
    edge_block: int | None = None, row_block: int | None = None,
    canon_map=None, device: torch.device | str | None = None,
) -> BlockedCOO:
    """Host-side packing of row-sorted COO into row-window edge blocks
    (JAX `pack_blocked`). `rows` may include pad entries
    (row == shape[0]); live edges must be sorted by row. `src` records
    each slot's index in the INPUT arrays; `canon_map` maps it to a
    canonical edge id (identity by default)."""
    device = resolve_device(device)
    eb = EDGE_BLOCK if edge_block is None else edge_block
    rb = ROW_BLOCK if row_block is None else row_block
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    live_idx = np.nonzero(rows < shape[0])[0]
    rows_l, cols_l, vals_l = rows[live_idx], cols[live_idx], vals[live_idx]

    n_windows = max(-(-shape[0] // rb), 1)
    starts = np.searchsorted(rows_l, np.arange(n_windows) * rb, side="left")
    ends = np.append(starts[1:], rows_l.shape[0])

    # live edge i of window w lands in slot
    #   (block_offset[w] + (i - starts[w]) // eb) * eb + (i - starts[w]) % eb;
    # an empty window still gets one all-pad block
    n_w = ends - starts
    blocks_per_w = np.maximum(-(-n_w // eb), 1)
    block_offset = np.concatenate([[0], np.cumsum(blocks_per_w)[:-1]])
    n_blocks = int(blocks_per_w.sum())
    wmap_np = np.repeat(np.arange(n_windows, dtype=np.int64), blocks_per_w)

    n_live = rows_l.shape[0]
    edge_w = np.repeat(np.arange(n_windows, dtype=np.int64), n_w)
    pos_in_w = np.arange(n_live, dtype=np.int64) - np.repeat(starts, n_w)
    flat = (block_offset[edge_w] + pos_in_w // eb) * eb + pos_in_w % eb

    cols_b = np.zeros(n_blocks * eb, np.int64)
    vals_b = np.zeros(n_blocks * eb, np.float32)
    lrows_b = np.full(n_blocks * eb, rb, np.int64)
    src_b = np.zeros(n_blocks * eb, np.int64)
    cols_b[flat] = cols_l
    vals_b[flat] = vals_l
    lrows_b[flat] = rows_l - edge_w * rb
    src_b[flat] = live_idx

    # a window's edges fill a contiguous flat range in row order, so each
    # row's slots are contiguous too
    counts = np.bincount(rows_l.astype(np.int64), minlength=shape[0])[: shape[0]]
    first = np.searchsorted(rows_l, np.arange(shape[0]), side="left")
    row_start = np.zeros(shape[0], np.int64)  # an empty row: the empty range [0, 0)
    row_start[counts > 0] = flat[first[counts > 0]]
    row_end = row_start + counts

    cols_p, vals_p, lrows_p, src_p, wmap_p = _pad_blocks8(
        cols_b.reshape(n_blocks, eb), vals_b.reshape(n_blocks, eb),
        lrows_b.reshape(n_blocks, eb), src_b.reshape(n_blocks, eb),
        wmap_np, rb,
    )
    canon_np = src_p if canon_map is None else np.asarray(canon_map)[src_p]
    return BlockedCOO(
        cols=_i32(cols_p, device),
        vals=torch.as_tensor(vals_p, device=device),
        local_rows=_i32(lrows_p, device),
        wmap=_i32(wmap_p, device),
        src=_i32(src_p, device),
        canon=_i32(canon_np, device),
        nrows=int(shape[0]),
        ncols=int(shape[1]),
        n_blocks=int(cols_p.shape[0]),
        n_windows=n_windows,
        bf16=bf16,
        eb=eb,
        rb=rb,
        n_live=int(n_live),
        warp_rows=_i32(_row_work(counts), device),
        row_start=_i32(row_start, device),
        row_end=_i32(row_end, device),
    )


def pack_blocked_dedup(
    rows, cols, vals, shape, bf16: bool = False,
    edge_block: int | None = None, row_block: int | None = None,
    unique_block: int | None = None, canon_map=None,
    device: torch.device | str | None = None,
) -> BlockedCOO:
    """Dedup-gather packing (JAX `pack_blocked_dedup`): col-sort edges
    inside each row window and close a block at `eb` edges or `ub`
    distinct columns. Same contract as `pack_blocked`."""
    eb = EDGE_BLOCK if edge_block is None else edge_block
    rb = ROW_BLOCK if row_block is None else row_block
    ub = UNIQUE_BLOCK if unique_block is None else unique_block
    device = resolve_device(device)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    live_idx = np.nonzero(rows < shape[0])[0]
    rows_l, cols_l, vals_l = rows[live_idx], cols[live_idx], vals[live_idx]
    w_l = rows_l // rb

    # col-sort within each window (global lexsort by (window, col, row))
    order = np.lexsort((rows_l, cols_l, w_l))
    rows_s, cols_s, vals_s, src_s, w_s = (
        rows_l[order], cols_l[order], vals_l[order], live_idx[order], w_l[order]
    )
    n_live = rows_s.shape[0]
    n_windows = max(-(-shape[0] // rb), 1)

    # distinct-col rank of each edge within its window
    if n_live:
        new_run = np.empty(n_live, bool)
        new_run[0] = True
        new_run[1:] = (w_s[1:] != w_s[:-1]) | (cols_s[1:] != cols_s[:-1])
        run_id = np.cumsum(new_run) - 1
        w_start = np.searchsorted(w_s, np.arange(n_windows), side="left")
        w_end = np.searchsorted(w_s, np.arange(n_windows), side="right")
        first_run = np.zeros(n_windows, np.int64)
        nonempty = w_start < w_end
        first_run[nonempty] = run_id[w_start[nonempty]]
        uid = run_id - first_run[w_s]
    else:
        uid = np.zeros(0, np.int64)
        w_start = w_end = np.zeros(n_windows, np.int64)

    # greedy segmentation per window: close at eb edges or ub uniques
    block_bounds = []  # (window, start, end) over the sorted arrays
    for wi in range(n_windows):
        s, e = int(w_start[wi]), int(w_end[wi])
        if s == e:
            block_bounds.append((wi, s, s))  # all-pad block
            continue
        i = s
        while i < e:
            j_cap = min(i + eb, e)
            j_u = i + np.searchsorted(uid[i:e], uid[i] + ub, side="left")
            j = min(j_cap, j_u)
            block_bounds.append((wi, i, int(j)))
            i = int(j)

    n_blocks = len(block_bounds)
    cols_b = np.zeros((n_blocks, eb), np.int64)
    vals_b = np.zeros((n_blocks, eb), np.float32)
    lrows_b = np.full((n_blocks, eb), rb, np.int64)
    lcols_b = np.full((n_blocks, eb), ub, np.int64)
    src_b = np.zeros((n_blocks, eb), np.int64)
    ucols_b = np.zeros((n_blocks, ub), np.int64)
    wmap_np = np.zeros(n_blocks, np.int64)
    for b, (wi, i, j) in enumerate(block_bounds):
        wmap_np[b] = wi
        n = j - i
        if n == 0:
            continue
        cols_b[b, :n] = cols_s[i:j]
        vals_b[b, :n] = vals_s[i:j]
        lrows_b[b, :n] = rows_s[i:j] - wi * rb
        src_b[b, :n] = src_s[i:j]
        lc = uid[i:j] - uid[i]
        lcols_b[b, :n] = lc
        ucols_b[b, lc] = cols_s[i:j]

    cols_b, vals_b, lrows_b, src_b, wmap_np, lcols_b, ucols_b = _pad_blocks8(
        cols_b, vals_b, lrows_b, src_b, wmap_np, rb,
        lcols=lcols_b, ucols=ucols_b, ub=ub,
    )
    canon_np = src_b if canon_map is None else np.asarray(canon_map)[src_b]
    order_rc, order_slot, block_meta = _dedup_order(lrows_b, lcols_b, rb, eb)
    return BlockedCOO(
        cols=_i32(cols_b, device),
        vals=torch.as_tensor(vals_b, device=device),
        local_rows=_i32(lrows_b, device),
        wmap=_i32(wmap_np, device),
        src=_i32(src_b, device),
        canon=_i32(canon_np, device),
        nrows=int(shape[0]),
        ncols=int(shape[1]),
        n_blocks=int(cols_b.shape[0]),
        n_windows=n_windows,
        bf16=bf16,
        eb=eb,
        rb=rb,
        n_live=int(n_live),
        ucols=_i32(ucols_b, device),
        local_cols=_i32(lcols_b, device),
        ub=ub,
        order_rc=_i32(order_rc, device),
        order_slot=_i32(order_slot, device),
        block_meta=_i32(block_meta, device),
        window_blocks=_window_bounds(wmap_np, n_windows),
    )


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8 quantisation, as the JAX int8 branches
    compute it outside the Pallas body: s = max(max|X| / 127, 1e-12),
    q = clip(round(X / s), -127, 127) (round half to even, as
    `jnp.round`). Returns (q [m, d] int8, s [d] float32). Both divisions
    are IEEE f32 divisions, as in JAX, on every device: the divisor 127 is
    a tensor, since torch divides a CUDA tensor by a Python number as a
    product with its reciprocal, which is an ulp off for some maxima."""
    amax = x.abs().amax(dim=0)
    s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def blocked_spmm_reference(blocked: BlockedCOO, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch A @ X over either layout, rounding where the kernels
    round (see the module docstring). Runs on any device."""
    eb, rb = blocked.eb, blocked.rb
    rounds = blocked.bf16 or blocked.int8  # edge values and W go through bf16
    scale = None
    if blocked.int8:
        q, scale = quantize_int8(x.float())
        table = q.double()  # f64 sums of exact products: exact
    else:
        table = x.to(torch.bfloat16).float() if blocked.bf16 else x.float()
    lrows = blocked.local_rows.reshape(-1).long()
    slots = torch.nonzero(lrows < rb).squeeze(1)
    blk = slots // eb
    grow = blocked.wmap.long()[blk] * rb + lrows[slots]
    vals = blocked.vals.reshape(-1)[slots]
    if rounds:
        vals = vals.bfloat16().float()
    cols = blocked.cols.reshape(-1)[slots].long()
    out = torch.zeros(blocked.nrows, x.shape[1], dtype=table.dtype, device=x.device)
    if not blocked.dedup:
        out.index_add_(0, grow, vals.to(table.dtype)[:, None] * table[cols])
    else:
        # dedup: W[r, u] sums the edges of a block that share (row,
        # distinct column); the packer's (col, row) order makes them
        # consecutive slots
        lcols = blocked.local_cols.reshape(-1)[slots].long()
        key = (blk * rb + lrows[slots]) * (blocked.ub + 1) + lcols
        _, run = torch.unique_consecutive(key, return_inverse=True)
        n_runs = int(run.max()) + 1 if run.numel() else 0
        w = torch.zeros(n_runs, dtype=torch.float32, device=x.device).index_add_(0, run, vals)
        if rounds:
            w = w.bfloat16().float()
        first = torch.ones_like(run, dtype=torch.bool)
        first[1:] = run[1:] != run[:-1]
        head = torch.nonzero(first).squeeze(1)
        out.index_add_(0, grow[head], w.to(table.dtype)[:, None] * table[cols[head]])
    if scale is not None:
        out = out.float() * scale
    return out.to(x.dtype)


_lib = None
_SM_COUNT: dict[int, int] = {}


def _library() -> ctypes.CDLL:
    """Build (first use) and bind `csrc/segment_spmm.cu`."""
    global _lib
    if _lib is None:
        from .build import load_library

        lib = load_library("segment_spmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hd_segment_spmm_rows.argtypes = [p] * 6 + [i, p, i, i, i, i, p]
        lib.hd_segment_spmm_rows.restype = i
        lib.hd_segment_spmm_dedup.argtypes = [p] * 9 + [i, p, p] + [i] * 7 + [p]
        lib.hd_segment_spmm_dedup.restype = i
        lib.hd_segment_spmm_rows_int8.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.hd_segment_spmm_rows_int8.restype = i
        lib.hd_segment_spmm_dedup_int8.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.hd_segment_spmm_dedup_int8.restype = i
        lib.hd_quantize_int8.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.hd_quantize_int8.restype = i
        _lib = lib
    return _lib


def _check_call(blocked: BlockedCOO, x: torch.Tensor) -> None:
    """What may change from call to call: X, and the values (edge dropout
    replaces them)."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            f"blocked_spmm: X must be a contiguous 2-D float32 tensor, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}"
        )
    if x.shape[0] != blocked.ncols:
        raise ValueError(f"blocked_spmm: X has {x.shape[0]} rows, A has {blocked.ncols} columns")
    v = blocked.vals
    if (v.dtype != torch.float32 or v.device != x.device or not v.is_contiguous()
            or v.numel() != blocked.n_blocks * blocked.eb):
        raise ValueError("blocked_spmm: the layout's vals must be a contiguous float32 "
                         "[n_blocks, eb] tensor on X's device")


def _structure(blocked: BlockedCOO, device: torch.device) -> tuple[int, ...]:
    """The data pointers of the index tensors the layout's kernel reads,
    checked at first use and then kept in `blocked.cache` (which the
    layout's `replace` copies share) for as long as the same tensors are
    in the layout."""
    if not blocked.dedup:
        tensors = (blocked.warp_rows, blocked.row_start, blocked.row_end, blocked.cols)
    else:
        tensors = (blocked.ucols, blocked.order_rc, blocked.order_slot, blocked.block_meta)
    key = ("structure", blocked.dedup)
    hit = blocked.cache.get(key)
    if hit is not None and hit[0] == device and all(a is b for a, b in zip(hit[1], tensors)):
        return hit[2]
    for a in tensors:
        if a is None:
            raise ValueError("blocked_spmm: the layout lacks the kernel's work lists (pack it "
                             "with pack_blocked or pack_blocked_dedup)")
        if a.device != device or not a.is_contiguous():
            raise ValueError("blocked_spmm: layout tensors must be contiguous and on X's device")
        if a.dtype != torch.int32:
            raise ValueError(f"blocked_spmm: layout tensor of dtype {a.dtype}; the kernels "
                             f"take int32 indices and float32 values")
    ptrs = tuple(a.data_ptr() for a in tensors)
    blocked.cache[key] = (device, tensors, ptrs)
    return ptrs


def _dedup_slice(elem_size: int) -> int:
    # features a dedup CTA sums: 128 in bf16 (the tensor-core kernel), 64 in
    # f32 and in int8 (elem_size 1)
    return 128 if elem_size == 2 else 64


def _dedup_smem(blocked: BlockedCOO, elem_size: int) -> int:
    # as `mma_smem_bytes` (bf16), `dedup_smem_bytes` (f32) and
    # `dedup_int8_smem_bytes` (int8) in the CUDA source: two data stages
    # (the block's staged rows and slots), three of its indices; in f32 and
    # int8 its run weights, in bf16 the warps' [16, 64] W tiles
    eb, ub, sl = blocked.eb, blocked.ub, _dedup_slice(elem_size)
    if elem_size == 2:
        return 2 * (ub * (sl + 8) * 2 + eb * 8) + 3 * (260 + ub + eb) * 4 + 256 * 72 * 2
    if elem_size == 1:  # W in f64, and the block's rows widened to f64
        data = -(-(ub * sl + eb * 8) // 16) * 16
        return 2 * data + 3 * (260 + ub + eb) * 4 + eb * 8 + ub * sl * 8
    return 2 * (ub * sl * 4 + eb * 8) + 3 * (260 + ub + eb) * 4 + eb * 4


def dedup_target(blocked: BlockedCOO, d: int, elem_size: int, n_sms: int) -> int:
    """Parts a dedup kernel cuts the blocks into: as many CTAs (parts x
    feature slices) as `n_sms` SMs hold at once (`elem_size` 1: the int8
    kernel, whose f64 sums fill an SM's registers with one CTA)."""
    per_sm = 1 if elem_size == 1 else max(1, min(_SM_SMEM // _dedup_smem(blocked, elem_size),
                                                 2048 // (DEDUP_WARPS * 32)))
    return max(1, n_sms * per_sm // -(-d // _dedup_slice(elem_size)))


def dedup_block_cost(block_meta: np.ndarray) -> np.ndarray:
    """A block's cost to the dedup kernel, in units of one 16-column mma
    step of the bf16 kernel: the staging and the barrier (about four steps,
    measured on the H100) and one step per 16 distinct columns."""
    return 4 + -(-block_meta[:, -1] // 16)


def dedup_int8_block_cost(block_meta: np.ndarray) -> np.ndarray:
    """A block's cost to the int8 dedup kernel, in units of 128 live slots:
    two for the staging and its barriers, and one per 128 live slots. Its
    warps walk every live slot on the CUDA cores (f64 multiply-adds), so
    its slots set its time, where the bf16 kernel's is set by its
    16-column mma steps (`dedup_block_cost`); the distinct rows it stages
    are 64 B each. The weights are a model, not a fit to the card."""
    return 2 + -(-block_meta[:, DEDUP_WARPS * DEDUP_ROWS_PER_WARP] // 128)


def _parts(blocked: BlockedCOO, target: int, device: torch.device):
    """The dedup kernel's parts, cut on the host at a layout's first call
    (a copy to the host: a CUDA graph capture that comes first raises, so
    the trainer's eager first step fills this cache)."""
    key = ("parts", target, device, blocked.int8)
    hit = blocked.cache.get(key)
    if hit is None:
        cost_of = dedup_int8_block_cost if blocked.int8 else dedup_block_cost
        cost = cost_of(blocked.block_meta.cpu().numpy())  # once a layout
        hit = blocked.cache[key] = tuple(
            _i32(a, device) for a in dedup_parts(blocked.window_blocks, target, cost))
    return hit


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = _SM_COUNT[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _width_multiple(blocked: BlockedCOO) -> int:
    """The widths the layout's kernel takes are multiples of this: 8 (16 B
    of f32 or bf16 a lane), 32 for the int8 kernels."""
    return 32 if blocked.int8 else 8


def _launch(blocked: BlockedCOO, x: torch.Tensor, target: int | None = None) -> torch.Tensor:
    """A @ X on the card: the layout's CUDA kernel on the current stream.
    `target` overrides `dedup_target` for the dedup kernel. A width the
    kernel does not take (AutoCF's [n, 1] operands) is padded with zero
    columns up to the next multiple it takes, and the product sliced back:
    the kernel still runs (`PADDED` counts these calls)."""
    m = _width_multiple(blocked)
    if x.dim() == 2 and x.shape[1] % m:
        d = x.shape[1]
        PADDED["calls"] += 1
        wide = torch.nn.functional.pad(x, (0, m - d % m))
        return _launch(blocked, wide, target)[:, :d].contiguous()
    _check_call(blocked, x)
    ptrs = _structure(blocked, x.device)
    lib = _library()
    n, d, dev = blocked.nrows, x.shape[1], x.device
    if blocked.n_live == 0:  # no edges: nothing to launch
        return torch.zeros(n, d, dtype=torch.float32, device=dev)
    scale = None
    if blocked.int8:
        table, scale = quantize_int8_fused(x)
    elif blocked.bf16:
        table = x.to(torch.bfloat16)  # cast the table once
    else:
        table = x
    # every kernel writes every row of `out`
    out = torch.empty(n, d, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    vals, tab = blocked.vals.data_ptr(), table.data_ptr()
    tiles = (blocked.eb, blocked.rb, blocked.ub, d, stream)
    if not blocked.dedup:
        n_ctas = blocked.warp_rows.shape[0]
        # a team of 2^lanes_log2 lanes covers a row, 16 B a lane
        per_lane = 16 // table.element_size()
        lanes_log2 = min(5, (-(-d // per_lane) - 1).bit_length())
        if scale is not None:
            name, fn = "segment_spmm_rows_int8", lib.hd_segment_spmm_rows_int8
            args = (*ptrs, vals, tab, scale.data_ptr(), out.data_ptr(), n_ctas, d, lanes_log2,
                    ROW_SLOTS, stream)
        else:
            name, fn = "segment_spmm_rows", lib.hd_segment_spmm_rows
            args = (*ptrs, vals, tab, int(blocked.bf16), out.data_ptr(), n_ctas, d, lanes_log2,
                    ROW_SLOTS, stream)
    else:
        elem = table.element_size()  # 1 for the int8 kernel
        _check_smem(_dedup_smem(blocked, elem))
        if elem == 2 and (blocked.ub > 256 or blocked.ub % 4 or blocked.eb % 4):
            raise ValueError(f"blocked_spmm: the bf16 dedup kernel takes unique_block <= 256 "
                             f"and edge and unique blocks of multiples of 4, got eb={blocked.eb} "
                             f"ub={blocked.ub}")
        pw, pb, wp = _parts(blocked, target or dedup_target(blocked, d, elem, _sm_count(dev)), dev)
        n_parts = pw.shape[0]
        # [n_parts, rb, d]: the tiles of the windows cut into several parts, f64 for int8
        scratch = (torch.empty(n_parts, blocked.rb, d, device=dev,
                               dtype=torch.float32 if scale is None else torch.float64)
                   if n_parts > blocked.n_windows else out)
        head = (pw.data_ptr(), pb.data_ptr(), wp.data_ptr(), *ptrs, vals, tab)
        tail = (out.data_ptr(), scratch.data_ptr(), n_parts, blocked.n_windows, n, *tiles)
        if scale is not None:
            name, fn = "segment_spmm_dedup_int8", lib.hd_segment_spmm_dedup_int8
            args = (*head, scale.data_ptr(), *tail)
        else:
            name, fn = "segment_spmm_dedup", lib.hd_segment_spmm_dedup
            args = (*head, int(blocked.bf16), *tail)
    _run(name, dev, fn, args)
    return out


def _run(name: str, dev: torch.device, fn, args) -> None:
    """Call a kernel's entry point on `dev` and count its launch; raise on
    the CUDA error it returns."""
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def quantize_int8_fused(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_int8` of a [m, d] float32 X (d % 4 == 0): the plain version
    on the CPU; on the card the CUDA kernel of two launches (column maxima
    of row chunks, then the quantisation), bit for bit with the plain one.
    Returns (q [m, d] int8, s [d] float32)."""
    if x.device.type == "cpu":
        return quantize_int8(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8_fused: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous() or x.shape[1] % 4:
        raise ValueError(f"quantize_int8_fused: X must be a contiguous 2-D float32 tensor with "
                         f"d % 4 == 0, got {tuple(x.shape)} {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    m, d = x.shape
    dev = x.device
    n_chunks = max(1, min(64, -(-m // 32)))  # row chunks of the column maxima
    n_q = max(1, min(2 * _sm_count(dev), -(-m // 16)))  # CTAs of the quantisation
    q = torch.empty(m, d, dtype=torch.int8, device=dev)
    scale = torch.empty(d, dtype=torch.float32, device=dev)
    partial = torch.empty(n_chunks, d, dtype=torch.float32, device=dev)
    _run("quantize_int8", dev, _library().hd_quantize_int8,
         (x.data_ptr(), q.data_ptr(), scale.data_ptr(), partial.data_ptr(), m, d, n_chunks, n_q,
          torch.cuda.current_stream(dev).cuda_stream))
    return q, scale


def _check_smem(smem: int) -> None:
    if smem > _MAX_SMEM:
        raise ValueError(f"blocked_spmm: {smem} B of shared memory exceed the {_MAX_SMEM} B a "
                         f"Hopper CTA may use")


def _forward(blocked: BlockedCOO, x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return blocked_spmm_reference(blocked, x)
    if x.device.type != "cuda":
        raise ValueError(f"blocked_spmm: unsupported device {x.device}")
    return _launch(blocked, x)


def _packed_vals(blocked: BlockedCOO, vals: torch.Tensor) -> torch.Tensor:
    """The source COO's current `vals` routed into the packed slots."""
    live = blocked.local_rows.reshape(-1) < blocked.rb
    return torch.where(live, vals[blocked.src.reshape(-1).long()], 0.0)


def _sum_into(n: int, ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[k] = sum of values[ids == k] over n rows, in one fixed order, so
    that a backward repeats bit for bit and its CUDA graph's replay equals
    it: on the card `index_put_` accumulates over a stable sort of the ids
    (`index_add_`'s atomics add in an order that changes from run to run),
    on the CPU `index_add_` adds in id order (`ops.sparse.scatter_sum`)."""
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    if out.is_cuda:
        return out.index_put_((ids,), values, accumulate=True)
    return out.index_add_(0, ids, values)


class _BlockedSpmm(torch.autograd.Function):
    """A @ X with the JAX `blocked_spmm` custom VJP (segment_spmm.py:680-706)."""

    @staticmethod
    def forward(ctx, x, vals, blocked):
        ctx.blocked = blocked
        ctx.save_for_backward(x, vals)
        if vals is not None:
            blocked = blocked.replace(vals=_packed_vals(blocked, vals).reshape(blocked.vals.shape))
        return _forward(blocked, x)

    @staticmethod
    def backward(ctx, g):
        b = ctx.blocked
        x, vals = ctx.saved_tensors
        v = b.vals.reshape(-1) if vals is None else _packed_vals(b, vals)
        lr = b.local_rows.reshape(-1).long()
        live = lr < b.rb
        rows = torch.where(live, b.wmap.long().repeat_interleave(b.eb) * b.rb + lr, 0)
        rows = rows.clamp(max=b.nrows - 1)
        cols = b.cols.reshape(-1).long()
        g_rows = g[rows] * live[:, None].to(g.dtype)
        # the pad slots add zeros: spread them over the rows, or the fixed-order
        # sum adds all of them one after another into one row (a LastFM-shape
        # layout has some 16,000 pads, and HCCF's step then took 25 ms)
        slot = torch.arange(live.numel(), device=live.device)
        dx = dvals = None
        if ctx.needs_input_grad[0]:
            # dx[c] = sum_e vals[e] * g[row_e]
            dx = _sum_into(x.shape[0], torch.where(live, cols, slot % x.shape[0]),
                           g_rows * v[:, None].to(g.dtype)).to(x.dtype)
        if vals is not None and ctx.needs_input_grad[1]:
            dv = (g_rows * x[cols]).sum(dim=-1) * live.to(g.dtype)
            src = torch.where(live, b.src.reshape(-1).long(), slot % vals.shape[0])
            dvals = _sum_into(vals.shape[0], src, dv).to(vals.dtype)
        return dx, dvals, None


def blocked_spmm(blocked: BlockedCOO, x: torch.Tensor,
                 vals: torch.Tensor | None = None) -> torch.Tensor:
    """A @ X: [nrows, ncols] x [ncols, d] -> [nrows, d] float32.

    A CPU tensor takes `blocked_spmm_reference`. A CUDA tensor launches
    the layout's kernel (`segment_spmm_rows`, `segment_spmm_dedup`, or
    their `_int8` forms) on the current stream; any other device raises.
    `vals`, the source COO's current values (after edge dropout, say), is
    routed into the slots through `src` instead of the packed snapshot.
    Differentiable in X and `vals` (the JAX VJP, plain torch ops).
    """
    if torch.is_grad_enabled() and (x.requires_grad or (vals is not None and vals.requires_grad)):
        return _BlockedSpmm.apply(x, vals, blocked)
    if vals is not None:
        blocked = blocked.replace(vals=_packed_vals(blocked, vals).reshape(blocked.vals.shape))
    return _forward(blocked, x)
