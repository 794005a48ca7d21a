"""Device-resident sparse format over torch tensors.

The port's counterpart of the JAX package's `core/types.py`: ONE
canonical device format, row-sorted padded COO (`SparseCOO`). Pad
entries carry `row == nrows`, `col == 0` and `val == 0`. torch's
`index_add_` raises on an out-of-range index where JAX drops it, so every
segment reduction in the port sums into `nrows + 1` rows and slices the
pad row off (`ops/sparse.py`).

Row/col indices are int32 (as in the JAX package), values float32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..native import sort_pairs
from .device import resolve_device


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class SparseCOO:
    """Row-sorted padded COO sparse matrix.

    rows/cols/vals have identical padded length. Pad entries: row == nrows,
    col == 0, val == 0.
    """

    rows: torch.Tensor  # [nnz_pad] int32, non-decreasing
    cols: torch.Tensor  # [nnz_pad] int32
    vals: torch.Tensor  # [nnz_pad] float32
    nrows: int
    ncols: int
    nnz: int  # true (unpadded) count
    # optional packed layout for the CUDA segment-SpMM kernels
    # (ops/kernels/segment_spmm.py). INVARIANT: blocked.vals mirrors
    # `vals` through blocked.src; replace values ONLY through
    # `with_new_vals`, never `dataclasses.replace(vals=...)`.
    blocked: object = None

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def nnz_pad(self) -> int:
        return int(self.rows.shape[0])

    def replace(self, **kw) -> "SparseCOO":
        return dataclasses.replace(self, **kw)


def with_new_vals(sp: SparseCOO, vals: torch.Tensor) -> SparseCOO:
    """Replace edge values, keeping the packed kernel layout in sync
    (one gather per mutation, not one per SpMM call)."""
    if sp.blocked is None:
        return sp.replace(vals=vals)
    b = sp.blocked
    live = b.local_rows.reshape(-1) < b.rb
    packed = torch.where(live, vals[b.src.reshape(-1).long()], 0.0).reshape(b.vals.shape)
    return sp.replace(vals=vals, blocked=b.replace(vals=packed))


def from_edges(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray | None,
    shape: tuple[int, int],
    device: torch.device | str | None = None,
    pad_multiple: int = 8,
    dtype=np.float32,
) -> SparseCOO:
    """Build padded SparseCOO straight from (row, col[, val]) edge arrays."""
    device = resolve_device(device)
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    if vals is None:
        vals = np.ones(rows.shape[0], dtype)
    vals = np.asarray(vals, dtype)
    order = sort_pairs(rows, cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    nnz = rows.shape[0]
    nnz_pad = max(pad_to_multiple(nnz, pad_multiple), pad_multiple)
    pad = nnz_pad - nnz
    if pad:
        rows = np.concatenate([rows, np.full(pad, shape[0], np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, dtype)])
    return SparseCOO(
        rows=torch.as_tensor(rows, device=device),
        cols=torch.as_tensor(cols, device=device),
        vals=torch.as_tensor(vals, device=device),
        nrows=int(shape[0]),
        ncols=int(shape[1]),
        nnz=int(nnz),
    )


def from_scipy(mat, device: torch.device | str | None = None, pad_multiple: int = 8,
               dtype=np.float32) -> SparseCOO:
    """Convert a scipy sparse matrix to row-sorted padded SparseCOO on
    `device` (the GPU unless the caller asks for the CPU)."""
    coo = mat.tocoo()
    return from_edges(coo.row, coo.col, coo.data, mat.shape, device, pad_multiple, dtype)


def to_scipy(sp: SparseCOO):
    """Back to a scipy COO matrix on the host, the pads dropped."""
    import scipy.sparse as sps

    rows, cols, vals = (t[: sp.nnz].cpu().numpy() for t in (sp.rows, sp.cols, sp.vals))
    return sps.coo_matrix((vals, (rows, cols)), shape=sp.shape)


def transpose_coo(sp: SparseCOO, pad_multiple: int = 8) -> SparseCOO:
    """Host-side transpose (re-sorted by the new row), on sp's device.
    Init-time only."""
    rows, cols, vals = (t[: sp.nnz].cpu().numpy() for t in (sp.rows, sp.cols, sp.vals))
    return from_edges(cols, rows, vals, (sp.ncols, sp.nrows), sp.rows.device, pad_multiple)


def padded_rows_from_lists(
    lists: list[np.ndarray] | list[list[int]],
    fill: int,
    width: int | None = None,
    pad_multiple: int = 8,
    max_width: int | None = None,
) -> np.ndarray:
    """Pack ragged per-row index lists into a dense [n, width] int32 array
    (per-user rated-item masks and test-set membership)."""
    n = len(lists)
    if width is None:
        width = max((len(l) for l in lists), default=1)
        width = max(pad_to_multiple(max(width, 1), pad_multiple), pad_multiple)
        if max_width is not None:
            width = min(width, max_width)
    out = np.full((n, width), fill, np.int32)
    for i, l in enumerate(lists):
        l = np.asarray(l, np.int32)[:width]
        out[i, : len(l)] = l
    return out
