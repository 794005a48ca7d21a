"""The gather-fusion probe kernels: a resident-table row gather and a
window SpMM with the gather fused in.

The port's counterpart of the two Pallas kernels of the JAX package's
microbenchmark `scripts/bench_gather_fusion.py` (`gather_kernel`, :86, and
`fused_kernel`, :125), CUDA kernels written for Hopper in
`csrc/gather_fusion.cu`:

  * `resident_row_gather(x, idx)`: out[...] = X[idx[...]], rows in X's
    dtype (f32 or bf16); an index outside [0, n) is clamped into it, so
    the kernel reads no memory outside X;
  * `fused_window_spmm(blocked, x)`: A @ X over the row-window layout of
    `pack_blocked` (`wmap`, `cols`, `local_rows`, `vals`), one CTA per
    window summing into a shared-memory tile. In bf16 mode
    (`BlockedCOO.bf16`) it rounds as the Pallas kernel does: the table
    and each edge value to bf16, their product to bf16, the sums in f32.

Each has a plain PyTorch version beside it (`*_reference`). A wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor it
launches its kernel or raises. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from .segment_spmm import _MAX_SMEM, BlockedCOO

# launches of each CUDA kernel, counted by its wrapper where it launches
LAUNCHES = {"resident_row_gather": 0, "fused_window_spmm": 0}

_lib = None


def _library() -> ctypes.CDLL:
    """Build (first use) and bind `csrc/gather_fusion.cu`."""
    global _lib
    if _lib is None:
        from .build import load_library

        lib = load_library("gather_fusion")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.hd_resident_row_gather.argtypes = [p, p, p, i64, i, i, p]
        lib.hd_resident_row_gather.restype = i
        lib.hd_fused_window_spmm.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, p]
        lib.hd_fused_window_spmm.restype = i
        _lib = lib
    return _lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def resident_row_gather_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: x[clamp(idx, 0, n - 1)], shape idx.shape + (d,)."""
    return x[idx.long().clamp(0, x.shape[0] - 1)]


def resident_row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X[idx] for a [n, d] table X (f32 or bf16) and int32 indices of any
    shape: the plain version on the CPU, the CUDA kernel on the card."""
    if x.device.type == "cpu":
        return resident_row_gather_reference(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"resident_row_gather: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"resident_row_gather: X must be a contiguous 2-D f32 or bf16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    row_bytes = x.shape[1] * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"resident_row_gather: a row of {row_bytes} B is not a multiple of 16 B")
    if idx.dtype != torch.int32 or idx.device != x.device or not idx.is_contiguous():
        raise ValueError("resident_row_gather: indices must be contiguous int32 on X's device")
    if x.shape[0] == 0:
        raise ValueError("resident_row_gather: an empty table has no row to gather")
    out = torch.empty(tuple(idx.shape) + (x.shape[1],), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().hd_resident_row_gather(idx.data_ptr(), x.data_ptr(), out.data_ptr(),
                                               idx.numel(), x.shape[0], row_bytes, _stream(x))
    if rc != 0:
        raise RuntimeError(f"resident_row_gather: CUDA error {rc} at launch")
    LAUNCHES["resident_row_gather"] += 1
    return out


def fused_window_spmm_reference(blocked: BlockedCOO, x: torch.Tensor) -> torch.Tensor:
    """Plain version: the live slots' val * X[col] summed into their rows,
    rounding as the kernel rounds in bf16 mode. Runs on any device."""
    eb, rb = blocked.eb, blocked.rb
    lrows = blocked.local_rows.reshape(-1).long()
    slots = torch.nonzero(lrows < rb).squeeze(1)
    grow = blocked.wmap.long()[slots // eb] * rb + lrows[slots]
    cols = blocked.cols.reshape(-1)[slots].long()
    vals = blocked.vals.reshape(-1)[slots]
    if blocked.bf16:
        prod = (x.to(torch.bfloat16)[cols] * vals.to(torch.bfloat16)[:, None]).float()
    else:
        prod = x.float()[cols] * vals[:, None]
    out = torch.zeros(blocked.n_windows * rb, x.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add_(0, grow, prod)[: blocked.nrows]


def fused_window_spmm(blocked: BlockedCOO, x: torch.Tensor) -> torch.Tensor:
    """A @ X [nrows, d] f32 over a `pack_blocked` layout: the plain version
    on the CPU, the CUDA kernel (a CTA per row window) on the card."""
    if x.device.type == "cpu":
        return fused_window_spmm_reference(blocked, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_window_spmm: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"fused_window_spmm: X must be a contiguous 2-D float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    if blocked.dedup or blocked.int8:
        raise ValueError("fused_window_spmm: takes the base layout of pack_blocked, f32 or bf16")
    d = x.shape[1]
    if x.shape[0] != blocked.ncols:
        raise ValueError(f"fused_window_spmm: X has {x.shape[0]} rows, A has {blocked.ncols} "
                         f"columns")
    if d % 32 or d > 256:
        raise ValueError(f"fused_window_spmm: the kernel needs d % 32 == 0 and d <= 256, got {d}")
    smem = blocked.rb * d * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_window_spmm: a {blocked.rb} x {d} f32 tile needs {smem} B of "
                         f"shared memory, above the {_MAX_SMEM} B a Hopper CTA may use")
    for a in (blocked.wmap, blocked.cols, blocked.local_rows, blocked.vals):
        if a.device != x.device or not a.is_contiguous():
            raise ValueError("fused_window_spmm: layout tensors must be contiguous and on X's "
                             "device")
        if a.dtype != (torch.float32 if a is blocked.vals else torch.int32):
            raise ValueError(f"fused_window_spmm: layout tensor of dtype {a.dtype}; the kernel "
                             f"takes int32 indices and float32 values")
    table = x.to(torch.bfloat16) if blocked.bf16 else x  # cast the table once
    out = torch.empty(blocked.n_windows * blocked.rb, d, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().hd_fused_window_spmm(
            blocked.wmap.data_ptr(), blocked.cols.data_ptr(), blocked.local_rows.data_ptr(),
            blocked.vals.data_ptr(), table.data_ptr(), int(blocked.bf16), out.data_ptr(),
            blocked.n_blocks, blocked.n_windows, blocked.eb, blocked.rb, d, _stream(x))
    if rc != 0:
        raise RuntimeError(f"fused_window_spmm: CUDA error {rc} at launch")
    LAUNCHES["fused_window_spmm"] += 1
    return out[: blocked.nrows]
