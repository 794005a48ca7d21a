"""The yardstick's arithmetic: the work a sparse product needs, its bound
on a card, and the card's peaks.

A product A @ X of an [R, C] matrix with nnz entries and width d costs
2 nnz d FLOPs. Its bytes: X read once at the operand's width (C d b),
the indices and values once (8 nnz), the float32 output written once
(4 R d). Its bound is the larger of the bytes over the card's HBM
bandwidth and the FLOPs over its float32 peak. These count the problem,
not a layout: a kernel that reads a row of X twice, or pads the
matrix, gains nothing by it.
"""

from __future__ import annotations

# Published peaks of one card (NVIDIA's data sheet, SXM part, dense rates
# without sparsity, at the full 700 W), by `torch.cuda.get_device_name()`:
# FLOP/s by precision and HBM bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}

OPERAND_BYTES = {"float32": 4, "tf32": 4, "bfloat16": 2}


def spmm_cost(nrows: int, ncols: int, nnz: int, d: int, operand_bytes: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one sparse product."""
    return 2 * nnz * d, ncols * d * operand_bytes + 8 * nnz + 4 * nrows * d


def bound_s(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: bytes over bandwidth or FLOPs
    over the float32 peak, whichever is longer."""
    return max(nbytes / peaks["hbm_bytes_per_s"], flops / peaks["float32"])


def products_cost(products: list, d: int, operand_bytes: int, backward: bool) -> tuple[int, int]:
    """(FLOPs, bytes) of `products` ((adjacency, direction, R, C, nnz, times)
    each), with each product's backward, A^T g over the same entries, added
    when `backward`."""
    flops = nbytes = 0
    for _, _, r, c, nnz, times in products:
        f, b = spmm_cost(r, c, nnz, d, operand_bytes)
        flops, nbytes = flops + times * f, nbytes + times * b
        if backward:
            f, b = spmm_cost(c, r, nnz, d, operand_bytes)
            flops, nbytes = flops + times * f, nbytes + times * b
    return flops, nbytes


def products_bound_s(products: list, d: int, operand_bytes: int, backward: bool,
                     peaks: dict) -> float:
    """The sum of each product's bound (and its backward's)."""
    total = 0.0
    for _, _, r, c, nnz, times in products:
        total += times * bound_s(*spmm_cost(r, c, nnz, d, operand_bytes), peaks)
        if backward:
            total += times * bound_s(*spmm_cost(c, r, nnz, d, operand_bytes), peaks)
    return total
