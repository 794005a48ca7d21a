"""The masked top-k select of the evaluation's ranking.

`topk_select(scores, rated, k)` returns the k largest scores of each row of
a [B, I] f32 score matrix and their item ids, in descending order with ties
to the lower index (`lax.top_k`'s order), after each row's rated items
(`rated` [B, max_deg] item ids, pad -1; None for no mask) were given the
value `ops.topk.NEG_INF`. A masked item stays a candidate with that value,
so a row with fewer than k unmasked items returns masked ids as well.
Values are f32, ids int64, each [B, min(k, I)].

The plain version, `topk_select_reference`, is `ops.topk.mask_rated`
followed by a stable descending sort of the whole row and its first k
columns. On the card the wrapper launches a CUDA kernel written for Hopper
(`csrc/topk_select.cu`) that reads each score once, masks as it reads and
keeps the row's top k in shared memory, with the same values and ids bit
for bit, for every k (in rounds of KMAX columns past KMAX); it replaces no
TPU kernel (the JAX package ranks with `lax.top_k`, an XLA op). A NaN goes
where the card's sort (cub's radix sort) puts it: above +inf without the
sign bit, below -inf with it; the CPU's sort puts every NaN first. -0.0
ties +0.0 on both.

The wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

KMAX = 256  # the most keys a round of the kernel keeps (`kMaxK` in the CUDA source)

# launches of the kernel, counted by `topk_select`
LAUNCHES = {"topk_select": 0}

_lib = None


def _library() -> ctypes.CDLL:
    """Build (first use) and bind `csrc/topk_select.cu`."""
    global _lib
    if _lib is None:
        from .build import load_library

        lib = load_library("topk_select")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.hd_topk_select.argtypes = [p, i64, i, i, p, i, i, p, p, p]
        lib.hd_topk_select.restype = i
        _lib = lib
    return _lib


def topk_select_reference(
    scores: torch.Tensor, rated: torch.Tensor | None, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: mask, sort each row stably in descending order, keep
    the first k columns."""
    from ..topk import mask_rated

    if rated is not None:
        scores = mask_rated(scores, rated)
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def topk_select(
    scores: torch.Tensor, rated: torch.Tensor | None, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of `scores` after the `rated` mask: the plain
    version on the CPU, the CUDA kernel on the card."""
    if scores.device.type == "cpu":
        return topk_select_reference(scores, rated, k)
    if scores.device.type != "cuda":
        raise ValueError(f"topk_select: unsupported device {scores.device}")
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"topk_select: scores must be a 2-D float32 tensor, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if k < 1:
        raise ValueError(f"topk_select: k must be at least 1, got {k}")
    b, n_items = scores.shape
    if n_items > 2**31 - 2**17 or b >= 2**31:  # the kernel's ids and windows are 32-bit ints
        raise ValueError(f"topk_select: {b} x {n_items} scores exceed the kernel's 32-bit ids")
    if scores.stride(1) != 1:
        scores = scores.contiguous()
    k_out = min(k, n_items)
    vals = torch.empty(b, k_out, dtype=torch.float32, device=scores.device)
    ids = torch.empty(b, k_out, dtype=torch.int64, device=scores.device)
    if b == 0 or k_out == 0:
        return vals, ids
    n_rated = 0
    if rated is not None:
        if rated.dim() != 2 or rated.shape[0] != b or rated.device != scores.device:
            raise ValueError(f"topk_select: rated must be [{b}, max_deg] on the scores' device, "
                             f"got {tuple(rated.shape)} on {rated.device}")
        if rated.dtype != torch.int32:
            # ids outside [0, I) are ignored; they must not wrap into it
            rated = torch.where((rated >= 0) & (rated < n_items), rated, -1).to(torch.int32)
        rated = rated.contiguous()
        n_rated = rated.shape[1]
    with torch.cuda.device(scores.device):
        rc = _library().hd_topk_select(
            scores.data_ptr(), scores.stride(0), b, n_items,
            rated.data_ptr() if n_rated else None, n_rated, k_out, vals.data_ptr(),
            ids.data_ptr(), torch.cuda.current_stream(scores.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"topk_select: CUDA error {rc} at launch")
    LAUNCHES["topk_select"] += 1
    return vals, ids
