"""The evaluation's ranking in one kernel: score and select together.

`score_topk(user_emb, users, item_emb, rated_pad, k)` returns, for each
user listed in `users`, the k largest of its f32 scores against every item
(`user_emb[u] @ item_emb.T`) after its rated items (`rated_pad[u]`, pad -1;
None for no mask) were given the value `ops.topk.NEG_INF`: values f32 and
ids int64, each [len(users), min(k, I)], in descending order with ties to
the lower index. It is what `topk_select(exact_scores(user_emb[users],
item_emb), rated_pad[users], k)` returns for the same score bits: a masked
item stays a candidate at NEG_INF, rated ids outside [0, I) are ignored,
-0.0 ties +0.0, and a NaN is placed by its sign bit on the card.

The plain version, `score_topk_reference`, is that code in blocks of users.
On the card the wrapper launches a CUDA kernel written for Hopper
(`csrc/score_topk.cu`) that gathers the user rows and the rated rows
itself, computes each user's scores tile by tile in f32 FMAs (TF32 off:
the sum over the width in a fixed order, the only difference from
cuBLAS's product) and keeps only the candidates: no [B, I] tensor is
written. It replaces no TPU kernel (the JAX package scores with an XLA
matmul and ranks with `lax.top_k`).

The wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. `covers` says whether the kernel
takes a ranking of these tables and this k.
"""

from __future__ import annotations

import ctypes

import torch

from .topk_select import KMAX, topk_select_reference

MAX_WIDTH = 256  # the widest rows the kernel takes (`kMaxD` in the CUDA source)

# launches of the ranking (the kernel, and the merge of split user tiles), counted once a call
LAUNCHES = {"score_topk": 0}

_lib = None


def _library() -> ctypes.CDLL:
    """Build (first use) and bind `csrc/score_topk.cu`."""
    global _lib
    if _lib is None:
        from .build import load_library

        lib = load_library("score_topk")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.hd_score_topk_workspace.argtypes = [i, i, i, i, ctypes.POINTER(i64)]
        lib.hd_score_topk_workspace.restype = i
        lib.hd_score_topk.argtypes = [p, i64, p, i, i, p, i64, i, i, p, i64, i, i, p, p, p, i64,
                                      p]
        lib.hd_score_topk.restype = i
        _lib = lib
    return _lib


def covers(user_emb: torch.Tensor, item_emb: torch.Tensor, rated: torch.Tensor | None,
           k: int) -> bool:
    """Whether the kernel ranks these tables: f32 tables on one card, a
    width of 1 to MAX_WIDTH and 1 <= k <= KMAX."""
    dev = user_emb.device
    return (dev.type == "cuda" and item_emb.device == dev
            and (rated is None or rated.device == dev)
            and user_emb.dtype == item_emb.dtype == torch.float32
            and user_emb.dim() == item_emb.dim() == 2
            and user_emb.shape[1] == item_emb.shape[1]
            and 1 <= item_emb.shape[1] <= MAX_WIDTH and 1 <= k <= KMAX)


def score_topk_reference(
    user_emb: torch.Tensor, users: torch.Tensor, item_emb: torch.Tensor,
    rated: torch.Tensor | None, k: int, block: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: `exact_scores` of a block of users, then
    `topk_select_reference`, block by block."""
    from ..topk import exact_scores

    users = users.long()
    vals, ids = [], []
    for s in range(0, max(users.shape[0], 1), block):
        u = users[s:s + block]
        scores = exact_scores(user_emb.index_select(0, u), item_emb)
        v, i = topk_select_reference(
            scores, None if rated is None else rated.index_select(0, u), k)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def score_topk(
    user_emb: torch.Tensor, users: torch.Tensor, item_emb: torch.Tensor,
    rated: torch.Tensor | None, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each listed user's masked scores: the plain version on the
    CPU, the CUDA kernel on the card."""
    if user_emb.device.type == "cpu":
        return score_topk_reference(user_emb, users, item_emb, rated, k)
    if user_emb.device.type != "cuda":
        raise ValueError(f"score_topk: unsupported device {user_emb.device}")
    if not covers(user_emb, item_emb, rated, k):
        raise ValueError(
            f"score_topk: needs f32 [*, d] user and item tables on one card with 1 <= d <= "
            f"{MAX_WIDTH} and 1 <= k <= {KMAX}, got {tuple(user_emb.shape)} {user_emb.dtype}, "
            f"{tuple(item_emb.shape)} {item_emb.dtype} on {item_emb.device}, k {k}")
    dev = user_emb.device
    if users.dim() != 1 or users.device != dev or users.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"score_topk: users must be a 1-D int32 or int64 tensor on {dev}, got "
                         f"{tuple(users.shape)} {users.dtype} on {users.device}")
    n, (n_items, d) = users.shape[0], item_emb.shape
    if n >= 2**31 or n_items > 2**27:
        raise ValueError(f"score_topk: {n} users x {n_items} items exceed the kernel's ids "
                         f"(at most 2**27 items)")
    if user_emb.stride(1) != 1:
        user_emb = user_emb.contiguous()
    if item_emb.stride(1) != 1:
        item_emb = item_emb.contiguous()
    users = users.contiguous()
    k_out = min(k, n_items)
    vals = torch.empty(n, k_out, dtype=torch.float32, device=dev)
    ids = torch.empty(n, k_out, dtype=torch.int64, device=dev)
    if n == 0:
        return vals, ids
    n_rated, ld_r = 0, 0
    if rated is not None:
        if rated.dim() != 2:
            raise ValueError(f"score_topk: rated must be [*, max_deg], got {tuple(rated.shape)}")
        if rated.dtype != torch.int32:
            # ids outside [0, I) are ignored; they must not wrap into it
            rated = torch.where((rated >= 0) & (rated < n_items), rated, -1).to(torch.int32)
        if rated.stride(1) != 1:
            rated = rated.contiguous()
        n_rated, ld_r = rated.shape[1], rated.stride(0)
    lib = _library()
    with torch.cuda.device(dev):
        need = ctypes.c_int64(0)
        rc = lib.hd_score_topk_workspace(n, n_items, d, k_out, ctypes.byref(need))
        if rc != 0:
            raise RuntimeError(f"score_topk: CUDA error {rc} planning the launch")
        work = torch.empty(max(need.value, 8), dtype=torch.uint8, device=dev)
        rc = lib.hd_score_topk(
            user_emb.data_ptr(), user_emb.stride(0), users.data_ptr(),
            int(users.dtype == torch.int64), n, item_emb.data_ptr(), item_emb.stride(0),
            n_items, d, rated.data_ptr() if n_rated else None, ld_r, n_rated, k_out,
            vals.data_ptr(), ids.data_ptr(), work.data_ptr(), need.value,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"score_topk: CUDA error {rc} at launch")
    LAUNCHES["score_topk"] += 1
    return vals, ids
