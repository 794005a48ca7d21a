"""The work of a LightGCN step and encode, from the configuration's shapes:
one product A X over the (U + I)^2 adjacency a layer (with its A^T g
backward in a step), as (adjacency, direction, rows, columns, entries,
times). Its dense FLOPs are counted on the reference (`FlopCounterMode`).
"""

from __future__ import annotations

ADJACENCIES = {"cf": ("cf", "adj")}


def width(s: dict) -> int:
    return s["embedding_size"]


def products(s: dict) -> list:
    n = s["n_users"] + s["n_items"]
    return [("cf", "fwd", n, n, s["cf_nnz"], s["n_layers"])]


def other_sparse_flops(s: dict, backward: bool) -> int:
    return 0
