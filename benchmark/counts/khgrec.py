"""The work of a KHGRec step and encode, from the configuration's shapes.

Sparse products per layer: the CF conv A (A^T X) over the (U + I)^2
adjacency, and the KG conv A_att K (K^T (A_att^T Y)) over the E x E KG
adjacency and the attention adjacency of `batch_size_kg` entries. A
training step runs each product forward and its A^T g backward.
`products` lists those that run through the public `spmm_pair` (the
`spmm.roofline.*` metrics time them there), as (adjacency, direction,
rows, columns, entries, times); `other_sparse_flops` the attention
adjacency's gather-scatter sums. Dense FLOPs are counted on the reference
(`FlopCounterMode`).
"""

from __future__ import annotations

# where the program's bundle holds each adjacency that `products` names
ADJACENCIES = {"cf": ("cf", "adj"), "kg": ("kg", "kg_adj")}


def width(s: dict) -> int:
    return s["hyper_dim"]


def products(s: dict) -> list:
    """The `spmm_pair` products of one forward (a step's or an encode's)."""
    n, e, layers = s["n_users"] + s["n_items"], s["n_entities"], s["n_layers"]
    return [("cf", "bwd", n, n, s["cf_nnz"], layers), ("cf", "fwd", n, n, s["cf_nnz"], layers),
            ("kg", "bwd", e, e, s["kg_nnz"], layers), ("kg", "fwd", e, e, s["kg_nnz"], layers)]


def other_sparse_flops(s: dict, backward: bool) -> int:
    """A_att^T and A_att on every layer, 2 entries' FLOPs per width each."""
    f = s["n_layers"] * 2 * 2 * s["batch_size_kg"] * s["hyper_dim"]
    return 2 * f if backward else f
