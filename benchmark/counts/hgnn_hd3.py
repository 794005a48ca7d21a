"""The work of an HGNN_HD3 step and encode, from the configuration's shapes.

Sparse products of one forward, each through the public `spmm_pair`: a
conv A (A^T X) over the (U + I)^2 adjacency is one `bwd` and one `fwd`
product; the local view runs two such convs in each ED-HNN layer and one
in its cap, the group view one in its last layer; a power of Theta over
the [U, I] incidence B is one `bwd` and one `fwd` product (B (B^T X) for
the users, B^T (B X) for the items), and each HWNN layer takes K1 - 1 +
K2 - 1 = 4 of them on each side. A training step runs each product
forward and its A^T g backward. Products as (adjacency, direction, rows,
columns, entries, times); dense FLOPs are counted on the reference
(`FlopCounterMode`).
"""

from __future__ import annotations

# where the program's bundle holds each adjacency that `products` names
ADJACENCIES = {"cf": ("cf", "adj"), "b_hyper": ("cf", "b_hyper")}

THETA_POWERS = 4  # (K1 - 1) + (K2 - 1), K1 = K2 = 3


def width(s: dict) -> int:
    return s["hyper_dim"]


def products(s: dict) -> list:
    """The `spmm_pair` products of one forward (a step's or an encode's)."""
    u, i, layers = s["n_users"], s["n_items"], s["n_layers"]
    n = u + i
    convs = 2 * (layers - 1) + 1 + 1  # ED-HNN layers, the local cap, the group cap
    thetas = 2 * THETA_POWERS * (layers - 1)  # both sides of each HWNN layer
    return [("cf", "bwd", n, n, s["cf_nnz"], convs), ("cf", "fwd", n, n, s["cf_nnz"], convs),
            ("b_hyper", "bwd", i, u, s["b_hyper_nnz"], thetas),
            ("b_hyper", "fwd", u, i, s["b_hyper_nnz"], thetas)]


def other_sparse_flops(s: dict, backward: bool) -> int:
    return 0
