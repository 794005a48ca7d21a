"""Graph normalisations (host-side, init-time) — parity with reference
`data/graph.py` and `data/knowledge.py:168-196`; the port's copy of the JAX
package's `data/normalize.py`."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def normalize_graph_mat(adj: sp.spmatrix) -> sp.csr_matrix:
    """Symmetric D^-1/2 A D^-1/2 for square A, row D^-1 A otherwise
    (data/graph.py:10-25)."""
    adj = adj.tocsr()
    rowsum = np.asarray(adj.sum(1)).flatten()
    if adj.shape[0] == adj.shape[1]:
        with np.errstate(divide="ignore"):
            d_inv = np.power(rowsum, -0.5)
        d_inv[np.isinf(d_inv)] = 0.0
        d = sp.diags(d_inv)
        return (d @ adj @ d).tocsr()
    with np.errstate(divide="ignore"):
        d_inv = np.power(rowsum, -1.0)
    d_inv[np.isinf(d_inv)] = 0.0
    return (sp.diags(d_inv) @ adj).tocsr()


def normalize_graph_mat_hyper(incidence: sp.spmatrix) -> sp.csr_matrix:
    """Hypergraph normalisation D_v^-1/2 H D_e^-1 H^T D_v^-1/2
    (data/graph.py:27-42). Input H: [V, E] incidence; output [V, V]."""
    h = incidence.tocsr()
    colsum = np.asarray(h.sum(0)).flatten()
    rowsum = np.asarray(h.sum(1)).flatten()
    with np.errstate(divide="ignore"):
        d_e_inv = np.power(colsum, -1.0)
        d_v_inv = np.power(rowsum, -0.5)
    d_e_inv[np.isinf(d_e_inv)] = 0.0
    d_v_inv[np.isinf(d_v_inv)] = 0.0
    d_e = sp.diags(d_e_inv)
    d_v = sp.diags(d_v_inv)
    return (d_v @ h @ d_e @ h.T @ d_v).tocsr()


def random_walk_norm(adj: sp.spmatrix) -> sp.csr_matrix:
    """D^-1 A (data/knowledge.py:179-187)."""
    adj = adj.tocsr()
    rowsum = np.asarray(adj.sum(1)).flatten()
    with np.errstate(divide="ignore"):
        d_inv = np.power(rowsum, -1.0)
    d_inv[np.isinf(d_inv)] = 0.0
    return (sp.diags(d_inv) @ adj).tocsr()


def symmetric_norm(adj: sp.spmatrix) -> sp.csr_matrix:
    """D^-1/2 A D^-1/2 (data/knowledge.py:169-177)."""
    adj = adj.tocsr()
    rowsum = np.asarray(adj.sum(1)).flatten()
    with np.errstate(divide="ignore"):
        d_inv = np.power(rowsum, -0.5)
    d_inv[np.isinf(d_inv)] = 0.0
    d = sp.diags(d_inv)
    return (d @ adj @ d).tocsr()
