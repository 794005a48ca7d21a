"""Similarity measures — the port of the JAX package's
`utils/similarity.py`, parity with reference `util/algorithm.py:6-121`.

The reference ships per-pair Python-loop helpers (cosine/pearson/
euclidean over dense vectors and sparse dicts) that are dead at HEAD
(no model file calls them) but part of the utility surface. The primary
forms are BATCHED tensor functions — an all-pairs similarity is one
matmul, in float32 with TF32 off (`ops.topk.exact_f32`), not O(n^2)
Python — with the reference's per-pair forms kept as exact-semantics
copies of the JAX package's (including their divide-by-zero fallbacks).

Quirks replicated deliberately:
  * `pearson_sp` returns 1 on a zero denominator when the vectors
    overlapped, 0 otherwise (util/algorithm.py:63-82);
  * `euclidean_sp` computes 1 / sum(x1[k]^2 - x2[k]^2) over the key
    overlap — the reference's formula, not a distance
    (util/algorithm.py:37-46);
  * dense `pearson` centres by `sum/len` over the FULL vector, not the
    overlap (util/algorithm.py:97-111).
"""

from __future__ import annotations

from math import sqrt

import numpy as np
import torch

from ..ops.topk import exact_f32

__all__ = [
    "cosine_matrix", "pearson_matrix", "cosine", "pearson", "euclidean",
    "cosine_sp", "pearson_sp", "euclidean_sp", "similarity",
]


# -- batched tensor forms ---------------------------------------------------

def cosine_matrix(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """All-pairs cosine similarity: [n, d] x [m, d] -> [n, m] float32 (one
    matmul; zero-norm rows map to 0, matching the per-pair fallback)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = x if y is None else torch.as_tensor(y, dtype=torch.float32, device=x.device)
    xn = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    yn = torch.linalg.vector_norm(y, dim=1, keepdim=True)
    with exact_f32():
        dots = x @ y.T
    denom = xn * yn.T
    return torch.where(denom > 0, dots / torch.clamp(denom, min=1e-30), 0.0)


def pearson_matrix(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """All-pairs Pearson correlation with the reference's full-vector
    centring (util/algorithm.py:97-111): centre each row by its mean,
    then cosine."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y0 = x if y is None else torch.as_tensor(y, dtype=torch.float32, device=x.device)
    xc = x - x.mean(dim=1, keepdim=True)
    yc = y0 - y0.mean(dim=1, keepdim=True)
    return cosine_matrix(xc, yc)


# -- dense per-pair forms (util/algorithm.py:49-111) ----------------------

def cosine(x1, x2) -> float:
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    denom = sqrt(x1.dot(x1) * x2.dot(x2))
    return float(x1.dot(x2) / denom) if denom else 0.0


def pearson(x1, x2) -> float:
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    n1 = x1 - x1.sum() / len(x1)
    n2 = x2 - x2.sum() / len(x2)
    denom = sqrt(n1.dot(n1) * n2.dot(n2))
    return float(n1.dot(n2) / denom) if denom else 0.0


def euclidean(x1, x2) -> float:
    """1 / ||x1 - x2|| over the co-rated entries (util/algorithm.py:85-94)."""
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    overlap = (x1 != 0) & (x2 != 0)
    diff = x1[overlap] - x2[overlap]
    denom = sqrt(diff.dot(diff))
    return float(1.0 / denom) if denom else 0.0


# -- sparse-dict per-pair forms (util/algorithm.py:22-82) -----------------

def cosine_sp(x1: dict, x2: dict) -> float:
    keys = [k for k in x1 if k in x2]
    if not keys:
        return 0.0
    a = np.array([x1[k] for k in keys], np.float64)
    b = np.array([x2[k] for k in keys], np.float64)
    denom = sqrt(a.dot(a)) * sqrt(b.dot(b))
    return float(a.dot(b) / denom) if denom else 0.0


def pearson_sp(x1: dict, x2: dict) -> float:
    if not x1 or not x2:
        return 0.0
    mean1 = sum(x1.values()) / len(x1)
    mean2 = sum(x2.values()) / len(x2)
    keys = [k for k in x1 if k in x2]
    if not keys:
        return 0.0
    a = np.array([x1[k] for k in keys], np.float64) - mean1
    b = np.array([x2[k] for k in keys], np.float64) - mean2
    denom = sqrt(a.dot(a)) * sqrt(b.dot(b))
    # zero denominator with overlap -> 1 (util/algorithm.py:78-81)
    return float(a.dot(b) / denom) if denom else 1.0


def euclidean_sp(x1: dict, x2: dict) -> float:
    total = sum(x1[k] ** 2 - x2[k] ** 2 for k in x1 if k in x2)
    return float(1.0 / total) if total else 0.0


def similarity(x1: dict, x2: dict, sim: str) -> float:
    """Dispatcher (util/algorithm.py:114-120): 'pcc' -> pearson_sp,
    'euclidean' -> euclidean_sp, anything else -> cosine_sp."""
    if sim == "pcc":
        return pearson_sp(x1, x2)
    if sim == "euclidean":
        return euclidean_sp(x1, x2)
    return cosine_sp(x1, x2)
