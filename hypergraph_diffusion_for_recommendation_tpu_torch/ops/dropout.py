"""Stateless, shape-preserving edge dropout — the port of the JAX
package's `ops/dropout.py` (`hash_keep_mask`).

Dropped edges keep their slot with value 0 and survivors are rescaled by
1/keep (inverted dropout on the nnz axis), so every shape stays static.
The keep-mask is a counter hash of (key, edge id): each layout of one
edge (forward, transpose, packed kernel blocks) draws the same bit from
its own constant id array, with no gathers (`AdjPair.dropped`). A key is
two uint32 words, as host integers or as an int64 tensor on the device
(what a CUDA graph of the training step reads: a captured integer would
be the same key at every replay); `epoch_key_words` draws an epoch's
keys at once.
`feature_dropout` is flax's `nn.Dropout` on activations, drawn from an
explicit `torch.Generator`; `drop_edges`, `node_dropout_mask` and
`drop_edges_by_nodes` draw their Bernoulli masks from one too
(`bernoulli_mask`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import SparseCOO, with_new_vals

_M32 = 0xFFFFFFFF


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for z in [0, 2^32) held in int64: z * c itself
    can reach 2^64 and overflow, so multiply the two 16-bit halves of z
    separately (each product stays below 2^48)."""
    lo = z & 0xFFFF
    hi = z >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def hash_keep_mask(key: tuple[int, int] | torch.Tensor, ids: torch.Tensor,
                   keep_rate: float) -> torch.Tensor:
    """Bernoulli(keep_rate) keep-mask over edge ids, bit for bit the JAX
    `hash_keep_mask` for the same key words: `key` is the pair
    (kd[0], kd[-1]) of the JAX key's uint32 data, as two integers or as an
    int64 tensor of shape [2] on `ids`' device. The uint32 arithmetic runs
    in int64, masked to 32 bits after every step."""
    if torch.is_tensor(key):
        k0, k1 = (key.to(torch.int64) & _M32).unbind()
    else:
        k0, k1 = (int(k) & _M32 for k in key)
    z = (ids.to(torch.int64) & _M32) ^ k0
    z = _mul32(z, 0x9E3779B9)
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ k1
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    z = z ^ (z >> 16)
    # z >> 8 < 2^24 is exact in f32; JAX compares with keep_rate as f32
    u = (z >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u < float(np.float32(keep_rate))


def feature_dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
                    train: bool) -> torch.Tensor:
    """flax `nn.Dropout` on features: off when not training or at rate 0;
    otherwise each element is kept with probability 1 - rate and scaled
    by 1 / (1 - rate), and rate 1 gives zeros. The keep draws come from
    `generator` (on x's device), torch's default one when None: flax's
    PRNG stream itself cannot be reproduced."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def bernoulli_mask(generator: torch.Generator | None, p: float, shape,
                   device: torch.device | str) -> torch.Tensor:
    """A boolean mask, each element True with probability p (the JAX
    `jax.random.bernoulli`), drawn from `generator` on `device`."""
    return torch.rand(shape, generator=generator, device=device) < p


def drop_edges(generator: torch.Generator | None, adj: SparseCOO,
               keep_rate: float) -> SparseCOO:
    """Bernoulli(keep_rate) mask on the edge values, survivors rescaled by
    1/keep_rate; keep_rate >= 1 returns adj unchanged (the reference's
    `if keepRate == 1.0` early-out)."""
    if keep_rate >= 1.0:
        return adj
    mask = bernoulli_mask(generator, keep_rate, adj.vals.shape, adj.vals.device)
    # divide by a device tensor: a CUDA division by a host scalar multiplies
    # by its reciprocal, which can differ in the last bit
    keep = torch.full((), keep_rate, dtype=adj.vals.dtype, device=adj.vals.device)
    return with_new_vals(adj, torch.where(mask, adj.vals / keep, 0.0))


def node_dropout_mask(generator: torch.Generator | None, n_nodes: int, drop_rate: float,
                      device: torch.device | str | None = None) -> torch.Tensor:
    """Boolean keep-mask over nodes (GraphAugmentor.node_dropout,
    data/augmentor.py:11-25), on `device` (default: the card)."""
    return bernoulli_mask(generator, 1.0 - drop_rate, (n_nodes,), resolve_device(device))


def drop_edges_by_nodes(generator: torch.Generator | None, adj: SparseCOO,
                        drop_rate: float) -> SparseCOO:
    """Node-dropout view of a graph: every edge incident to a dropped row or
    column node is zeroed, without rescaling (data/augmentor.py:11-25)."""
    if drop_rate <= 0.0:
        return adj
    dev = adj.vals.device
    keep_rows = node_dropout_mask(generator, adj.nrows, drop_rate, dev)
    keep_cols = node_dropout_mask(generator, adj.ncols, drop_rate, dev)
    rows_ok = keep_rows[adj.rows.long().clamp(0, adj.nrows - 1)]
    cols_ok = keep_cols[adj.cols.long().clamp(0, adj.ncols - 1)]
    return with_new_vals(adj, torch.where(rows_ok & cols_ok, adj.vals, 0.0))


def key_words(generator: torch.Generator) -> tuple[int, int]:
    """Two uint32 key words drawn from `generator` (a CPU generator: the
    words are host integers, so drawing them does not wait on the card)."""
    w = torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64)
    return int(w[0]), int(w[1])


def epoch_key_words(generator: torch.Generator, n_steps: int, n_keys: int) -> torch.Tensor:
    """[n_steps, n_keys, 2] int64 key words on the CPU: the words that
    `n_steps` x `n_keys` calls of `key_words` would draw from `generator`,
    in that order (step-major), in one draw, for one copy to the card."""
    return torch.randint(0, 1 << 32, (n_steps, n_keys, 2), generator=generator,
                         dtype=torch.int64)
