"""Stateless, shape-preserving edge dropout — the port of the JAX
package's `ops/dropout.py` (`hash_keep_mask`).

Dropped edges keep their slot with value 0 and survivors are rescaled by
1/keep (inverted dropout on the nnz axis), so every shape stays static.
The keep-mask is a counter hash of (key, edge id): each layout of one
edge (forward, transpose, packed kernel blocks) draws the same bit from
its own constant id array, with no gathers (`AdjPair.dropped`).
`feature_dropout` is flax's `nn.Dropout` on activations, drawn from an
explicit `torch.Generator`. `drop_edges` and the node-dropout helpers come
with the model zoo.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for z in [0, 2^32) held in int64: z * c itself
    can reach 2^64 and overflow, so multiply the two 16-bit halves of z
    separately (each product stays below 2^48)."""
    lo = z & 0xFFFF
    hi = z >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def hash_keep_mask(key: tuple[int, int], ids: torch.Tensor, keep_rate: float) -> torch.Tensor:
    """Bernoulli(keep_rate) keep-mask over edge ids, bit for bit the JAX
    `hash_keep_mask` for the same key words: `key` is the pair
    (kd[0], kd[-1]) of the JAX key's uint32 data. The uint32 arithmetic
    runs in int64, masked to 32 bits after every step."""
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


def key_words(generator: torch.Generator) -> tuple[int, int]:
    """Two uint32 key words drawn from `generator` (a CPU generator: the
    words are host integers, so drawing them does not wait on the card)."""
    w = torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64)
    return int(w[0]), int(w[1])
