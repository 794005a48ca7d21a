"""Mini-batch construction and negative sampling — the port of the JAX
package's `ops/sampling.py`.

A whole epoch of batches is built on the card from a `torch.Generator`:
one permutation of the edge list, a reshape into [n_batches, B] (the tail
batch wraps around the permutation), and negatives drawn with a fixed
number of redraw rounds against a membership table, with no rejection
loop. The probability that a negative is still a rated item after R
rounds is (deg_u / I)^R. torch and JAX draw different numbers from their
generators, so the port matches the JAX samplers in shapes, ranges and
rounds, not in values; `HostExactSampler` (numpy) matches bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class CSRMembership:
    """Sorted-CSR membership table: per-row sorted id lists stored as one
    concatenated array + indptr, tested by a vectorised binary search.
    O(nnz) memory, where the padded [n_rows, max_deg] table is
    O(n_rows * max_deg); both are exact."""

    items: torch.Tensor  # [nnz] concatenated per-row ascending ids, int32
    indptr: torch.Tensor  # [n_rows + 1] int32
    steps: int  # binary-search iterations


def membership_from_lists(lists, device: torch.device | str) -> CSRMembership:
    """Host-side build from ragged per-row id lists (as the JAX one)."""
    n = len(lists)
    lens = np.fromiter((len(l) for l in lists), np.int64, count=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    if indptr[-1] == 0:
        items = np.zeros(1, np.int32)
    else:
        items = np.concatenate([np.sort(np.asarray(l, np.int32)) for l in lists if len(l)])
    max_len = int(lens.max()) if n else 1
    steps = int(np.ceil(np.log2(max(max_len, 1) + 1))) + 1
    return CSRMembership(
        items=torch.as_tensor(items.astype(np.int32), device=device),
        indptr=torch.as_tensor(indptr.astype(np.int32), device=device),
        steps=steps,
    )


def _is_member_csr(m: CSRMembership, rows: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Vectorised lower-bound binary search in each row's sorted segment."""
    rows = rows.long()
    lo = m.indptr[rows].long()
    hi = m.indptr[rows + 1].long()
    l, h = lo, hi
    size = m.items.shape[0]
    for _ in range(m.steps):
        active = l < h
        mid = (l + h) >> 1
        go = m.items[mid.clamp(0, size - 1)] < cands
        l = torch.where(active & go, mid + 1, l)
        h = torch.where(active & ~go, mid, h)
    return (l < hi) & (m.items[l.clamp(0, size - 1)] == cands)


def is_rated(table, users: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Is cands[b] in row users[b] of the table? `table` is a padded
    [n_rows, max_deg] id tensor (pad -1) or a `CSRMembership`."""
    if isinstance(table, CSRMembership):
        return _is_member_csr(table, users, cands)
    return (table[users.long()] == cands[:, None]).any(dim=1)


def sample_negatives(generator: torch.Generator, users: torch.Tensor, rated, n_items: int,
                     rounds: int = 8) -> torch.Tensor:
    """Uniform negatives not in the user's history: one draw, then
    `rounds - 1` redraws of the candidates still rated (the last draw
    stays where all collide)."""
    dev = users.device
    cands = torch.randint(0, n_items, users.shape, generator=generator, device=dev,
                          dtype=torch.int32)
    for _ in range(rounds - 1):
        bad = is_rated(rated, users, cands)
        redraw = torch.randint(0, n_items, users.shape, generator=generator, device=dev,
                               dtype=torch.int32)
        cands = torch.where(bad, redraw, cands)
    return cands


def sample_negatives_chunked(generator: torch.Generator, users_2d: torch.Tensor, rated,
                             n_items: int, rounds: int = 8) -> torch.Tensor:
    """`sample_negatives` over [n_chunks, B] rows. A CSR table tests by
    binary search, so the whole epoch samples in one flat call; a padded
    table gathers [B, max_deg] per round, so it samples a row at a time
    (one flat call would hold [n_chunks * B, max_deg])."""
    if isinstance(rated, CSRMembership):
        flat = sample_negatives(generator, users_2d.reshape(-1), rated, n_items, rounds)
        return flat.reshape(users_2d.shape)
    return torch.stack([sample_negatives(generator, row, rated, n_items, rounds)
                        for row in users_2d])


def epoch_pairwise_batches(generator: torch.Generator, edge_users: torch.Tensor,
                           edge_items: torch.Tensor, rated, n_items: int, batch_size: int,
                           rounds: int = 8):
    """One epoch of BPR batches on the edges' device (`next_batch_pairwise`,
    reference util/sampler.py:237-264): shuffle the training edges, cut
    them into ceil(n / B) batches, the tail filled by wrapping around the
    permutation (again, where B > n), and one negative per positive.
    Returns (users, pos, neg), each [n_batches, B] int32."""
    n = edge_users.shape[0]
    n_batches = -(-n // batch_size)
    total = n_batches * batch_size
    perm = torch.randperm(n, generator=generator, device=edge_users.device)
    # the JAX package's concat([perm, perm[:total - n]]), which it equals
    # whenever total <= 2n, and defined past that too
    idx = perm[torch.arange(total, device=perm.device) % n]
    users = edge_users[idx].reshape(n_batches, batch_size)
    pos = edge_items[idx].reshape(n_batches, batch_size)
    neg = sample_negatives_chunked(generator, users, rated, n_items, rounds)
    return users, pos, neg


def pointwise_layout(idx: torch.Tensor, negs: torch.Tensor, edge_users: torch.Tensor,
                     edge_items: torch.Tensor, batch_size: int):
    """The pointwise batches of one epoch from its draws: `idx` [total] the
    wrapped permutation of the edges, `negs` [total, n_negs] the negatives
    of each drawn edge. Each row is the positive then its negatives, labels
    1 then 0; returns (users, items, labels), each [n_batches,
    B * (1 + n_negs)]."""
    total, n_negs = negs.shape
    u = edge_users[idx]
    i = edge_items[idx]
    users = torch.cat([u[:, None], u[:, None].expand(total, n_negs)], dim=1)
    items = torch.cat([i[:, None], negs.to(i.dtype)], dim=1)
    labels = torch.cat([torch.ones((total, 1), device=u.device),
                        torch.zeros((total, n_negs), device=u.device)], dim=1)
    n_batches, bw = total // batch_size, batch_size * (1 + n_negs)
    return users.reshape(n_batches, bw), items.reshape(n_batches, bw), labels.reshape(n_batches, bw)


def epoch_pointwise_batches(generator: torch.Generator, edge_users: torch.Tensor,
                            edge_items: torch.Tensor, rated, n_items: int, batch_size: int,
                            n_negs: int = 4, rounds: int = 8):
    """Pointwise batches: 1 positive + n_negs negatives, labels 1/0
    (util/sampler.py:266-290), over a permutation of the edges cut into
    ceil(n / B) batches with the tail wrapped, as `epoch_pairwise_batches`.
    Returns (users, items, labels), each [n_batches, B * (1 + n_negs)]."""
    n = edge_users.shape[0]
    total = -(-n // batch_size) * batch_size
    perm = torch.randperm(n, generator=generator, device=edge_users.device)
    idx = perm[torch.arange(total, device=perm.device) % n]
    users = edge_users[idx].repeat_interleave(n_negs)
    negs = sample_negatives(generator, users, rated, n_items, rounds).reshape(total, n_negs)
    return pointwise_layout(idx, negs, edge_users, edge_items, batch_size)


def epoch_kg_batches(generator: torch.Generator, heads: torch.Tensor, relations: torch.Tensor,
                     tails: torch.Tensor, head_tails, n_entities: int, n_batches: int,
                     batch_size_kg: int, rounds: int = 8):
    """KG triple batches with corrupted tails (the KG half of
    `next_batch_unified`, util/sampler.py:33-88): per batch a uniform
    sample of `batch_size_kg` triples, and one negative tail per triple,
    redrawn while it is a true tail of (h, *).
    Returns (h, r, pos_t, neg_t), each [n_batches, B_kg] int32."""
    idx = torch.randint(0, heads.shape[0], (n_batches, batch_size_kg), generator=generator,
                        device=heads.device)
    h = heads[idx]
    neg_t = sample_negatives_chunked(generator, h, head_tails, n_entities, rounds)
    return h, relations[idx], tails[idx], neg_t


class HostExactSampler:
    """Host-side exact rejection sampler (the reference's semantics,
    util/sampler.py:252-257 and :33-88), in numpy: the same batch layout
    as the device samplers (shuffled edges, wrapped tail), negatives drawn
    by a true rejection loop. Bit for bit the JAX package's for one seed."""

    def __init__(self, edge_users, edge_items, n_items: int,
                 kg_heads=None, kg_relations=None, kg_tails=None,
                 n_entities: int = 0):
        self.edge_u = np.asarray(edge_users, np.int64)
        self.edge_i = np.asarray(edge_items, np.int64)
        self.n_items = int(n_items)
        self.hist: dict[int, set] = {}
        for u, i in zip(self.edge_u.tolist(), self.edge_i.tolist()):
            self.hist.setdefault(u, set()).add(i)
        self.kg = None
        if kg_heads is not None:
            h = np.asarray(kg_heads, np.int64)
            t = np.asarray(kg_tails, np.int64)
            tails: dict[int, set] = {}
            for hh, tt in zip(h.tolist(), t.tolist()):
                tails.setdefault(hh, set()).add(tt)
            self.kg = (h, np.asarray(kg_relations, np.int64), t, tails, int(n_entities))

    @staticmethod
    def _neg(rng, user_row, hist, n_domain) -> np.ndarray:
        out = np.empty(user_row.shape[0], np.int32)
        for b, u in enumerate(user_row.tolist()):
            s = hist.get(u, ())
            j = int(rng.integers(0, n_domain))
            while j in s:
                j = int(rng.integers(0, n_domain))
            out[b] = j
        return out

    def pairwise(self, seed: int, batch_size: int):
        """One epoch of BPR batches: (users, pos, neg) [n_batches, B]."""
        rng = np.random.default_rng(seed)
        n = self.edge_u.shape[0]
        n_batches = -(-n // batch_size)
        total = n_batches * batch_size
        perm = rng.permutation(n)
        idx = perm[np.arange(total) % n]  # = concat([perm, perm[:total - n]]) for total <= 2n
        users = self.edge_u[idx].astype(np.int32)
        pos = self.edge_i[idx].astype(np.int32)
        neg = self._neg(rng, users, self.hist, self.n_items)
        return (users.reshape(n_batches, batch_size), pos.reshape(n_batches, batch_size),
                neg.reshape(n_batches, batch_size))

    def kg_batches(self, seed: int, n_batches: int, batch_size_kg: int):
        """KG triple batches with exact-rejection corrupted tails."""
        if self.kg is None:
            raise ValueError("HostExactSampler was built without KG triples")
        h, r, t, tails, n_entities = self.kg
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, h.shape[0], (n_batches, batch_size_kg))
        hh = h[idx].astype(np.int32)
        rr = r[idx].astype(np.int32)
        pt = t[idx].astype(np.int32)
        nt = np.stack([self._neg(rng, hh[b], tails, n_entities) for b in range(n_batches)])
        return hh, rr, pt, nt
