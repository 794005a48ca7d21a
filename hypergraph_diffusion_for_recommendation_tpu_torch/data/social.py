"""Social-relation data path — the port's copy of the JAX package's
`data/social.py` (parity with reference `data/social.py`, `Relation`):
trust edges filtered to known users, follower/followee maps, the U x U
social matrix and its bidirectional (mutual-follow) restriction, the
normalised Laplacian. Host numpy and scipy; the same inputs give the same
arrays bit for bit. The social models (MHCN, SEPT) build their device
matrices from it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from .dataset import InteractionData
from .normalize import normalize_graph_mat


@dataclass
class SocialData:
    """Host-side social graph keyed by dense user ids."""

    edges: np.ndarray  # [n, 2] dense (follower, followee)
    n_users: int
    social_mat: sp.csr_matrix = field(repr=False)

    @property
    def n_relations(self) -> int:
        return int(self.edges.shape[0])

    def bidirectional_mat(self) -> sp.csr_matrix:
        """Mutual-follow restriction: S ⊙ S^T (social.py:38-41 uses
        S.multiply(S), an evident typo for S.multiply(S.T) — mutual
        links; the intended semantics, as in the JAX package)."""
        return self.social_mat.multiply(self.social_mat.T).tocsr()

    def norm_social(self) -> sp.csr_matrix:
        return normalize_graph_mat(self.social_mat)

    def followees(self, u: int) -> np.ndarray:
        return self.social_mat[u].indices

    def followers(self, u: int) -> np.ndarray:
        return self.social_mat.T.tocsr()[u].indices


def build_social(relations: np.ndarray, inter: InteractionData) -> SocialData:
    """relations: raw (user1, user2[, weight]) rows; pairs with unknown
    users dropped (social.py:17-22)."""
    rel = np.asarray(relations)
    u1 = np.array([inter.user.get(int(a), -1) for a in rel[:, 0]], np.int64)
    u2 = np.array([inter.user.get(int(b), -1) for b in rel[:, 1]], np.int64)
    keep = (u1 >= 0) & (u2 >= 0)
    u1, u2 = u1[keep], u2[keep]
    mat = sp.csr_matrix(
        (np.ones(u1.shape[0], np.float32), (u1, u2)),
        shape=(inter.n_users, inter.n_users),
    )
    return SocialData(edges=np.stack([u1, u2], axis=1), n_users=inter.n_users, social_mat=mat)


def synthetic_social(inter: InteractionData, n_per_user: int = 5, seed: int = 13) -> np.ndarray:
    """Synthetic trust network correlated with taste: users follow users
    with overlapping histories (raw-id pairs for `build_social`)."""
    rng = np.random.default_rng(seed)
    rated = inter.rated_lists()
    # cluster proxy: most-rated item bucket
    sig = np.array([int(r[0]) % 16 if len(r) else 0 for r in rated])
    edges = []
    users = np.arange(inter.n_users)
    for u in range(inter.n_users):
        same = users[sig == sig[u]]
        pool = same if len(same) > 1 else users
        picks = rng.choice(pool, size=min(n_per_user, len(pool)), replace=False)
        for v in picks:
            if v != u:
                edges.append((inter.id2user[u], inter.id2user[v]))
    return np.asarray(edges, np.int64)
