"""Host-side interaction dataset — semantics parity with reference
`data/ui_graph.py` (`Interaction`), vectorised with numpy. The
port's copy of the JAX package's `data/dataset.py`; it gives identical
arrays for identical inputs.

Key parity points:
  * dense ids are assigned in FIRST-APPEARANCE order over the training
    edges (ui_graph.py:43-52) — `native.factorize` reproduces this exactly;
  * test entries keep only users seen in training, but KEEP items never
    seen in training (ui_graph.py:63-68). Such items can never be
    retrieved yet still count in recall/NDCG denominators — the eval
    path encodes them as dense id -2 (never matches a top-k id);
  * the bipartite adjacency is (U+I)x(U+I) with items offset by n_users
    (ui_graph.py:70-84), normalised D^-1/2 A D^-1/2; the rectangular
    U x I / I x U interaction matrices are row-normalised (graph.py:20-24).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from ..native import factorize
from .normalize import normalize_graph_mat


@dataclass
class InteractionData:
    """Id maps + train/test edge arrays + scipy adjacencies (host)."""

    # raw -> dense maps (insertion order over training data)
    user: dict
    item: dict
    id2user: np.ndarray  # [n_users] raw ids
    id2item: np.ndarray  # [n_items] raw ids
    n_users: int
    n_items: int

    # training edges, dense ids
    train_u: np.ndarray  # [n_train] int32
    train_i: np.ndarray  # [n_train] int32

    # test edges: users are dense; items are dense or -2 when unseen in train
    test_u: np.ndarray  # [n_test] int32 (dense)
    test_i: np.ndarray  # [n_test] int32 (dense or -2)
    test_i_raw: np.ndarray  # [n_test] raw item ids

    # scipy adjacencies
    ui_adj: sp.csr_matrix = field(repr=False)  # (U+I)^2 bipartite
    norm_adj: sp.csr_matrix = field(repr=False)
    interaction_mat: sp.csr_matrix = field(repr=False)  # U x I
    inv_interaction_mat: sp.csr_matrix = field(repr=False)  # I x U
    norm_interaction_mat: sp.csr_matrix = field(repr=False)
    norm_inv_interaction_mat: sp.csr_matrix = field(repr=False)

    @property
    def n_cf_train(self) -> int:
        return int(self.train_u.shape[0])

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    def rated_lists(self) -> list[np.ndarray]:
        """Per-user dense rated-item id lists (training history)."""
        order = np.argsort(self.train_u, kind="stable")
        u_sorted = self.train_u[order]
        i_sorted = self.train_i[order]
        splits = np.searchsorted(u_sorted, np.arange(1, self.n_users))
        return np.split(i_sorted, splits)

    def test_lists(self) -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
        """Group test edges per user: (test_users, per-user dense items,
        per-user counts). Counts include items unseen in training (parity:
        the reference's recall/NDCG denominators count them,
        util/evaluation.py:50-53,94-95)."""
        if self.test_u.size == 0:
            return np.empty(0, np.int32), [], np.empty(0, np.int32)
        order = np.argsort(self.test_u, kind="stable")
        u_sorted = self.test_u[order]
        i_sorted = self.test_i[order]
        users, start = np.unique(u_sorted, return_index=True)
        groups = np.split(i_sorted, start[1:])
        counts = np.diff(np.append(start, u_sorted.size)).astype(np.int32)
        return users.astype(np.int32), groups, counts


def build_interaction(train_pairs: np.ndarray, test_pairs: np.ndarray) -> InteractionData:
    """Build InteractionData from raw (user, item) id pairs."""
    train_pairs = np.asarray(train_pairs)[:, :2].astype(np.int64)
    test_pairs = (
        np.asarray(test_pairs)[:, :2].astype(np.int64)
        if len(test_pairs) else np.zeros((0, 2), np.int64)
    )

    train_u_dense, uniq_users = factorize(train_pairs[:, 0])
    train_i_dense, uniq_items = factorize(train_pairs[:, 1])
    n_users = len(uniq_users)
    n_items = len(uniq_items)
    user_map = {int(u): k for k, u in enumerate(uniq_users)}
    item_map = {int(i): k for k, i in enumerate(uniq_items)}

    # test: keep only users seen in training; unseen items -> -2
    if test_pairs.shape[0]:
        tu = np.array([user_map.get(int(u), -1) for u in test_pairs[:, 0]], np.int32)
        keep = tu >= 0
        tu = tu[keep]
        ti_raw = test_pairs[keep, 1]
        ti = np.array([item_map.get(int(i), -2) for i in ti_raw], np.int32)
    else:
        tu = np.empty(0, np.int32)
        ti = np.empty(0, np.int32)
        ti_raw = np.empty(0, np.int64)

    n_nodes = n_users + n_items
    ones = np.ones(train_u_dense.shape[0], np.float32)
    tmp = sp.csr_matrix(
        (ones, (train_u_dense, train_i_dense + n_users)), shape=(n_nodes, n_nodes), dtype=np.float32
    )
    ui_adj = (tmp + tmp.T).tocsr()
    norm_adj = normalize_graph_mat(ui_adj)

    interaction_mat = sp.csr_matrix(
        (ones, (train_u_dense, train_i_dense)), shape=(n_users, n_items), dtype=np.float32
    )
    inv_interaction_mat = sp.csr_matrix(
        (ones, (train_i_dense, train_u_dense)), shape=(n_items, n_users), dtype=np.float32
    )

    return InteractionData(
        user=user_map,
        item=item_map,
        id2user=np.asarray(uniq_users),
        id2item=np.asarray(uniq_items),
        n_users=n_users,
        n_items=n_items,
        train_u=train_u_dense,
        train_i=train_i_dense,
        test_u=tu,
        test_i=ti,
        test_i_raw=np.asarray(ti_raw),
        ui_adj=ui_adj,
        norm_adj=norm_adj,
        interaction_mat=interaction_mat,
        inv_interaction_mat=inv_interaction_mat,
        norm_interaction_mat=normalize_graph_mat(interaction_mat),
        norm_inv_interaction_mat=normalize_graph_mat(inv_interaction_mat),
    )
