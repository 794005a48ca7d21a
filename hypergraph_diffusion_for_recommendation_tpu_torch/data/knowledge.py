"""Host-side knowledge-graph construction — parity with reference
`data/knowledge.py` (`Knowledge.construct_data`, :44-129), vectorised.
The port's copy of the JAX package's `data/knowledge.py`.

Reference construction (quirks preserved deliberately, survey 2.3):
  1. n_rel0 = max(r)+1; inverse triples get r += n_rel0;
  2. kg_data = concat([kg, inverse]); then kg_data.r += 2;
  3. kg_train = concat([kg_data, inverse])  -- the inverse block is
     appended a SECOND time with UNSHIFTED relation ids (knowledge.py:56);
  4. CF interactions appended as triples with r=0 (u->i) and r=1 (i->u)
     using RAW user/item ids as entity ids (knowledge.py:59-67);
  5. n_users_entities = max(h, t)+1, rounded up to a multiple of 16.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import pandas as pd
import scipy.sparse as sp

from .dataset import InteractionData
from .normalize import normalize_graph_mat


@dataclass
class KnowledgeData:
    # full triple list (after inverse/shift/CF augmentation), raw entity ids
    h: np.ndarray  # [n_kg] int32
    r: np.ndarray  # [n_kg] int32
    t: np.ndarray  # [n_kg] int32
    n_entities: int  # n_users_entities in the reference
    n_relations: int
    n_kg_train: int
    # raw entity ids of CF users / items in dense-id order
    user_entity_ids: np.ndarray  # [n_users]
    item_entity_ids: np.ndarray  # [n_items]
    kg_interaction_mat: sp.csr_matrix = field(repr=False)  # E x E
    norm_kg_adj: sp.csr_matrix = field(repr=False)

    def adjacency_dict(self) -> dict[int, sp.csr_matrix]:
        """Per-relation E x E adjacency (reference
        Knowledge.create_adjacency_dict, data/knowledge.py:159-166).
        KGAT consumes only the KEYS (its relation list, KGAT.py:132);
        the matrices are exposed for API completeness."""
        out: dict[int, sp.csr_matrix] = {}
        for rel in np.unique(self.r):
            m = self.r == rel
            ones = np.ones(int(m.sum()), np.float32)
            out[int(rel)] = sp.csr_matrix(
                (ones, (self.h[m], self.t[m])),
                shape=(self.n_entities, self.n_entities),
                dtype=np.float32,
            )
        return out

    def laplacian_dict(self, laplacian_type: str = "random-walk") -> dict[int, sp.csr_matrix]:
        """Per-relation normalised laplacians (reference
        Knowledge.create_laplacian_dict, data/knowledge.py:168-196):
        'random-walk' D^-1 A or 'symmetric' D^-1/2 A D^-1/2."""
        out: dict[int, sp.csr_matrix] = {}
        for rel, adj in self.adjacency_dict().items():
            deg = np.asarray(adj.sum(axis=1)).flatten()
            with np.errstate(divide="ignore"):
                if laplacian_type == "symmetric":
                    d = np.power(deg, -0.5)
                    d[np.isinf(d)] = 0.0
                    di = sp.diags(d)
                    out[rel] = (di @ adj @ di).tocsr()
                elif laplacian_type == "random-walk":
                    d = np.power(deg, -1.0)
                    d[np.isinf(d)] = 0.0
                    out[rel] = (sp.diags(d) @ adj).tocsr()
                else:
                    raise ValueError(f"unknown laplacian_type {laplacian_type!r}")
        return out

    def head_tail_lists(self) -> list[np.ndarray]:
        """Per-head true-tail lists (train_kg_dict equivalent) for
        negative-tail rejection (util/sampler.py:50-57)."""
        order = np.argsort(self.h, kind="stable")
        h_sorted = self.h[order]
        t_sorted = self.t[order]
        out: list[np.ndarray] = [np.empty(0, np.int32)] * self.n_entities
        uniq, start = np.unique(h_sorted, return_index=True)
        groups = np.split(t_sorted, start[1:])
        for u, g in zip(uniq, groups):
            out[int(u)] = g.astype(np.int32)
        return out


def build_knowledge(kg_df: pd.DataFrame, inter: InteractionData) -> KnowledgeData:
    """Vectorised equivalent of Knowledge.construct_data (knowledge.py:44-129)."""
    kg = kg_df[["h", "r", "t"]].to_numpy(np.int64)
    n_rel0 = int(kg[:, 1].max()) + 1 if len(kg) else 0

    inverse = kg[:, [2, 1, 0]].copy()
    inverse[:, 1] += n_rel0

    both = np.concatenate([kg, inverse], axis=0)
    both[:, 1] += 2
    # reference appends the unshifted inverse block a second time
    kg_train = np.concatenate([both, inverse], axis=0)

    # CF interactions as relations 0 (u->i) and 1 (i->u), raw ids
    raw_u = inter.id2user[inter.train_u].astype(np.int64)
    raw_i = inter.id2item[inter.train_i].astype(np.int64)
    cf_fwd = np.stack([raw_u, np.zeros_like(raw_u), raw_i], axis=1)
    cf_inv = np.stack([raw_i, np.ones_like(raw_i), raw_u], axis=1)
    kg_train = np.concatenate([kg_train, cf_fwd, cf_inv], axis=0)

    n_entities = int(max(kg_train[:, 0].max(), kg_train[:, 2].max())) + 1
    # round the entity-table row count up (extra rows are never
    # referenced by any triple), as the JAX package does for sharding
    n_entities = ((n_entities + 15) // 16) * 16
    n_relations = int(kg_train[:, 1].max()) + 1

    h = kg_train[:, 0].astype(np.int32)
    r = kg_train[:, 1].astype(np.int32)
    t = kg_train[:, 2].astype(np.int32)

    ones = np.ones(h.shape[0], np.float32)
    kg_mat = sp.csr_matrix((ones, (h, t)), shape=(n_entities, n_entities), dtype=np.float32)

    return KnowledgeData(
        h=h,
        r=r,
        t=t,
        n_entities=n_entities,
        n_relations=n_relations,
        n_kg_train=int(h.shape[0]),
        user_entity_ids=inter.id2user.astype(np.int64),
        item_entity_ids=inter.id2item.astype(np.int64),
        kg_interaction_mat=kg_mat,
        norm_kg_adj=normalize_graph_mat(kg_mat),
    )
