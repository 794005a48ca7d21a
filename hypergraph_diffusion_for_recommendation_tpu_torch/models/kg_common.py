"""Shared knowledge-graph ops for the KHGRec family — the port of the JAX
package's `models/kg_common.py`.

Relation-batched projections run as R stacked matmuls, and the attention
row-softmax is a segment softmax over the triple list (the reference
round-trips through a CPU sparse softmax, KGAT.py:349-389,
KHGRec.py:298-331).
"""

from __future__ import annotations

import torch

from ..ops.sparse import scatter_sum, segment_softmax


def project_by_relation(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """x[b] @ w[r[b]]: x [B, d], w [R, d, dr], r [B] -> [B, dr]. All R
    projections as one einsum (R is small), then each row picks its own
    relation's — the values the JAX one-hot contraction gives."""
    all_proj = torch.einsum("bd,rdk->rbk", x, w)  # [R, B, dr]
    return all_proj[r.long(), torch.arange(x.shape[0], device=x.device)]


def relation_lookup(rel_emb: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """rel_emb[r] as a one-hot matmul (R ~ 10 relations), the JAX package's
    form: its values are rel_emb's rows exactly, and its backward is one
    matmul into the relation table. A KG batch of 8192 triples holds runs of
    thousands of one relation id, which the index backward would add one
    element after another: KGAT's whole KG step took 2.28 ms with plain
    indexing, 1.03 with `gather_rows_hubs` and 0.62 in this form (NVIDIA
    H100 80GB HBM3, 700 W; `chip_smoke.py` phase 17)."""
    onehot = torch.nn.functional.one_hot(r.long(), rel_emb.shape[0]).to(rel_emb.dtype)
    return onehot @ rel_emb


def attention_values(
    entity_emb: torch.Tensor,
    rel_emb: torch.Tensor,
    trans_m: torch.Tensor,
    h: torch.Tensor,
    t: torch.Tensor,
    r: torch.Tensor,
) -> torch.Tensor:
    """KGAT attention logits per triple (Equation 4, KGAT.py:349-360):
    v = sum((t W_r) * tanh(h W_r + r), -1). Out-of-range ids clamp, as
    JAX gathers do."""
    n = entity_emb.shape[0]
    ht = entity_emb[torch.cat([h, t]).long().clamp(0, n - 1)]
    both = project_by_relation(ht, trans_m, torch.cat([r, r]))
    r_mul_h, r_mul_t = torch.chunk(both, 2, dim=0)
    return torch.sum(r_mul_t * torch.tanh(r_mul_h + relation_lookup(rel_emb, r)), dim=1)


def attention_softmax(
    values: torch.Tensor, h: torch.Tensor, n_entities: int, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Row-softmax of the attention adjacency (Equation 5)."""
    return segment_softmax(values, h, n_entities, valid)


def att_matvec(
    h: torch.Tensor, t: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, n: int
) -> torch.Tensor:
    """(A_att @ X)[i] = sum_{(i,t)} vals * X[t] over the triple list; pad
    triples (h == n) are dropped."""
    gathered = x[t.long().clamp(0, n - 1)] * vals[:, None]
    return scatter_sum(gathered, h, n)


def att_matvec_t(
    h: torch.Tensor, t: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, n: int
) -> torch.Tensor:
    """A_att^T @ X over the same triple list."""
    gathered = x[h.long().clamp(0, n - 1)] * vals[:, None]
    return scatter_sum(gathered, t, n)
