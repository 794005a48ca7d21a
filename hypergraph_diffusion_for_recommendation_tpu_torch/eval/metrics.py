"""On-device ranking evaluation — the port of the JAX package's
`eval/metrics.py`: blocked exact-f32 scoring, rated-item mask, top-k and
vectorised Hit/Precision/Recall/NDCG (also from given top-k ids:
`metrics_from_topk`), with the reference's formulas
(util/evaluation.py):

  hits[u]    = |top_N(u) ∩ test(u)|
  hit_ratio  = Σ_u hits[u] / Σ_u |test(u)|
  precision  = Σ_u hits[u] / (n_test_users * N)
  recall     = mean_u hits[u] / |test(u)|
  NDCG       = mean_u DCG_u / IDCG_u

|test(u)| counts ALL of u's test items, including items never seen in
training (id -2: unretrievable, but in the denominators).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.device import EvalData
from ..ops.topk import exact_scores, masked_topk
from ..utils.spans import EVAL_METRICS, EVAL_SCORE, EVAL_TOPK, span


def ranking_metrics(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    rated_pad: torch.Tensor,
    eval_data: EvalData,
    top_ns: tuple[int, ...] = (10, 20, 40),
    block: int = 256,
) -> dict[str, torch.Tensor]:
    """Returns {"hit_ratio": [len(top_ns)], "precision": ..., "recall": ...,
    "ndcg": ...} as tensors on the embeddings' device, ordered like
    `top_ns`."""
    max_n = max(int(n) for n in top_ns)

    def top_ids(s: int, e: int) -> torch.Tensor:
        users = eval_data.test_users[s:e].long()
        with span(EVAL_SCORE):
            scores = exact_scores(user_emb[users], item_emb)
        with span(EVAL_TOPK):
            return masked_topk(scores, rated_pad[users], max_n)[1]

    return _metrics(top_ids, eval_data, top_ns, block, user_emb.device, "ranking_metrics")


def metrics_from_topk(
    top_ids: torch.Tensor,
    eval_data: EvalData,
    top_ns: tuple[int, ...] = (10, 20, 40),
    block: int = 256,
) -> dict[str, torch.Tensor]:
    """The metrics of `ranking_metrics` from PRE-COMPUTED top-max_n item ids
    per padded test user ([n_pad, >= max_n], the JAX package's
    distributed-top-k eval path)."""
    return _metrics(lambda s, e: top_ids[s:e], eval_data, top_ns, block, top_ids.device,
                    "metrics_from_topk")


def _metrics(top_ids, eval_data: EvalData, top_ns, block: int, dev, name: str) -> dict:
    """Hit/Precision/Recall/NDCG over the padded test users, a block at a
    time; `top_ids(s, e)` gives the top-max_n ids of users s..e-1."""
    top_ns = tuple(int(n) for n in top_ns)
    max_n = max(top_ns)
    n_pad = eval_data.test_users.shape[0]
    if n_pad == 0:
        raise ValueError(f"{name}: empty eval set (0 padded test users); nothing to score")
    block = min(block, n_pad)
    if n_pad % block:
        raise ValueError(f"{name}: {n_pad} padded test users is not a multiple of {block}")
    # ctable[k] = sum_{n<k} 1/log2(n+2), computed in float64 then cast, as
    # the JAX package's discount table is
    d = 1.0 / np.log2(np.arange(max_n) + 2.0)
    disc = torch.as_tensor(np.concatenate([[0.0], np.cumsum(d)]), dtype=torch.float32, device=dev)
    pos_disc = 1.0 / torch.log2(torch.arange(max_n, dtype=torch.float32, device=dev) + 2.0)

    total = torch.zeros(len(top_ns), 3, dtype=torch.float32, device=dev)
    for s in range(0, n_pad, block):
        ids = top_ids(s, s + block)[:, :max_n]
        with span(EVAL_METRICS):
            vf = eval_data.user_valid[s : s + block].float()
            test_pos = eval_data.test_pos_pad[s : s + block]
            cnt = eval_data.test_counts[s : s + block].long()
            hit_f = (ids[:, :, None] == test_pos[:, None, :]).any(dim=-1).float()
            rows = []
            for n in top_ns:
                hits_n = hit_f[:, :n].sum(dim=1)
                dcg_n = (hit_f[:, :n] * pos_disc[:n]).sum(dim=1)
                idcg_n = disc[torch.clamp(cnt, max=n)]
                ndcg_n = torch.where(idcg_n > 0, dcg_n / torch.clamp(idcg_n, min=1e-12), 0.0)
                rec_n = hits_n / torch.clamp(cnt.float(), min=1.0)
                rows.append(torch.stack([(hits_n * vf).sum(), (rec_n * vf).sum(),
                                         (ndcg_n * vf).sum()]))
            total += torch.stack(rows)

    n_users = float(eval_data.n_test_users)
    n_inter = float(eval_data.total_test_interactions)
    ns = torch.as_tensor(top_ns, dtype=torch.float32, device=dev)
    return {
        "hit_ratio": total[:, 0] / max(n_inter, 1.0),
        "precision": total[:, 0] / torch.clamp(n_users * ns, min=1.0),
        "recall": total[:, 1] / max(n_users, 1.0),
        "ndcg": total[:, 2] / max(n_users, 1.0),
    }


def metrics_to_host(metrics: dict, top_ns: tuple[int, ...]) -> dict:
    """Device dict -> {N: {metric: float rounded to 5}} (the reference's
    round(x, 5), evaluation.py:30-97), with one copy to the host per metric."""
    host = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
    return {
        int(n): {name: round(float(host[name][k]), 5)
                 for name in ("hit_ratio", "precision", "recall", "ndcg")}
        for k, n in enumerate(top_ns)
    }
