"""On-device ranking evaluation — the port of the JAX package's
`eval/metrics.py`: the ranking of users over the full catalog (`top_items`)
and vectorised Hit/Precision/Recall/NDCG from its top-k ids
(`ranking_metrics`; from given ids: `metrics_from_topk`), with the
reference's formulas (util/evaluation.py). `top_items` is the one place
the port chooses how users are ranked, for the evaluation, serving and the
facade alike.

  hits[u]    = |top_N(u) ∩ test(u)|
  hit_ratio  = Σ_u hits[u] / Σ_u |test(u)|
  precision  = Σ_u hits[u] / (n_test_users * N)
  recall     = mean_u hits[u] / |test(u)|
  NDCG       = mean_u DCG_u / IDCG_u

|test(u)| counts ALL of u's test items, including items never seen in
training (id -2: unretrievable, but in the denominators).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.device import EvalData
from ..ops.kernels import score_topk as fused
from ..ops.topk import exact_f32, exact_scores, masked_topk, topk_ids
from ..parallel.mesh import MODEL_AXIS, axis_size
from ..parallel.topk import sharded_user_topk
from ..utils.spans import EVAL_METRICS, EVAL_SCORE, EVAL_TOPK, span


def top_items(user_emb: torch.Tensor, users: torch.Tensor, item_emb: torch.Tensor,
              rated: torch.Tensor | None, k: int, *, block: int, mesh=None,
              n_items: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The top k items of each user listed in `users` (rows of `user_emb` and
    `rated`) after its rated items (`rated` [n_users, max_deg], pad -1; None:
    no mask) were given `ops.topk.NEG_INF`: values f32 and ids int64, each
    [len(users), min(k, I)], descending, ties to the lower id. On a mesh whose
    model axis is above 1, `item_emb` is this rank's row block and `n_items`
    the catalogue's size, and the ranks' top-k merge over the model group
    (`sharded_user_topk`), `block` users a call; else, where `score_topk`
    covers the tables (f32 on the card, width and k within its limits), one
    call for every user, which writes no score matrix; else `block` users at a
    time through `exact_scores` and `masked_topk`."""
    if mesh is not None and axis_size(mesh, MODEL_AXIS) > 1:
        def merged(rows):
            mask = (torch.full((rows.shape[0], 1), -1, device=rows.device) if rated is None
                    else rated.index_select(0, rows))
            with span(EVAL_TOPK):
                return sharded_user_topk(mesh, user_emb.index_select(0, rows), item_emb, mask, k,
                                         n_items)

        return _in_blocks(merged, users, block)
    if fused.covers(user_emb, item_emb, rated, k):
        with span(EVAL_TOPK):
            return fused.score_topk(user_emb, users, item_emb, rated, k)

    def blocked(rows):
        with span(EVAL_SCORE):
            scores = exact_scores(user_emb.index_select(0, rows), item_emb)
        with span(EVAL_TOPK):
            return (topk_ids(scores, k) if rated is None
                    else masked_topk(scores, rated.index_select(0, rows), k))

    return _in_blocks(blocked, users, block)


def _in_blocks(rank, users: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    parts = [rank(users[s:s + block]) for s in range(0, max(users.shape[0], 1), block)]
    return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])


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
    `top_ns`, from every padded test user's `top_items`."""
    max_n = max(int(n) for n in top_ns)
    ids = top_items(user_emb, eval_data.test_users, item_emb, rated_pad, max_n, block=block)[1]
    return metrics_from_topk(ids, eval_data, top_ns, block)


@functools.lru_cache(maxsize=None)
def _tables(top_ns: tuple[int, ...], dev: torch.device) -> tuple[torch.Tensor, ...]:
    """The cutoffs' constants on `dev`, made once: the cutoffs; ctable[k] =
    sum_{n<k} 1/log2(n+2), computed in float64 then cast, as the JAX
    package's discount table is; and `take` [max_n, 3 * len(top_ns)], whose
    product with a row of hits (1 at each top-k position that is a test
    item) gives the hits, the hits again and the DCG at each cutoff."""
    max_n = max(top_ns)
    d = 1.0 / np.log2(np.arange(max_n) + 2.0)
    disc = torch.as_tensor(np.concatenate([[0.0], np.cumsum(d)]), dtype=torch.float32, device=dev)
    pos_disc = 1.0 / torch.log2(torch.arange(max_n, dtype=torch.float32, device=dev) + 2.0)
    ns = torch.as_tensor(top_ns, device=dev)
    within = (torch.arange(max_n, device=dev)[:, None] < ns[None, :]).float()
    return ns, disc, torch.cat([within, within, within * pos_disc[:, None]], dim=1)


def metrics_from_topk(
    top_ids: torch.Tensor,
    eval_data: EvalData,
    top_ns: tuple[int, ...] = (10, 20, 40),
    block: int = 256,
) -> dict[str, torch.Tensor]:
    """The metrics of `ranking_metrics` from PRE-COMPUTED top-max_n item ids
    per padded test user ([n_pad, >= max_n], the JAX package's
    distributed-top-k eval path), summed a block of users at a time."""
    top_ns = tuple(int(n) for n in top_ns)
    max_n, n_cut = max(top_ns), len(top_ns)
    n_pad = eval_data.test_users.shape[0]
    if n_pad == 0:
        raise ValueError("metrics_from_topk: empty eval set (0 padded test users)")
    block = min(block, n_pad)
    if n_pad % block:
        raise ValueError(f"metrics_from_topk: {n_pad} padded test users, not a multiple of {block}")
    dev = top_ids.device
    ns, disc, take = _tables(top_ns, dev)
    # what the test set alone decides, for every padded user at once, so that
    # a block launches only what reads its top-k ids: each user's weights of
    # (hits, hits, DCG) at each cutoff for (hits, recall, NDCG), 0 for a pad
    vf = eval_data.user_valid.float()[:, None]
    cnt = eval_data.test_counts.long()[:, None]
    idcg = disc[torch.minimum(cnt, ns)]
    weights = vf * torch.cat([
        torch.ones_like(idcg),
        (1.0 / torch.clamp(cnt.float(), min=1.0)).expand_as(idcg),
        torch.where(idcg > 0, 1.0 / torch.clamp(idcg, min=1e-12), 0.0),
    ], dim=1)

    per_user = torch.empty(n_pad, 3 * n_cut, dtype=torch.float32, device=dev)
    with exact_f32():
        for s in range(0, n_pad, block):
            e = s + block
            ids = top_ids[s:e, :max_n]
            with span(EVAL_METRICS):
                test_pos = eval_data.test_pos_pad[s:e]
                hit = (ids[:, :, None] == test_pos[:, None, :]).any(dim=-1)
                torch.mul(hit.float() @ take, weights[s:e], out=per_user[s:e])
    # the blocks' sums, then their sum: [3, cutoffs] of (hits, recall, NDCG)
    total = per_user.view(n_pad // block, block, 3, n_cut).sum(1).sum(0)

    n_users = float(eval_data.n_test_users)
    n_inter = float(eval_data.total_test_interactions)
    ns = ns.float()
    return {
        "hit_ratio": total[0] / max(n_inter, 1.0),
        "precision": total[0] / torch.clamp(n_users * ns, min=1.0),
        "recall": total[1] / max(n_users, 1.0),
        "ndcg": total[2] / max(n_users, 1.0),
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

