"""Synthetic dataset generator (LastFM-scale by default) — the port's copy
of the JAX package's `data/synthetic.py`, drawing the same numpy random
streams, so that one seed gives identical arrays in both packages.

The reference repo gitignores its datasets (`dataset/` is absent), so
tests and benchmarks run on synthetic data with planted structure:
users carry a mixture over latent clusters, items a cluster + Zipf
popularity, and interactions are drawn ∝ popularity x cluster affinity.
A recommender that learns the structure beats the popularity baseline by
a wide margin; `oracle_metrics` gives the ceiling for the same draws.

Raw-id convention mirrors the processed LastFM KG data the reference
trains on (survey 2.3: CF pairs are appended to the KG with raw ids as
entity ids, data/knowledge.py:59-67): item entity ids 0..I-1, attribute
entities I..I+A-1, user entity ids I+A..I+A+U-1 — disjoint ranges.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def _item_clusters(n_items: int, n_clusters: int, cluster_seed: int) -> np.ndarray:
    """Shared item->cluster map so the KG attributes align with the
    planted interaction structure."""
    return np.random.default_rng(abs(cluster_seed) + 1000).integers(0, n_clusters, n_items)


def _latent_prelude(n_users, n_items, n_clusters, mean_degree, seed,
                    cluster_seed, pop_scale, hierarchy, min_degree):
    """The generator's latent state, in the EXACT rng call order of the
    historical `generate_interactions` prelude (streams stay bit-for-bit
    identical). Shared with `oracle_metrics` so the Bayes-optimal scorer
    sees the same popularity/cluster latents the data was drawn from."""
    rng = np.random.default_rng(seed)
    if hierarchy is not None:
        n_coarse, n_fine_per = hierarchy
        n_clusters = n_coarse * n_fine_per
    item_cluster = _item_clusters(n_items, n_clusters, seed if cluster_seed is None else cluster_seed)
    item_pop = rng.zipf(1.5, n_items).astype(np.float64)
    item_pop = np.clip(item_pop, 1, 50)
    if pop_scale is not None:
        item_pop = item_pop * np.asarray(pop_scale, np.float64)

    user_main = rng.integers(0, n_clusters, n_users)
    user_second = rng.integers(0, n_clusters, n_users)

    degrees = np.clip(
        rng.lognormal(np.log(mean_degree), 0.6, n_users), min_degree, n_items // 4
    ).astype(int)
    return rng, n_clusters, item_cluster, item_pop, user_main, user_second, degrees


def oracle_metrics(
    train: np.ndarray,
    test: np.ndarray,
    n_users: int,
    n_items: int,
    n_clusters: int = 16,
    mean_degree: float = 45.0,
    seed: int = 7,
    k: int = 20,
    affinity: float = 8.0,
    cluster_seed: int | None = None,
    pop_scale: np.ndarray | None = None,
    hierarchy: tuple[int, int] | None = None,
    sibling_affinity: float | None = None,
    min_degree: int = 5,
    user_id_offset: int | None = None,
    block: int = 256,
) -> dict:
    """EMPIRICAL oracle ceiling for the planted-structure task.

    Scores every (user, item) by the exact generative draw weight
    w = pop x (1 + affinity terms) — the Bayes-optimal ranking for data
    drawn (without replacement) from p ∝ w — masks train-rated items,
    takes top-k, and returns recall/ndcg@k over the test users with the
    framework's formulas (recall = mean_u |hits|/|test_u|; IDCG over
    min(|test_u|, k) — eval/metrics.py parity). Also returns the
    popularity-only oracle (clusters ignored) as a baseline.

    Call with the SAME generator kwargs as the dataset; pass
    `cluster_seed=seed` when the data came through `synthetic_dataset`
    (it forwards cluster_seed=seed, synthetic.py:180-184).
    """
    _, n_clusters, item_cluster, item_pop, user_main, user_second, _ = (
        _latent_prelude(n_users, n_items, n_clusters, mean_degree, seed,
                        cluster_seed, pop_scale, hierarchy, min_degree)
    )
    if user_id_offset is None:
        user_id_offset = int(min(train[:, 0].min(), test[:, 0].min()))
    tr_u = train[:, 0] - user_id_offset
    tr_i = train[:, 1]
    te_u = test[:, 0] - user_id_offset
    te_i = test[:, 1]

    if hierarchy is not None:
        n_coarse, n_fine_per = hierarchy
        sib = affinity / 2.0 if sibling_affinity is None else sibling_affinity
        item_coarse = item_cluster // n_fine_per
        boost = np.zeros((n_users, n_items))
        for u in range(n_users):
            fine = user_main[u]
            boost[u] = affinity * (item_cluster == fine) + sib * (
                (item_coarse == fine // n_fine_per) & (item_cluster != fine)
            )
    else:
        # [n_users, n_items] via cluster one-hots — no python loop
        boost = (
            affinity * (item_cluster[None, :] == user_main[:, None])
            + 0.5 * affinity * (item_cluster[None, :] == user_second[:, None])
        )

    # ---- posterior-predictive ceiling (the ATTAINABLE one): the
    # full-latent oracle above knows each user's (main, second) clusters,
    # which no learner can — it only sees the train draws. The Bayes-
    # optimal scorer GIVEN ONLY TRAIN DATA posterior-weights the
    # (main, second) pair from the user's train cluster counts under the
    # true generative model, then scores by the posterior-mean draw
    # weight. (Approximation: ranks by posterior-mean w rather than the
    # exact without-replacement successive-draw probability; the
    # difference only reorders items with near-equal w.)
    if hierarchy is None:
        counts = np.zeros((n_users, n_clusters))
        np.add.at(counts, (tr_u, item_cluster[tr_i]), 1.0)
        # per-(m,s): per-cluster log draw weight and normaliser Z(m,s)
        pop_per_c = np.zeros(n_clusters)
        np.add.at(pop_per_c, item_cluster, item_pop)
        m_idx, s_idx = np.meshgrid(np.arange(n_clusters), np.arange(n_clusters),
                                   indexing="ij")
        mult = (1.0
                + affinity * (np.arange(n_clusters)[None, None, :] == m_idx[..., None])
                + 0.5 * affinity * (np.arange(n_clusters)[None, None, :] == s_idx[..., None]))
        lw = np.log(mult)  # [K, K, K_c]
        logz = np.log((mult * pop_per_c[None, None, :]).sum(-1))  # [K, K]
        n_u = counts.sum(1)
        loglik = (counts @ lw.reshape(-1, n_clusters).T).reshape(
            n_users, n_clusters, n_clusters
        ) - n_u[:, None, None] * logz[None, :, :]
        loglik -= loglik.max(axis=(1, 2), keepdims=True)
        post = np.exp(loglik)
        post /= post.sum(axis=(1, 2), keepdims=True)  # P(m, s | train_u)
        p_main = post.sum(2)  # [U, K]
        p_second = post.sum(1)  # [U, K]
        boost_post = (affinity * p_main[:, item_cluster]
                      + 0.5 * affinity * p_second[:, item_cluster])
    else:
        boost_post = None  # hierarchy regime: posterior ceiling not derived

    test_users = np.unique(te_u)
    # per-user test / train sets as CSR-ish dicts of arrays
    order = np.argsort(te_u, kind="stable")
    te_sorted_u, te_sorted_i = te_u[order], te_i[order]
    starts = np.searchsorted(te_sorted_u, test_users)
    ends = np.searchsorted(te_sorted_u, test_users, side="right")

    disc = 1.0 / np.log2(np.arange(2, k + 2))
    acc = {name: ([], []) for name in ("oracle", "posterior", "pop")}
    for b0 in range(0, len(test_users), block):
        users = test_users[b0:b0 + block]
        mats = {
            "oracle": item_pop[None, :] * (1.0 + boost[users]),
            "pop": np.broadcast_to(item_pop, (len(users), n_items)).copy(),
        }
        if boost_post is not None:
            mats["posterior"] = item_pop[None, :] * (1.0 + boost_post[users])
        for row, u in enumerate(users):
            rated = tr_i[tr_u == u]
            for w_mat in mats.values():
                w_mat[row, rated] = -np.inf
        for name, w_mat in mats.items():
            rec_list, ndcg_list = acc[name]
            top = np.argpartition(-w_mat, k, axis=1)[:, :k]
            # order the k by score for DCG positions
            row_scores = np.take_along_axis(w_mat, top, axis=1)
            top = np.take_along_axis(top, np.argsort(-row_scores, axis=1), axis=1)
            for row, u in enumerate(users):
                i0, i1 = starts[b0 + row], ends[b0 + row]
                tset = set(te_sorted_i[i0:i1].tolist())
                hits = np.fromiter((t in tset for t in top[row]), bool, k)
                rec_list.append(hits.sum() / max(len(tset), 1))
                idcg = disc[: min(len(tset), k)].sum()
                ndcg_list.append((disc * hits).sum() / idcg if idcg > 0 else 0.0)
    out = {
        "recall": float(np.mean(acc["oracle"][0])),
        "ndcg": float(np.mean(acc["oracle"][1])),
        "recall_pop": float(np.mean(acc["pop"][0])),
        "ndcg_pop": float(np.mean(acc["pop"][1])),
        "n_test_users": int(len(test_users)),
        "k": k,
    }
    if acc["posterior"][0]:
        out["recall_posterior"] = float(np.mean(acc["posterior"][0]))
        out["ndcg_posterior"] = float(np.mean(acc["posterior"][1]))
    return out


def generate_interactions(
    n_users: int = 1890,
    n_items: int = 4000,
    n_clusters: int = 16,
    mean_degree: float = 45.0,
    seed: int = 7,
    user_id_offset: int | None = None,
    affinity: float = 8.0,
    cluster_seed: int | None = None,
    pop_scale: np.ndarray | None = None,
    hierarchy: tuple[int, int] | None = None,
    sibling_affinity: float | None = None,
    min_degree: int = 5,
) -> np.ndarray:
    """Return raw (user, item) pairs with planted cluster structure.

    `pop_scale` (optional [n_items] multiplier) damps/boosts item draw
    weights — used by the cold-item (KG-informative) regime. None keeps
    the historical rng stream bit-for-bit.

    `hierarchy=(n_coarse, n_fine_per)` switches to the HIERARCHICAL
    regime (`n_clusters` is then ignored; fine clusters = the product):
    each user prefers one FINE cluster with `affinity` but also its
    SIBLING fine clusters (same coarse parent) with `sibling_affinity`
    (default affinity/2). With a low `mean_degree`, a user's few train
    edges scatter over the whole coarse family, so identifying the fine
    cluster requires aggregating evidence across structurally similar
    users — the multi-hop / hypergraph-diffusion setting, as opposed to
    the flat regime where 1-hop co-occurrence already carries the
    signal.
    """
    (rng, n_clusters, item_cluster, item_pop, user_main, user_second,
     degrees) = _latent_prelude(
        n_users, n_items, n_clusters, mean_degree, seed, cluster_seed,
        pop_scale, hierarchy, min_degree,
    )

    if user_id_offset is None:
        user_id_offset = n_items

    rows = []
    base = item_pop.copy()
    log_base = np.log(base)
    if hierarchy is not None:
        n_coarse, n_fine_per = hierarchy
        sib = affinity / 2.0 if sibling_affinity is None else sibling_affinity
        item_coarse = item_cluster // n_fine_per
    for u in range(n_users):
        # weighted sampling WITHOUT replacement via the Gumbel top-k
        # trick: argtop(log w + Gumbel) ~ successive draws from p ∝ w
        # (O(n_items) per user; rng.choice(replace=False, p=...) is
        # O(n_items * degree) and dominates build time at ML-1M scale)
        if hierarchy is not None:
            fine = user_main[u]
            logw = log_base + np.log1p(
                affinity * (item_cluster == fine)
                + sib * ((item_coarse == fine // n_fine_per) & (item_cluster != fine))
            )
        else:
            logw = log_base + np.log1p(
                affinity * (item_cluster == user_main[u])
                + 0.5 * affinity * (item_cluster == user_second[u])
            )
        g = rng.gumbel(size=n_items)
        d = degrees[u]
        items = np.argpartition(-(logw + g), d)[:d]
        rows.append(np.stack([np.full(d, user_id_offset + u), items], axis=1))
    pairs = np.concatenate(rows, axis=0)
    return pairs[rng.permutation(len(pairs))]


def generate_kg(
    n_items: int = 4000,
    n_clusters: int = 16,
    n_attrs_per_cluster: int = 8,
    n_relations: int = 4,
    seed: int = 11,
    cluster_seed: int = 7,
    max_triples_per_item: int = 3,
) -> pd.DataFrame:
    """Item->attribute triples; attributes encode (noisy) cluster identity.

    Entity ids: items 0..I-1, attributes I..I+A-1. Relations 0..R-1 (the
    knowledge builder shifts them by +2 to make room for the CF
    relations, parity with data/knowledge.py:54).
    """
    rng = np.random.default_rng(abs(seed))
    item_cluster = _item_clusters(n_items, n_clusters, cluster_seed)
    n_attrs = n_clusters * n_attrs_per_cluster
    triples = []
    for i in range(n_items):
        k = rng.integers(1, max_triples_per_item + 1)
        for _ in range(k):
            # mostly own-cluster attributes, some noise
            c = item_cluster[i] if rng.random() < 0.8 else rng.integers(0, n_clusters)
            a = n_items + c * n_attrs_per_cluster + rng.integers(0, n_attrs_per_cluster)
            r = rng.integers(0, n_relations)
            triples.append((i, r, a))
    df = pd.DataFrame(triples, columns=["h", "r", "t"]).astype(np.int64)
    return df.drop_duplicates(ignore_index=True)


def synthetic_dataset(
    n_users: int = 1890,
    n_items: int = 4000,
    n_clusters: int = 16,
    mean_degree: float = 45.0,
    seed: int = 7,
    with_kg: bool = False,
    train_frac: float = 0.75,
    cold_item_frac: float = 0.0,
    hierarchy: tuple[int, int] | None = None,
    sibling_affinity: float | None = None,
    affinity: float = 8.0,
    min_degree: int = 5,
):
    """Full synthetic bundle: (train_pairs, test_pairs, kg_df | None).

    User entity ids start after item+attribute entities so that KG and CF
    id spaces compose exactly like the reference's processed datasets.

    `cold_item_frac` > 0 switches on the KG-INFORMATIVE regime: that
    fraction of items is damped ~20x in the train draw (kept >= 1 train
    edge each so they stay scoreable) while the test set gains
    cluster-matched interactions for them. Their cluster identity then
    survives mainly in the KG attributes — the setting where KG-aware
    models (KGAT/KHGRec) can separate from CF-only propagation. With
    0.0 the historical rng stream is untouched.
    """
    if hierarchy is not None:
        n_clusters = hierarchy[0] * hierarchy[1]
    n_attrs = n_clusters * 8
    offset = n_items + n_attrs if with_kg else n_items
    rng_cold = np.random.default_rng(seed + 9000)
    pop_scale = None
    cold_items = None
    if cold_item_frac > 0.0:
        cold_items = rng_cold.choice(
            n_items, max(int(n_items * cold_item_frac), 1), replace=False
        )
        pop_scale = np.ones(n_items)
        pop_scale[cold_items] = 0.05
    pairs = generate_interactions(
        n_users, n_items, n_clusters, mean_degree, seed, user_id_offset=offset,
        cluster_seed=seed, pop_scale=pop_scale, hierarchy=hierarchy,
        sibling_affinity=sibling_affinity, affinity=affinity, min_degree=min_degree,
    )
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(len(pairs))
    n_train = int(len(pairs) * train_frac)
    train, test = pairs[perm[:n_train]], pairs[perm[n_train:]]
    if cold_items is not None:
        train, test = _add_cold_item_test(
            train, test, cold_items, n_items, n_clusters, seed, offset, n_users, rng_cold
        )
    kg = generate_kg(n_items, n_clusters, seed=seed + 2, cluster_seed=seed) if with_kg else None
    return train, test, kg


def _add_cold_item_test(
    train, test, cold_items, n_items, n_clusters, seed, user_id_offset, n_users, rng,
    per_item: int = 4,
):
    """Cold-item regime plumbing: guarantee each cold item >= 1 train
    edge (stays in the scoreable catalog) and append cluster-matched
    TEST interactions for it.

    User->cluster affinity is inferred from the train pairs (majority
    cluster of interacted items), so the historical interaction rng
    stream stays untouched.
    """
    item_cluster = _item_clusters(n_items, n_clusters, seed)
    # majority train cluster per user
    u_idx = train[:, 0] - user_id_offset
    votes = np.zeros((n_users, n_clusters), np.int64)
    np.add.at(votes, (u_idx, item_cluster[train[:, 1]]), 1)
    user_cluster = votes.argmax(axis=1)

    # ensure every cold item has at least one train edge
    have = np.zeros(item_cluster.shape[0], bool)
    have[train[:, 1]] = True
    extra_train = []
    for it in cold_items[~have[cold_items]]:
        cand = np.nonzero(user_cluster == item_cluster[it])[0]
        u = int(rng.choice(cand)) if len(cand) else int(rng.integers(0, n_users))
        extra_train.append((user_id_offset + u, it))

    # cluster-matched test interactions for cold items
    extra_test = []
    for it in cold_items:
        cand = np.nonzero(user_cluster == item_cluster[it])[0]
        if len(cand) == 0:
            continue
        us = rng.choice(cand, min(per_item, len(cand)), replace=False)
        extra_test.extend((user_id_offset + int(u), int(it)) for u in us)

    if extra_train:
        train = np.concatenate([train, np.asarray(extra_train, train.dtype)])
    if extra_test:
        test = np.concatenate([test, np.asarray(extra_test, test.dtype)])
    return train, test
