"""Interactions with planted cluster structure, and item-attribute KG
triples: a frozen copy of the port's `data/synthetic.py` recipe
(`synthetic_dataset` without its cold-item and hierarchy regimes), which
draws the same numpy streams, so one seed gives the arrays that recipe
gives.

Users carry a main and a second latent cluster, items a cluster and a
Zipf(1.5) popularity clipped to [1, 50]; each user draws a lognormal
number of items without replacement, with weight popularity x (1 +
affinity on the user's clusters), by the Gumbel top-k trick. Raw ids as
the reference's processed KG datasets: items 0..I-1, attribute entities
I..I+A-1, users after them.
"""

from __future__ import annotations

import numpy as np


def _item_clusters(n_items: int, n_clusters: int, cluster_seed: int) -> np.ndarray:
    return np.random.default_rng(abs(cluster_seed) + 1000).integers(0, n_clusters, n_items)


def generate_interactions(n_users: int, n_items: int, n_clusters: int, mean_degree: float,
                          seed: int, user_id_offset: int, affinity: float = 8.0,
                          min_degree: int = 5) -> tuple[np.ndarray, dict]:
    """(raw (user, item) pairs in a random order, the planted structure by
    raw id: `planted`'s dict)."""
    rng = np.random.default_rng(seed)
    item_cluster = _item_clusters(n_items, n_clusters, seed)
    item_pop = np.clip(rng.zipf(1.5, n_items).astype(np.float64), 1, 50)
    user_main = rng.integers(0, n_clusters, n_users)
    user_second = rng.integers(0, n_clusters, n_users)
    degrees = np.clip(rng.lognormal(np.log(mean_degree), 0.6, n_users), min_degree,
                      n_items // 4).astype(int)
    log_base = np.log(item_pop)
    rows = []
    for u in range(n_users):
        logw = log_base + np.log1p(affinity * (item_cluster == user_main[u])
                                   + 0.5 * affinity * (item_cluster == user_second[u]))
        g = rng.gumbel(size=n_items)
        d = degrees[u]
        items = np.argpartition(-(logw + g), d)[:d]
        rows.append(np.stack([np.full(d, user_id_offset + u), items], axis=1))
    pairs = np.concatenate(rows, axis=0)
    latent = planted(user_id_offset + np.arange(n_users), np.stack([user_main, user_second], 1),
                     np.arange(n_items), item_cluster, item_pop, n_clusters)
    return pairs[rng.permutation(len(pairs))], latent


def planted(user_raw, user_clusters, item_raw, item_cluster, item_pop, n_clusters: int) -> dict:
    """The structure a generator planted, by raw id: each user's main and
    second cluster, each item's cluster and popularity."""
    return {"user_raw": user_raw, "user_clusters": user_clusters, "item_raw": item_raw,
            "item_cluster": item_cluster, "item_pop": item_pop, "n_clusters": n_clusters}


def generate_kg(n_items: int, n_clusters: int, seed: int, cluster_seed: int,
                n_attrs_per_cluster: int = 8, n_relations: int = 4,
                max_triples_per_item: int = 3) -> np.ndarray:
    """[n, 3] (h, r, t) item -> attribute triples, mostly of the item's own
    cluster, duplicates dropped (first kept, in draw order)."""
    rng = np.random.default_rng(abs(seed))
    item_cluster = _item_clusters(n_items, n_clusters, cluster_seed)
    triples = []
    for i in range(n_items):
        k = rng.integers(1, max_triples_per_item + 1)
        for _ in range(k):
            c = item_cluster[i] if rng.random() < 0.8 else rng.integers(0, n_clusters)
            a = n_items + c * n_attrs_per_cluster + rng.integers(0, n_attrs_per_cluster)
            r = rng.integers(0, n_relations)
            triples.append((i, r, a))
    arr = np.asarray(triples, np.int64)
    _, first = np.unique(arr, axis=0, return_index=True)
    return arr[np.sort(first)]


def generate(params: dict, seed: int, device=None):
    """(train pairs, test pairs, kg triples or None, the planted structure),
    raw ids, int64 numpy.
    `params`: n_users, n_items, n_clusters, mean_degree, with_kg,
    train_frac. `device` is unused: the recipe draws on the host."""
    n_items, n_clusters = params["n_items"], params["n_clusters"]
    with_kg = params["with_kg"]
    offset = n_items + n_clusters * 8 if with_kg else n_items
    pairs, latent = generate_interactions(params["n_users"], n_items, n_clusters,
                                          params["mean_degree"], seed, offset)
    perm = np.random.default_rng(seed + 1).permutation(len(pairs))
    n_train = int(len(pairs) * params["train_frac"])
    train, test = pairs[perm[:n_train]], pairs[perm[n_train:]]
    kg = generate_kg(n_items, n_clusters, seed=seed + 2, cluster_seed=seed) if with_kg else None
    return train, test, kg, latent
