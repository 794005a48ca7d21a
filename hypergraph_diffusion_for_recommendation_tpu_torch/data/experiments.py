"""Experiment variants — the port's copy of the JAX package's
`data/experiments.py` (numpy, seeded: the same seed gives the same arrays),
parity with reference `dataset_util.py` and the experiment-aware loading in
`SELFRec.py:12-33`.

Given a base (train, test) split of raw (user, item) pairs, produce the
robustness-matrix variants:
  * full         — unchanged;
  * missing p%   — drop the LAST p% * total interactions from train
                   (dataset_util.py:39-59 keeps the head of the
                   shuffled train list);
  * add_noise p% — replace p% * total randomly-chosen train rows' items
                   with a uniform draw from the user's non-interacted
                   items (dataset_util.py:115-199);
  * cold_start g — split by user-degree quartiles of the TRAIN set and
                   keep only test rows of users in group g
                   (dataset_util.py:61-109; group 1 = lightest users).
"""

from __future__ import annotations

import numpy as np


def make_split(pairs: np.ndarray, rng: np.random.Generator, train_frac: float = 0.75):
    """75/25 random split (dataset_util.py:20-37)."""
    n = len(pairs)
    perm = rng.permutation(n)
    n_train = int(n * train_frac)
    return pairs[perm[:n_train]], pairs[perm[n_train:]]


def missing_variant(train: np.ndarray, test: np.ndarray, pct: int, rng: np.random.Generator):
    """Drop pct% of TOTAL interactions from train (tail of a shuffle)."""
    n_total = len(train) + len(test)
    n_missing = int(n_total * pct / 100.0)
    perm = rng.permutation(len(train))
    keep = perm[: max(len(train) - n_missing, 0)]
    return train[np.sort(keep)], test


def add_noise_variant(train: np.ndarray, test: np.ndarray, pct: int, rng: np.random.Generator):
    """Replace pct%*total random train rows' items with unseen items.

    The non-interacted pool is computed over train+test per user and
    items are drawn uniformly from it (dataset_util.py:134-186).
    """
    n_total = len(train) + len(test)
    n_noise = min(int(n_total * pct / 100.0), len(train))
    all_items = np.unique(np.concatenate([train[:, 1], test[:, 1]])) if len(test) else np.unique(train[:, 1])
    item_set = set(all_items.tolist())

    seen: dict[int, set] = {}
    for u, i in np.concatenate([train, test])[:, :2]:
        seen.setdefault(int(u), set()).add(int(i))

    idx_noise = rng.choice(len(train), size=n_noise, replace=False)
    keep_mask = np.ones(len(train), bool)
    keep_mask[idx_noise] = False
    noisy = train[idx_noise].copy()
    for k in range(len(noisy)):
        u = int(noisy[k, 0])
        pool = list(item_set - seen.get(u, set()))
        if pool:
            noisy[k, 1] = pool[rng.integers(len(pool))]
    out = np.concatenate([train[keep_mask], noisy])
    return out[rng.permutation(len(out))], test


def cold_start_variant(train: np.ndarray, test: np.ndarray, group_id: int):
    """Filter test to users in the requested train-degree quartile group.

    Quartile boundaries are inclusive on both sides exactly as the
    reference's pandas filters (dataset_util.py:85-95), so boundary
    users may belong to two groups.
    """
    users, counts = np.unique(train[:, 0], return_counts=True)
    q1, q2, q3 = np.quantile(counts, [0.25, 0.5, 0.75])
    if group_id == 1:
        sel = users[counts <= q1]
    elif group_id == 2:
        sel = users[(counts >= q1) & (counts <= q2)]
    elif group_id == 3:
        sel = users[(counts >= q2) & (counts <= q3)]
    else:
        sel = users[counts >= q3]
    sel_set = set(sel.tolist())
    mask = np.array([int(u) in sel_set for u in test[:, 0]])
    return train, test[mask] if len(test) else test


def apply_experiment(
    train: np.ndarray,
    test: np.ndarray,
    experiment: str,
    seed: int = 0,
    missing_pct: int = 0,
    noise_pct: int = 0,
    group_id: int = 1,
):
    rng = np.random.default_rng(seed)
    if experiment == "full":
        return train, test
    if experiment == "missing":
        return missing_variant(train, test, missing_pct, rng)
    if experiment == "add_noise":
        return add_noise_variant(train, test, noise_pct, rng)
    if experiment == "cold_start":
        return cold_start_variant(train, test, group_id)
    raise ValueError(f"Unknown experiment: {experiment}")
