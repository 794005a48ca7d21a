"""Interactions with planted cluster structure at a published interaction
count, drawn in blocks of users on the device.

The recipe of `synthetic_recipe.py` (Zipf(1.5) item popularity clipped to
[1, 50], a main and a second cluster per user with `affinity` and half of
it, weighted draws without replacement by the Gumbel top-k trick), with
four changes that a catalog of 90k items and 3M interactions needs:

  * the Gumbel keys of a block of users are drawn and ranked on the device
    in one [block, items] tensor, not user by user on the host;
  * the lognormal degrees are scaled to add up to `n_interactions`
    exactly, each at least `min_degree` (the dataset's k-core), and are the
    same values for every seed, in another order (`_degrees`);
  * each user's draws are split into train and test by a uniform key of
    their own, `train_share` of them (rounded, at least one) to train, as
    a per-user random split;
  * every item gets a training pair, so that the catalog is the published
    one (`_cover_items`): a few thousand of 2.4M pairs change their item.

Deterministic for a seed on one kind of device: the small latent arrays
come from numpy, the [block, items] keys from a `torch.Generator` there.
Raw ids: items 0..I-1, users I..I+U-1.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np
import torch

from .synthetic_recipe import planted


def _degrees(rng: np.random.Generator, n_users: int, total: int, sigma: float,
             lo: int, hi: int) -> np.ndarray:
    """Lognormal degrees in [lo, hi] that add up to `total`: the same values
    for every seed (the lognormal's quantiles at (k + 0.5) / n, rounded, the
    largest moved by one until they add up), dealt to the users in an order
    drawn from `rng`, so that a seed changes who has which degree and not the
    work (the widest user sets the width of the ranking's mask)."""
    z = np.array([NormalDist().inv_cdf((k + 0.5) / n_users) for k in range(n_users)])
    raw = np.exp(sigma * z)
    deg = np.clip(np.rint(raw * (total / raw.sum())), lo, hi).astype(np.int64)
    order = np.argsort(-deg, kind="stable")
    diff = int(total - deg.sum())
    while diff:
        step = 1 if diff > 0 else -1
        can = order[(deg[order] < hi) if step > 0 else (deg[order] > lo)]
        take = can[: abs(diff)]
        if take.size == 0:
            raise ValueError(f"{total} interactions do not fit {n_users} users in [{lo}, {hi}]")
        deg[take] += step
        diff -= step * take.size
    return deg[rng.permutation(n_users)]


def _cover_items(train: np.ndarray, test: np.ndarray, n_items: int, n_users: int,
                 rng: np.random.Generator):
    """Every item in a training pair, each user's degree and split kept: an
    item with test pairs only trades places with a training pair (u, j) of
    the first of those users, j an item with another training pair; an item
    never drawn takes the place of j in a random training pair (u, j) of a
    user without it."""
    count = np.bincount(train[:, 1], minlength=n_items)
    missing = np.flatnonzero(count == 0)
    if not missing.size:
        return train, test
    user = train[:, 0] - n_items
    order = np.argsort(user, kind="stable")
    bounds = np.searchsorted(user[order], np.arange(n_users + 1))
    t_order = np.argsort(test[:, 1], kind="stable")
    t_bounds = np.searchsorted(test[t_order, 1], np.arange(n_items + 1))
    spare = iter(rng.permutation(len(train)))
    for m in missing:
        t_rows = t_order[t_bounds[m]:t_bounds[m + 1]]
        if t_rows.size:
            tr = t_rows[0]
            rows = order[bounds[test[tr, 0] - n_items]:bounds[test[tr, 0] - n_items + 1]]
            cand = rows[count[train[rows, 1]] >= 2]
            if cand.size:
                j = cand[rng.integers(cand.size)]
                count[train[j, 1]] -= 1
                count[m] += 1
                train[j, 1], test[tr, 1] = m, train[j, 1]
                continue
        holders = set(test[t_rows, 0].tolist())
        j = next(j for j in spare if count[train[j, 1]] >= 2 and train[j, 0] not in holders)
        count[train[j, 1]] -= 1
        count[m] += 1
        train[j, 1] = m
    return train, test


def generate(params: dict, seed: int, device=None):
    """(train pairs, test pairs, None, the planted structure): raw ids, int64
    numpy. `params`:
    n_users, n_items, n_interactions, n_clusters, min_degree,
    degree_sigma, affinity, train_share, block_users."""
    device = torch.device("cuda" if device is None else device)
    n_users, n_items = params["n_users"], params["n_items"]
    k, affinity = params["n_clusters"], params["affinity"]
    rng = np.random.default_rng(seed)
    item_cluster = rng.integers(0, k, n_items)
    item_pop = np.clip(rng.zipf(1.5, n_items).astype(np.float64), 1, 50)
    user_main = rng.integers(0, k, n_users)
    user_second = rng.integers(0, k, n_users)
    deg = _degrees(rng, n_users, params["n_interactions"], params["degree_sigma"],
                   params["min_degree"], n_items // 4)
    n_train = np.maximum(np.rint(deg * params["train_share"]), 1).astype(np.int64)

    gen = torch.Generator(device).manual_seed(seed)
    cl = torch.as_tensor(item_cluster, device=device)
    log_pop = torch.as_tensor(np.log(item_pop), dtype=torch.float32, device=device)
    train, test = [], []
    block = params["block_users"]
    for s in range(0, n_users, block):
        e = min(s + block, n_users)
        main = torch.as_tensor(user_main[s:e], device=device)[:, None]
        second = torch.as_tensor(user_second[s:e], device=device)[:, None]
        logw = log_pop + torch.log1p(affinity * (cl == main).float()
                                     + 0.5 * affinity * (cl == second).float())
        u = torch.rand(logw.shape, generator=gen, device=device).clamp_(min=1e-12)
        logw -= torch.log(-torch.log(u))  # + Gumbel(0, 1)
        d = torch.as_tensor(deg[s:e], device=device)
        kmax = int(deg[s:e].max())
        items = torch.topk(logw, kmax, dim=1).indices  # a block's draws, in draw order
        del logw, u
        slot = torch.arange(kmax, device=device)[None, :]
        valid = slot < d[:, None]
        key = torch.rand(items.shape, generator=gen, device=device).masked_fill_(~valid, 2.0)
        rank = torch.argsort(torch.argsort(key, dim=1), dim=1)
        is_train = rank < torch.as_tensor(n_train[s:e], device=device)[:, None]
        users = (torch.arange(s, e, device=device)[:, None] + n_items).expand_as(items)
        for mask, out in ((valid & is_train, train), (valid & ~is_train, test)):
            out.append(torch.stack([users[mask], items[mask]], dim=1).cpu().numpy())
    train, test = _cover_items(np.concatenate(train), np.concatenate(test), n_items, n_users, rng)
    # the pairs in a random order, as a file of interactions would list them
    latent = planted(n_items + np.arange(n_users), np.stack([user_main, user_second], 1),
                     np.arange(n_items), item_cluster, item_pop, k)
    return (train[rng.permutation(len(train))].astype(np.int64),
            test[rng.permutation(len(test))].astype(np.int64), None, latent)
