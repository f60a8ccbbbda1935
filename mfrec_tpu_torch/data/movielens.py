'''
Synthetic MovieLens-shaped ratings, the train/test split and
``ratings_from_arrays``, copied from ``mfrec_tpu/data/movielens.py``
(that package imports jax).  The file loaders are not ported yet.
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu_torch.data.ratings import Ratings


def ratings_from_arrays(users, items, values, nbr_users=None, nbr_items=None):
    users = np.asarray(users, np.int32)
    items = np.asarray(items, np.int32)
    values = np.asarray(values, np.float32)
    if nbr_users is None:
        nbr_users = int(users.max()) + 1
    if nbr_items is None:
        nbr_items = int(items.max()) + 1
    r = Ratings(nbr_users, nbr_items)
    r.set_many(users, items, values)
    return r


def synthetic_ratings(nbr_users=500, nbr_items=300, nbr_ratings=8000,
                      rank=6, seed=0, min_rating=1.0, max_rating=5.0,
                      zipf_items=1.1):
    '''Synthetic explicit-feedback ratings with planted low-rank structure.

    Users are sampled uniformly; item popularity follows a Zipf-like tail
    (like MovieLens).  True ratings = clipped affine map of a rank-`rank`
    factor model plus user/item biases and noise, rounded to half stars.
    Returns (users, items, values) with duplicates removed.
    '''
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 1.0, (nbr_users, rank))
    Q = rng.normal(0, 1.0, (nbr_items, rank))
    bu = rng.normal(0, 0.4, nbr_users)
    bi = rng.normal(0, 0.6, nbr_items)

    n_draw = int(nbr_ratings * 1.5)
    users = rng.integers(0, nbr_users, n_draw)
    ranks = np.arange(1, nbr_items + 1, dtype=np.float64)
    pop = 1.0 / ranks ** zipf_items
    pop /= pop.sum()
    item_order = rng.permutation(nbr_items)
    items = item_order[rng.choice(nbr_items, n_draw, p=pop)]

    key = users.astype(np.int64) * nbr_items + items
    _, first = np.unique(key, return_index=True)
    # a RANDOM subset of the unique pairs: np.unique returns indices in
    # key order, so truncating directly would keep only the smallest
    # (user, item) keys — silently dropping every high-id user from the
    # dataset (a "300-user" draw kept ~207 rated users)
    first = rng.permutation(first)[:nbr_ratings]
    users, items = users[first], items[first]

    mu = (min_rating + max_rating) / 2.0
    scale = (max_rating - min_rating) / 6.0
    raw = (P[users] * Q[items]).sum(-1) / np.sqrt(rank)
    vals = mu + scale * (raw + bu[users] + bi[items]) + rng.normal(0, 0.3, users.shape[0])
    vals = np.clip(np.round(vals * 2) / 2, min_rating, max_rating)
    # avoid explicit zeros which a sparse store would drop
    vals[vals == 0.0] = min_rating
    return users.astype(np.int32), items.astype(np.int32), vals.astype(np.float32)


def train_test_split(users, items, values, test_fraction=0.2, seed=0):
    rng = np.random.default_rng(seed)
    n = users.shape[0]
    perm = rng.permutation(n)
    n_test = int(n * test_fraction)
    te, tr = perm[:n_test], perm[n_test:]
    train = (users[tr], items[tr], values[tr])
    test = np.stack([users[te].astype(np.float64),
                     items[te].astype(np.float64),
                     values[te].astype(np.float64)], axis=1)
    return train, test
