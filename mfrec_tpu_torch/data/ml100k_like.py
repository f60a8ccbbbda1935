'''
ML-100K-faithful synthetic dataset for acceptance runs.

The sandbox has no network, so the real MovieLens-100K ``u1.base`` /
``u1.test`` files (the reference's only driver input,
``mfrec/examples/example1b_movielens_100k_wrmf.py:23-27``) cannot be
fetched.  This generator reproduces the published ML-100K marginals so
the acceptance floors (tests/test_acceptance_ml100k.py) are pinned on
data with the real splits' SHAPE, not a convenience draw:

  * 943 users x 1,682 items, exactly 100,000 ratings;
  * the exact global rating histogram
    {1: 6,110, 2: 11,370, 3: 27,145, 4: 34,174, 5: 21,201}
    (enforced by quantile-mapping the latent scores);
  * every user has >= 20 ratings (the MovieLens collection rule), with a
    long-tailed per-user count distribution (lognormal; ML-100K: min 20,
    median ~65, max 737);
  * a Zipf-tailed item popularity (ML-100K: top item 583 ratings,
    median ~27);
  * genuine latent structure (low-rank + user/item biases + noise) so
    models that learn structure beat bias-only baselines by a real
    margin, as on the true data.

If real ML-100K files ARE present (path pointing at ``u.data``-format
TSV), ``load_or_generate`` prefers them.

Copied from ``mfrec_tpu/data/ml100k_like.py`` (numpy only; that package
imports jax): the same seed gives the same arrays.
'''
from __future__ import annotations

import os

import numpy as np

N_USERS = 943
N_ITEMS = 1682
N_RATINGS = 100_000
# published ML-100K global rating histogram
RATING_COUNTS = {1: 6110, 2: 11370, 3: 27145, 4: 34174, 5: 21201}


def _user_counts(rng):
    '''Per-user rating counts: >= 20 each, lognormal tail, summing to
    exactly N_RATINGS (ML-100K: min 20, median ~65, mean ~106, max 737).'''
    raw = np.exp(rng.normal(0.0, 1.0, N_USERS))
    extra = raw / raw.sum() * (N_RATINGS - 20 * N_USERS)
    counts = 20 + np.floor(extra).astype(np.int64)
    counts = np.minimum(counts, N_ITEMS)          # can't exceed catalog
    # distribute the rounding remainder one-by-one to users with room
    short = N_RATINGS - int(counts.sum())
    order = rng.permutation(N_USERS)
    j = 0
    while short > 0:
        u = order[j % N_USERS]
        if counts[u] < N_ITEMS:
            counts[u] += 1
            short -= 1
        j += 1
    return counts


def generate(seed=0, rank=8):
    '''Returns (users, items, values) int32/int32/float32 arrays with the
    marginals described in the module docstring.'''
    rng = np.random.default_rng(seed)
    counts = _user_counts(rng)

    # Zipf item popularity over a shuffled catalog
    ranks = np.arange(1, N_ITEMS + 1, dtype=np.float64)
    pop = 1.0 / ranks ** 0.9
    pop /= pop.sum()
    item_of_rank = rng.permutation(N_ITEMS)

    users = np.repeat(np.arange(N_USERS, dtype=np.int32), counts)
    items = np.empty(N_RATINGS, np.int32)
    pos = 0
    for u in range(N_USERS):
        c = int(counts[u])
        # without-replacement popularity draw per user (each user rates
        # an item at most once, like the real data)
        chosen = rng.choice(N_ITEMS, size=c, replace=False, p=pop)
        items[pos:pos + c] = item_of_rank[chosen]
        pos += c

    # latent structure: low-rank + biases + noise.  The low-rank term is
    # weighted so factor models beat the bias-only floor by a real-data
    # margin (ML-100K: biased SGD gains ~0.03-0.05 RMSE over bias-only)
    P = rng.normal(0, 1.0, (N_USERS, rank))
    Q = rng.normal(0, 1.0, (N_ITEMS, rank))
    bu = rng.normal(0, 0.7, N_USERS)
    bi = rng.normal(0, 0.9, N_ITEMS)
    score = (1.5 * np.einsum('nk,nk->n', P[users], Q[items]) / np.sqrt(rank)
             + bu[users] + bi[items] + rng.normal(0, 0.5, N_RATINGS))

    # quantile-map scores onto the EXACT published rating histogram
    order = np.argsort(score, kind='stable')
    values = np.empty(N_RATINGS, np.float32)
    start = 0
    for r in (1, 2, 3, 4, 5):
        c = RATING_COUNTS[r]
        values[order[start:start + c]] = float(r)
        start += c
    return users, items, values


def u1_split(seed=0, rank=8):
    '''ML-100K ``u1`` analogue: a deterministic 80,000 / 20,000 split of
    the generated ratings.  Returns ((u, i, v) train, [n, 3] test).'''
    users, items, values = generate(seed=seed, rank=rank)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(N_RATINGS)
    tr, te = perm[:80_000], perm[80_000:]
    test = np.stack([users[te], items[te], values[te]], axis=1)
    return (users[tr], items[tr], values[tr].astype(np.float32)), test


def load_or_generate(base_path=None, seed=0):
    '''Prefer real ML-100K ``u1.base``/``u1.test`` files when available
    (u.data format: user \\t item \\t rating \\t ts, 1-based ids);
    otherwise generate the faithful synthetic split.'''
    if base_path:
        b = os.path.join(base_path, 'u1.base')
        t = os.path.join(base_path, 'u1.test')
        if os.path.exists(b) and os.path.exists(t):
            tr = np.loadtxt(b, dtype=np.int64)
            te = np.loadtxt(t, dtype=np.int64)
            return ((tr[:, 0].astype(np.int32) - 1,
                     tr[:, 1].astype(np.int32) - 1,
                     tr[:, 2].astype(np.float32)),
                    np.stack([te[:, 0] - 1, te[:, 1] - 1, te[:, 2]],
                             axis=1).astype(np.float64), True)
    (u, i, v), test = u1_split(seed=seed)
    return (u, i, v), test.astype(np.float64), False
