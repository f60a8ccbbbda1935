'''
Copies of the JAX bench's data generator and bias-only floor
(``bench.py:24-44`` ``make_data`` and ``bench.py:85-100``
``bias_floor_rmse``), so that the port's tools and ``chip_smoke.py`` run
without ``bench``.  ``tests/test_torch_tools.py`` pins both to the
originals byte for byte.
'''
from __future__ import annotations

import numpy as np


def make_data(U, I, N, seed=0, rank=16):
    '''MovieLens-shaped ratings with planted low-rank structure: N raw
    draws (duplicate pairs kept), users uniform, items Zipf(1.1), values
    3 + 0.667 * (rank-16 dot / 4 + biases) + noise, rounded to half stars
    in [1, 5].  Returns (users, items, vals): int32, int32, float32.'''
    rng = np.random.default_rng(seed)
    users = rng.integers(0, U, N).astype(np.int32)
    ranks = np.arange(1, I + 1, dtype=np.float64)
    pop = 1.0 / ranks ** 1.1
    pop /= pop.sum()
    items = rng.choice(I, N, p=pop).astype(np.int32)
    P = rng.normal(0, 1.0, (U, rank))
    Q = rng.normal(0, 1.0, (I, rank))
    bu = rng.normal(0, 0.4, U)
    bi = rng.normal(0, 0.6, I)
    raw = np.einsum('nk,nk->n', P[users], Q[items]) / np.sqrt(rank)
    vals = 3.0 + 0.667 * (raw + bu[users] + bi[items]) \
        + rng.normal(0, 0.3, N)
    vals = np.clip(np.round(vals * 2) / 2, 1.0, 5.0).astype(np.float32)
    return users, items, vals


def bias_floor_rmse(users, items, vals, U, I):
    '''Training RMSE of the best mu + b_i + b_u predictor (one bincount
    pass each), the floor a model that learns no structure cannot beat.
    Returns (floor, bu, bi): the biases as float32, for training with
    them fixed.'''
    mu = vals.mean()
    cnt_i = np.bincount(items, minlength=I)
    bi = (np.bincount(items, weights=vals - mu, minlength=I)
          / np.maximum(cnt_i, 1)).astype(np.float32)
    resid = vals - mu - bi[items]
    cnt_u = np.bincount(users, minlength=U)
    bu = (np.bincount(users, weights=resid, minlength=U)
          / np.maximum(cnt_u, 1)).astype(np.float32)
    pred = np.clip(mu + bi[items] + bu[users], 1.0, 5.0)
    return float(np.sqrt(((vals - pred) ** 2).mean())), bu, bi
