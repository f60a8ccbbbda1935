'''
The data laws of the benchmark's configurations, made from the seed.

* ``user_counts``: a heavy-tailed number of ratings a user (a log-normal
  weight over a floor, capped), summing exactly to the configuration's
  total; every seed deals the same set of counts, in its own order.
* ``explicit_ratings``: the repository's ``synthetic_ratings`` law
  (``mfrec_tpu_torch/data/movielens.py``): a planted rank-16 model plus
  user and item biases and noise, rounded to half stars, items Zipf(1.1)
  over a random order.  Two changes: each user draws exactly its count of
  distinct items (so the store keeps the configuration's total, where the
  original's duplicate draws kept 8,346,084 of 10,000,000), and users
  follow ``user_counts`` instead of a uniform law.
* ``implicit_interactions``: the taste-cluster law of ``bench.py``'s
  ``make_implicit_data`` (32 clusters, each a gamma(0.3) affinity over the
  Zipf(1.1) popularity), with the same per-user counts and no duplicates.

A user's items are drawn without replacement in proportion to their
weights by the Gumbel top-k rule, on the device in blocks of users.
'''
from __future__ import annotations

from statistics import NormalDist

import numpy as np
import torch

BLOCK_USERS = 4096


def user_counts(U, N, seed, floor=20, sigma=1.35, cap=7359):
    """Ratings a user: ``floor`` plus a share of the rest in proportion to
    a log-normal(0, sigma) weight, no user above ``cap``; int64 [U]
    summing to N.  The weights are the law's U quantiles, dealt to the
    users in an order drawn from the seed, so that every seed has the
    same set of counts.  The shares are filled with the capped users taken
    out and the fractions handed out by largest remainder."""
    extra = int(N) - floor * U
    if extra < 0 or N > cap * U:
        raise ValueError('%d ratings do not fit %d users in [%d, %d]'
                         % (N, U, floor, cap))
    z = NormalDist().inv_cdf
    w = np.exp(sigma * np.array([z((j + 0.5) / U) for j in range(U)]))
    w = w[np.random.default_rng([int(seed), 1]).permutation(U)]
    share = np.zeros(U)
    free = np.ones(U, bool)
    left = float(extra)
    while True:
        share[free] = left * w[free] / w[free].sum()
        over = free & (share > cap - floor)
        if not over.any():
            break
        share[over] = cap - floor
        left -= (cap - floor) * int(over.sum())
        free &= ~over
    base = np.floor(share).astype(np.int64)
    short = extra - int(base.sum())
    if short:
        frac = np.where(base < cap - floor, share - base, -1.0)
        base[np.argsort(-frac, kind='stable')[:short]] += 1
    return base + floor


def _gumbel_pick(log_w, counts, gen, device):
    '''For each row of ``log_w`` [R, I] (or one row for all), ``counts[r]``
    distinct columns drawn without replacement in proportion to exp(log_w)
    (Gumbel top-k).  Returns (row, column) int64 tensors, row-major with
    columns ascending.'''
    R = counts.shape[0]
    I = log_w.shape[-1]
    u = torch.rand((R, I), generator=gen, device=device)
    key = log_w - torch.log(-torch.log(u.clamp_min_(1e-30)))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    keep = torch.arange(I, device=device)[None, :] < counts[:, None]
    sel = torch.zeros((R, I), dtype=torch.bool, device=device)
    sel.scatter_(1, order, keep)
    return torch.nonzero(sel, as_tuple=True)


def _pairs(U, I, counts, log_w_of, gen, device):
    '''All users' (user, item) pairs, block by block of users.'''
    cnt = torch.from_numpy(counts).to(device)
    users, items = [], []
    for lo in range(0, U, BLOCK_USERS):
        hi = min(lo + BLOCK_USERS, U)
        r, c = _gumbel_pick(log_w_of(lo, hi), cnt[lo:hi], gen, device)
        users.append(r + lo)
        items.append(c)
    return torch.cat(users), torch.cat(items)


def _zipf_log_pop(I, zipf, gen, device):
    '''log popularity of each item: Zipf(``zipf``) over a random order.'''
    ranks = torch.randperm(I, generator=gen, device=device) + 1
    return -float(zipf) * torch.log(ranks.double()).float()


def planted_model(U, I, rank, gen, device):
    '''The law's planted factors and biases: P [U, rank], Q [I, rank]
    N(0, 1), bu N(0, 0.4), bi N(0, 0.6), float32 on ``device``.'''
    P = torch.randn((U, rank), generator=gen, device=device)
    Q = torch.randn((I, rank), generator=gen, device=device)
    bu = 0.4 * torch.randn((U,), generator=gen, device=device)
    bi = 0.6 * torch.randn((I,), generator=gen, device=device)
    return P, Q, bu, bi


def rating_values(u, i, planted, gen, lo=1.0, hi=5.0):
    '''The law's value of each (u, i): ``(lo+hi)/2 + (hi-lo)/6 * (P_u.Q_i
    / sqrt(rank) + bu + bi) + N(0, 0.3)``, rounded to half stars, clipped
    to [lo, hi].'''
    P, Q, bu, bi = planted
    rank = P.shape[1]
    out = torch.empty(u.shape[0], dtype=torch.float32, device=u.device)
    step = 1 << 22
    for s in range(0, u.shape[0], step):
        uu, ii = u[s:s + step], i[s:s + step]
        raw = (P[uu] * Q[ii]).sum(1) / float(np.sqrt(rank))
        v = (lo + hi) / 2.0 + (hi - lo) / 6.0 * (raw + bu[uu] + bi[ii])
        v = v + 0.3 * torch.randn(v.shape, generator=gen, device=u.device)
        out[s:s + step] = torch.clamp(torch.round(v * 2.0) / 2.0, lo, hi)
    return out


def make_generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def explicit_ratings(spec, seed, device):
    '''The explicit law of ``spec`` (a configuration's ``data``): returns
    numpy (users int32, items int32, values float32), user-major with
    items ascending, no duplicate pair, and the planted model (device
    tensors).'''
    U, I, N = spec['users'], spec['items'], spec['ratings']
    counts = user_counts(U, N, seed, **spec['activity'])
    gen = make_generator(seed, device)
    log_pop = _zipf_log_pop(I, spec['zipf_items'], gen, device)
    u, i = _pairs(U, I, counts, lambda lo, hi: log_pop[None, :], gen,
                  device)
    planted = planted_model(U, I, spec['rank'], gen, device)
    v = rating_values(u, i, planted, gen, spec['min_rating'],
                      spec['max_rating'])
    out = (u.to(torch.int32).cpu().numpy(), i.to(torch.int32).cpu().numpy(),
           v.cpu().numpy())
    return out, planted


def implicit_interactions(spec, seed, device):
    '''The taste-cluster law of ``spec``: numpy (users int32, items int32,
    values float32 ones), user-major with items ascending, no duplicate
    pair.'''
    U, I, N = spec['users'], spec['items'], spec['ratings']
    counts = user_counts(U, N, seed, **spec['activity'])
    gen = make_generator(seed, device)
    log_pop = _zipf_log_pop(I, spec['zipf_items'], gen, device)
    C = int(spec['clusters'])
    # the clusters' sizes and affinities are the same for every seed: the
    # users are dealt to them in an order drawn from the seed, and the
    # affinities follow the items' random order
    cu = torch.from_numpy(np.random.default_rng([int(seed), 2]).permutation(
        np.arange(U) % C)).to(device)
    aff = np.random.default_rng(0).gamma(
        float(spec['affinity_shape']), 1.0, (C, I))
    order = torch.argsort(log_pop, descending=True, stable=True)
    log_aff = torch.empty((C, I), device=device)
    log_aff[:, order] = torch.from_numpy(
        np.log(np.maximum(aff, 1e-30))).float().to(device)
    log_w = log_aff + log_pop[None, :]
    u, i = _pairs(U, I, counts, lambda lo, hi: log_w[cu[lo:hi]], gen, device)
    n = u.shape[0]
    return (u.to(torch.int32).cpu().numpy(), i.to(torch.int32).cpu().numpy(),
            np.ones(n, np.float32))

