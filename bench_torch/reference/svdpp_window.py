'''
Plain PyTorch reference of SVD++ (Y. Koren, "Factorization meets the
neighborhood: a multifaceted collaborative filtering model", KDD 2008)
by sorted-window alternating epochs, as the configuration states it:

    r_hat_ui = mu + b_u + b_i + q_i . (p_u + |N(u)|^-1/2 sum_{j in N(u)} y_j)

with N(u) the items u rated.  An epoch has five phases:

1. A[u] = |N(u)|^-1/2 sum_{j in N(u)} y_j;
2. a user half-pass on the effective rows Peff = [P + A | b_u | 1]
   against [Q | 1 | b_i] fixed, then P = Peff - A;
3. an item half-pass on [Q | 1 | b_i] against Peff fixed;
4. G[u] = |N(u)|^-1/2 sum_{i in N(u)} err_ui q_i, the errors from Peff
   and the new Q, the prediction clamped to [lo, hi];
5. y_j += lr * mean over each batch's ratings of j of (G[u] - K y_j),
   item by item along its batches in batch order, y_j as the batch
   before left it.

A half-pass sorts the ratings by the updated side's key (ties in the
other key's order) and cuts them into batches of at most ``batch``
ratings whose keys span fewer than ``window`` rows.  Within a batch each
updated row takes ``sweeps`` gradient steps on the mean of its ratings'
gradients, its other rows untouched; a row that spans several batches
takes them in batch order.  Rows are independent, so a half-pass (and
phase 5) is computed as waves: wave j holds every row's j-th batch, and
a wave is taken in blocks of whole rows of at most ``BLOCK`` entries, so
that at the Netflix Prize shape it fits on the card beside nothing else.

Departures from Koren's per-rating SGD, each the configuration's:

* the biases are fixed BellKor biases (mean, then item bias ``sum / (K3
  + n)``, then user bias over the item-adjusted residuals ``sum / (K2 +
  n)``), computed here from the ratings, not learned;
* the steps are row means over sorted windows, not one rating at a time;
* each batch takes T sweeps against the same fixed rows;
* Y steps once an epoch, after both half-passes, from the aggregated
  user errors G, not with each rating.

Precision (the configuration's): factors float32; the fixed side's rows
float32; the updated rows read in bfloat16 for the prediction; each
aggregated term (a gradient ``err * q``, a Y row, an error-weighted Q
row, a Y step term) rounded to bfloat16 before its float32 sum; the
prediction ``mu + p.q`` clamped to [lo, hi].  With
``dtype=torch.bfloat16`` every float32 quantity is held in bfloat16: the
control.  No code of the program is used.
'''
from __future__ import annotations

import numpy as np
import torch

from reference.sgd_window import (batch_bounds, bellkor_biases,
                                  column_rates, params_of)

# entries a block of a wave holds at most (a row's batch segment is never
# split): ~3 GB of temporaries at k = 102
BLOCK = 1 << 21


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _cuts(key, block):
    '''Start offsets of blocks of at most ``block`` entries (unless one
    row has more) over ``key``, sorted, cut only where the key changes;
    with the end appended.'''
    n = int(key.numel())
    if n == 0:
        return [0]
    starts = torch.nonzero(torch.diff(key, prepend=key[:1] - 1))[:, 0]
    want = torch.arange(0, n, block, device=key.device)
    at = torch.searchsorted(starts, want).clamp(max=starts.numel() - 1)
    cuts = torch.unique(starts[at]).tolist()
    return cuts + [n]


class Side:
    '''One half-pass's plan, built on the device: the entries sorted by
    (updated key, other key), cut into batches, and reordered wave by
    wave (wave j: every row's j-th batch, sorted by key), each wave in
    blocks of whole rows.  ``key``, ``other`` int32, ``val`` float32;
    ``waves`` [(start, end, cuts)]; the counts the yardstick needs.'''

    def __init__(self, upd, fix, v, batch, window, device, waves=True,
                 block=BLOCK):
        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                device)

        up, fx = t(upd, np.int64), t(fix, np.int64)
        width = int(fx.max()) + 1 if fx.numel() else 1
        # the pairs are distinct: sorting by (upd, fix) is one order
        order = torch.argsort(up * width + fx)
        key, other = up[order], fx[order]
        del up, fx
        val = t(v, np.float32)[order]
        del order
        bounds = batch_bounds(key.cpu().numpy(), batch, window)
        nb = bounds.shape[0] - 1
        b_of = torch.repeat_interleave(
            torch.arange(nb, device=device),
            torch.from_numpy(np.diff(bounds)).to(device))
        self.n = int(key.numel())
        self.rows = int(torch.unique(key).numel())
        self.segments = int(torch.unique(key * (nb + 1) + b_of).numel())
        self.fixed_rows = int(torch.unique(other).numel())
        self.batches = int(nb)
        self.waves = []
        if not (waves and self.n):
            return
        wave = b_of - b_of[torch.searchsorted(key, key)]
        del b_of
        # stable: a wave keeps the sorted order
        by_wave = torch.sort(wave, stable=True)
        counts = torch.bincount(wave).tolist()
        del wave
        perm = by_wave.indices
        self.key = key[perm].to(torch.int32)
        self.other = other[perm].to(torch.int32)
        self.val = val[perm]
        del perm, key, other, val
        s = 0
        for c in counts:
            cuts = [s + x for x in _cuts(self.key[s:s + c], block)]
            self.waves.append((s, s + c, cuts))
            s += c

    def blocks(self):
        '''Each block: (wave index, key, other, val) slices.'''
        for w, (_, _, cuts) in enumerate(self.waves):
            for a, b in zip(cuts[:-1], cuts[1:]):
                yield w, self.key[a:b], self.other[a:b], self.val[a:b]


def half_pass(F_upd, F_fix, side, lrv, regv, mu, sweeps, lo, hi, dtype,
              keep=None):
    '''One half-pass in place on ``F_upd`` [rows, k+2]; returns its SSE
    (the first sweep's residuals) as a 0-dim float32 tensor.  ``keep``: a
    fault's rule leaving some ratings out (a function of a block's entry
    count returning a bool mask), else None.'''
    ffull = F_fix.to(dtype)
    sse = torch.zeros((), dtype=torch.float32, device=F_upd.device)
    for _, key, fix, val in side.blocks():
        if keep is not None:
            m = keep(key.shape[0])
            key, fix, val = key[m], fix[m], val[m]
        rows, inv = torch.unique_consecutive(key.long(), return_inverse=True)
        cnt = torch.bincount(inv, minlength=rows.shape[0]).to(torch.float32)
        den = cnt.clamp(min=1.0)[:, None].to(dtype)
        alive = (cnt > 0).to(dtype)[:, None]
        ff = ffull[fix.long()]
        vv = val.to(dtype)
        x = F_upd[rows].to(dtype)
        for t in range(sweeps):
            fu = _bf16(x)[inv]
            dot = (fu * ff).sum(1)
            err = vv - torch.clamp(mu + dot, lo, hi)
            if t == 0:
                sse += (err.float() * err.float()).sum()
            acc = torch.zeros_like(x)
            acc.index_add_(0, inv, _bf16(err[:, None] * ff))
            x = x + lrv * (acc / den - regv * x * alive)
        F_upd[rows] = x.to(F_upd.dtype)
    return sse


def user_sums(target, side, rows_of, keep=None):
    '''``target[u] += sum over u's ratings of bf16(rows_of(u, i, r))`` in
    blocks of the user side's entries; returns ``target``.'''
    for _, key, fix, val in side.blocks():
        if keep is not None:
            m = keep(key.shape[0])
            key, fix, val = key[m], fix[m], val[m]
        u = key.long()
        target.index_add_(0, u, _bf16(rows_of(u, fix.long(), val)))
    return target


def y_step(Y, G, side, lr, K, dtype, keep=None):
    '''Phase 5 in place on ``Y`` over the item side's waves: each row's
    mean of bf16(G[u] - K y) over its batch, y as the batch before left
    it, times ``lr``.'''
    for _, key, fix, val in side.blocks():
        if keep is not None:
            m = keep(key.shape[0])
            key, fix = key[m], fix[m]
        rows, inv = torch.unique_consecutive(key.long(), return_inverse=True)
        cnt = torch.bincount(inv, minlength=rows.shape[0]).to(dtype)
        y = Y[rows]
        terms = _bf16(G[fix.long()] - K * y[inv])
        acc = torch.zeros_like(y)
        acc.index_add_(0, inv, terms)
        Y[rows] = y + lr * (acc / cnt.clamp(min=1.0)[:, None])


def work(u, i, v, cfg, device):
    '''The counts of one epoch: its half-passes (``n``, ``rows``,
    ``segments``, ``fixed_rows`` of the user side, then the item side),
    ``k`` the augmented width, ``T`` the sweeps; the aggregations run
    over the user side's entries and the Y step over the item side's,
    ``k_factors`` wide.'''
    p = params_of(cfg)
    B, W = int(p['batch_size']), int(p['window'])
    sides = [Side(a, b, v, B, W, device, waves=False)
             for a, b in ((u, i), (i, u))]
    k = int(p['nbr_features'])
    return {'half_passes': [dict(n=h.n, rows=h.rows, segments=h.segments,
                                 fixed_rows=h.fixed_rows) for h in sides],
            'k': k + 2, 'T': int(p['inner_steps_implicit']),
            'k_factors': k, 'svdpp': True}


class Reference:
    '''The reference model over one data set: plans built once, then
    ``run(P0, Q0, calls, dtype, Y0)`` from a start, ``calls`` the epochs
    of each train call in turn (each call goes on from the last).'''

    @classmethod
    def build(cls, u, i, v, cfg, device, keep=None):
        return cls(u, i, v, cfg['data']['users'], cfg['data']['items'],
                   params_of(cfg), device, keep)

    def __init__(self, u, i, v, U, I, params, device, keep=None):
        # no float32 product of the reference may run in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.U, self.I = U, I
        self.p = params
        self.device = device
        self.keep = keep
        self.mu, self.bu, self.bi = bellkor_biases(
            u, i, v, U, I, params['regularization_users_bias'],
            params['regularization_items_bias'])
        W = int(params['window'])
        B = int(params['batch_size'])
        self.user_side = Side(u, i, v, B, W, device)
        self.item_side = Side(i, u, v, B, W, device)
        cnt = np.bincount(u, minlength=U).astype(np.float32)
        self.nrm = torch.from_numpy(np.where(
            cnt > 0, 1.0 / np.sqrt(np.maximum(cnt, 1.0)), 0.0).astype(
                np.float32)).to(device)

    def epoch(self, Pa, Qa, Y, mu, nrm, rates_u, rates_i, dtype):
        '''One epoch in place on the augmented ``Pa``, ``Qa`` and ``Y``;
        returns its rmse (pooled over both half-passes) as a float.'''
        k = Y.shape[1]
        lo, hi = self.p['min_rating'], self.p['max_rating']
        T = int(self.p['inner_steps_implicit'])
        lr, K = self.p['learning_rate'], self.p['regularization_model']
        us, its = self.user_side, self.item_side
        # 1) A[u] = nrm_u * sum of the rated items' Y rows
        A = user_sums(torch.zeros((self.U, k), dtype=dtype,
                                  device=self.device), us,
                      lambda u, i, r: Y[i], self.keep) * nrm[:, None]
        # 2) the user half-pass on the effective rows, 3) the item one
        Pa[:, :k] += A
        sse = half_pass(Pa, Qa, us, *rates_u, mu, T, lo, hi, dtype,
                        self.keep)
        sse += half_pass(Qa, Pa, its, *rates_i, mu, T, lo, hi, dtype,
                         self.keep)

        # 4) G[u] = nrm_u * sum of err_ui q_i, from Peff and the new Q
        def err_q(u, i, r):
            q = Qa[i]
            pred = torch.clamp(mu + (Pa[u] * q).sum(1), lo, hi)
            return (r.to(dtype) - pred)[:, None] * q[:, :k]

        G = user_sums(torch.zeros((self.U, k), dtype=dtype,
                                  device=self.device), us, err_q,
                      self.keep) * nrm[:, None]
        Pa[:, :k] -= A
        # 5) Y along the items' batches
        y_step(Y, G, its, lr, K, dtype, self.keep)
        n = max(us.n + its.n, 1)
        return float(torch.sqrt(sse / n))

    def run(self, P0, Q0, calls, dtype=torch.float32, Y0=None):
        '''Returns (rmse of each epoch, [(P, Q, Y) after each call]) as
        numpy float32, starting from numpy ``P0``, ``Q0`` and ``Y0``
        (zeros when None).'''
        dev = self.device
        k = P0.shape[1]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                dev)

        ones_u = torch.ones((self.U, 1), device=dev)
        ones_i = torch.ones((self.I, 1), device=dev)
        Pa = torch.cat([t(P0), t(self.bu)[:, None], ones_u], 1).to(dtype)
        Qa = torch.cat([t(Q0), ones_i, t(self.bi)[:, None]], 1).to(dtype)
        # a copy: on the CPU, from_numpy shares the caller's array
        Y = (torch.zeros((self.I, k), device=dev) if Y0 is None
             else t(Y0).clone()).to(dtype)
        lr, K = self.p['learning_rate'], self.p['regularization_model']
        rates_u = column_rates(k, True, lr, K, dev, dtype)
        rates_i = column_rates(k, False, lr, K, dev, dtype)
        mu = torch.tensor(self.mu, dtype=torch.float32).to(dtype).to(dev)
        nrm = self.nrm.to(dtype)
        hist, states = [], []
        for epochs in calls:
            for _ in range(epochs):
                hist.append(self.epoch(Pa, Qa, Y, mu, nrm, rates_u, rates_i,
                                       dtype))
            states.append(tuple(x.float().cpu().numpy().copy() for x in
                                (Pa[:, :k], Qa[:, :k], Y)))
        self.last_history = hist
        return hist, states
