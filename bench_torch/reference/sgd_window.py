'''
Plain PyTorch reference of biased SGD matrix factorization by
sorted-window alternating epochs, as the configuration states it.

An epoch is a user half-pass (Q fixed), then an item half-pass (P fixed).
A half-pass sorts the ratings by the updated side's key (ties in the
other key's order) and cuts them into batches of at most ``batch``
ratings whose keys span fewer than ``window`` rows.  Within a batch each
updated row takes ``sweeps`` gradient steps on the mean of its ratings'
gradients, its other rows untouched; a row that spans several batches
takes them in batch order.  Rows are independent, so a half-pass is
computed as waves: wave j holds every row's j-th batch.

Factors are augmented ``[P | bu | 1]`` and ``[Q | 1 | bi]`` with the
biases fixed.  Precision (the configuration's): factors float32, the
fixed side's rows and the window's reads rounded to bfloat16, each
rating's gradient term ``err * q`` rounded to bfloat16 before its f32
sum; the prediction ``mu + p.q`` is clamped to [lo, hi].  With
``dtype=torch.bfloat16`` every float32 quantity is held in bfloat16: the
control.

The BellKor biases (mean, then item bias ``sum / (K3 + n)``, then user
bias over the item-adjusted residuals ``sum / (K2 + n)``) are computed
here from the ratings.  No code of the program is used.
'''
from __future__ import annotations

import numpy as np
import torch


def bellkor_biases(u, i, v, U, I, K2, K3):
    '''(mu, bu [U], bi [I]) as float32 numpy, mu a float.'''
    v64 = v.astype(np.float64)
    mu = float(v64.mean())
    ci = np.bincount(i, minlength=I)
    bi = np.bincount(i, weights=v64 - mu, minlength=I) / (K3 + ci)
    bi[ci == 0] = 0.0
    bi = bi.astype(np.float32)
    cu = np.bincount(u, minlength=U)
    bu = np.bincount(u, weights=v64 - mu - bi[i].astype(np.float64),
                     minlength=U) / (K2 + cu)
    bu[cu == 0] = 0.0
    return mu, bu.astype(np.float32), bi


def batch_bounds(key, batch, window):
    '''Batch boundaries over the sorted keys: a batch closes at ``batch``
    ratings or where the key reaches its first key + ``window``.'''
    n = key.shape[0]
    starts = []
    s = 0
    while s < n:
        e = min(s + batch, n)
        limit = int(np.searchsorted(key, key[s] + window, side='left'))
        e = min(e, max(limit, s + 1))
        starts.append(s)
        s = e
    return np.asarray(starts + [n], np.int64)


class HalfPass:
    """One half-pass's plan, built on the device: its waves (index
    tensors) and the counts the yardstick needs."""

    def __init__(self, upd, fix, v, batch, window, device, waves=True):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        up, fx = t(upd.astype(np.int64)), t(fix.astype(np.int64))
        width = int(fx.max()) + 1 if fx.numel() else 1
        # the pairs are distinct: sorting by (upd, fix) is one order
        order = torch.argsort(up * width + fx)
        key, other, val = up[order], fx[order], t(v)[order]
        bounds = batch_bounds(key.cpu().numpy(), batch, window)
        nb = bounds.shape[0] - 1
        b_of = torch.repeat_interleave(
            torch.arange(nb, device=device), t(np.diff(bounds)))
        wave = b_of - b_of[torch.searchsorted(key, key)]
        self.n = int(key.numel())
        self.rows = int(torch.unique(key).numel())
        self.segments = int(torch.unique(key * (nb + 1) + b_of).numel())
        self.fixed_rows = int(torch.unique(other).numel())
        self.batches = int(nb)
        self.waves = []
        for w in range(int(wave.max()) + 1 if self.n and waves else 0):
            sel = torch.nonzero(wave == w)[:, 0]
            rows, inv = torch.unique(key[sel], return_inverse=True)
            self.waves.append((rows, inv, other[sel], val[sel],
                               torch.bincount(inv).to(torch.float32)))


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def half_pass(F_upd, F_fix, plan, lrv, regv, mu, sweeps, lo, hi, dtype,
              keep=None):
    '''Run one half-pass in place on ``F_upd``; returns its SSE (the
    first sweep's residuals) as a float.  ``keep``: a fault's rule
    leaving some ratings out (a function of the wave's entry count
    returning a bool mask), else None.'''
    ffull = _bf16(F_fix.float()).to(dtype)
    sse = 0.0
    for rows, inv, fix, val, cnt in plan.waves:
        if keep is not None:
            m = keep(inv.shape[0])
            inv, fix, val = inv[m], fix[m], val[m]
            cnt = torch.bincount(inv, minlength=rows.shape[0]).to(
                torch.float32)
        den = cnt.clamp(min=1.0)[:, None].to(dtype)
        alive = (cnt > 0).to(dtype)[:, None]
        ff = ffull[fix]
        vv = val.to(dtype)
        x = F_upd[rows].to(dtype)
        for t in range(sweeps):
            fu = _bf16(x)[inv]
            dot = (fu * ff).sum(1)
            pred = torch.clamp(mu + dot, lo, hi)
            err = vv - pred
            if t == 0:
                sse += float((err.float() * err.float()).sum())
            acc = torch.zeros_like(x)
            acc.index_add_(0, inv, _bf16(err[:, None] * ff))
            x = x + lrv * (acc / den - regv * x * alive)
        F_upd[rows] = x.to(F_upd.dtype)
    return sse


def column_rates(k, upd_is_user, lr, K, device, dtype):
    '''Rates and regularizations of the augmented columns: the factor
    columns learn, the bias columns (fixed biases, the constant) do not.'''
    lrv = torch.full((k + 2,), float(lr), dtype=torch.float32)
    regv = torch.full((k + 2,), float(K), dtype=torch.float32)
    lrv[k:] = 0.0
    regv[k:] = 0.0
    return lrv.to(device=device, dtype=dtype), regv.to(device=device,
                                                       dtype=dtype)


def params_of(cfg):
    '''The reference's parameters: the model's and the fixed ones.'''
    p = dict(cfg['parameters'])
    p.update(cfg['fixed'])
    return p


def work(u, i, v, cfg, device):
    '''The counts of one epoch's half-passes (``n``, ``rows``,
    ``segments``, ``fixed_rows``), k the augmented width, T the sweeps.'''
    p = params_of(cfg)
    B, W = int(p['batch_size']), int(p['window'])
    sides = [HalfPass(a, b, v, B, W, device, waves=False)
             for a, b in ((u, i), (i, u))]
    return {'half_passes': [dict(n=h.n, rows=h.rows, segments=h.segments,
                                 fixed_rows=h.fixed_rows) for h in sides],
            'k': int(p['nbr_features']) + 2, 'T': int(p['inner_steps'])}


class Reference:
    '''The reference model over one data set: plans built once, then
    ``run(P0, Q0, calls)`` from a start, ``calls`` the epochs of each
    train call in turn.'''

    @classmethod
    def build(cls, u, i, v, cfg, device, keep=None):
        return cls(u, i, v, cfg['data']['users'], cfg['data']['items'],
                   params_of(cfg), device, keep)

    def __init__(self, u, i, v, U, I, params, device, keep=None):
        self.U, self.I = U, I
        self.p = params
        self.device = device
        self.keep = keep
        self.mu, self.bu, self.bi = bellkor_biases(
            u, i, v, U, I, params['regularization_users_bias'],
            params['regularization_items_bias'])
        W = int(params['window'])
        B = int(params['batch_size'])
        self.user_plan = HalfPass(u, i, v, B, W, device)
        self.item_plan = HalfPass(i, u, v, B, W, device)

    def run(self, P0, Q0, calls, dtype=torch.float32):
        '''Returns (rmse of each epoch, [(P, Q) after each call]) as numpy
        float32, starting from numpy ``P0``, ``Q0``.'''
        dev = self.device
        k = P0.shape[1]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                dev)

        ones_u = torch.ones((self.U, 1), device=dev)
        ones_i = torch.ones((self.I, 1), device=dev)
        Pa = torch.cat([t(P0), t(self.bu)[:, None], ones_u], 1).to(dtype)
        Qa = torch.cat([t(Q0), ones_i, t(self.bi)[:, None]], 1).to(dtype)
        lr, K = self.p['learning_rate'], self.p['regularization_model']
        rates_u = column_rates(k, True, lr, K, dev, dtype)
        rates_i = column_rates(k, False, lr, K, dev, dtype)
        mu = torch.tensor(self.mu, dtype=torch.float32).to(dtype).to(dev)
        lo, hi = self.p['min_rating'], self.p['max_rating']
        T = int(self.p['inner_steps'])
        n = self.user_plan.n + self.item_plan.n
        hist, states = [], []
        for epochs in calls:
            for _ in range(epochs):
                sse = half_pass(Pa, Qa, self.user_plan, *rates_u, mu, T, lo,
                                hi, dtype, self.keep)
                sse += half_pass(Qa, Pa, self.item_plan, *rates_i, mu, T,
                                 lo, hi, dtype, self.keep)
                hist.append(float(np.sqrt(sse / max(n, 1))))
            states.append((Pa[:, :k].float().cpu().numpy().copy(),
                           Qa[:, :k].float().cpu().numpy().copy()))
        self.last_history = hist
        return hist, states
