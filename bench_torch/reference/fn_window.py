'''
Plain PyTorch reference of Koren's Asymmetric-SVD (Y. Koren,
"Factorization meets the neighborhood: a multifaceted collaborative
filtering model", KDD 2008, §4.1) by sorted-window alternating epochs,
as the configuration states it:

    r_hat_ui = mu + b_u + b_i + q_i . a_u
    a_u      = |R(u)|^-1/2 sum_{j in R(u)} [(r_uj - b_uj) x_j + y_j]
    b_uj     = mu + b_u + b_j

with R(u) the items u rated (N(u) = R(u)) and b_u, b_i learned.  An
epoch has five phases, in order:

1. install the profiles: A[u] = a_u from the current biases, X and Y;
2. a user half-pass on [A | b_u | 1] against [Q | 1 | b_i] fixed, the
   profile columns frozen: it trains b_u only;
3. an item half-pass on [Q | 1 | b_i] against [A | b_u | 1] fixed;
4. G[u] = |R(u)|^-1/2 sum_{i in R(u)} err_ui q_i, the errors from the
   rows after both half-passes, the prediction clamped to [lo, hi];
5. x_j += lr * mean over each batch's ratings of j of (res_uj G[u] - K_x
   x_j) and y_j += lr * mean of (G[u] - K_y y_j), res_uj = r_uj - b_uj
   from the biases after the half-passes, item by item along its batches
   in batch order, x_j and y_j as the batch before left them.

After a train call the served profiles are a_u of the final state (phase
1's sum, in float32 without rounding).  The half-passes, the batches and
the waves are ``svdpp_window``'s (its ``Side``, ``half_pass`` and
``user_sums``): within a batch each updated row takes ``sweeps`` gradient
steps on the mean of its ratings' gradients.

Departures from Koren's per-rating SGD, each the configuration's:

* b_uj comes from the learned biases, not from a fixed baseline;
* the steps are row means over sorted windows with T sweeps against the
  same fixed rows, not one rating at a time;
* the user half-pass trains only b_u (a_u is a function of X, Y and the
  biases, installed before it);
* X and Y step once an epoch, after both half-passes, from the
  aggregated user errors G, not with each rating.

Precision (the configuration's): factors float32; the fixed side's rows
float32; the updated rows read in bfloat16 for the prediction; each
aggregated term (a gradient ``err * q``, a profile row ``res x + y``, an
error-weighted Q row, an X or Y step term) rounded to bfloat16 before
its float32 sum; the served profiles summed in float32 unrounded.  With
``dtype=torch.bfloat16`` every float32 quantity is held in bfloat16: the
control.  Everything runs in blocks of at most ``svdpp_window.BLOCK``
entries, so that at the Netflix Prize shape it fits on the card beside
the program.  No code of the program is used.
'''
from __future__ import annotations

import numpy as np
import torch

from reference.sgd_window import params_of
from reference.svdpp_window import Side, half_pass, user_sums


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def column_rates(k, upd_is_user, p, device, dtype):
    '''Rates and regularizations of the augmented columns: on the user
    side only b_u learns; on the item side q (rate and K of the items) and
    b_i; the constant columns never.'''
    lrv = torch.zeros(k + 2, dtype=torch.float32)
    regv = torch.zeros(k + 2, dtype=torch.float32)
    if upd_is_user:
        lrv[k] = p['learning_rate_users']
        regv[k] = p['regularization_bias']
    else:
        lrv[:k] = p['learning_rate']
        regv[:k] = p['regularization_items']
        lrv[k + 1] = p['learning_rate_items']
        regv[k + 1] = p['regularization_bias']
    return lrv.to(device=device, dtype=dtype), regv.to(device=device,
                                                       dtype=dtype)


def xy_step(X, Y, G, side, bu, bi, mu, lr, K_x, K_y, dtype, keep=None):
    '''Phase 5 in place on ``X`` and ``Y`` over the item side's waves:
    each row's mean of bf16(res G[u] - K_x x) and of bf16(G[u] - K_y y)
    over its batch, x and y as the batch before left them, times ``lr``.'''
    for _, key, fix, val in side.blocks():
        if keep is not None:
            m = keep(key.shape[0])
            key, fix, val = key[m], fix[m], val[m]
        rows, inv = torch.unique_consecutive(key.long(), return_inverse=True)
        cnt = torch.bincount(inv, minlength=rows.shape[0]).to(dtype)
        den = cnt.clamp(min=1.0)[:, None]
        u = fix.long()
        res = val.to(dtype) - (mu + bu[u] + bi[key.long()])
        Gu = G[u]
        x, y = X[rows], Y[rows]
        acc = torch.zeros_like(x)
        acc.index_add_(0, inv, _bf16(res[:, None] * Gu - K_x * x[inv]))
        X[rows] = x + lr * (acc / den)
        acc = torch.zeros_like(y)
        acc.index_add_(0, inv, _bf16(Gu - K_y * y[inv]))
        Y[rows] = y + lr * (acc / den)


def work(u, i, v, cfg, device):
    '''The counts of one epoch: its half-passes (``n``, ``rows``,
    ``segments``, ``fixed_rows`` of the user side, then the item side),
    ``k`` the augmented width, ``T`` the sweeps; the aggregations run
    over the user side's entries and the X/Y step over the item side's,
    ``k_factors`` wide.'''
    p = params_of(cfg)
    B, W = int(p['batch_size']), int(p['window'])
    sides = [Side(a, b, v, B, W, device, waves=False)
             for a, b in ((u, i), (i, u))]
    k = int(p['nbr_features'])
    return {'half_passes': [dict(n=h.n, rows=h.rows, segments=h.segments,
                                 fixed_rows=h.fixed_rows) for h in sides],
            'k': k + 2, 'T': int(p['inner_steps']), 'k_factors': k,
            'fn': True}


class Reference:
    '''The reference model over one data set: plans built once, then
    ``run(Q0, X0, Y0, calls, dtype)`` from a start with zero biases,
    ``calls`` the epochs of each train call in turn (each call goes on
    from the last).'''

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
        self.mu = float(np.float32(v.astype(np.float64).mean()))
        W = int(params['window'])
        B = int(params['batch_size'])
        self.user_side = Side(u, i, v, B, W, device)
        self.item_side = Side(i, u, v, B, W, device)
        cnt = np.bincount(u, minlength=U).astype(np.float32)
        self.nrm = torch.from_numpy(np.where(
            cnt > 0, 1.0 / np.sqrt(np.maximum(cnt, 1.0)), 0.0).astype(
                np.float32)).to(device)

    def profiles(self, X, Y, bu, bi, mu, nrm, rounded):
        '''a_u of every user from ``X``, ``Y`` and the biases: each row
        ``res x + y`` rounded to bf16 before its sum (phase 1), or summed
        as it is (the served profiles).'''
        us = self.user_side

        def row(u, i, r):
            res = r.to(X.dtype) - (mu + bu[u] + bi[i])
            return res[:, None] * X[i] + Y[i]

        A = torch.zeros((self.U, X.shape[1]), dtype=X.dtype,
                        device=self.device)
        if rounded:
            user_sums(A, us, row, self.keep)
        else:
            for _, key, fix, val in us.blocks():
                if self.keep is not None:
                    m = self.keep(key.shape[0])
                    key, fix, val = key[m], fix[m], val[m]
                u = key.long()
                A.index_add_(0, u, row(u, fix.long(), val))
        return A * nrm[:, None]

    def epoch(self, Pa, Qa, X, Y, mu, nrm, rates_u, rates_i, dtype):
        '''One epoch in place on the augmented ``Pa`` (its factor columns
        the installed profiles), ``Qa``, ``X`` and ``Y``; returns its rmse
        (pooled over both half-passes) as a float.'''
        k = X.shape[1]
        p = self.p
        lo, hi = p['min_rating'], p['max_rating']
        T = int(p['inner_steps'])
        us, its = self.user_side, self.item_side
        # 1) the profiles from the biases the epoch starts with
        Pa[:, :k] = self.profiles(X, Y, Pa[:, k].clone(), Qa[:, k + 1].clone(),
                                  mu, nrm, rounded=True)
        # 2) the user half-pass (b_u only), 3) the item half-pass
        sse = half_pass(Pa, Qa, us, *rates_u, mu, T, lo, hi, dtype,
                        self.keep)
        sse += half_pass(Qa, Pa, its, *rates_i, mu, T, lo, hi, dtype,
                         self.keep)

        # 4) G[u] = nrm_u * sum of err_ui q_i from the rows after both
        def err_q(u, i, r):
            q = Qa[i]
            pred = torch.clamp(mu + (Pa[u] * q).sum(1), lo, hi)
            return (r.to(dtype) - pred)[:, None] * q[:, :k]

        G = user_sums(torch.zeros((self.U, k), dtype=dtype,
                                  device=self.device), us, err_q,
                      self.keep) * nrm[:, None]
        # 5) X and Y along the items' batches
        xy_step(X, Y, G, its, Pa[:, k], Qa[:, k + 1], mu,
                p['learning_rate'], p['regularization_items'],
                p['regularization_users'], dtype, self.keep)
        n = max(us.n + its.n, 1)
        return float(torch.sqrt(sse / n))

    def run(self, Q0, X0, Y0, calls, dtype=torch.float32):
        '''Returns (rmse of each epoch, [(P, Q, X, Y) after each call]) as
        numpy float32, starting from numpy ``Q0``, ``X0``, ``Y0`` and zero
        biases; P the served profiles.'''
        dev = self.device
        k = Q0.shape[1]

        def t(a):
            # a copy: on the CPU, from_numpy shares the caller's array
            return torch.from_numpy(np.array(a, np.float32)).to(dev)

        zeros_u = torch.zeros((self.U, 1), device=dev)
        ones_u = torch.ones((self.U, 1), device=dev)
        Pa = torch.cat([torch.zeros((self.U, k), device=dev), zeros_u,
                        ones_u], 1).to(dtype)
        Qa = torch.cat([t(Q0), torch.ones((self.I, 1), device=dev),
                        torch.zeros((self.I, 1), device=dev)], 1).to(dtype)
        X, Y = t(X0).to(dtype), t(Y0).to(dtype)
        rates_u = column_rates(k, True, self.p, dev, dtype)
        rates_i = column_rates(k, False, self.p, dev, dtype)
        mu = torch.tensor(self.mu, dtype=torch.float32).to(dtype).to(dev)
        nrm = self.nrm.to(dtype)
        hist, states = [], []
        for epochs in calls:
            for _ in range(epochs):
                hist.append(self.epoch(Pa, Qa, X, Y, mu, nrm, rates_u,
                                       rates_i, dtype))
            P = self.profiles(X, Y, Pa[:, k], Qa[:, k + 1], mu, nrm,
                              rounded=False)
            states.append(tuple(a.float().cpu().numpy().copy() for a in
                                (P, Qa[:, :k], X, Y)))
        self.last_history = hist
        return hist, states
