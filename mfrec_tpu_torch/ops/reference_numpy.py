'''
Pure-numpy slow-oracle twins of the reference Cython kernels.

Copied from ``mfrec_tpu/ops/reference_numpy.py`` (numpy only; that package
imports jax), function for function: the same inputs give the same
outputs (``tests/test_torch_engines.py`` pins each function).  These
functions re-express the reference's Cython loops line for line in numpy
(float64, strictly sequential): ``funk_train_oracle`` is the exactness
oracle of the serial Funk tier (``ops.sgd_mf.serial_feature_epoch``) and
the body of ``GDRecommender.feature_training_prototype``.

Layout note: these oracles use the *reference* layout u=[dim, items],
v=[dim, users] (base.py:144-146).
'''
from __future__ import annotations

import numpy as np


def clamping(value, lo=1.0, hi=5.0):
    '''gd_estimator.pyx:26-35 (bounds honored; reference hardcodes 1..5).'''
    return min(max(value, lo), hi)


def estimator(f, u, v, dim, f_init, cache=0.0, trailing=0, overall_avg=1.0,
              item_bias=0.0, user_bias=0.0, lo=1.0, hi=5.0):
    '''gd_estimator.pyx:38-73.'''
    s = cache if cache > 0 else overall_avg + item_bias + user_bias
    s += u * v
    s = clamping(s, lo, hi)
    if trailing == 1:
        s += (dim - f - 1) * f_init * f_init
        s = clamping(s, lo, hi)
    return s


def funk_train_oracle(min_epochs, max_epochs, min_improvement, dim, f_init,
                      lr, K, u, v, ratings_index, ratings, bias_mode='none',
                      overall_avg=0.0, items_bias=None, users_bias=None,
                      lr_users=0.0, lr_items=0.0, K_bias_users=0.0,
                      K_bias_items=0.0,
                      update_users=True, update_items=True,
                      lo=1.0, hi=5.0, cap_epochs=True):
    '''Feature-by-feature Funk SGD, mirroring
    ``estimator_loop_without_bias`` (gd_estimator.pyx:691-779, bias_mode
    'none'), ``estimator_loop_with_bias`` (:489-582, 'fixed') and
    ``estimator_loop_with_learned_bias`` (:401-483, 'learned'), including
    the per-rating cache, the trailing-value term, the pre-update gradient
    reads and the epoch rule.  Mutates u, v (and biases) in place; returns
    the per-epoch rmse history.'''
    n = ratings.shape[0]
    cache = np.zeros(n)
    hist = []
    for f in range(dim):
        # rmse_last reset per feature (same min_epochs=0 converge-only
        # semantics as ConvergenceDriver — it must neither NameError on
        # the first feature nor leak across features)
        rmse, rmse_last, epoch = 2.0, 2.0, 0
        while epoch < min_epochs or rmse <= rmse_last - min_improvement:
            if cap_epochs and epoch >= max_epochs:
                break
            rmse_last = rmse
            sse = 0.0
            for s in range(n):
                ui = ratings_index[s, 0]
                ii = ratings_index[s, 1]
                r = ratings[s]
                if bias_mode == 'learned':
                    full = overall_avg + items_bias[ii] + users_bias[ui] \
                        + float(u[:, ii] @ v[:, ui])
                    p = clamping(full, lo, hi)
                    p = clamping(p + (dim - f - 1) * f_init * f_init, lo, hi)
                elif bias_mode == 'fixed':
                    p = estimator(f, u[f, ii], v[f, ui], dim, f_init,
                                  cache[s], 1, overall_avg, items_bias[ii],
                                  users_bias[ui], lo, hi)
                else:
                    p = estimator(f, u[f, ii], v[f, ui], dim, f_init,
                                  cache[s], 1, 1.0, 0.0, 0.0, lo, hi)
                err = r - p
                sse += err * err
                cf = v[f, ui]
                mf = u[f, ii]
                if bias_mode == 'learned':
                    # K2/K3 split per the public parameter names
                    # (regularization_users_bias / _items_bias,
                    # gradient_descent.py:68-69); the reference kernel
                    # collapses both to K2 (gradient_descent.py:502) —
                    # a latent defect not replicated.
                    users_bias[ui] += lr_users * (
                        err - K_bias_users * users_bias[ui])
                    items_bias[ii] += lr_items * (
                        err - K_bias_items * items_bias[ii])
                if update_items:
                    u[f, ii] += lr * (err * cf - K * mf)
                if update_users:
                    v[f, ui] += lr * (err * mf - K * cf)
            rmse = np.sqrt(sse / n)
            hist.append(rmse)
            epoch += 1
        if bias_mode != 'learned':
            for s in range(n):
                ui = ratings_index[s, 0]
                ii = ratings_index[s, 1]
                if bias_mode == 'fixed':
                    cache[s] = estimator(f, u[f, ii], v[f, ui], dim, f_init,
                                         cache[s], 0, overall_avg,
                                         items_bias[ii], users_bias[ui],
                                         lo, hi)
                else:
                    cache[s] = estimator(f, u[f, ii], v[f, ui], dim, f_init,
                                         cache[s], 0, 1.0, 0.0, 0.0, lo, hi)
    return hist


def kmf_train_oracle(nbr_epochs, dim, lr, K_users, K_items, K_bias, u, v,
                     ratings_index, ratings, items_bias, users_bias,
                     kernel='logistic', update_users=True, update_items=True,
                     lo=1.0, hi=5.0):
    '''Kernel-MF SGD mirroring ``train_logistic_kernel``
    (kmf_train.pyx:103-189) and ``train_linear_kernel`` (:195-277).
    Mutates u, v, biases in place; returns final rmse.'''
    n = ratings.shape[0]
    rng = hi - lo
    rmse = 0.0
    for _ in range(nbr_epochs):
        sse = 0.0
        for s in range(n):
            ui = ratings_index[s, 0]
            ii = ratings_index[s, 1]
            r = ratings[s]
            dot = float(u[:, ii] @ v[:, ui]) + items_bias[ii] + users_bias[ui]
            if kernel == 'logistic':
                sig = 1.0 / (1.0 + np.exp(-dot))
                p = lo + sig * rng
                grad_scale = sig * (1.0 - sig) * rng
            else:
                p = dot
                grad_scale = 1.0
            err = r - p
            sse += err * err
            grad = err * grad_scale
            if update_users:
                users_bias[ui] += lr * (grad - K_bias * users_bias[ui])
            if update_items:
                items_bias[ii] += lr * (grad - K_bias * items_bias[ii])
            for f in range(dim):
                cf = v[f, ui]
                mf = u[f, ii]
                if update_items:
                    u[f, ii] += lr * (grad * cf - K_items * mf)
                if update_users:
                    v[f, ui] += lr * (grad * mf - K_users * cf)
        rmse = np.sqrt(sse / n)
    return rmse


def fn_train_oracle(nbr_epochs, lr, lr_bu, lr_bi, K, K_bu, K_bi, mu,
                    Q, X, Y, bu, bi, ratings_index, ratings, rated_ids,
                    rated_vals, K_y=None, lo=1.0, hi=5.0):
    '''Strictly-sequential factorized-neighborhood SGD (Koren KDD'08 §4,
    the factored item-item model) — the slow twin of ``ops.fn``'s fused
    mini-batch kernel.  Row-major layout (Q/X/Y: [items, k]); mutates
    Q, X, Y, bu, bi in place; returns the final epoch rmse.

    rated_ids/rated_vals: per-user python lists of (item ids, ratings).
    The reference's fn.py never implemented this model (train dispatches
    to never-imported kernels, predict is ``pass`` — fn.py:75-96), so
    there is no Cython loop to mirror; this oracle IS the spec.'''
    K_y = K if K_y is None else K_y
    n = ratings.shape[0]
    rmse = 0.0
    for _ in range(nbr_epochs):
        sse = 0.0
        for s in range(n):
            u = ratings_index[s, 0]
            i = ratings_index[s, 1]
            r = ratings[s]
            ids = rated_ids[u]
            vals = rated_vals[u]
            resid = vals - (mu + bu[u] + bi[ids])
            nrm = 1.0 / np.sqrt(max(len(ids), 1))
            a = nrm * (resid @ X[ids] + Y[ids].sum(0))
            pred = clamping(mu + bu[u] + bi[i] + float(Q[i] @ a), lo, hi)
            err = r - pred
            sse += err * err
            bu[u] += lr_bu * (err - K_bu * bu[u])
            bi[i] += lr_bi * (err - K_bi * bi[i])
            qi = Q[i].copy()
            Q[i] += lr * (err * a - K * qi)
            X[ids] += lr * ((err * nrm) * resid[:, None] * qi[None, :]
                            - K * X[ids])
            Y[ids] += lr * ((err * nrm) * qi[None, :] - K_y * Y[ids])
        rmse = np.sqrt(sse / n)
    return rmse
