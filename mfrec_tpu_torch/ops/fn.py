'''
Factorized-neighborhood SGD (Koren KDD'08 §4, the factored item-item
model): the sorted-window tier of the port.

Port of ``mfrec_tpu/ops/fn.py``: ``FNState``, ``init_fn_state``,
``user_aggregates`` (``:64-78``), ``make_fn_alternating_epoch``
(``:141-252``) and ``padded_user_lists`` (``:255-267``).  Every item
carries q_i (target), x_j (explicit-neighborhood weights factor) and y_j
(implicit offsets); the prediction for (u, i) is

    r_hat = mu + b_u + b_i + q_i . a_u
    a_u   = |R(u)|^-1/2 * sum_{j in R(u)} [ (r_uj - b_uj) x_j + y_j ]
    b_uj  = mu + b_u + b_j

The per-batch scatter tier (``make_fn_epoch``, ``:81-137``) is not
ported yet.
'''
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mfrec_tpu_torch.ops import sgd_mf, window_agg_kernel
from mfrec_tpu_torch.ops.als import ieee_f32


class FNState(NamedTuple):
    '''Q: [I, k] target item factors; X: [I, k] explicit-weight factors;
    Y: [I, k] implicit factors; bu/bi: learned biases; mu: overall avg.'''
    Q: torch.Tensor
    X: torch.Tensor
    Y: torch.Tensor
    bu: torch.Tensor
    bi: torch.Tensor
    mu: torch.Tensor


def init_fn_state(nbr_users, nbr_items, k, feature_init=0.1, seed=0,
                  mu=0.0, device='cuda'):
    '''Q, X, Y ~ N(0, feature_init) and zero biases, drawn from a
    ``torch.Generator`` seeded with ``seed`` (Q, then X, then Y), as the
    JAX package draws them from ``PRNGKey(seed)``.  The two generators
    give different numbers from the same seed: to compare the packages,
    hand both the same state.  ``device``: 'cuda' (default; raises
    without a card) or 'cpu', as the models take it.'''
    from mfrec_tpu_torch.models.base import resolve_device
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    f = float(feature_init)

    def draw():
        return (torch.randn((nbr_items, k), generator=gen) * f).to(device)

    Q, X, Y = draw(), draw(), draw()
    return FNState(Q=Q, X=X, Y=Y,
                   bu=torch.zeros(nbr_users, device=device),
                   bi=torch.zeros(nbr_items, device=device),
                   mu=torch.tensor(float(mu), dtype=torch.float32))


def user_aggregates(state, fl, fv, fm):
    '''a_u for every user in one shot: [U, k] f32 on the state's device.

    fl/fv/fm: [U, L] padded per-user rated item ids / values / mask (on
    the same device).  Materializes the serving profiles (P := A makes
    every MF retrieval path work unchanged on an FN model).  Gathers
    [U, L, k] twice; the products run in full f32.'''
    _, X, Y, bu, bi, mu = state
    fl = fl.long()
    base = mu + bu[:, None] + bi[fl]
    resid = (fv - base) * fm
    nrm = torch.rsqrt(torch.clamp(fm.sum(1), min=1.0))[:, None]
    with ieee_f32():
        agg = torch.bmm(resid[:, None, :], X[fl])[:, 0]
        agg = agg + torch.bmm(fm[:, None, :], Y[fl])[:, 0]
    return nrm * agg


def make_fn_alternating_epoch(W_user, W_item, lr, lr_bu, lr_bi, lr_xy,
                              K, K_bu, K_bi, K_x=None, K_y=None,
                              clamp_pred=True, lo=1.0, hi=5.0,
                              row_mean=True, inner_steps=1, use_kernel=False,
                              ff_dtype=None):
    '''FN at sorted-window speed, as ``mfrec_tpu/ops/fn.py:146-176`` sets
    out:

      1. A[u] = nrm_u * sum_j [resid_uj x_j + y_j] (K4 over the user
         layout), installed into the user factor columns.
      2. user half-pass with frozen factor columns: trains b_u only.
      3. item half-pass: trains q_i and b_i against the profiles.
      4. G[u] = nrm_u * sum_{i in R(u)} err_ui q_i (K4 over the user
         layout).
      5. x_j += lr_xy*(mean_u resid_uj G[u] - K_x x_j) and
         y_j += lr_xy*(mean_u G[u] - K_y y_j), batch after batch over the
         item layout: one K4 call per batch over [gX | gY] side by side
         (columns sum independently, so this is the two calls' result).

    ``epoch_fn(Paug, Qaug, Xpad, Ypad, mu, p_layout, q_layout, nrm_rows,
    lr_scale=1.0) -> (Paug, Qaug, Xpad, Ypad, rmse)``, every factor
    updated in place.  Paug: [U + W_user, k+2], factor columns the
    installed a_u, column k the learned b_u.  Xpad/Ypad: [I + W_item, k];
    nrm_rows: [U + W_user] per-user |R(u)|^-1/2 (0 for none).
    ``on_phase(name)``, if given, is called as each phase ends (a timing
    hook: 'profiles', 'half-passes', 'aggregate errors', 'X/Y step').'''
    K_x = K if K_x is None else K_x
    K_y = K if K_y is None else K_y
    base = sgd_mf.make_alternating_epoch(
        W_user, W_item, lr, K, lr_bu=lr_bu, lr_bi=lr_bi, K_bu=K_bu,
        K_bi=K_bi, bias_mode='learned', clamp_pred=clamp_pred, lo_r=lo,
        hi_r=hi, row_mean=row_mean, inner_steps=inner_steps,
        use_kernel=use_kernel, ff_dtype=ff_dtype, freeze_user_factors=True)

    def epoch_fn(Paug, Qaug, Xpad, Ypad, mu, p_layout, q_layout, nrm_rows,
                 lr_scale=1.0, on_phase=None):
        mark = on_phase or (lambda name: None)
        s = np.float32(lr_scale)
        step_xy = float(np.float32(lr_xy) * s)    # f32, as the JAX scalar
        mu = torch.as_tensor(mu, dtype=torch.float32)
        k = Xpad.shape[1]
        bu = Paug[:, k].clone()
        bi = Qaug[:, k + 1].clone()

        def zeros():
            return torch.zeros((Paug.shape[0], k), dtype=Paug.dtype,
                               device=Paug.device)

        # 1) profiles: A[u] = nrm_u * sum_j [resid_uj x_j + y_j]
        def xy_src(u, i, r, m):
            resid = r - (mu + bu[u] + bi[i])
            return resid[:, None] * Xpad[i] + Ypad[i]

        A = sgd_mf._scan_window_agg(zeros(), p_layout, xy_src, W_user,
                                    mean=False)
        Paug[:, :k] = A * nrm_rows[:, None]
        mark('profiles')

        # 2+3) half-passes (user side factor-frozen: b_u only)
        Paug, Qaug, rmse = base(Paug, Qaug, mu, p_layout, q_layout, float(s))
        mark('half-passes')

        # 4) error-weighted item-factor sums into user windows
        def err_q(u, i, r, m):
            ff = Qaug[i]
            pred = mu + (Paug[u] * ff).sum(-1)
            if clamp_pred:
                pred = sgd_mf.clamp(pred, lo, hi)
            return ((r - pred) * m)[:, None] * ff[:, :k]

        G = sgd_mf._scan_window_agg(zeros(), p_layout, err_q, W_user,
                                    mean=False)
        G = G * nrm_rows[:, None]
        mark('aggregate errors')

        # 5) step X and Y over item windows (the post-half-pass biases
        # weight the residuals; the decay rides per sample)
        bu2 = Paug[:, k]
        bi2 = Qaug[:, k + 1]
        together = 2 * k <= window_agg_kernel.MAX_K
        for b, lo_ in enumerate(q_layout.lo_host.tolist()):
            winX = Xpad[lo_:lo_ + W_item]
            winY = Ypad[lo_:lo_ + W_item]
            u, i = q_layout.u[b].long(), q_layout.i[b].long()
            kl, m = q_layout.kl[b], q_layout.m[b]
            kll = kl.long()
            resid = q_layout.r[b] - (mu + bu2[u] + bi2[i])
            Gu = G[u]
            gX = resid[:, None] * Gu - K_x * winX[kll]
            gY = Gu - K_y * winY[kll]
            if together:
                agg = sgd_mf._agg_window(torch.cat([gX, gY], 1), kl, m,
                                         W_item, row_mean)
                aggX, aggY = agg[:, :k], agg[:, k:]
            else:
                aggX = sgd_mf._agg_window(gX, kl, m, W_item, row_mean)
                aggY = sgd_mf._agg_window(gY, kl, m, W_item, row_mean)
            winX.copy_(winX + step_xy * aggX)
            winY.copy_(winY + step_xy * aggY)
        mark('X/Y step')
        return Paug, Qaug, Xpad, Ypad, rmse

    return epoch_fn


def padded_user_lists(ratings, cap=None):
    '''Host-side [U, L] padded (ids, values, mask) per-user rated lists;
    L is the most ratings any user has (at least 1), capped at ``cap``.'''
    from mfrec_tpu_torch.data.ratings import padded_segment_gather
    ptr, items, vals = ratings.csr()
    counts = np.diff(ptr)
    L = max(int(counts.max()) if counts.size else 1, 1)
    if cap is not None:
        L = min(L, int(cap))
    rows = np.arange(ptr.shape[0] - 1, dtype=np.int64)
    return padded_segment_gather(ptr, rows, L, items, vals)
