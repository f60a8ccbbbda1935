'''
Interleaved A/B of two sorted-window batch steps in one process: K1 (the
shipped step, the regularization by the diagonal identity, the count
built once per batch) against P1 (the round-2 step, a per-rating
regularization term and the count summed every sweep).

Port of ``tools/ab_kernel.py`` (``build``, ``run_block`` and its main
block).  At the ML-10M shape of the JAX bench's ``make_data`` (69,878 x
10,677, 10M raw draws, duplicates kept), rank 64, batch 16384, window
128, T=8, biases fixed at the bias-only fit: 'new' is the port's
``make_alternating_epoch(..., use_kernel=True, ff_dtype='bfloat16')``
(K1), 'old' the same two half-passes with the same per-column rates and
P1 in place of K1.  One warm epoch each, then interleaved reps of
3-epoch blocks, old then new, each block timed on the host clock between
two ``torch.cuda.synchronize()``.

    python -m mfrec_tpu_torch.tools.ab_kernel            # on the card
    python -m mfrec_tpu_torch.tools.ab_kernel --reps 2 --ratings 1000000

``device='cpu'`` runs the plain versions (for tests at a small size).
'''
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mfrec_tpu_torch.models.base import resolve_device
from mfrec_tpu_torch.ops import half_pass_old_kernel, sgd_mf
from mfrec_tpu_torch.tools import bench_data

U, I, N, K = 69878, 10677, 10_000_000, 64
BATCH = 1 << 14
INNER = 8
MAX_WINDOW = 128
LR, REG = 0.15, 0.02


def make_layouts(users, items, vals, device, batch=BATCH,
                 max_window=MAX_WINDOW):
    '''The user- and item-sorted ``PassLayout``s of the stream (with K1's
    segment table on a card); both variants share them.'''
    dev = resolve_device(device)
    return tuple(sgd_mf.PassLayout(
        sgd_mf.sorted_pass_layout(users, items, vals, batch, axis=a,
                                  max_window=max_window),
        a, dev, segments=dev.type == 'cuda') for a in ('user', 'item'))


def old_epoch(W_user, W_item, inner_steps=INNER, lr=LR, reg=REG):
    '''The 'old' epoch: the P then Q half-pass of
    ``make_alternating_epoch`` (fixed biases), each one P1 launch over
    the layout's batches with the fixed side cast to bf16 once.
    ``epoch(Paug, Qaug, mu, p_layout, q_layout) -> (Paug, Qaug, rmse)``,
    the factors updated in place.'''
    rates = {}

    def half_pass(F_upd, F_fix, mu, layout, W, upd_is_user):
        key = (upd_is_user, str(F_upd.device))
        if key not in rates:
            rates[key] = tuple(torch.from_numpy(a).to(F_upd.device)
                               for a in sgd_mf.column_rates(
                                   F_upd.shape[1] - 2, upd_is_user, lr, reg,
                                   reg))
        lrv, regv = rates[key]
        return half_pass_old_kernel.half_pass_old(
            F_upd, F_fix.to(torch.bfloat16), layout.batches(), W, lrv, regv,
            float(mu), inner_steps, segments=layout.segments)

    def epoch(Paug, Qaug, mu, p_layout, q_layout):
        sse_p = half_pass(Paug, Qaug, mu, p_layout, W_user, True)
        sse_q = half_pass(Qaug, Paug, mu, q_layout, W_item, False)
        n = torch.clamp(p_layout.mask_sum + q_layout.mask_sum, min=1.0)
        return Paug, Qaug, torch.sqrt((sse_p + sse_q) / n)

    return epoch


def build(variant, layouts, bu_fit, bi_fit, nbr_users=U, nbr_items=I, k=K,
          inner_steps=INNER, factors=None, seed=0):
    '''``(epoch, (Paug, Qaug))`` of ``variant`` ('new': K1, 'old': P1)
    over ``layouts`` (``make_layouts``), on their device.  The factors
    are ``factors`` (numpy [Paug, Qaug], copied) or drawn as the JAX tool
    draws them: ``init_state(..., feature_init=0.05, mode='normal')``
    (from a ``torch.Generator``: other numbers than ``jax.random``),
    augmented with the fixed biases ``bu_fit``/``bi_fit``.'''
    if variant not in ('new', 'old'):
        raise ValueError("variant must be 'new' or 'old', got %r"
                         % (variant,))
    p_layout, q_layout = layouts
    W_user, W_item = p_layout.W, q_layout.W
    dev = p_layout.r.device
    if factors is None:
        st = sgd_mf.init_state(nbr_users + W_user, nbr_items + W_item, k,
                               feature_init=0.05, mode='normal', seed=seed,
                               device=dev)
        Paug, Qaug = sgd_mf.augment_factors(
            st.P, st.Q,
            torch.from_numpy(np.pad(bu_fit, (0, W_user))).to(dev),
            torch.from_numpy(np.pad(bi_fit, (0, W_item))).to(dev))
    else:
        Paug, Qaug = (torch.from_numpy(np.array(f, np.float32)).to(dev)
                      for f in factors)
    if variant == 'new':
        ep = sgd_mf.make_alternating_epoch(
            W_user, W_item, lr=LR, K=REG, bias_mode='fixed',
            inner_steps=inner_steps, ff_dtype='bfloat16', use_kernel=True)
    else:
        ep = old_epoch(W_user, W_item, inner_steps)
    return ep, (Paug, Qaug)


def run_block(ep, state, layouts, mu, epochs=3):
    '''``epochs`` epochs from ``state``: (seconds per epoch, state, last
    rmse), between two device syncs.'''
    Pa, Qa = state
    on_card = Pa.device.type == 'cuda'
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        Pa, Qa, rmse = ep(Pa, Qa, mu, *layouts)
    if on_card:
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / epochs
    return dt, (Pa, Qa), float(rmse)


def run_ab(users, items, vals, nbr_users=U, nbr_items=I, k=K, batch=BATCH,
           inner_steps=INNER, max_window=MAX_WINDOW, reps=4, epochs=3,
           device='cuda', log=print):
    '''The interleaved A/B: one warm epoch each, then ``reps`` blocks of
    ``epochs`` epochs, old then new.  Logs each rep and both medians as
    the JAX tool prints them; returns ``{'old': [s], 'new': [s],
    'rmse_old': [..], 'rmse_new': [..], 'floor': f, 'speedup': %}``.'''
    floor, bu_fit, bi_fit = bench_data.bias_floor_rmse(
        users, items, vals, nbr_users, nbr_items)
    mu = float(np.float32(vals.mean()))
    layouts = make_layouts(users, items, vals, device, batch, max_window)
    eps, states = {}, {}
    for v in ('new', 'old'):
        eps[v], states[v] = build(v, layouts, bu_fit, bi_fit, nbr_users,
                                  nbr_items, k, inner_steps)
        _, states[v], _ = run_block(eps[v], states[v], layouts, mu, 1)
    res = {'old': [], 'new': [], 'rmse_old': [], 'rmse_new': [],
           'floor': floor}
    for rep in range(reps):
        for v in ('old', 'new'):
            dt, states[v], rmse = run_block(eps[v], states[v], layouts, mu,
                                            epochs)
            res[v].append(dt)
            res['rmse_' + v].append(rmse)
        log('rep %d old %.4f (rmse %.4f) | new %.4f (rmse %.4f)'
            % (rep, res['old'][-1], res['rmse_old'][-1], res['new'][-1],
               res['rmse_new'][-1]))
    for v in ('old', 'new'):
        log('%s: %s median %.4f' % (v, [round(x, 4) for x in res[v]],
                                    float(np.median(res[v]))))
    mo, mn = float(np.median(res['old'])), float(np.median(res['new']))
    res['speedup'] = 100 * (mo - mn) / mo
    log('new kernel speedup: %.1f%%' % res['speedup'])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description='Interleaved A/B of K1 and P1 '
                                 'epochs at the JAX bench\'s data shape.')
    ap.add_argument('--users', type=int, default=U)
    ap.add_argument('--items', type=int, default=I)
    ap.add_argument('--ratings', type=int, default=N)
    ap.add_argument('--rank', type=int, default=K)
    ap.add_argument('--batch', type=int, default=BATCH)
    ap.add_argument('--inner-steps', type=int, default=INNER)
    ap.add_argument('--max-window', type=int, default=MAX_WINDOW)
    ap.add_argument('--reps', type=int, default=4)
    ap.add_argument('--epochs', type=int, default=3)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    users, items, vals = bench_data.make_data(a.users, a.items, a.ratings)
    return run_ab(users, items, vals, a.users, a.items, a.rank, a.batch,
                  a.inner_steps, a.max_window, a.reps, a.epochs, a.device)


if __name__ == '__main__':
    main()
