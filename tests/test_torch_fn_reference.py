'''The port's FN (Koren's Asymmetric-SVD) against the benchmark's plain
reference (``bench_torch/reference/fn_window.py``, the file that decides
the ``fn-netflix-r100.train`` cell's ``correct``) at a small size on the
CPU, from seeded random Q, X and Y and zero biases.

Tolerances, each with its reason:

- the epoch in K1's arithmetic (``use_kernel=True`` on CPU tensors: K1's
  plain version, f32 fixed side), through both aggregation routes (the
  segment tables' gathered entries, ``profile_aggregate`` and
  ``error_aggregate``, and the per-batch K4 calls): Q, X, Y and the
  biases within 1e-5, the served profiles within 1e-5, rmse within 1e-6
  relative.  Program and reference compute the same arithmetic; only
  the f32 order of the aggregations' sums differs (the reference sums a
  user's rows at once, the program segment by segment), which can move
  an element by an ulp and flip a later bf16 rounding.
- ``FNRecommender(device='cpu').train()`` of 3 epochs in the card's
  arithmetic (the CUDA model's path, its segment tables and kernels'
  plain versions): within 1e-5, rmse 1e-6 relative -- the model's mean
  is numpy's f32 mean, the reference's the f64 mean rounded, which can
  lie an ulp apart.
- the same call in the CPU model's own arithmetic (the XLA branch: the
  window read in f32, each rating's regularized gradient rounded to bf16,
  where K1 reads the window in bf16 and regularizes the row in f32):
  within 5e-4 after 3 epochs (measured 2.1e-4 on Q, which moved by
  0.40), rmse within 3e-5 relative (measured 1.2e-5).
- the bfloat16 control (the reference one precision below the
  configuration's) misses the card arithmetic's tolerances.
'''
import os
import sys

import numpy as np
import pytest
import torch

from mfrec_tpu_torch.models.fn import FNRecommender
from mfrec_tpu_torch.ops import fn as fn_ops
from mfrec_tpu_torch.ops import sgd_mf

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'bench_torch')
if BENCH not in sys.path:
    sys.path.append(BENCH)

from reference import fn_window  # noqa: E402

# The suite runs in several xdist workers on one machine; torch's default
# of one intra-op thread per core then oversubscribes the cores.
torch.set_num_threads(1)

U, I, N, K, T = 300, 120, 6000, 16, 6
W_EPOCH, B = 16, 256
LR, REG, REG_Y, REG_B = 0.15, 0.015, 0.02, 0.007
PARAMS = dict(nbr_features=K, learning_rate=LR, learning_rate_users=LR,
              learning_rate_items=LR, regularization_items=REG,
              regularization_users=REG_Y, regularization_bias=REG_B,
              batch_size=B, inner_steps=T, window=512, min_rating=1.0,
              max_rating=5.0)
CARD_ATOL, CARD_RTOL = 1e-5, 1e-6


@pytest.fixture(scope='module')
def case():
    '''Distinct (user, item) pairs, half-star ratings, seeded Q0, X0, Y0.'''
    rng = np.random.default_rng(5)
    flat = np.sort(rng.choice(U * I, N, replace=False))
    u, i = (flat // I).astype(np.int32), (flat % I).astype(np.int32)
    v = np.clip(np.round(rng.normal(3.5, 1.0, N) * 2) / 2, 1,
                5).astype(np.float32)
    Q0, X0, Y0 = (rng.normal(0, 0.05, (I, K)).astype(np.float32)
                  for _ in range(3))
    return u, i, v, Q0, X0, Y0


def _pad(a, W):
    return torch.from_numpy(np.concatenate(
        [a, np.zeros((W,) + a.shape[1:], a.dtype)]))


def _within(got, want, atol):
    return all(np.abs(g - w).max() <= atol for g, w in zip(got, want))


@pytest.mark.parametrize('segments', [True, False])
def test_epochs_match_the_reference(case, segments):
    '''Two epochs of ``make_fn_alternating_epoch`` in K1's arithmetic at a
    window of 16 against two reference epochs: Q, X, Y and both biases
    after each, each epoch's rmse, and the served profiles of the end
    state (``user_profiles``).'''
    u, i, v, Q0, X0, Y0 = case
    W = W_EPOCH
    ref = fn_window.Reference(u, i, v, U, I, dict(PARAMS, window=W), 'cpu')
    lay = [sgd_mf.PassLayout(sgd_mf.sorted_pass_layout(
        u, i, v, B, axis=a, max_window=W), a, 'cpu', segments=segments)
        for a in ('user', 'item')]
    assert (lay[0].segments is not None) == segments
    zu, zi = np.zeros(U, np.float32), np.zeros(I, np.float32)
    Pa, Qa = sgd_mf.augment_factors(_pad(np.zeros((U, K), np.float32), W),
                                    _pad(Q0, W), _pad(zu, W), _pad(zi, W))
    cnt = np.bincount(u, minlength=U + W).astype(np.float32)
    nrm = torch.from_numpy(np.where(cnt > 0, 1 / np.sqrt(np.maximum(
        cnt, 1)), 0).astype(np.float32))
    ep = fn_ops.make_fn_alternating_epoch(
        W, W, LR, LR, LR, LR, REG, REG_B, REG_B, K_x=REG, K_y=REG_Y,
        inner_steps=T, use_kernel=True)
    hist, states = ref.run(Q0, X0, Y0, [1, 1])
    state = (Pa, Qa, _pad(X0, W), _pad(Y0, W))
    mu = torch.tensor(np.float32(ref.mu))
    for e in range(2):
        *state, rmse = ep(*state, mu, *lay, nrm)
        Pa, Qa, X, Y = state
        got = (Qa[:I, :K], X[:I], Y[:I])
        for g, w in zip(got, states[e][1:]):
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=CARD_ATOL)
        assert float(rmse) == pytest.approx(hist[e], rel=CARD_RTOL)
    served = fn_ops.user_profiles(fn_ops.FNState(
        Q=Qa[:I, :K], X=X[:I], Y=Y[:I], bu=Pa[:, K], bi=Qa[:I, K + 1],
        mu=mu), lay[0], nrm)
    np.testing.assert_allclose(served[:U].numpy(), states[1][0], rtol=0,
                               atol=CARD_ATOL)
    # the epochs moved every leaf and both biases
    for start, want in zip((Q0, X0, Y0), states[1][1:]):
        assert float(np.abs(want - start).max()) > 1e-3
    assert float(Pa[:U, K].abs().max()) > 1e-2
    assert float(Qa[:I, K + 1].abs().max()) > 1e-2


def _model(case):
    u, i, v, Q0, X0, Y0 = case
    m = FNRecommender(U, I, {'nbr_features': K, 'nbr_epochs': 3,
                             'batch_size': B, 'inner_steps': T,
                             'learning_rate': LR, 'learning_rate_users': LR,
                             'learning_rate_items': LR,
                             'regularization_items': REG,
                             'regularization_users': REG_Y,
                             'regularization_bias': REG_B,
                             'min_improvement': -1.0}, device='cpu')
    m.set_ratings(u, i, v)
    m.Q, m.X, m.Y = Q0.copy(), X0.copy(), Y0.copy()
    m.users_bias = np.zeros(U, np.float32)
    m.items_bias = np.zeros(I, np.float32)
    return m


@pytest.mark.parametrize('arith', ['card', 'cpu_model'])
def test_train_matches_the_reference(case, arith, monkeypatch):
    '''A 3-epoch ``train(initialize_model=False)`` of a CPU model from Q0,
    X0, Y0 and zero biases against 3 reference epochs: the rmse history
    and the served profiles P, Q, X and Y; ``'card'`` runs the CUDA
    model's path on the CPU tensors (segment tables, the kernels' plain
    versions).'''
    u, i, v, Q0, X0, Y0 = case
    if arith == 'card':
        monkeypatch.setattr(FNRecommender, '_on_card', True)
    m = _model(case)
    m.train(initialize_model=False)
    ref = fn_window.Reference(u, i, v, U, I, PARAMS, 'cpu')
    hist, states = ref.run(Q0, X0, Y0, [3])
    atol = CARD_ATOL if arith == 'card' else 5e-4
    for got, want in zip((m.P, m.Q, m.X, m.Y), states[0]):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(m.rmse_history, hist,
                               rtol=CARD_RTOL if arith == 'card' else 3e-5)
    assert float(np.abs(states[0][3] - Y0).max()) > 1e-3    # Y moved


def test_bf16_control_misses(case):
    '''The reference in bfloat16, put in the program's place, fails the
    card arithmetic's tolerances on some leaf or epoch.'''
    u, i, v, Q0, X0, Y0 = case
    ref = fn_window.Reference(u, i, v, U, I, PARAMS, 'cpu')
    hist, states = ref.run(Q0, X0, Y0, [3])
    h16, s16 = ref.run(Q0, X0, Y0, [3], torch.bfloat16)
    rmse_ok = np.allclose(h16, hist, rtol=CARD_RTOL, atol=0)
    assert not (rmse_ok and _within(s16[0], states[0], CARD_ATOL))


def test_layout_profiles_match_user_aggregates():
    '''``user_profiles`` over a user layout -- with its segment table (the
    profile mode's plain version, unrounded) and without (a plain
    ``index_add_`` a batch) -- against ``user_aggregates`` over the padded
    lists, within f32 sum order.'''
    rng = np.random.default_rng(8)
    nu, ni, n, k = 90, 60, 2500, 12
    flat = rng.choice(nu * ni, n, replace=False)
    u, i = (flat // ni).astype(np.int32), (flat % ni).astype(np.int32)
    v = rng.uniform(1, 5, n).astype(np.float32)
    st = fn_ops.FNState(*(torch.from_numpy(rng.normal(0, 0.2, s).astype(
        np.float32)) for s in ((ni, k), (ni, k), (ni, k), (nu,), (ni,))),
        mu=torch.tensor(np.float32(v.mean())))
    m = FNRecommender(nu, ni, {'nbr_features': k}, device='cpu')
    m.set_ratings(u, i, v)
    lists = (torch.from_numpy(a) for a in fn_ops.padded_user_lists(
        m.ratings))
    want = fn_ops.user_aggregates(st, *lists)
    cnt = np.bincount(u, minlength=nu).astype(np.float32)
    nrm = torch.from_numpy((1 / np.sqrt(np.maximum(cnt, 1))).astype(
        np.float32))
    for segments in (True, False):
        lay = sgd_mf.PassLayout(sgd_mf.sorted_pass_layout(
            u, i, v, 128, axis='user', max_window=8), 'user', 'cpu',
            segments=segments)
        got = fn_ops.user_profiles(st, lay, nrm)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
