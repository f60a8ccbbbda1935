'''The port's SVD++ against the benchmark's plain reference
(``bench_torch/reference/svdpp_window.py``, the file that decides the
``svdpp-netflix-r100.train`` cell's ``correct``) at a small size on the
CPU, from seeded random P and Q and a non-zero random Y.

Tolerances, each with its reason:

- the epoch in K1's arithmetic (``use_kernel=True`` on CPU tensors: K1's
  plain version, f32 fixed side), through both aggregation routes (the
  segment tables' gathered entries, ``gather_aggregate`` and
  ``error_aggregate``, and the per-batch K4 calls): factors and Y within
  1e-5, rmse within 1e-6 relative.  Program and reference compute the same
  arithmetic; only the f32 order of the aggregations' sums differs (the
  reference sums a user's rows at once, the program segment by segment),
  which can move an element by an ulp and flip a later bf16 rounding.
- ``GDRecommender(device='cpu').feature_training_implicit()`` of 3 epochs
  with the card's arithmetic: within 1e-4, rmse 1e-5 relative -- the
  model's BellKor biases start from its f32 mean, the reference's from the
  f64 mean, so a bias may lie an ulp apart, and the epochs carry that on.
- the same call in the CPU model's own arithmetic (the XLA branch: the
  window read in f32, each rating's regularized gradient rounded to bf16,
  where K1 reads the window in bf16 and regularizes the row in f32): within
  2e-3 after 3 epochs, about 2^-8 of what the factors moved (0.34), rmse
  within 1e-5 relative.
'''
import os
import sys

import numpy as np
import pytest
import torch

from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.ops import sgd_mf

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'bench_torch')
if BENCH not in sys.path:
    sys.path.append(BENCH)

from reference import svdpp_window  # noqa: E402

# The suite runs in several xdist workers on one machine; torch's default
# of one intra-op thread per core then oversubscribes the cores.
torch.set_num_threads(1)

U, I, N, W, B, K, T = 80, 50, 2500, 16, 256, 8, 6
LR, REG = 0.15, 0.015
PARAMS = dict(nbr_features=K, learning_rate=LR, regularization_model=REG,
              regularization_users_bias=0.01,
              regularization_items_bias=0.01, batch_size=B,
              inner_steps_implicit=T, window=W, min_rating=1.0,
              max_rating=5.0)


@pytest.fixture(scope='module')
def case():
    '''Distinct (user, item) pairs in user-major order, half-star ratings,
    seeded P0, Q0 and a non-zero Y0, and the reference built on them.'''
    rng = np.random.default_rng(3)
    flat = np.sort(rng.choice(U * I, N, replace=False))
    u, i = (flat // I).astype(np.int32), (flat % I).astype(np.int32)
    v = np.clip(np.round(rng.normal(3.5, 1.0, N) * 2) / 2, 1,
                5).astype(np.float32)
    P0 = rng.normal(0, 0.1, (U, K)).astype(np.float32)
    Q0 = rng.normal(0, 0.1, (I, K)).astype(np.float32)
    Y0 = rng.normal(0, 0.05, (I, K)).astype(np.float32)
    ref = svdpp_window.Reference(u, i, v, U, I, PARAMS, 'cpu')
    return u, i, v, P0, Q0, Y0, ref


def _pad(a):
    return torch.from_numpy(np.concatenate(
        [a, np.zeros((W,) + a.shape[1:], a.dtype)]))


@pytest.mark.parametrize('segments', [True, False])
def test_epochs_match_the_reference(case, segments):
    '''Two epochs of ``make_alternating_implicit_epoch`` in K1's
    arithmetic, from the reference's biases, against two reference
    epochs: P, Q and Y after each, and each epoch's rmse.'''
    u, i, v, P0, Q0, Y0, ref = case
    lay = [sgd_mf.PassLayout(sgd_mf.sorted_pass_layout(
        u, i, v, B, axis=a, max_window=W), a, 'cpu', segments=segments)
        for a in ('user', 'item')]
    assert (lay[0].segments is not None) == segments
    Pa, Qa = sgd_mf.augment_factors(_pad(P0), _pad(Q0), _pad(ref.bu),
                                    _pad(ref.bi))
    cnt = np.bincount(u, minlength=U + W).astype(np.float32)
    nrm = torch.from_numpy(np.where(cnt > 0, 1 / np.sqrt(np.maximum(
        cnt, 1)), 0).astype(np.float32))
    ep = sgd_mf.make_alternating_implicit_epoch(
        W, W, LR, LR, REG, REG, inner_steps=T, use_kernel=True)
    hist, states = ref.run(P0, Q0, [1, 1], torch.float32, Y0)
    state = (Pa, Qa, _pad(Y0))
    mu = torch.tensor(np.float32(ref.mu))
    for e in range(2):
        *state, rmse = ep(*state, mu, *lay, nrm)
        P, Q, _, _ = sgd_mf.split_factors(state[0], state[1])
        for got, want, n in zip((P, Q, state[2]), states[e], (U, I, I)):
            np.testing.assert_allclose(got[:n].numpy(), want, rtol=0,
                                       atol=1e-5)
        assert float(rmse) == pytest.approx(hist[e], rel=1e-6)
    # the epochs moved every leaf, Y from a non-zero start
    for start, want in zip((P0, Q0, Y0), states[1]):
        assert float(np.abs(want - start).max()) > 1e-2


@pytest.mark.parametrize('arith', ['card', 'cpu_model'])
def test_feature_training_implicit_matches_the_reference(case, arith,
                                                         monkeypatch):
    '''A 3-epoch ``feature_training_implicit()`` of a CPU model from P0,
    Q0 (Y starts at zero) against 3 reference epochs: the rmse history,
    P, Q and Y; ``'card'`` runs the CUDA model's arithmetic on the CPU
    tensors (``_implicit_epoch(use_kernel=True)``).'''
    u, i, v, P0, Q0, _, ref = case
    m = GDRecommender(U, I, {'nbr_features': K, 'min_epochs': 3,
                             'max_epochs': 3, 'batch_size': B,
                             'inner_steps_implicit': T, 'learning_rate': LR,
                             'regularization_model': REG,
                             'feature_init': 0.05, 'min_improvement': -1.0},
                      device='cpu')
    if arith == 'card':
        orig = GDRecommender._implicit_epoch
        monkeypatch.setattr(GDRecommender, '_implicit_epoch',
                            lambda self, use_kernel=None:
                            orig(self, use_kernel=True))
    m.set_ratings(u, i, v)
    m.P, m.Q = P0.copy(), Q0.copy()
    m.feature_training_implicit(initialize_model=False)
    hist, states = ref.run(P0, Q0, [3])
    atol = 1e-4 if arith == 'card' else 2e-3
    for got, want in zip((m.P, m.Q, m.Y), states[0]):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(m.rmse_history, hist, rtol=1e-5)
    assert float(np.abs(states[0][2]).max()) > 1e-2      # Y moved from 0
