'''The port's training path on the CPU, held to the JAX package.

Numerics held to, by test:
- the epoch with ``use_kernel=False`` against
  ``make_alternating_epoch(use_pallas_full=False)``: the XLA branch (f32
  window and fixed side, per-sample gradients rounded to bf16).  f32
  sums in another order can flip one bf16 rounding of a gradient term,
  which moves a factor by at most lr * 2^-8 * |g| / cnt; measured
  <= 6e-6 here, held to 1e-4;
- with ``use_kernel=True`` (K1's plain version on the CPU) against
  ``make_alternating_epoch(use_pallas_full=True, pallas_interpret=True,
  ff_dtype='bfloat16')``: the Pallas numerics, same bound and reason;
- ``GDRecommender(device='cpu')`` against the JAX model on the CPU (the
  XLA branch again): bit-identical init, RMSE history within 1e-5
  relative and factors within 1e-4 after several epochs;
- the ML-100K-shape acceptance floors of test_acceptance_ml100k.py.

The benchmark's faults (``bench_torch/runners``' ``FAULTS``), planted by
name on the port's methods, are held here to changing what the public
calls train, so a renamed seam fails this suite, not the benchmark.'''
import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mfrec_tpu.models.gd import GDRecommender as JaxGD
from mfrec_tpu.ops import sgd_mf as jax_sgd
from mfrec_tpu_torch import interop
from mfrec_tpu_torch.data import ml100k_like
from mfrec_tpu_torch.models.base import Error
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.models.wrmf import WRMFRecommender
from mfrec_tpu_torch.ops import sgd_mf

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'bench_torch')
if BENCH not in sys.path:
    sys.path.append(BENCH)

from runners import svdpp_calls, train_calls  # noqa: E402

FACTOR_ATOL = 1e-4
RMSE_RTOL = 1e-5


def _stream(U=60, I=40, N=2000, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, U, N).astype(np.int32),
            rng.integers(0, I, N).astype(np.int32),
            rng.uniform(1, 5, N).astype(np.float32))


@pytest.mark.parametrize('k', [6, 66])
@pytest.mark.parametrize('use_kernel', [False, True])
@pytest.mark.parametrize('bias_mode', ['fixed', 'learned', 'none'])
def test_epoch_matches_jax(bias_mode, use_kernel, k):
    U, I, W = 60, 40, 32
    u, i, v = _stream(U, I)
    lay = {a: jax_sgd.sorted_pass_layout(u, i, v, 256, axis=a,
                                         max_window=W)
           for a in ('user', 'item')}
    rng = np.random.default_rng(k)
    P = rng.normal(0, 0.1, (U + W, k)).astype(np.float32)
    Q = rng.normal(0, 0.1, (I + W, k)).astype(np.float32)
    bu = rng.normal(0, 0.1, U + W).astype(np.float32)
    bi = rng.normal(0, 0.1, I + W).astype(np.float32)
    Pa, Qa = jax_sgd.augment_factors(P, Q, bu, bi)
    mu = np.float32(v.mean())
    kw = dict(lr=0.1, K=0.02, lr_bu=0.05, lr_bi=0.07, K_bu=0.01, K_bi=0.03,
              bias_mode=bias_mode, inner_steps=3)
    ep_j = jax_sgd.make_alternating_epoch(
        W, W, donate=False, use_pallas_full=use_kernel,
        pallas_interpret=use_kernel, ff_dtype='bfloat16', **kw)
    ep_t = sgd_mf.make_alternating_epoch(W, W, use_kernel=use_kernel,
                                         ff_dtype='bfloat16', **kw)
    pj = tuple(jnp.asarray(x) for x in lay['user'][:-1])
    qj = tuple(jnp.asarray(x) for x in lay['item'][:-1])
    pt = sgd_mf.PassLayout(lay['user'], 'user', 'cpu')
    qt = sgd_mf.PassLayout(lay['item'], 'item', 'cpu')
    Pj, Qj = jnp.asarray(Pa), jnp.asarray(Qa)
    Pt, Qt = torch.from_numpy(Pa.copy()), torch.from_numpy(Qa.copy())
    for scale in (1.0, 0.7):                       # lr_scale != 1 too
        Pj, Qj, rj = ep_j(Pj, Qj, jnp.float32(mu), pj, qj,
                          jnp.float32(scale))
        Pt, Qt, rt = ep_t(Pt, Qt, mu, pt, qt, np.float32(scale))
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj),
                                   atol=FACTOR_ATOL, rtol=0)
        np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj),
                                   atol=FACTOR_ATOL, rtol=0)
        assert float(rt) == pytest.approx(float(rj), rel=RMSE_RTOL)


def _params(**over):
    # engine pinned: under the suite's 8-device CPU mesh the JAX model's
    # 'auto' picks alternating_sharded (the port's 'auto' is alternating)
    p = {'nbr_features': 6, 'min_epochs': 4, 'max_epochs': 4,
         'batch_size': 512, 'inner_steps': 4, 'feature_init': 0.05,
         'engine': 'alternating'}
    p.update(over)
    return p


def _pair(dataset, params, seed=3):
    (u, i, v), _ = dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    a = JaxGD(U, I, params)
    b = GDRecommender(U, I, params, device='cpu')
    for m in (a, b):
        m.seed(seed)
        m.set_ratings(u, i, v)
    return a, b


def _assert_same_model(a, b, biases=False):
    np.testing.assert_allclose(b.get_rmse_history(), a.get_rmse_history(),
                               rtol=RMSE_RTOL)
    names = ('P', 'Q') + (('users_bias', 'items_bias') if biases else ())
    for name in names:
        got, want = getattr(b, name), np.asarray(getattr(a, name))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=FACTOR_ATOL, rtol=0)


@pytest.mark.parametrize('entry', ['train_bias', 'train_plain',
                                   'feature_training_bias'])
def test_model_matches_jax(small_dataset, entry):
    a, b = _pair(small_dataset, _params())
    # the same rng draws give the same init, bit for bit
    a._init_factors(True)
    b._init_factors(True)
    np.testing.assert_array_equal(a.P, b.P)
    np.testing.assert_array_equal(a.Q, b.Q)
    a.seed(3)
    b.seed(3)
    for m in (a, b):
        if entry == 'feature_training_bias':
            m.feature_training_bias()
        else:
            m.train(handle_bias=entry == 'train_bias')
    assert len(b.rmse_history) == 4
    _assert_same_model(a, b, biases=entry == 'feature_training_bias')


@pytest.mark.parametrize('over', [
    {'lr_decay': 0.8},
    {'lr_plateau_decay': 0.5, 'min_epochs': 1, 'max_epochs': 5,
     'min_improvement': 10.0},
    {'learning_rate': 0.05, 'learning_rate_users': 0.02,
     'regularization_model': 0.03, 'init_mode': 'constant'}])
def test_model_schedules_match_jax(small_dataset, over):
    a, b = _pair(small_dataset, _params(**over))
    for m in (a, b):
        m.train(handle_bias=True)
    _assert_same_model(a, b)
    if 'lr_plateau_decay' in over:
        assert len(b.rmse_history) == 5        # decayed past the stalls


def test_continue_training_from_jax_state(small_dataset):
    '''JAX trains 2 epochs; the port model built from its arrays (and
    its parameters, through from_numpy) and the JAX model both continue
    2 more with initialize_model=False.'''
    params = _params(min_epochs=2, max_epochs=2)
    a, _ = _pair(small_dataset, params)
    a.train(handle_bias=True)
    b = interop.from_numpy(a.P, a.Q, a.users_bias, a.items_bias,
                           a.overall_bias, a.ratings.coo(),
                           parameters=params, device='cpu')
    assert b.batch_size == 512 and b.inner_steps == 4
    for m in (a, b):
        m.train(initialize_model=False, handle_bias=True)
    _assert_same_model(a, b)
    with pytest.raises(ValueError):
        interop.from_numpy(a.P, a.Q, None, None, None, a.ratings.coo(),
                           parameters={'nbr_features': 3}, device='cpu')


def test_biased_sgd_rmse_floor():
    '''The test_acceptance_ml100k.py setup and floors on the port's copy
    of the ML-100K-shape generator.'''
    from mfrec_tpu.data import ml100k_like as jax_ml100k
    from mfrec_tpu.eval.metrics import test_predict_rating
    (u, i, v), test = ml100k_like.u1_split(seed=0)
    (ju, ji, jv), jtest = jax_ml100k.u1_split(seed=0)
    for x, y in ((u, ju), (i, ji), (v, jv), (test, jtest)):
        assert x.tobytes() == y.tobytes()             # the copy is exact
    m = GDRecommender(ml100k_like.N_USERS, ml100k_like.N_ITEMS,
                      {'nbr_features': 16, 'min_epochs': 30,
                       'max_epochs': 30, 'engine': 'alternating',
                       'batch_size': 8192, 'inner_steps': 4}, device='cpu')
    m.set_ratings(u, i, v)
    m.train(handle_bias=True)
    test = test.astype(np.float64)
    rmse = test_predict_rating(m, test, nbr_samples=20000,
                               predictor='predict_rating_with_bias',
                               quiet=True)[0]
    assert rmse <= 0.76, rmse
    mu = v.mean()
    ci = np.bincount(i, minlength=ml100k_like.N_ITEMS)
    bi = np.bincount(i, weights=v - mu, minlength=ml100k_like.N_ITEMS) \
        / np.maximum(ci, 1)
    resid = v - mu - bi[i]
    cu = np.bincount(u, minlength=ml100k_like.N_USERS)
    bu = np.bincount(u, weights=resid, minlength=ml100k_like.N_USERS) \
        / np.maximum(cu, 1)
    pred = np.clip(mu + bi[test[:, 1].astype(int)]
                   + bu[test[:, 0].astype(int)], 1, 5)
    floor = float(np.sqrt(((test[:, 2] - pred) ** 2).mean()))
    assert rmse < floor - 0.01, (rmse, floor)


def test_load_state_swaps_layouts(small_dataset, tmp_path):
    '''R1: a store swapped in by load_state restarts its version, so the
    JAX model's layout key (version, nnz, batch, window) matches the old
    store's and its cache would serve stale layouts; the port's key also
    carries the store's identity token, so train() builds fresh ones.'''
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = _params(min_epochs=1, max_epochs=1)
    other = GDRecommender(U, I, params, device='cpu')
    other.set_ratings(u, i, np.where(v > 3, 1.0, 5.0).astype(np.float32))
    other.seed(1)
    other._init_factors(True)
    path = str(tmp_path / 'other')
    other.save_state(path)
    ja = JaxGD(U, I, params)
    ja.set_ratings(u, i, v)
    ja.train(handle_bias=True)
    stale = ja._alt_layout_cache[0]
    ja.load_state(path)
    assert (ja.ratings.version, ja.ratings.nnz, ja.batch_size,
            stale[3]) == stale                     # the JAX cache would hit
    m = GDRecommender(U, I, params, device='cpu')
    m.set_ratings(u, i, v)
    m.train(handle_bias=True)
    old_key, (old_pl, _, _, _) = m._alt_layout_cache
    m.load_state(path)
    m.train(handle_bias=True)
    key, (pl_, ql_, _, _) = m._alt_layout_cache
    assert key[1:] == old_key[1:] and key[0] is not old_key[0]
    assert pl_ is not old_pl
    _, _, new_v = m.ratings.coo()
    assert float(pl_.r.sum()) == pytest.approx(float(new_v.sum()))
    assert float(ql_.r.sum()) == pytest.approx(float(new_v.sum()))
    m.train(handle_bias=True)                      # unchanged: reused
    assert m._alt_layout_cache[1][0] is pl_


def test_port_trained_state_loads_in_jax(small_dataset, tmp_path):
    _, test = small_dataset
    tu, ti = test[:, 0].astype(int), test[:, 1].astype(int)
    _, b = _pair(small_dataset, _params())
    b.train(handle_bias=True)
    path = str(tmp_path / 'port')
    b.save_state(path)
    a = JaxGD(b.nbr_users, b.nbr_items)
    a.load_state(path)
    for pred in ('predict_rating', 'predict_rating_with_bias'):
        np.testing.assert_allclose(a.predict_batch(ti, tu, pred),
                                   b.predict_batch(ti, tu, pred), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(a.P), b.P)
    ids_a, _ = a.recommend_batch(np.arange(10), 5)
    ids_b, _ = b.recommend_batch(np.arange(10), 5)
    np.testing.assert_array_equal(np.asarray(ids_a), ids_b)


@pytest.mark.parametrize('over,exc', [
    ({'resilience': 1}, Error),
    ({'engine': 'alternating_ring'}, NotImplementedError),
    ({'engine': 'alternating_sharded', 'n_slices': 2}, NotImplementedError),
    ({'engine': 'dsgd'}, NotImplementedError),
    ({'engine': 'alternating_sharded'}, NotImplementedError),
    ({'engine': 'no_such_engine'}, Error),
    ({'lr_decay': 1.5}, Error),
    ({'lr_plateau_decay': 0.0}, Error),
    ({'init_mode': 'zeros'}, Error),
    ({'feature_init': 0.0}, Error)])
def test_unported_options_raise(over, exc):
    u, i, v = _stream(20, 10, 200)
    m = GDRecommender(20, 10, _params(**over), device='cpu')
    m.set_ratings(u, i, v)
    with pytest.raises(exc):
        m.train(handle_bias=True)


def test_model_matches_jax_at_default_sweeps():
    '''The default inner_steps=128: JAX and port GDRecommenders at rank
    6, 80 users x 50 items, 1,500 ratings, 3 epochs, the same init (the
    same seed draws the same factors, bit for bit).

    The RMSE history is held to 1e-5 relative.  The factors are held to
    the drift that bf16 flips can build up, not to FACTOR_ATOL: f32 sums
    in another order can flip one bf16 rounding of a gradient term, which
    moves a row by at most lr * 2^-8 * |g| / cnt in one sweep (see the
    top of this file), with |g| <= ((hi - lo) + K) * max|F| (the error is
    at most hi - lo, the fixed row and the decayed row at most max|F|)
    and cnt at least the fewest ratings of any rated row.  The whole
    stream is one batch per half-pass, so a row sees 128 sweeps per
    epoch: the bound is 3 * 128 such moves, 0.168 here (lr 0.15, max|F|
    1.85, cnt_min 10).  Measured drift 5.8e-4 (items' Q; the biases
    agree exactly): the two models differ only in the f32 summation
    order of the XLA-branch sweeps.'''
    rng = np.random.default_rng(11)
    U, I, N = 80, 50, 1500
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.integers(1, 6, N).astype(np.float32)
    params = {'nbr_features': 6, 'min_epochs': 3, 'max_epochs': 3,
              'engine': 'alternating', 'feature_init': 0.05}
    a = JaxGD(U, I, params)
    b = GDRecommender(U, I, params, device='cpu')
    assert b.inner_steps == 128 and b.batch_size >= N
    for m in (a, b):
        m.seed(2)
        m.set_ratings(u, i, v)
        m.train(handle_bias=True)
    np.testing.assert_allclose(b.get_rmse_history(), a.get_rmse_history(),
                               rtol=RMSE_RTOL)
    assert len(b.rmse_history) == 3
    lr, _, _ = b._alt_lrs()
    cnt_min = min(int(np.bincount(x)[np.bincount(x) > 0].min())
                  for x in (u, i))
    fmax = max(float(np.abs(np.asarray(getattr(a, n))).max())
               for n in ('P', 'Q'))
    move = lr * 2.0 ** -8 * ((5.0 - 1.0) + b.K) * fmax / cnt_min
    bound = 3 * 128 * move
    for name in ('P', 'Q', 'users_bias', 'items_bias'):
        got, want = getattr(b, name), np.asarray(getattr(a, name))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=bound, rtol=0,
                                   err_msg=name)


def _faulted_call(entry):
    """The public call of ``entry`` on a small CPU model from seeded P0 and
    Q0: GD ``train(handle_bias=True)``, SVD++
    ``feature_training_implicit()`` or WRMF ``train()``.  Returns P0, Q0
    and the trained P, Q (and SVD++'s Y)."""
    rng = np.random.default_rng(7)
    U, I, N, k = 50, 30, 900, 4
    flat = rng.choice(U * I, N, replace=False)
    u, i = (flat // I).astype(np.int32), (flat % I).astype(np.int32)
    v = np.clip(np.round(rng.normal(3.5, 1.0, N) * 2) / 2, 1,
                5).astype(np.float32)
    P0 = rng.normal(0, 0.1, (U, k)).astype(np.float32)
    Q0 = rng.normal(0, 0.1, (I, k)).astype(np.float32)
    if entry == 'wrmf':
        m = WRMFRecommender(U, I, {'nbr_features': k, 'nbr_epochs': 2},
                            device='cpu')
    else:
        m = GDRecommender(U, I, {'nbr_features': k, 'min_epochs': 2,
                                 'max_epochs': 2, 'batch_size': 128,
                                 'inner_steps': 2, 'inner_steps_implicit': 2,
                                 'learning_rate': 0.1}, device='cpu')
    m.set_ratings(u, i, v)
    m.P, m.Q = P0.copy(), Q0.copy()
    if entry == 'gd':
        m.train(handle_bias=True, initialize_model=False)
    elif entry == 'svdpp':
        m.feature_training_implicit(initialize_model=False)
    else:
        m.train(initialize_model=False)
    leaves = ('P', 'Q', 'Y') if entry == 'svdpp' else ('P', 'Q')
    return P0, Q0, {n: np.array(getattr(m, n)) for n in leaves}


@pytest.mark.parametrize('entry,fault', [
    (e, f) for e, faults in (('gd', train_calls.FAULTS),
                             ('wrmf', train_calls.FAULTS),
                             ('svdpp', svdpp_calls.FAULTS)) for f in faults],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_benchmark_faults_bite(entry, fault, monkeypatch):
    """Each fault the benchmark's ``correct`` check plants on a cell's
    public call changes the state that call trains, and
    ``unchanged_state`` leaves the starting factors (and SVD++'s Y at
    zero) as they were: a fault whose seam was renamed or left the path
    fails here."""
    P0, Q0, sound = _faulted_call(entry)
    fault(monkeypatch)
    _, _, got = _faulted_call(entry)
    assert any(not np.array_equal(got[n], sound[n]) for n in sound)
    if fault.__name__ == 'unchanged_state':
        np.testing.assert_array_equal(got['P'], P0)
        np.testing.assert_array_equal(got['Q'], Q0)
        if 'Y' in got:
            assert not got['Y'].any()
