'''The FN (factorized neighborhood) tier on the CPU, held to the JAX
package.

Numerics held to, by test (the bounds and reasons of
tests/test_torch_train.py: f32 sums in another order can flip one bf16
rounding of a gradient term; measured well inside them here):
- ``make_fn_alternating_epoch`` on both numerics paths (the Pallas one
  with the JAX base epoch in interpret mode) and through both aggregation
  routes: Paug, Qaug, X, Y within 1e-4, RMSE within 1e-5 relative;
- ``FNRecommender(device='cpu').train(initialize_model=False)`` against
  the JAX model from the same handed-in state (the two frameworks draw
  different random inits; engine pinned to 'alternating', since under
  the suite's 8-device mesh the JAX model's 'auto' picks the sharded
  tier): RMSE history within 1e-5 relative, the materialized P, X, Y and
  the biases within 1e-4;
- fold-in and checkpoints in both directions: within 1e-5.'''
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mfrec_tpu.models.fn import FNRecommender as JaxFN
from mfrec_tpu.ops import fn as jax_fn
from mfrec_tpu_torch import interop
from mfrec_tpu_torch.models.fn import FNRecommender
from mfrec_tpu_torch.ops import fn as fn_ops

from test_torch_implicit import _setup, jax_base_interpret  # noqa: F401

# The suite runs in several xdist workers on one machine; torch's default
# of one intra-op thread per core then oversubscribes the cores, and its
# small CPU ops slow down a hundredfold.  Every worker imports this file.
torch.set_num_threads(1)

FACTOR_ATOL = 1e-4
RMSE_RTOL = 1e-5


@pytest.mark.parametrize('use_kernel,segments,k', [(False, False, 6),
                                                   (False, True, 6),
                                                   (True, False, 6),
                                                   (False, False, 130),
                                                   (True, True, 6),
                                                   (False, True, 130)])
def test_fn_epoch_matches_jax(use_kernel, segments, k, jax_base_interpret):
    '''k=130: [gX | gY] is wider than K4 takes, so X and Y aggregate in
    two calls per batch, or with a segment table in two ``step_aggregate``
    launches; at k=6 a table makes the X/Y step one launch.'''
    Pa, Qa, jl, tl, mu, nrm, W = _setup(k, segments=segments)
    rng = np.random.default_rng(4)
    X = rng.normal(0, 0.05, (40 + W, k)).astype(np.float32)
    Y = rng.normal(0, 0.05, (40 + W, k)).astype(np.float32)
    T = 3 if use_kernel else 4
    args = (W, W, 0.1, 0.05, 0.06, 0.08, 0.02, 0.01, 0.015)
    kw = dict(K_x=0.025, K_y=0.03, inner_steps=T)
    ep_j = jax_fn.make_fn_alternating_epoch(*args, donate=False,
                                            use_pallas_full=use_kernel, **kw)
    ep_t = fn_ops.make_fn_alternating_epoch(*args, use_kernel=use_kernel,
                                            **kw)
    js = tuple(jnp.asarray(x) for x in (Pa, Qa, X, Y))
    ts = tuple(torch.from_numpy(x.copy()) for x in (Pa, Qa, X, Y))
    nrm_t = torch.from_numpy(nrm)
    for scale in (1.0, 0.7):
        *js, rj = ep_j(*js, jnp.float32(mu), *jl, jnp.asarray(nrm),
                       jnp.float32(scale))
        *ts, rt = ep_t(*ts, mu, *tl, nrm_t, np.float32(scale))
        for got, want in zip(ts, js):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=FACTOR_ATOL, rtol=0)
        assert float(rt) == pytest.approx(float(rj), rel=RMSE_RTOL)


def _state(U, I, k, seed=0):
    rng = np.random.default_rng(seed)
    return {'Q': rng.normal(0, 0.1, (I, k)).astype(np.float32),
            'X': rng.normal(0, 0.1, (I, k)).astype(np.float32),
            'Y': rng.normal(0, 0.1, (I, k)).astype(np.float32),
            'users_bias': rng.normal(0, 0.1, U).astype(np.float32),
            'items_bias': rng.normal(0, 0.1, I).astype(np.float32)}


def _pair(dataset, **over):
    (u, i, v), _ = dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = {'nbr_epochs': 3, 'nbr_features': 6, 'batch_size': 1024,
              'inner_steps': 4, 'engine': 'alternating',
              'min_improvement': -1.0}
    params.update(over)
    a = JaxFN(U, I, params)
    b = FNRecommender(U, I, params, device='cpu')
    st = _state(U, I, 6)
    for m in (a, b):
        m.set_ratings(u, i, v)
        for name, val in st.items():
            setattr(m, name, val.copy())
    return a, b


def _assert_same_fn(a, b, atol=FACTOR_ATOL):
    for name in ('P', 'Q', 'X', 'Y', 'users_bias', 'items_bias'):
        got, want = getattr(b, name), np.asarray(getattr(a, name))
        assert got.shape == want.shape and got.dtype == np.float32, name
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize('over', [{}, {'learning_rate': 0.1,
                                       'learning_rate_users': 0.03,
                                       'regularization_users': 0.05}])
def test_model_matches_jax(small_dataset, over):
    a, b = _pair(small_dataset, **over)
    for m in (a, b):
        m.train(initialize_model=False)
    np.testing.assert_allclose(b.get_rmse_history(), a.get_rmse_history(),
                               rtol=RMSE_RTOL)
    assert len(b.rmse_history) == 3
    _assert_same_fn(a, b)
    _, test = small_dataset
    for uu, ii in test[:20, :2].astype(int):
        assert b.predict(ii, uu) == pytest.approx(a.predict(ii, uu),
                                                  abs=1e-4)


def test_fold_in_and_checkpoints(small_dataset, tmp_path):
    a, b = _pair(small_dataset, nbr_epochs=2)
    for m in (a, b):
        m.train(initialize_model=False)
    # fold-in: the same new user's profile on both
    ids = [m.add_user('fresh', [1, 2, 7], [5.0, 4.0, 2.0]) for m in (a, b)]
    assert ids[0] == ids[1] == a.nbr_users - 1
    np.testing.assert_allclose(b.P[ids[1]], np.asarray(a.P)[ids[0]],
                               atol=1e-5)
    b.ratings.set(3, 5, 1.0)
    b.refresh_user_profile(3)
    a.ratings.set(3, 5, 1.0)
    a.refresh_user_profile(3)
    np.testing.assert_allclose(b.P[3], np.asarray(a.P)[3], atol=1e-5)
    # the port's checkpoint loads in the JAX package, X and Y included
    path = str(tmp_path / 'port_fn')
    b.save_state(path)
    a2 = JaxFN(2, 2)
    a2.load_state(path)
    _assert_same_fn(b, a2, atol=0)
    assert a2.predict(4, ids[0]) == pytest.approx(b.predict(4, ids[1]),
                                                  abs=1e-5)
    # and the JAX package's loads in the port
    path = str(tmp_path / 'jax_fn')
    a.save_state(path)
    b2 = interop.load_jax_state(path, device='cpu', model_class=FNRecommender)
    assert isinstance(b2, FNRecommender)
    _assert_same_fn(a, b2, atol=0)
    new_id = b2.add_user('later', [0, 3], [3.0, 4.0])
    assert np.isfinite(b2.predict(4, new_id))


def test_fn_beats_bias_baseline(small_dataset):
    '''tests/test_fn.py's quality check of the default engine at default
    rates, on the port: held-out RMSE beats the bias-only baseline.'''
    from mfrec_tpu.eval.metrics import test_predict_rating
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    m = FNRecommender(U, I, {'nbr_epochs': 30, 'nbr_features': 8,
                             'regularization_items': 0.02,
                             'regularization_users': 0.02,
                             'feature_init': 0.05,
                             'min_improvement': 1e-5}, device='cpu')
    m.seed(0)
    m.set_ratings(u, i, v)
    m.train()
    rmse_fn = test_predict_rating(m, test, nbr_samples=len(test),
                                  predictor='predict', quiet=True)[0]
    mu = float(v.mean())
    tu = test[:, 0].astype(int)
    ti = test[:, 1].astype(int)
    pred = np.clip(mu + m.users_bias[tu] + m.items_bias[ti], 1.0, 5.0)
    rmse_bias = float(np.sqrt(((test[:, 2] - pred) ** 2).mean()))
    assert rmse_fn < rmse_bias - 0.02, (rmse_fn, rmse_bias)
    hist = m.get_rmse_history()
    assert hist[-1] < hist[0]


def test_init_and_aggregates():
    '''``init_fn_state`` draws Q, X, Y ~ N(0, f) from its seed (the same
    seed, the same state); ``user_aggregates`` against the JAX function
    on a handed-in state.'''
    s1 = fn_ops.init_fn_state(5, 30, 4, feature_init=0.2, seed=7, mu=3.5,
                              device='cpu')
    s2 = fn_ops.init_fn_state(5, 30, 4, feature_init=0.2, seed=7, mu=3.5,
                              device='cpu')
    assert all(torch.equal(x, y) for x, y in zip(s1, s2))
    assert 0.1 < float(s1.Q.std()) < 0.3 and float(s1.mu) == 3.5
    st = _state(12, 30, 4, seed=2)
    rng = np.random.default_rng(3)
    fl = rng.integers(0, 30, (12, 7)).astype(np.int32)
    fv = rng.uniform(1, 5, (12, 7)).astype(np.float32)
    fm = (rng.random((12, 7)) > 0.3).astype(np.float32)
    arrs = (st['Q'], st['X'], st['Y'], st['users_bias'], st['items_bias'])
    want = jax_fn.user_aggregates(
        jax_fn.FNState(*(jnp.asarray(x) for x in arrs), jnp.float32(3.5)),
        jnp.asarray(fl), jnp.asarray(fv), jnp.asarray(fm))
    got = fn_ops.user_aggregates(
        fn_ops.FNState(*(torch.from_numpy(x) for x in arrs),
                       torch.tensor(3.5)),
        torch.from_numpy(fl), torch.from_numpy(fv), torch.from_numpy(fm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('engine,exc', [('fused', NotImplementedError),
                                        ('alternating_sharded',
                                         NotImplementedError),
                                        ('no_such_engine', Exception)])
def test_unported_engines_raise(engine, exc):
    rng = np.random.default_rng(0)
    m = FNRecommender(20, 10, {'engine': engine, 'nbr_epochs': 1},
                      device='cpu')
    m.set_ratings(rng.integers(0, 20, 100).astype(np.int32),
                  rng.integers(0, 10, 100).astype(np.int32),
                  rng.uniform(1, 5, 100).astype(np.float32))
    with pytest.raises(exc):
        m.train()
