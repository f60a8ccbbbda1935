'''``KMFRecommender`` and the KMF fused tier on the CPU, held to the JAX
package (``mfrec_tpu/models/kmf.py``, ``mfrec_tpu/ops/kmf.py``) on the
same seeded inputs.

Tolerances, by test:
- the fused epoch against ``make_kmf_fused_epoch``: factors within 1e-5
  absolute, RMSE within 1e-5 relative (a row that repeats in a batch
  takes its entries' sum in one add, where JAX's scatter adds them one
  by one; f32 sums in another order);
- ``train()`` on the alternating tier against the JAX model on the CPU
  (its XLA branch: f32 window and fixed side, gradients rounded to bf16
  before the row sum): the protocol of ``tests/test_torch_train.py``,
  RMSE histories within 1e-5 relative, factors within 1e-4 at the
  row-mean default rate 0.15 (a flipped bf16 rounding of one gradient
  term moves a factor by at most lr * 2^-8 * |g| / cnt, so the bound
  scales with lr: 2e-4 at 0.3);
- ``engine='serial'`` and the fold-ins against the JAX model: the
  serial tier's 1e-6 a few epochs in; a fold-in's 200 epochs move the
  new row by at most 2e-5 (f32 ulps of the dot's order compound), and
  its top-5 ids are the same;
- the predictors, the host scoring path, interop and the checkpoint:
  exact (the same numpy code on the same arrays);
- the JAX package's own gates for the port's twins of its tests
  (``tests/test_kmf.py``, ``test_class_parity.py``,
  ``test_acceptance_ml100k.py``).'''
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mfrec_tpu.eval.metrics import test_predict_rating as jax_tpr
from mfrec_tpu.models.base import Error as JaxError
from mfrec_tpu.models.kmf import KMFRecommender as JaxKMF
from mfrec_tpu.ops import kmf as jax_kmf
from mfrec_tpu_torch import interop
from mfrec_tpu_torch.data import ml100k_like
from mfrec_tpu_torch.eval.metrics import test_predict_rating as port_tpr
from mfrec_tpu_torch.models.base import Error
from mfrec_tpu_torch.models.kmf import KMFRecommender
from mfrec_tpu_torch.ops import kmf as kmf_ops
from mfrec_tpu_torch.ops import sgd_mf
from mfrec_tpu_torch.ops.reference_numpy import kmf_train_oracle

torch.set_num_threads(1)

TIER_ATOL = 1e-5
RMSE_RTOL = 1e-5
FACTOR_ATOL = 1e-4
SERIAL_ATOL = 1e-6
FOLD_ATOL = 2e-5
LINKS = ['train_logistic_kernel', 'train_linear_kernel']


def _dims(data):
    (u, i, v), _ = data
    return u, i, v, int(u.max()) + 1, int(i.max()) + 1


def _pair(data, params, seed=0):
    '''The JAX model and the port's CPU model, same ratings and seed.'''
    u, i, v, U, I = _dims(data)
    out = []
    for cls, kw in ((JaxKMF, {}), (KMFRecommender, {'device': 'cpu'})):
        m = cls(U, I, dict(params), **kw)
        m.seed(seed)
        m.set_ratings(u, i, v)
        out.append(m)
    return out


def _same_model(a, b, atol):
    for name in ('P', 'Q', 'users_bias', 'items_bias'):
        np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                   atol=atol, rtol=0, err_msg=name)


# ------------------------------------------------------------ surface
def test_public_surface_matches_jax():
    a, b = JaxKMF(5, 4), KMFRecommender(5, 4, device='cpu')
    assert KMFRecommender.PARAMETERS_INDEX == JaxKMF.PARAMETERS_INDEX
    assert KMFRecommender.KERNELS == JaxKMF.KERNELS
    assert b._default_predictor_mode == a._default_predictor_mode
    for attr in set(JaxKMF.PARAMETERS_INDEX.values()):
        assert getattr(b, attr) == getattr(a, attr), attr
        assert type(getattr(b, attr)).__name__ == \
            type(getattr(a, attr)).__name__, attr
    public = {x for x in dir(JaxKMF) if not x.startswith('__')
              and x in vars(JaxKMF)}
    assert public <= set(dir(KMFRecommender))
    for k in ('logistic', 'train_linear_kernel'):
        assert b._kernel_name(k) == a._kernel_name(k)
    with pytest.raises(Error):
        b._kernel_name('rbf')
    with pytest.raises(Error):
        KMFRecommender(5, 4, {'no_such': 1}, device='cpu')
    assert b._alt_lr() == a._alt_lr() == 0.15
    b.learning_rate = 0.01
    assert b._alt_lr() == 0.01


def test_predictors_match_jax(small_dataset):
    a, b = _pair(small_dataset, {'nbr_features': 5, 'nbr_epochs': 2,
                                 'batch_size': 1024, 'inner_steps': 2})
    a.train()
    b.P, b.Q = a.P.copy(), a.Q.copy()
    b.users_bias, b.items_bias = a.users_bias.copy(), a.items_bias.copy()
    b.overall_bias = a.overall_bias
    items, users = np.arange(20), np.arange(20) % 7
    for pred in ('predict_logistic', 'predict_linear', 'predict_linear_neg',
                 'predict'):
        assert getattr(b, pred)(3, 5) == getattr(a, pred)(3, 5)
        np.testing.assert_array_equal(b.predict_batch(items, users, pred),
                                      a.predict_batch(items, users, pred))
        assert b.predict_rating_by_label('user_2', 'item_9', pred) == \
            a.predict_rating_by_label('user_2', 'item_9', pred)
    assert b.predict_rating_by_label('nobody', 'item_9') == \
        a.predict_rating_by_label('nobody', 'item_9')
    with pytest.raises(KeyError):
        b.predict_batch(items, users, 'predict_rbf')


# --------------------------------------------------------- fused tier
@pytest.mark.parametrize('kernel', ['logistic', 'linear'])
def test_fused_epoch_matches_jax(small_dataset, kernel):
    u, i, v, U, I = _dims(small_dataset)
    rng = np.random.default_rng(1)
    st = [rng.normal(0, 0.1, (U, 8)).astype(np.float32),
          rng.normal(0, 0.1, (I, 8)).astype(np.float32),
          np.zeros(U, np.float32), np.zeros(I, np.float32)]
    batches = sgd_mf.batch_ratings(u, i, v.astype(np.float32), 512, seed=0)
    lr = 0.05 if kernel == 'logistic' else 0.01
    je = jax_kmf.make_kmf_fused_epoch(kernel=kernel, lr=lr)
    pe = kmf_ops.make_kmf_fused_epoch(kernel=kernel, lr=lr)
    plan = sgd_mf.fused_plan(batches[0], batches[1], 'cpu')
    js = [jnp.asarray(a) for a in st]
    ps = [torch.from_numpy(a.copy()) for a in st]
    jb = [jnp.asarray(a) for a in batches]
    pb = [torch.from_numpy(a) for a in batches]
    for _ in range(3):
        *js, jr = je(*js, *jb)
        *ps, pr = pe(*ps, *pb, plan=plan)
        assert float(pr) == pytest.approx(float(jr), rel=RMSE_RTOL)
    for a, b in zip(js, ps):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TIER_ATOL,
                                   rtol=0)
    # masks: a side that does not learn stays, bit for bit
    pe_u = kmf_ops.make_kmf_fused_epoch(kernel=kernel, lr=lr,
                                        update_items=False)
    ps2 = [torch.from_numpy(a.copy()) for a in st]
    pe_u(*ps2, *pb, plan=plan)
    assert torch.equal(ps2[1], torch.from_numpy(st[1]))
    assert torch.equal(ps2[3], torch.from_numpy(st[3]))


@pytest.mark.parametrize('kernel', LINKS)
def test_fused_model_matches_jax(small_dataset, kernel):
    a, b = _pair(small_dataset, {'nbr_features': 6, 'nbr_epochs': 3,
                                 'engine': 'fused', 'batch_size': 1024,
                                 'learning_rate': 0.02})
    for m in (a, b):
        m.train(kernel=kernel)
    np.testing.assert_allclose(b.rmse_history, a.rmse_history,
                               rtol=RMSE_RTOL)
    _same_model(a, b, TIER_ATOL)


# --------------------------------------------------- alternating tier
@pytest.mark.parametrize('over', [{}, {'learning_rate': 0.3},
                                  {'lr_decay': 0.7},
                                  {'min_improvement': 0.01, 'nbr_epochs': 8,
                                   'lr_plateau_decay': 0.5}])
@pytest.mark.parametrize('kernel', LINKS)
def test_alternating_model_matches_jax(small_dataset, kernel, over):
    params = dict({'nbr_features': 6, 'nbr_epochs': 4, 'batch_size': 1024,
                   'inner_steps': 4, 'regularization_users': 0.05,
                   'regularization_items': 0.03}, **over)
    a, b = _pair(small_dataset, params)
    for m in (a, b):
        m.train(kernel=kernel)
    assert len(b.rmse_history) == len(a.rmse_history) >= 1
    np.testing.assert_allclose(b.rmse_history, a.rmse_history,
                               rtol=RMSE_RTOL)
    _same_model(a, b, FACTOR_ATOL * max(1.0, b._alt_lr() / 0.15))
    assert np.abs(b.users_bias).max() > 0


# --------------------------------------------------------- serial tier
@pytest.mark.parametrize('kernel', LINKS)
def test_serial_model_matches_jax(tiny_dataset, kernel):
    a, b = _pair(tiny_dataset, {'nbr_features': 4, 'nbr_epochs': 3,
                                'engine': 'serial'}, seed=7)
    for m in (a, b):
        m.train(kernel=kernel)
    np.testing.assert_allclose(b.rmse_history, a.rmse_history,
                               atol=SERIAL_ATOL, rtol=0)
    _same_model(a, b, SERIAL_ATOL)


def test_serial_min_improvement_matches_jax(tiny_dataset):
    a, b = _pair(tiny_dataset, {'nbr_features': 4, 'nbr_epochs': 40,
                                'engine': 'serial', 'learning_rate': 0.05,
                                'min_improvement': 0.01})
    for m in (a, b):
        m.train()
    assert 1 < len(b.rmse_history) == len(a.rmse_history) < 40
    np.testing.assert_allclose(b.rmse_history, a.rmse_history,
                               atol=SERIAL_ATOL, rtol=0)


def test_serial_divergence_raises_the_drivers_error(tiny_dataset):
    params = {'nbr_features': 4, 'nbr_epochs': 30, 'engine': 'serial',
              'learning_rate': 3.0}
    a, b = _pair(tiny_dataset, params)
    msgs = []
    for m in (a, b):
        P0 = m.P
        with pytest.raises(FloatingPointError) as ei:
            m.train(kernel='train_linear_kernel')
        msgs.append(str(ei.value).split('rmse=')[1].split(' (')[0])
        assert m.P is P0 is None or m.P is not None
    # both at the same epoch (the rmse value itself is nan or inf)
    assert msgs[0].split(' at ')[1] == msgs[1].split(' at ')[1]


def test_class_matches_oracle(tiny_dataset):
    '''The port twin of ``tests/test_class_parity.py::
    test_kmf_class_matches_oracle``: ``engine='serial'`` through
    ``train`` against the sequential numpy oracle, the same init and
    shuffle draws.'''
    u, i, v, U, I = _dims(tiny_dataset)
    dim, epochs = 3, 3
    m = KMFRecommender(U, I, {'nbr_epochs': epochs, 'nbr_features': dim,
                              'learning_rate': 0.01, 'engine': 'serial'},
                       device='cpu')
    m.seed(7)
    m.set_ratings(u, i, v)
    m.train(kernel='train_logistic_kernel')
    rng = np.random.default_rng(7)
    Q0 = rng.normal(0.0, 0.1, (I, dim))
    P0 = rng.normal(0.0, 0.1, (U, dim))
    shuffle_seed = int(rng.integers(2 ** 31))
    cu, ci, cv = m.ratings.coo()
    perm = np.random.default_rng(shuffle_seed).permutation(cu.shape[0])
    idx = np.stack([cu[perm], ci[perm]], 1)
    uo, vo = Q0.T.copy(), P0.T.copy()
    bu, bi = np.zeros(U), np.zeros(I)
    kmf_train_oracle(epochs, dim, m.learning_rate, m.K_users, m.K_items,
                     m.K_bias, uo, vo, idx, cv[perm].astype(np.float64), bi,
                     bu, kernel='logistic')
    np.testing.assert_allclose(m.Q, uo.T, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(m.P, vo.T, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(m.users_bias, bu, atol=2e-3)
    np.testing.assert_allclose(m.items_bias, bi, atol=2e-3)


def test_serial_refuses_schedules_unlike_jax(tiny_dataset):
    '''ROADMAP queue 3, R5: the JAX model's ``engine='serial'`` trains
    with ``lr_decay`` != 1 and ignores it; the port refuses it, as both
    packages refuse it on ``'fused'``.  The fold-ins still run on such a
    model (a schedule is a training knob).'''
    for over in ({'lr_decay': 0.5},
                 {'lr_plateau_decay': 0.5, 'min_improvement': 0.01}):
        params = dict({'nbr_features': 4, 'nbr_epochs': 2,
                       'engine': 'serial'}, **over)
        a, b = _pair(tiny_dataset, params)
        a.train()                                # R5: no refusal
        assert len(a.rmse_history) >= 1
        with pytest.raises(Error):
            b.train()
        b.engine = 'alternating'
        b.set_parameters({'batch_size': 512, 'inner_steps': 2})
        b.train()
        b.engine = 'serial'
        new = b.add_user('late', np.arange(5, dtype=np.int32),
                         np.full(5, 4.0, np.float32))
        assert np.isfinite(b.P[new]).all() and len(b.rmse_history) == 2


# ----------------------------------------------------------- fold-in
def _trained_pair(data, **over):
    params = dict({'nbr_features': 6, 'nbr_epochs': 3, 'batch_size': 1024,
                   'inner_steps': 2}, **over)
    a, b = _pair(data, params)
    a.train()
    b.P, b.Q = a.P.copy(), a.Q.copy()
    b.users_bias, b.items_bias = a.users_bias.copy(), a.items_bias.copy()
    b.overall_bias = a.overall_bias
    b.rng = np.random.default_rng(11)
    a.rng = np.random.default_rng(11)
    return a, b


@pytest.mark.parametrize('kernel', LINKS)
def test_fold_ins_match_jax(small_dataset, kernel):
    a, b = _trained_pair(small_dataset, nbr_epochs=3)
    for m in (a, b):
        m.nbr_epochs = 200                       # the shipped fold-in depth
    items = np.array([3, 9, 27, 40, 41, 77, 90, 120], np.int32)
    vals = np.array([5, 4, 1, 2, 5, 3, 4, 4], np.float32)
    users = np.array([1, 4, 6, 7, 9], np.int32)
    ids = []
    for m in (a, b):
        nu = m.add_user('new-user', items, vals)
        ni = m.add_item('new-item', users, vals[:5])
        ids.append((nu, ni))
        idx = np.stack([np.full(8, 5, np.int32), items], 1)
        m.retrain_user(5, idx, vals, kernel=kernel)
        m.retrain_item(9, np.stack([users, np.full(5, 9, np.int32)], 1),
                       vals[:5], kernel=kernel)
    assert ids[0] == ids[1]
    assert len(b.rmse_history) == len(a.rmse_history) == 200
    _same_model(a, b, FOLD_ATOL)
    nu = ids[0][0]
    for pred in ('predict_logistic', 'predict_linear'):
        assert b.find_recommended_items(nu, nbr_recommendations=5,
                                        predictor=pred)[0] == \
            a.find_recommended_items(nu, nbr_recommendations=5,
                                     predictor=pred)[0]


def test_retrain_user_only_touches_user(small_dataset):
    '''The port twin of ``tests/test_kmf.py::
    test_kmf_retrain_user_only_touches_user``.'''
    u, i, v, U, I = _dims(small_dataset)
    model = KMFRecommender(U, I, {'nbr_epochs': 5, 'nbr_features': 6},
                           device='cpu')
    model.seed(0)
    model.set_ratings(u, i, v)
    model.train()
    Q_before, P_before = model.Q.copy(), model.P.copy()
    bi_before = model.items_bias.copy()
    idx = np.stack([u, i], 1).astype(np.int32)
    model.retrain_user(3, idx, v)
    np.testing.assert_array_equal(model.Q, Q_before)
    np.testing.assert_array_equal(model.items_bias, bi_before)
    assert not np.allclose(model.P[3], P_before[3])
    others = np.arange(U) != 3
    np.testing.assert_array_equal(model.P[others], P_before[others])


def test_empty_fold_in_raises(small_dataset):
    '''A fold-in with no rating: the JAX epoch fails to index its empty
    stream (IndexError); the port raises the driver's guard on the
    epoch's rmse, sqrt(0 / 0).  A length mismatch is the model's Error in
    both.'''
    a, b = _trained_pair(small_dataset)
    for m, exc in ((a, IndexError), (b, FloatingPointError)):
        with pytest.raises(exc):
            m.add_user('nobody', np.zeros(0, np.int32),
                       np.zeros(0, np.float32))
        with pytest.raises(Error if m is b else JaxError):
            m.add_user('bad', np.arange(3), np.ones(2, np.float32))


# ------------------------------------------------ the JAX tests' twins
def test_model_end_to_end(small_dataset):
    '''The port twin of ``tests/test_kmf.py::test_kmf_model_end_to_end``,
    and the workflow's other steps on a JAX model holding the port's
    trained state: the same held-out RMSE, the host scoring path's top-n
    equal to the JAX model's, ``add_item`` within the fold-in's
    tolerance.'''
    (u, i, v), test = small_dataset
    params = {'nbr_epochs': 200, 'nbr_features': 8, 'learning_rate': 0.02,
              'regularization_users': 0.05, 'regularization_items': 0.05,
              'inner_steps': 8}
    _, b = _pair(small_dataset, params)
    b.train()
    rmse = port_tpr(b, test, nbr_samples=len(test),
                    predictor='predict_logistic', quiet=True)[0]
    base_rmse = float(np.sqrt(((test[:, 2] - v.mean()) ** 2).mean()))
    assert rmse < base_rmse
    a = JaxKMF(b.nbr_users, b.nbr_items, params)
    a.set_ratings(u, i, v)
    a.P, a.Q = b.P.copy(), b.Q.copy()
    a.users_bias, a.items_bias = b.users_bias.copy(), b.items_bias.copy()
    a.overall_bias = b.overall_bias
    assert jax_tpr(a, test, nbr_samples=len(test),
                   predictor='predict_logistic', quiet=True)[0] == rmse
    for user in (0, 17, 99):
        got = b.find_recommended_items(user, nbr_recommendations=10,
                                       predictor='predict_linear_neg')
        assert got == a.find_recommended_items(
            user, nbr_recommendations=10, predictor='predict_linear_neg')
        assert len(got[0]) == 10
    b.rng, a.rng = np.random.default_rng(2), np.random.default_rng(2)
    ids = [m.add_item('new-item', np.arange(6, dtype=np.int32),
                      np.full(6, 4.0, np.float32)) for m in (a, b)]
    assert ids[0] == ids[1] == b.nbr_items - 1
    np.testing.assert_allclose(b.Q[ids[1]], a.Q[ids[0]], atol=FOLD_ATOL,
                               rtol=0)


def test_alternating_tracks_fused(small_dataset):
    '''The port twin of ``tests/test_kmf.py::
    test_kmf_alternating_tracks_fused``.'''
    u, i, v, U, I = _dims(small_dataset)
    test = small_dataset[1]

    def train(engine, kernel, lr):
        m = KMFRecommender(U, I, {'nbr_epochs': 40, 'nbr_features': 8,
                                  'learning_rate': lr,
                                  'regularization_users': 0.05,
                                  'regularization_items': 0.05,
                                  'engine': engine, 'batch_size': 2048,
                                  'inner_steps': 4}, device='cpu')
        m.seed(0)
        m.set_ratings(u, i, v)
        m.train(kernel=kernel)
        pred = ('predict_logistic' if 'logistic' in kernel
                else 'predict_linear')
        return m, port_tpr(m, test, nbr_samples=len(test), predictor=pred,
                           quiet=True)[0]

    for kernel in LINKS:
        m_alt, r_alt = train('alternating', kernel, lr=0.3)
        m_fus, r_fus = train('fused', kernel,
                             lr=0.05 if 'logistic' in kernel else 0.01)
        assert np.isfinite(r_alt), kernel
        assert r_alt < r_fus + 0.05, (kernel, r_alt, r_fus)
        assert np.abs(m_alt.users_bias).max() > 0


def test_logistic_rmse_floor_ml100k():
    '''The port twin of ``tests/test_acceptance_ml100k.py::
    test_kmf_logistic_rmse_floor`` on the synthetic u1 split (the JAX
    package measured 0.734 against the bias floor 0.953).'''
    (u, i, v), test = ml100k_like.u1_split(seed=0)
    m = KMFRecommender(ml100k_like.N_USERS, ml100k_like.N_ITEMS,
                       {'nbr_epochs': 40, 'nbr_features': 16,
                        'batch_size': 8192, 'inner_steps': 4}, device='cpu')
    m.set_ratings(u, i, v)
    m.train()
    rmse = port_tpr(m, test.astype(np.float64), nbr_samples=20000,
                    predictor='predict_logistic', quiet=True)[0]
    assert rmse <= 0.78, rmse


# ------------------------------------------- interop and checkpoints
def test_jax_state_carries_over(small_dataset, tmp_path):
    a, _ = _pair(small_dataset, {'nbr_features': 5, 'nbr_epochs': 2,
                                 'batch_size': 1024, 'inner_steps': 2})
    a.train()
    a.save_state(str(tmp_path / 'jax'))
    b = interop.load_jax_state(str(tmp_path / 'jax'), device='cpu',
                               model_class=KMFRecommender)
    c = interop.from_numpy(a.P, a.Q, a.users_bias, a.items_bias,
                           a.overall_bias, a.ratings.coo(), device='cpu',
                           model_class=KMFRecommender,
                           parameters={'nbr_epochs': 7})
    assert isinstance(b, KMFRecommender) and c.nbr_epochs == 7
    items, users = np.arange(30), np.arange(30) % 11
    for m in (b, c):
        for name in ('P', 'Q', 'users_bias', 'items_bias'):
            np.testing.assert_array_equal(getattr(m, name),
                                          getattr(a, name))
        for pred in ('predict_logistic', 'predict_linear_neg'):
            np.testing.assert_array_equal(
                m.predict_batch(items, users, pred),
                a.predict_batch(items, users, pred))
            assert m.find_recommended_items(4, nbr_recommendations=5,
                                            predictor=pred) == \
                a.find_recommended_items(4, nbr_recommendations=5,
                                         predictor=pred)


def test_checkpoint_round_trip(small_dataset, tmp_path):
    _, b = _trained_pair(small_dataset)
    b.add_user('late', np.arange(4, dtype=np.int32),
               np.full(4, 3.0, np.float32))
    b.save_state(str(tmp_path / 'port'))
    c = KMFRecommender(device='cpu')
    c.load_state(str(tmp_path / 'port'))
    for name in ('P', 'Q', 'users_bias', 'items_bias'):
        np.testing.assert_array_equal(getattr(c, name), getattr(b, name))
    assert c.users.labels == b.users.labels
    assert c.overall_bias == b.overall_bias
    users = np.arange(6)
    for pred in ('predict_logistic', 'predict_linear_neg'):
        for x, y in zip(c.recommend_batch(users, 5, predictor=pred),
                        b.recommend_batch(users, 5, predictor=pred)):
            np.testing.assert_array_equal(x, y)
    # the JAX model reads the port's checkpoint
    j = JaxKMF()
    j.load_state(str(tmp_path / 'port'))
    np.testing.assert_array_equal(j.P, b.P)


def test_retrieval_modes_match_jax(small_dataset):
    '''K3's logistic mode (its plain twin on the CPU) and the plain top-n
    against the JAX model's retrieval, and ``recommend_batch`` through the
    host scoring path for ``predict_linear_neg`` (no score mode) against
    the JAX model's, ids and scores equal.'''
    a, b = _trained_pair(small_dataset)
    users = np.array([0, 3, 8, 21, 50])
    for pred in ('predict', 'predict_logistic', 'predict_linear'):
        for use_pallas in (False, True):
            bi, bs = b.recommend_batch(users, 6, predictor=pred,
                                       use_pallas=use_pallas)
            ai, as_ = a.recommend_batch(users, 6, predictor=pred,
                                        sharded=False)
            np.testing.assert_array_equal(bi, np.asarray(ai))
            np.testing.assert_allclose(bs, np.asarray(as_), atol=1e-5,
                                       rtol=1e-5)
    bi, bs = b.recommend_batch(users, 6, predictor='predict_linear_neg')
    ai, as_ = a.recommend_batch(users, 6, predictor='predict_linear_neg')
    np.testing.assert_array_equal(bi, ai)
    np.testing.assert_array_equal(bs, as_)
