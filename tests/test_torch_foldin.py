'''Fold-in, held-out evaluation, the sweeps and the rest of
``GDRecommender``'s reference API on the CPU, held to the JAX package on
the same seeded inputs and state.

Tolerances, by test:
- fold-in (``add_user``/``add_item``, ``retrain_*``) from the same state:
  the new id equal, the new row within 1e-6 (the serial tier rounds
  every step to f32 in the JAX order; XLA's FMA contraction is a few
  ulps off), every old row untouched;
- ``test_predict_rating`` / ``_2``, ``shannon_entropy``,
  ``folding_in_new_*``, ``estimate_rating`` on shared arrays: equal;
- the sweeps: each score within 1e-5 (mini-batch tiers, f32 sums in
  another order);
- example 2's workflow, scaled down: held-out RMSE within 1e-3, P@10
  within 0.002, the folded-in user's top-5 the same ids with scores
  within 1e-3 (``chip_smoke.py`` phase 9 holds the card to the CPU with
  the same numbers).'''
import numpy as np
import pytest
import torch

from mfrec_tpu.eval import metrics as jax_metrics
from mfrec_tpu.eval import sweep as jax_sweep
from mfrec_tpu.models.gd import GDRecommender as JaxGD
from mfrec_tpu_torch import interop
from mfrec_tpu_torch.data import ml100k_like
from mfrec_tpu_torch.eval import metrics, sweep
from mfrec_tpu_torch.models.gd import GDRecommender

torch.set_num_threads(1)

ROW_ATOL = 1e-6
SWEEP_ATOL = 1e-5
EX2 = dict(rmse=1e-3, p10=2e-3, score=1e-3)


def _trained_pair(small_dataset, engine='fused', k=4, epochs=3):
    '''A JAX and a port model in the same trained state: the JAX model
    trains, the port model takes its arrays through ``interop``.'''
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = {'min_epochs': epochs, 'max_epochs': epochs, 'nbr_features': k,
              'learning_rate': 0.01, 'engine': engine, 'batch_size': 512}
    jm = JaxGD(U, I, params)
    jm.seed(3)
    jm.set_ratings(u, i, v)
    jm.train(handle_bias=True)
    pm = interop.from_numpy(jm.P, jm.Q, jm.users_bias, jm.items_bias,
                            jm.overall_bias, (u, i, v), device='cpu',
                            parameters=params)
    pm.seed(8)
    jm.seed(8)
    return jm, pm, test


@pytest.mark.parametrize('side', ['user', 'item'])
def test_fold_in_matches_jax(small_dataset, side):
    jm, pm, _ = _trained_pair(small_dataset)
    old = [(m.P.copy(), m.Q.copy()) for m in (jm, pm)]
    ids = np.arange(3, 15, 2)
    vals = np.linspace(1.0, 5.0, ids.shape[0])
    add = 'add_user' if side == 'user' else 'add_item'
    new = [getattr(m, add)('new', ids, vals) for m in (jm, pm)]
    assert new[0] == new[1]
    F = 'P' if side == 'user' else 'Q'
    np.testing.assert_allclose(getattr(pm, F)[new[1]],
                               getattr(jm, F)[new[0]], rtol=0,
                               atol=ROW_ATOL)
    for (P0, Q0), m in zip(old, (jm, pm)):
        np.testing.assert_array_equal(m.P[:P0.shape[0]], P0)
        np.testing.assert_array_equal(m.Q[:Q0.shape[0]], Q0)
    np.testing.assert_array_equal(pm.users_bias, jm.users_bias)
    np.testing.assert_array_equal(pm.items_bias, jm.items_bias)
    if side == 'user':
        # the new user is served (rated nothing in the store)
        a = jm.find_recommended_items(user_index=new[0],
                                      nbr_recommendations=5,
                                      predictor='predict_rating_with_bias')
        b = pm.find_recommended_items(user_index=new[1],
                                      nbr_recommendations=5,
                                      predictor='predict_rating_with_bias')
        assert a[0] == b[0]


@pytest.mark.parametrize('side', ['user', 'item'])
def test_retrain_matches_jax(small_dataset, side):
    jm, pm, _ = _trained_pair(small_dataset)
    (u, i, v), _ = small_dataset
    idx = np.stack([u, i], 1).astype(np.int32)
    who = 7
    for m in (jm, pm):
        getattr(m, 'retrain_' + side)(who, idx, v)
    F = 'P' if side == 'user' else 'Q'
    np.testing.assert_allclose(getattr(pm, F), getattr(jm, F), rtol=0,
                               atol=ROW_ATOL)


def test_fold_in_refuses_mismatched_lengths(small_dataset):
    _, pm, _ = _trained_pair(small_dataset)
    from mfrec_tpu_torch.models.base import Error
    with pytest.raises(Error):
        pm.add_user('x', [1, 2, 3], [5.0, 4.0])


def test_folding_in_projections_and_components_mean(small_dataset):
    jm, pm, _ = _trained_pair(small_dataset)
    r_items = np.random.default_rng(0).uniform(0, 5, pm.nbr_items)
    r_users = np.random.default_rng(1).uniform(0, 5, pm.nbr_users)
    np.testing.assert_allclose(pm.folding_in_new_user('a', r_items),
                               jm.folding_in_new_user('a', r_items),
                               rtol=1e-6)
    np.testing.assert_allclose(pm.folding_in_new_item('b', r_users),
                               jm.folding_in_new_item('b', r_users),
                               rtol=1e-6)
    for m in (jm, pm):
        m.compute_components_mean()
    np.testing.assert_array_equal(pm.components_mean, jm.components_mean)
    A, B = pm.Q[2, 1:], pm.Q[5, 1:]
    assert pm._normalize_cosine_similarity(A, B) == \
        jm._normalize_cosine_similarity(A, B)
    assert pm.estimate_rating(3, 4, 1, cache=2.5, trailing=True) == \
        jm.estimate_rating(3, 4, 1, cache=2.5, trailing=True)


def test_feature_training_folding_matches_jax(tiny_dataset):
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = {'min_epochs': 2, 'max_epochs': 2, 'nbr_features': 3,
              'learning_rate': 0.01, 'engine': 'funk'}
    ms = []
    for m in (JaxGD(U, I, params), GDRecommender(U, I, params,
                                                 device='cpu')):
        m.seed(2)
        m.set_ratings(u, i, v)
        m.feature_training_folding(initialize_model=True, handle_bias=True)
        ms.append(m)
    np.testing.assert_allclose(ms[1].components_mean, ms[0].components_mean,
                               atol=ROW_ATOL)
    np.testing.assert_allclose(ms[1].P, ms[0].P, atol=ROW_ATOL)


@pytest.mark.parametrize('entry', ['feature_training2', 'feature_training_dev',
                                   'online_prototype', 'prototype',
                                   'prototype_p', 'batch'])
def test_training_entry_points_match_jax(tiny_dataset, entry):
    (u, i, v), test = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = {'min_epochs': 2, 'max_epochs': 2, 'nbr_features': 2,
              'learning_rate': 0.01, 'batch_size': 128}
    out = []
    for m in (JaxGD(U, I, params), GDRecommender(U, I, params,
                                                 device='cpu')):
        m.seed(6)
        m.set_ratings(u, i, v)
        if entry == 'online_prototype':
            idx, vals = m.get_ratings(randomize_order=True, seed=4)
            m.feature_training_online_prototype(idx, vals)
        elif entry == 'prototype':
            m.feature_training_prototype()
        elif entry == 'prototype_p':
            m.feature_training_prototype_p(nbr_batch=2)
        elif entry == 'batch':
            res = m.feature_training_batch(batch_size=200, probeset=test)
            out.append(res)
        else:
            getattr(m, entry)()
        out.append((np.asarray(m.P), np.asarray(m.Q)))
    if entry == 'batch':
        np.testing.assert_allclose(out[2], out[0], rtol=1e-5)
        out = [out[1], out[3]]
    atol = 1e-5 if entry == 'batch' else ROW_ATOL
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def test_similar_users_and_top_match_match_jax(small_dataset):
    jm, pm, _ = _trained_pair(small_dataset)
    for method in ('cosine_binary', 'pearson', 'cosine'):
        a = jm.similar_users(4, 6, similarities_output=True, method=method)
        b = pm.similar_users(4, 6, similarities_output=True, method=method)
        assert a[0] == b[0]
        np.testing.assert_allclose(b[1], a[1], rtol=1e-5)
    assert jm.similar_users(4, 'All', similarity_threshold=0.1) == \
        pm.similar_users(4, 'All', similarity_threshold=0.1)
    a, b = jm.find_user_top_match(3), pm.find_user_top_match(3)
    assert a[0] == b[0]
    np.testing.assert_allclose(b[1], a[1], rtol=1e-5)


def test_reference_api_members(small_dataset):
    '''``set_ratings_iterator``, ``get_ratings``, ``predict_rating_by_label``,
    ``warmyup``, ``initialize_bias`` as in the JAX model.'''
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    ms = [JaxGD(U, I, {'nbr_features': 3}),
          GDRecommender(U, I, {'nbr_features': 3}, device='cpu')]
    rows = list(zip(u.tolist(), i.tolist(), v.tolist()))
    for m in ms:
        m.seed(1)
        m.set_ratings_iterator(iter(rows))
        m.warmyup()
        m.init_feature_normal()
    for a, b in zip(ms[0].get_ratings(), ms[1].get_ratings()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ms[0].get_ratings(True, seed=3),
                    ms[1].get_ratings(True, seed=3)):
        np.testing.assert_array_equal(a, b)
    assert ms[0].predict_rating_by_label('user3', 'item2') == \
        ms[1].predict_rating_by_label('user3', 'item2')
    for m in ms:
        m.initialize_bias()
    np.testing.assert_array_equal(ms[0].users_bias, ms[1].users_bias)


# ---------------------------------------------------------------- metrics
def test_metrics_copies_identical(small_dataset):
    '''``test_predict_rating``, ``test_predict_rating2`` and
    ``shannon_entropy``: the copies on the same model and arrays give the
    same numbers (the pin of ``eval/metrics.py``'s host code).'''
    jm, pm, test = _trained_pair(small_dataset)
    for pred in ('predict_rating', 'predict_rating_with_bias'):
        a = jax_metrics.test_predict_rating(pm, test, nbr_samples=len(test),
                                            predictor=pred, quiet=True)
        b = metrics.test_predict_rating(pm, test, nbr_samples=len(test),
                                        predictor=pred, quiet=True)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        c = metrics.test_predict_rating(jm, test, nbr_samples=len(test),
                                        predictor=pred, quiet=True)
        np.testing.assert_allclose(b[0], c[0], rtol=1e-5)
    imap = {j: (j * 7) % pm.nbr_items for j in range(0, pm.nbr_items, 2)}
    a = jax_metrics.test_predict_rating2(pm, test, imap, 500)
    b = metrics.test_predict_rating2(pm, test, imap, 500)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    recs = [pm.find_recommended_items(user_index=x)[0] for x in range(20)]
    assert jax_metrics.shannon_entropy(pm, recs) == \
        metrics.shannon_entropy(pm, recs)
    assert jax_metrics.precision_recall(pm, test, 5) == \
        metrics.precision_recall(pm, test, 5)


def test_predict_rating_prints_its_report(small_dataset, capsys):
    _, pm, test = _trained_pair(small_dataset)
    metrics.test_predict_rating(pm, test, nbr_samples=50)
    out = capsys.readouterr().out
    assert 'Mean root mean square error (RMSE)' in out


# ----------------------------------------------------------------- sweeps
def _factory(pair_cls, U, I, u, i, v):
    def make(params):
        p = {'min_epochs': 2, 'max_epochs': 2, 'nbr_features': 3,
             'learning_rate': 0.01, 'engine': 'fused', 'batch_size': 256}
        p.update(params)
        m = pair_cls(U, I, p) if pair_cls is JaxGD \
            else pair_cls(U, I, p, device='cpu')
        m.seed(4)
        m.set_ratings(u, i, v)
        return m
    return make


def test_sweeps_match_jax(small_dataset):
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    jf = _factory(JaxGD, U, I, u, i, v)
    pf = _factory(GDRecommender, U, I, u, i, v)
    a = jax_sweep.sweep_parameter(jf, {'handle_bias': True}, test,
                                  'regularization_model', [0.01, 0.1])
    b = sweep.sweep_parameter(pf, {'handle_bias': True}, test,
                              'regularization_model', [0.01, 0.1])
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(b[1], a[1], atol=SWEEP_ATOL)
    # the pin: the copy and the original on the same port models, equal
    c = jax_sweep.sweep_parameter(pf, {'handle_bias': True}, test,
                                  'regularization_model', [0.01, 0.1])
    np.testing.assert_array_equal(b[1], c[1])
    for name, args in (('optimize_dim', ({}, test, [2])),
                       ('optimize_similarity_threshold',
                        ({}, test, [0.3]))):
        np.testing.assert_array_equal(
            getattr(sweep, name)(pf, *args)[1],
            getattr(jax_sweep, name)(pf, *args)[1])
    a = jax_sweep.optimize_dim(jf, {}, test, dims=[2, 4])
    b = sweep.optimize_dim(pf, {}, test, dims=[2, 4])
    np.testing.assert_allclose(b[1], a[1], atol=SWEEP_ATOL)
    a = jax_sweep.optimize_similarity_threshold(jf, {}, test, [0.1, 0.5])
    b = sweep.optimize_similarity_threshold(pf, {}, test, [0.1, 0.5])
    np.testing.assert_allclose(b[1], a[1], atol=SWEEP_ATOL)
    a = jax_sweep.sweep_parameter(jf, {}, test, 'nbr_features', [2],
                                  metric='precision')
    b = sweep.sweep_parameter(pf, {}, test, 'nbr_features', [2],
                              metric='precision')
    np.testing.assert_allclose(b[1], a[1], atol=SWEEP_ATOL)


def test_regularization_sweep_matches_jax(small_dataset):
    (u, i, v), test = small_dataset
    regs = [0.0, 0.02, 0.2]
    a = jax_sweep.optimize_regularization_vmapped(u, i, v, test, regs,
                                                  rank=4, epochs=3,
                                                  batch_size=512, seed=2)
    b = sweep.optimize_regularization_vmapped(u, i, v, test, regs, rank=4,
                                              epochs=3, batch_size=512,
                                              seed=2, device='cpu')
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(b[1], a[1], atol=SWEEP_ATOL)


def test_optimize_k_raises_naming_item_8(small_dataset):
    _, pm, test = _trained_pair(small_dataset)
    with pytest.raises(NotImplementedError, match='item 8'):
        sweep.optimize_k(pm, test)


# ------------------------------------------------------ example 2, scaled
def test_example2_workflow_matches_jax():
    '''``examples/example2_movielens_100k_sgd.py:44-61`` on both packages,
    scaled down (the synthetic ML-100K u1 split's first 150 users, 40
    epochs at most): the fused engine, the held-out RMSE, P@10, the
    cold-start fold-in and its top-5.'''
    (u, i, v), test = ml100k_like.u1_split(seed=0)
    keep, tkeep = u < 150, test[:, 0] < 150
    u, i, v, test = u[keep], i[keep], v[keep], test[tkeep]
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = {'min_epochs': 30, 'max_epochs': 40, 'min_improvement': 1e-4,
              'feature_init': 0.1, 'learning_rate': 0.01,
              'regularization_model': 0.02, 'nbr_features': 16,
              'engine': 'fused'}
    out = []
    for m, mod in ((JaxGD(U, I, params), jax_metrics),
                   (GDRecommender(U, I, params, device='cpu'), metrics)):
        m.seed(0)
        m.set_ratings(u, i, v)
        m.train(handle_bias=True)
        hist = list(m.rmse_history)
        rmse = mod.test_predict_rating(m, test, nbr_samples=len(test),
                                       predictor='predict_rating_with_bias',
                                       quiet=True)[0]
        p10 = mod.precision_recall(m, test, nbr_recommendations=10,
                                   predictor='predict_rating_with_bias')[0]
        new = m.add_user('new-user', np.arange(10, dtype=np.int32),
                         np.full(10, 5.0, np.float32))
        ids, scores = m.find_recommended_items(
            user_index=new, nbr_recommendations=5,
            predictor='predict_rating_with_bias')
        out.append((hist, rmse, p10, new, ids, scores))
    (ha, ra, pa, na, ia, sa), (hb, rb, pb, nb, ib, sb) = out
    assert len(ha) == len(hb) and na == nb
    assert abs(ra - rb) <= EX2['rmse'] and abs(pa - pb) <= EX2['p10']
    assert sorted(ia) == sorted(ib)
    np.testing.assert_allclose(sb, sa, atol=EX2['score'])
