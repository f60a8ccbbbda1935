'''A small JAX GDRecommender, trained on the CPU, carried into the port
(through its checkpoint and through from_numpy): predictors, retrieval
and similarity agree.  Tolerances as in test_torch_topk.py: exact
retrieval ids equal and scores within 1e-5; fast retrieval within one
quantization step, ids equal outside quasi-ties.'''
import os

import numpy as np
import pytest

from mfrec_tpu.data.movielens import synthetic_ratings
from mfrec_tpu.models.gd import GDRecommender as JaxGD
from mfrec_tpu_torch import interop
from mfrec_tpu_torch.models.gd import GDRecommender
from test_torch_topk import EXACT, FAST, assert_topn_match

PREDICTORS = ['predict', 'predict_rating', 'predict_rating_with_bias',
              'predict_logistic', 'predict_linear']
USERS = np.arange(0, 80, 3)


@pytest.fixture(scope='module')
def jax_model():
    users, items, vals = synthetic_ratings(80, 50, 1500, rank=3, seed=2)
    m = JaxGD(80, 50, {'nbr_features': 6, 'min_epochs': 8, 'max_epochs': 8,
                       'engine': 'fused', 'learning_rate': 0.02,
                       'batch_size': 512})
    m.set_ratings(users, items, vals)
    m.train(handle_bias=True)
    return m


@pytest.fixture(scope='module', params=['checkpoint', 'from_numpy'])
def pair(request, jax_model, tmp_path_factory):
    m = jax_model
    if request.param == 'checkpoint':
        path = os.path.join(tmp_path_factory.mktemp('ck'), 'gd')
        m.save_state(path)
        p = interop.load_jax_state(path, device='cpu')
    else:
        p = interop.from_numpy(m.P, m.Q, m.users_bias, m.items_bias,
                               m.overall_bias, m.ratings.coo(),
                               {'users': m.users.labels,
                                'items': m.items.labels}, device='cpu')
    return m, p


def test_pointwise_predictors_agree(pair):
    m, p = pair
    rng = np.random.default_rng(0)
    items = rng.integers(0, 50, 40)
    users = rng.integers(0, 80, 40)
    for it, us in zip(items[:10], users[:10]):
        assert p.predict(int(it), int(us)) == pytest.approx(
            m.predict(int(it), int(us)), abs=1e-6)
        assert p.predict_rating_with_bias(int(it), int(us)) == \
            pytest.approx(m.predict_rating_with_bias(int(it), int(us)),
                          abs=1e-6)
    for pred in ('predict', 'predict_rating_with_bias'):
        np.testing.assert_allclose(p.predict_batch(items, users, pred),
                                   m.predict_batch(items, users, pred),
                                   atol=1e-6)
    assert p.predict_rating_by_label('user3', 'item7') == pytest.approx(
        m.predict_rating_by_label('user3', 'item7'), abs=1e-6)


@pytest.mark.parametrize('predictor', PREDICTORS)
@pytest.mark.parametrize('kernel', [False, True])
def test_recommend_batch_exact_agrees(pair, predictor, kernel):
    '''Exact retrieval: the plain path and (kernel=True) the kernel's
    twin against the JAX model's own recommend_batch (XLA / Pallas).'''
    m, p = pair
    ref = m.recommend_batch(USERS, 8, predictor=predictor,
                            use_pallas=kernel)
    got = p.recommend_batch(USERS, 7, predictor=predictor,
                            use_pallas=kernel)
    assert got[0].shape == (len(USERS), 7) and got[0].dtype == np.int32
    assert_topn_match(*got, *ref, 7, **EXACT)


@pytest.mark.parametrize('predictor', ['predict', 'predict_rating_with_bias',
                                       'predict_logistic'])
def test_recommend_batch_fast_agrees(pair, predictor):
    m, p = pair
    ref = m.recommend_batch(USERS, 8, predictor=predictor, fast=True)
    got = p.recommend_batch(USERS, 7, predictor=predictor, fast=True)
    if predictor == 'predict_logistic':
        # the sigmoid post-map squeezes the top scores together past the
        # quantization step; hold the lists to their set overlap
        lo, hi = p.min_rating, p.max_rating
        assert ((got[1] >= lo) & (got[1] <= hi)).all()
        return _assert_same_sets_mostly(got[0], np.asarray(ref[0])[:, :7])
    assert_topn_match(*got, *ref, 7, **FAST)


def _assert_same_sets_mostly(a, b):
    overlap = np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)])
    assert overlap >= 0.9, overlap


def test_recommend_batch_options(pair):
    m, p = pair
    # no masking, and a fixed rated-list width
    for kw in ({'mask_rated': False}, {'rated_pad_to': 64}):
        ref = m.recommend_batch(USERS, 6, **kw)
        got = p.recommend_batch(USERS, 5, **kw)
        assert_topn_match(*got, *ref, 5, **EXACT)
    # n past the catalog clamps to it
    got = p.recommend_batch([1, 2], 500)
    assert got[0].shape == (2, 50)
    # a cached device pair gives the same lists
    dq = p.device_item_terms('predict_rating_with_bias')
    a = p.recommend_batch(USERS, 5, predictor='predict_rating_with_bias',
                          use_pallas=True, device_q=dq)
    b = p.recommend_batch(USERS, 5, predictor='predict_rating_with_bias',
                          use_pallas=True)
    np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(NotImplementedError):
        p.recommend_batch(USERS, 5, sharded=True)


@pytest.mark.parametrize('predictor', ['predict', 'predict_rating_with_bias',
                                       'predict_logistic'])
def test_find_recommended_items_agrees(pair, predictor):
    m, p = pair
    for u in (0, 3, 41):
        ids_r, s_r = m.find_recommended_items(u, nbr_recommendations=6,
                                              predictor=predictor)
        ids, s = p.find_recommended_items(u, nbr_recommendations=5,
                                          predictor=predictor)
        assert_topn_match(np.array([ids]), np.array([s]), np.array([ids_r]),
                          np.array([s_r]), 5, **EXACT)
    # label output and a seeded candidate subset behave the same
    labels, _ = p.find_recommended_items(user_label='user3',
                                         nbr_recommendations=3,
                                         output_label=True)
    assert all(lbl.startswith('item') for lbl in labels)
    m.seed(11)
    p.seed(11)
    a = m.find_recommended_items(5, nbr_recommendations=4, neighborhood=20)
    b = p.find_recommended_items(5, nbr_recommendations=4, neighborhood=20)
    assert a[0] == b[0]
    np.testing.assert_allclose(a[1], b[1], atol=1e-5)


@pytest.mark.parametrize('method', ['pearson', 'cosine', 'norm_cosine',
                                    'euclidean'])
def test_similar_items_agree(pair, method):
    m, p = pair
    for item in (0, 7, 49):
        ids_r, s_r = m.similar_items(item, 6, similarities_output=True,
                                     method=method)
        ids, s = p.similar_items(item, 5, similarities_output=True,
                                 method=method)
        assert_topn_match(np.array([ids]), np.array([s]), np.array([ids_r]),
                          np.array([s_r]), 5, **EXACT)
    assert p.similar_items(7, 3) == m.similar_items(7, 3)


def test_init_and_biases_match_jax_from_same_seed(small_dataset):
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    models = [JaxGD(U, I, {'nbr_features': 7}),
              GDRecommender(U, I, {'nbr_features': 7}, device='cpu')]
    for mod in models:
        mod.seed(5)
        mod.set_ratings(u, i, v)
        mod.init_feature_normal()
        mod.compute_items_bias_bk()
        mod.compute_users_bias_bk()
    a, b = models
    for name in ('P', 'Q', 'users_bias', 'items_bias'):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.overall_bias == b.overall_bias


def test_port_surface_and_refusals():
    p = GDRecommender(5, 4, {'nbr_features': 3, 'learning_rate': 0.01},
                      device='cpu')
    assert p.dimensionality == 3 and p.learning_rate == 0.01
    ref = JaxGD(5, 4)
    assert set(GDRecommender.PARAMETERS_INDEX) == set(JaxGD.PARAMETERS_INDEX)
    for attr in ('min_epochs', 'K', 'K2', 'K3', 'batch_size', 'inner_steps',
                 'engine', 'feature_init'):
        assert getattr(GDRecommender(5, 4, device='cpu'), attr) == \
            getattr(ref, attr)
    from mfrec_tpu_torch.models.base import Error
    with pytest.raises(Error):
        p.set_parameters({'no_such': 1})
    with pytest.raises(NotImplementedError):        # not ported yet
        GDRecommender(5, 4, {'engine': 'dsgd'}, device='cpu').train()
    # a predictor with no retrieval score mode scores on the host, as the
    # JAX model does: the same ids and scores, NEG past a short list
    a, b = _svdpp_pair()
    users = np.arange(a.nbr_users)
    for x, y in zip(b.recommend_batch(users, 6,
                                      predictor='predict_rating_implicit'),
                    a.recommend_batch(users, 6,
                                      predictor='predict_rating_implicit')):
        np.testing.assert_array_equal(x, np.asarray(y))
    with pytest.raises(ValueError):
        GDRecommender(5, 4, device='meta')


def _svdpp_pair(U=9, I=14, k=4, seed=3):
    '''A JAX and a port SVD++ GDRecommender holding the same random
    state: factors, implicit factors Y, biases and the rated-feedback
    tables; user 0 rated all but 3 items.'''
    rng = np.random.default_rng(seed)
    pairs = {(0, j) for j in range(I - 3)}
    while len(pairs) < 60:
        pairs.add((int(rng.integers(U)), int(rng.integers(I))))
    u, i = np.array(sorted(pairs), np.int32).T
    v = rng.integers(1, 6, u.shape[0]).astype(np.float32)
    state = dict(P=rng.normal(0, 0.3, (U, k)).astype(np.float32),
                 Q=rng.normal(0, 0.3, (I, k)).astype(np.float32),
                 Y=rng.normal(0, 0.3, (I, k)).astype(np.float32),
                 users_bias=rng.normal(0, 0.2, U).astype(np.float32),
                 items_bias=rng.normal(0, 0.2, I).astype(np.float32))
    out = []
    for m in (JaxGD(U, I, {'nbr_features': k}),
              GDRecommender(U, I, {'nbr_features': k}, device='cpu')):
        m.set_ratings(u, i, v)
        m.compute_overall_avg()
        for name, val in state.items():
            setattr(m, name, val.copy())
        m.initialize_rated_feedback()
        out.append(m)
    return out


def test_host_scoring_path_matches_jax():
    '''``find_recommended_items`` with a predictor that has no score mode
    (SVD++'s ``predict_rating_implicit``, and a predictor the model
    defines on the fly) against the JAX model: ids and scores equal, in
    both label and index form; user 0 has only 3 unrated items.'''
    a, b = _svdpp_pair()
    for m in (a, b):
        m.predict_custom = lambda item, user, m=m: \
            float(m.Q[item] @ m.P[user]) * (item % 3)
    for pred in ('predict_rating_implicit', 'predict_custom'):
        for user in range(a.nbr_users):
            for n, labels in ((5, False), (20, True)):
                got = b.find_recommended_items(user, nbr_recommendations=n,
                                               predictor=pred,
                                               output_label=labels)
                assert got == a.find_recommended_items(
                    user, nbr_recommendations=n, predictor=pred,
                    output_label=labels)
                assert len(got[0]) <= (3 if user == 0 else n)
