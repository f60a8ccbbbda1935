'''The port's HTTP server on device='cpu': every endpoint, coalesced
concurrent requests, the retrieval modes, and a warmup failure that
raises.  Served lists are held to the JAX model's recommend_batch on the
same state (exact: ids equal; fast: ids equal outside quasi-ties).'''
import json
import threading
import urllib.request

import numpy as np
import pytest

from mfrec_tpu.data.movielens import synthetic_ratings
from mfrec_tpu.models.gd import GDRecommender as JaxGD
from mfrec_tpu_torch import interop
from mfrec_tpu_torch.serving import RecommenderServer
from test_torch_topk import FAST, assert_topn_match


def _get(port, path):
    try:
        with urllib.request.urlopen('http://127.0.0.1:%d%s' % (port, path),
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_rate(port, user, item, value):
    req = urllib.request.Request(
        'http://127.0.0.1:%d/rate' % port,
        data=json.dumps({'user': user, 'item': item,
                         'value': value}).encode(), method='POST')
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope='module')
def models():
    users, items, vals = synthetic_ratings(80, 50, 1500, rank=3, seed=2)
    m = JaxGD(80, 50, {'nbr_features': 6, 'min_epochs': 8, 'max_epochs': 8,
                       'engine': 'fused', 'learning_rate': 0.02,
                       'batch_size': 512})
    m.set_ratings(users, items, vals)
    m.train(handle_bias=True)
    return m


def _port_model(m):
    return interop.from_numpy(m.P, m.Q, m.users_bias, m.items_bias,
                              m.overall_bias, m.ratings.coo(), device='cpu')


def test_server_endpoints(models):
    m = models
    p = _port_model(m)
    srv = RecommenderServer(p, batch_window_ms=1.0)
    port = srv.start()
    try:
        code, health = _get(port, '/health')
        assert code == 200 and health == {'ok': True, 'users': 80,
                                          'items': 50}
        code, rec = _get(port, '/recommend?user=3&n=5')
        assert code == 200 and len(rec['items']) == 5
        ids, _ = m.recommend_batch(np.array([3]), nbr_recommendations=5)
        assert rec['items'] == np.asarray(ids)[0].tolist()
        code, rec2 = _get(port, '/recommend?label=user3&n=5')
        assert rec2['items'] == rec['items']
        code, sim = _get(port, '/similar_items?item=7&n=4')
        assert code == 200
        assert sim['items'] == m.similar_items(7, 4)
        code, pred = _get(port, '/predict?user=3&item=7')
        assert code == 200
        assert abs(pred['score'] - float(m.predict_rating(7, 3))) < 1e-6
        assert _get(port, '/recommend?label=nosuch')[0] == 404
        assert _get(port, '/nothing')[0] == 404
        nnz0 = p.ratings.nnz
        assert _post_rate(port, 1, 2, 4.0)['ok']
        assert p.ratings.nnz == nnz0 + (0 if m.ratings.get(1, 2) else 1)
        # the write reaches readers after a refresh: item 2 is now rated
        srv.refresh()
        code, rec = _get(port, '/recommend?user=1&n=49')
        scored = [i for i, s in zip(rec['items'], rec['scores'])
                  if s > -1e38]                # past them: masked (NEG)
        assert 2 not in scored and len(scored) < 49
    finally:
        srv.stop()


def test_server_input_validation(models):
    srv = RecommenderServer(_port_model(models), batch_window_ms=1.0)
    port = srv.start()
    try:
        for path, code in (('/recommend?user=99999', 404),
                           ('/recommend?user=-1', 404),
                           ('/recommend', 400), ('/recommend?user=abc', 400),
                           ('/similar_items?item=12345', 404),
                           ('/predict?user=1', 400)):
            assert _get(port, path)[0] == code, path
        code, rec = _get(port, '/recommend?user=2&n=3')
        assert code == 200 and len(rec['items']) == 3
    finally:
        srv.stop()


@pytest.mark.parametrize('pad_to', [None, 4])
def test_server_concurrent_requests_batch(models, pad_to):
    '''Concurrent requests coalesce into batched calls (pad_to=4 splits
    12 users into warmed-shape chunks) and each gets its own list.'''
    m = models
    p = _port_model(m)
    calls = []
    orig = p.recommend_batch

    def counting(*a, **k):
        calls.append(len(a[0]))
        return orig(*a, **k)

    p.recommend_batch = counting
    srv = RecommenderServer(p, batch_window_ms=20.0, pad_to=pad_to)
    port = srv.start()
    try:
        results = {}

        def hit(u):
            _, rec = _get(port, '/recommend?user=%d&n=3' % u)
            results[u] = rec['items']

        threads = [threading.Thread(target=hit, args=(u,))
                   for u in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 12
        ids, _ = m.recommend_batch(np.arange(12), nbr_recommendations=3)
        for u in range(12):
            assert results[u] == np.asarray(ids)[u].tolist()
        served = calls[1:]                     # calls[0] is the warmup
        assert len(served) < 12                # requests were coalesced
        assert set(served) == {pad_to or 256}
    finally:
        srv.stop()


@pytest.mark.parametrize('retrieval', ['pallas', 'fast'])
def test_server_kernel_retrieval_modes(models, retrieval):
    '''The kernel modes serve through the twin on a CPU model with a
    per-view cached item pair that a /rate write replaces.'''
    m = models
    p = _port_model(m)
    srv = RecommenderServer(p, batch_window_ms=1.0, retrieval=retrieval)
    port = srv.start()
    try:
        view0 = srv.view
        code, rec = _get(port, '/recommend?user=3&n=5')
        assert code == 200
        fast = retrieval == 'fast'
        ref = m.recommend_batch(np.array([3]), 6, use_pallas=True, fast=fast)
        if fast:
            assert_topn_match(np.array([rec['items']]),
                              np.array([rec['scores']]), *ref, 5, **FAST)
        else:
            assert rec['items'] == np.asarray(ref[0])[0, :5].tolist()
        dq0 = view0._dq
        assert dq0 is not None
        assert str(dq0[0].dtype) == ('torch.bfloat16' if fast
                                     else 'torch.float32')
        _get(port, '/recommend?user=4&n=5')
        assert view0._dq is dq0
        _post_rate(port, 1, 2, 4.0)
        srv.refresh()
        assert srv.view is not view0
        assert _get(port, '/recommend?user=3&n=5')[0] == 200
    finally:
        srv.stop()


def test_server_predictor_option_ranks_by_bias_predictor(models):
    m = models
    p = _port_model(m)
    srv = RecommenderServer(p, batch_window_ms=1.0,
                            predictor='predict_rating_with_bias')
    port = srv.start()
    try:
        _, rec = _get(port, '/recommend?user=5&n=4')
        ids, sc = m.recommend_batch(np.array([5]), 4,
                                    predictor='predict_rating_with_bias')
        assert rec['items'] == np.asarray(ids)[0].tolist()
        np.testing.assert_allclose(rec['scores'], np.asarray(sc)[0],
                                   atol=1e-5)
    finally:
        srv.stop()


def test_server_warmup_failure_raises(models):
    p = _port_model(models)

    def broken(*a, **k):
        raise RuntimeError('retrieval is broken')

    p.recommend_batch = broken
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match='retrieval is broken'):
        RecommenderServer(p, batch_window_ms=1.0)
    # the constructor's worker threads were stopped, not leaked
    for t in threading.enumerate():
        if t.ident not in before:
            t.join(timeout=10)
            assert not t.is_alive()
