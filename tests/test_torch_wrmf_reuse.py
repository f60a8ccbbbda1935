'''``WRMFRecommender.train()`` on an unchanged ratings store reuses what it
derives from the ratings: both sides' device buckets
(``als.layouts_reused``, and ``h2d_bytes`` then only P and Q).  On the
CPU (``device='cpu'``), small streams: a hit gives, bit for bit, a fresh
model's factors; a write or a store swapped in by ``load_state`` builds
everything again; never-rated rows come out exactly zero at 0 epochs and
after training, with and without the cache; the SVD++ feedback arrays,
which WRMF does not read, are not built.'''
import numpy as np
import pytest

from mfrec_tpu_torch.models.base import BaseRecommender
from mfrec_tpu_torch.models.wrmf import WRMFRecommender
from mfrec_tpu_torch.utils import profiling

U, I = 70, 50
RATED_U, RATED_I = 62, 44          # rows and items past these never rated
SOLVERS = [{'solver': 'cg', 'cg_steps': 3}, {'solver': 'exact'}]


@pytest.fixture
def recording():
    '''Recording on for the test; off and emptied after it.'''
    profiling.collect()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.collect()


def _stream(seed=5, N=1500):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, RATED_U, N).astype(np.int32),
            rng.integers(0, RATED_I, N).astype(np.int32),
            np.ones(N, np.float32))


def _model(*streams, epochs=2, params=SOLVERS[0]):
    m = WRMFRecommender(U, I, dict(params, nbr_epochs=epochs,
                                   nbr_features=8), device='cpu')
    for s in streams:
        m.set_ratings(*s)
    m.ratings.nnz
    return m


def _trained(m, seed=3):
    '''``m.train()`` from the init of ``seed``; the factors after it.'''
    m.seed(seed)
    m.train()
    return m.P, m.Q


def _bits(a, b):
    '''Equal bit for bit (the sign of a zero included).'''
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _full_bytes(m):
    '''P, Q and every bucket array of ``m``'s store.'''
    return (m.P.nbytes + m.Q.nbytes
            + sum(a.nbytes for axis in ('user', 'item')
                  for b in m.ratings.padded_rows(axis=axis) for a in b))


@pytest.mark.parametrize('params', SOLVERS, ids=['cg', 'exact'])
def test_unchanged_store_reuses_layouts(recording, params):
    m = _model(_stream(), params=params)
    first = _trained(m)
    assert profiling.collect().counters == {'h2d_bytes': _full_bytes(m)}
    second = _trained(m)
    assert profiling.collect().counters == {
        'h2d_bytes': m.P.nbytes + m.Q.nbytes, 'als.layouts_reused': 1}
    want = _trained(_model(_stream(), params=params))
    for got in (first, second):
        _bits(got[0], want[0])
        _bits(got[1], want[1])


def test_write_between_calls_builds_again(recording):
    extra = _stream(seed=6, N=300)
    m = _model(_stream())
    _trained(m)
    m.set_ratings(*extra)
    profiling.collect()
    got = _trained(m)
    assert profiling.collect().counters == {'h2d_bytes': _full_bytes(m)}
    want = _trained(_model(_stream(), extra))
    _bits(got[0], want[0])
    _bits(got[1], want[1])


def test_loaded_store_never_reuses_layouts(recording, tmp_path):
    '''Another store with the same version and nnz, swapped in by
    ``load_state``: only its identity token tells it apart.'''
    u, i, v = _stream()
    other = (u, (i + 1) % RATED_I, v)          # same count, other layout
    src = _model(other)
    _trained(src)
    src.save_state(str(tmp_path / 'other'))
    m = _model((u, i, v))
    _trained(m)
    version, nnz = m.ratings.version, m.ratings.nnz
    m.load_state(str(tmp_path / 'other'))
    assert (m.ratings.version, m.ratings.nnz) == (version, nnz)
    profiling.collect()
    got = _trained(m)
    assert profiling.collect().counters == {'h2d_bytes': _full_bytes(m)}
    want = _trained(_model(other))
    _bits(got[0], want[0])
    _bits(got[1], want[1])


def _fresh_feedback(*streams):
    b = BaseRecommender(U, I, device='cpu')
    for s in streams:
        b.set_ratings(*s)
    b.initialize_rated_feedback()
    return b.feedback_rated, b.feedback_hash


def test_train_builds_no_feedback_arrays():
    '''WRMF reads no SVD++ feedback arrays, so ``train()`` leaves them
    unbuilt; built on demand, after a hit and after a write, they equal
    a fresh build's on the same ratings.'''
    extra = _stream(seed=6, N=300)
    m = _model(_stream())
    _trained(m)
    _trained(m)
    assert not hasattr(m, 'feedback_rated')
    assert not hasattr(m, 'feedback_hash')
    for streams in ((_stream(),), (_stream(), extra)):
        if len(streams) == 2:
            m.set_ratings(*extra)
            _trained(m)
        m.initialize_rated_feedback()
        for got, want in zip((m.feedback_rated, m.feedback_hash),
                             _fresh_feedback(*streams)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('params', SOLVERS, ids=['cg', 'exact'])
@pytest.mark.parametrize('epochs', [0, 2])
def test_never_rated_rows_come_out_zero(recording, epochs, params):
    m = _model(_stream(), epochs=epochs, params=params)
    for reused in (False, True):
        P, Q = _trained(m)
        assert profiling.collect().counters.get('als.layouts_reused') == \
            (1 if reused else None)
        assert not P[RATED_U:].any() and not Q[RATED_I:].any()
        assert np.abs(P[:RATED_U]).min(axis=1).all()
        if epochs == 0:                # the rated rows keep the init draws
            rng = np.random.default_rng(3)
            P0 = rng.normal(0.0, m.feature_init, P.shape).astype(np.float32)
            Q0 = rng.normal(0.0, m.feature_init, Q.shape).astype(np.float32)
            _bits(P[:RATED_U], P0[:RATED_U])
            _bits(Q[:RATED_I], Q0[:RATED_I])
