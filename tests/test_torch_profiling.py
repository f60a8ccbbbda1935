'''``mfrec_tpu_torch.utils.profiling`` on the CPU: off it records nothing;
on, spans keep their parent, call, thread and order; ``train()`` of a
GD and of a WRMF model and a GD model's ``feature_training_implicit()``
(SVD++) each give their span tree; ``h2d_bytes`` is the bytes of the host
arrays each upload hands over, counted here apart;
``svdpp.layouts_reused`` counts the SVD++ calls that found their layouts
kept; ``kernel.build:<name>`` is recorded only when the compiler runs.'''
import os
import stat
import threading

import numpy as np
import pytest

from mfrec_tpu_torch.models.fn import FNRecommender
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.models.wrmf import WRMFRecommender
from mfrec_tpu_torch.ops import _cuda_build
from mfrec_tpu_torch.utils import profiling

# the layouts before the bias refit, which reads their segment tables on
# a CUDA model
GD_CHILDREN = ['gd.init', 'gd.layouts', 'gd.bias', 'gd.upload', 'gd.epochs',
               'gd.writeback']
SVDPP_CHILDREN = ['svdpp.init', 'svdpp.layouts', 'svdpp.bias',
                  'svdpp.feedback', 'svdpp.upload', 'svdpp.epochs',
                  'svdpp.writeback']
# inside each epoch, in order: the Y sums, the half-passes, the error sums,
# the Y step; then the driver's wait for the epoch's rmse
SVDPP_EPOCH = ['svdpp.aggregate', 'svdpp.half_passes', 'svdpp.aggregate',
               'svdpp.y_step', 'converge.sync']
FN_CHILDREN = ['fn.init', 'fn.layouts', 'fn.upload', 'fn.epochs',
               'fn.profiles', 'fn.writeback']
# inside each FN epoch, in order: the profile sums, the half-passes, the
# error sums, the X/Y step; then the driver's wait for the epoch's rmse
FN_EPOCH = ['fn.aggregate', 'fn.half_passes', 'fn.aggregate', 'fn.xy_step',
            'converge.sync']
WRMF_CHILDREN = ['wrmf.init', 'wrmf.feedback', 'wrmf.buckets', 'als.upload',
                 'als.epochs', 'wrmf.writeback']


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


def _stream(U=60, I=40, N=2000, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, U, N).astype(np.int32),
            rng.integers(0, I, N).astype(np.int32),
            rng.uniform(1, 5, N).astype(np.float32))


def _gd(epochs=3):
    m = GDRecommender(60, 40, {'nbr_features': 6, 'min_epochs': epochs,
                               'max_epochs': epochs, 'batch_size': 512,
                               'inner_steps': 4, 'feature_init': 0.05,
                               'engine': 'alternating'}, device='cpu')
    m.seed(3)
    m.set_ratings(*_stream())
    m.ratings.nnz
    profiling.collect()                # the store's consolidation span
    return m


def _wrmf():
    u, i, v = _stream(U=70, I=50)
    m = WRMFRecommender(70, 50, {'nbr_epochs': 2, 'nbr_features': 8,
                                 'solver': 'cg', 'cg_steps': 3},
                        device='cpu')
    m.seed(3)
    m.set_ratings(u, i, np.ones_like(v))
    m.ratings.nnz
    profiling.collect()
    return m


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def test_off_records_nothing():
    profiling.collect()
    assert not profiling.enabled()
    assert profiling.span('a') is profiling.span('b')
    with profiling.span('a'):
        profiling.count('h2d_bytes', 10)
    _gd(epochs=1).train(handle_bias=True)
    rec = profiling.collect()
    assert rec.spans == [] and rec.counters == {}


def test_nested_spans_keep_parent_call_thread_and_order(recording):
    assert profiling.enabled()
    tid = threading.get_native_id()
    with profiling.span('root'):
        with profiling.span('a'):
            with profiling.span('a1'):
                pass
        with profiling.span('b'):
            profiling.count('n', 2)
            profiling.count('n', 3)
    with profiling.span('second'):
        pass

    def in_thread():
        with profiling.span('thread'):
            pass

    t = threading.Thread(target=in_thread)
    with profiling.span('outer'):
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    rec = profiling.collect()
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ['root', 'a', 'a1', 'b', 'second',
                                           'outer', 'thread']
    root = by['root']
    assert root.parent is None and root.call == root.id
    assert by['a'].parent == root.id and by['b'].parent == root.id
    assert by['a1'].parent == by['a'].id
    assert {by[n].call for n in ('a', 'a1', 'b')} == {root.id}
    assert by['second'].parent is None and by['second'].call != root.id
    # a span on another thread does not nest under this thread's span
    assert by['thread'].parent is None
    assert by['thread'].tid != tid
    assert all(by[n].tid == tid for n in ('root', 'a', 'a1', 'b'))
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    assert root.start_ns <= by['a'].start_ns <= by['a1'].end_ns \
        <= by['a'].end_ns <= by['b'].start_ns <= by['b'].end_ns \
        <= root.end_ns
    assert rec.counters == {'n': 5}
    assert profiling.collect() == ([], {})


def test_gd_train_span_tree(recording):
    m = _gd()
    m.train(handle_bias=True)
    m.train(handle_bias=True, initialize_model=False)   # layouts cached
    rec = profiling.collect()
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ['gd.train', 'gd.train']
    for root in roots:
        spans = [s for s in rec.spans if s.call == root.id]
        assert _children(spans, root) == GD_CHILDREN
        epochs = next(s for s in spans if s.name == 'gd.epochs')
        assert _children(spans, epochs) == ['converge.sync'] * 3
        assert len(spans) == 1 + len(GD_CHILDREN) + 3
    # the recording leaves the numbers alone
    profiling.disable()
    off = _gd()
    off.train(handle_bias=True)
    off.train(handle_bias=True, initialize_model=False)
    np.testing.assert_array_equal(off.P, m.P)
    np.testing.assert_array_equal(off.Q, m.Q)


def test_gd_h2d_bytes(recording):
    m = _gd(epochs=1)
    m.train(handle_bias=True)
    U, I, k = 60, 40, 6                # P, Q and the biases in f32
    want = 4 * (U * k + I * k + U + I)
    assert profiling.collect().counters == {'h2d_bytes': want}


def _svdpp(epochs=2):
    m = GDRecommender(60, 40, {'nbr_features': 6, 'min_epochs': epochs,
                               'max_epochs': epochs, 'batch_size': 512,
                               'inner_steps_implicit': 4,
                               'feature_init': 0.05}, device='cpu')
    m.seed(3)
    m.set_ratings(*_stream())
    m.ratings.nnz
    profiling.collect()
    return m


def test_svdpp_span_tree(recording):
    '''Two calls: the second finds its layouts kept (one count); each
    epoch's spans lie under ``svdpp.epochs`` in phase order.'''
    m = _svdpp()
    m.feature_training_implicit()
    m.feature_training_implicit(initialize_model=False)
    rec = profiling.collect()
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ['svdpp.train', 'svdpp.train']
    for root in roots:
        spans = [s for s in rec.spans if s.call == root.id]
        assert _children(spans, root) == SVDPP_CHILDREN
        epochs = next(s for s in spans if s.name == 'svdpp.epochs')
        assert _children(spans, epochs) == SVDPP_EPOCH * 2
        assert len(spans) == 1 + len(SVDPP_CHILDREN) + 2 * len(SVDPP_EPOCH)
    assert rec.counters['svdpp.layouts_reused'] == 1
    # the recording leaves the numbers alone
    profiling.disable()
    off = _svdpp()
    off.feature_training_implicit()
    off.feature_training_implicit(initialize_model=False)
    for name in ('P', 'Q', 'Y'):
        np.testing.assert_array_equal(getattr(off, name), getattr(m, name))
    assert off.rmse_history == m.rmse_history


def test_svdpp_h2d_bytes(recording):
    '''P, Q, the biases, Y and the per-user norms (padded by the window),
    in f32; a first call builds its layouts, so nothing is reused.'''
    m = _svdpp(epochs=1)
    m.feature_training_implicit()
    U, I, k, W = 60, 40, 6, 512
    want = 4 * (U * k + I * k + U + I + I * k + U + W)
    assert profiling.collect().counters == {'h2d_bytes': want}


def _fn(epochs=2):
    m = FNRecommender(60, 40, {'nbr_features': 6, 'nbr_epochs': epochs,
                               'batch_size': 512, 'inner_steps': 4,
                               'feature_init': 0.05,
                               'min_improvement': -1.0}, device='cpu')
    m.seed(3)
    m.set_ratings(*_stream())
    m.ratings.nnz
    profiling.collect()
    return m


def test_fn_span_tree(recording):
    '''Two calls: the second finds its layouts kept (one count); each
    epoch's spans lie under ``fn.epochs`` in phase order, the served
    profiles in ``fn.profiles`` after them.'''
    m = _fn()
    m.train()
    m.train(initialize_model=False)
    rec = profiling.collect()
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ['fn.train', 'fn.train']
    for root in roots:
        spans = [s for s in rec.spans if s.call == root.id]
        assert _children(spans, root) == FN_CHILDREN
        epochs = next(s for s in spans if s.name == 'fn.epochs')
        assert _children(spans, epochs) == FN_EPOCH * 2
        assert len(spans) == 1 + len(FN_CHILDREN) + 2 * len(FN_EPOCH)
    assert rec.counters['fn.layouts_reused'] == 1
    # the recording leaves the numbers alone
    profiling.disable()
    off = _fn()
    off.train()
    off.train(initialize_model=False)
    for name in ('P', 'Q', 'X', 'Y', 'users_bias', 'items_bias'):
        np.testing.assert_array_equal(getattr(off, name), getattr(m, name))
    assert off.rmse_history == m.rmse_history


def test_fn_h2d_bytes(recording):
    '''Q, X, Y, the biases and the per-user norms (padded by the
    window), in f32; a first call builds its layouts, so nothing is
    reused.'''
    m = _fn(epochs=1)
    m.train()
    U, I, k, W = 60, 40, 6, 512
    want = 4 * (3 * I * k + U + I + U + W)
    assert profiling.collect().counters == {'h2d_bytes': want}


def test_fn_fused_tier_records_no_alternating_spans(recording):
    '''The per-batch scatter tier runs none of the alternating tier's
    phases, so it records none of its spans.'''
    m = _fn(epochs=1)
    m.engine = 'fused'
    m.train()
    assert not [s for s in profiling.collect().spans
                if s.name.startswith('fn.')]


def test_wrmf_train_span_tree_and_h2d_bytes(recording):
    m = _wrmf()
    m.train()
    rec = profiling.collect()
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ['wrmf.train']
    assert _children(rec.spans, roots[0]) == WRMF_CHILDREN
    assert len(rec.spans) == 1 + len(WRMF_CHILDREN)
    want = (m.P.nbytes + m.Q.nbytes
            + sum(a.nbytes for axis in ('user', 'item')
                  for b in m.ratings.padded_rows(axis=axis) for a in b))
    assert rec.counters == {'h2d_bytes': want}


def test_store_consolidate_span(recording):
    m = GDRecommender(60, 40, device='cpu')
    m.set_ratings(*_stream())
    assert profiling.collect().spans == []       # writes are only queued
    m.ratings.nnz
    m.ratings.nnz                                # nothing pending: no span
    assert [s.name for s in profiling.collect().spans] == \
        ['store.consolidate']


def test_kernel_build_span_only_when_compiling(recording, tmp_path,
                                               monkeypatch):
    '''A stand-in compiler writes the library: the first build records
    ``kernel.build:topn``, the second finds it built and records none.'''
    fake = tmp_path / 'nvcc'
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_cuda_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_cuda_build, 'nvcc_path', lambda: str(fake))
    _cuda_build.build(['topn'])
    assert os.path.exists(_cuda_build.library_path('topn'))
    _cuda_build.build(['topn'])
    assert [s.name for s in profiling.collect().spans] == \
        ['kernel.build:topn']
