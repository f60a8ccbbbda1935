'''The port's copied host code against the originals: the Ratings store
byte for byte, the rated-list padding, the synthetic generator, and the
checkpoint files in both directions.'''
import os

import numpy as np
import pytest

from mfrec_tpu.data import movielens as jax_ml
from mfrec_tpu.data import ratings as jax_ratings
from mfrec_tpu.ops import topk as jax_topk
from mfrec_tpu.utils import math_ as jax_math
from mfrec_tpu_torch.data import movielens as port_ml
from mfrec_tpu_torch.data import ratings as port_ratings
from mfrec_tpu_torch.ops import topk as port_topk
from mfrec_tpu_torch.utils import math_ as port_math

DATASETS = ['small_dataset', 'tiny_dataset']


def _stores(request, name, extra_writes=True):
    (u, i, v), _ = request.getfixturevalue(name)
    U, I = int(u.max()) + 1, int(i.max()) + 1
    out = []
    for mod in (jax_ratings, port_ratings):
        r = mod.Ratings(U, I)
        r.set_many(u, i, v)
        if extra_writes:
            # scalar writes after a bulk one: overwrite, delete (explicit
            # zero), and a fresh pair — last write wins
            r.set(int(u[0]), int(i[0]), 1.5)
            r.set(int(u[1]), int(i[1]), 0.0)
            r.set(U - 1, I - 1, 4.0)
        out.append(r)
    return out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize('name', DATASETS)
@pytest.mark.parametrize('layout', ['coo', 'csr', 'csc'])
def test_ratings_layouts_byte_identical(request, name, layout):
    ref, port = _stores(request, name)
    for a, b in zip(getattr(ref, layout)(), getattr(port, layout)()):
        _same(a, b)


@pytest.mark.parametrize('name', DATASETS)
def test_ratings_counts_stats_version_identical(request, name):
    ref, port = _stores(request, name)
    for fn in ('user_counts', 'item_counts', 'user_means', 'item_means',
               'to_dense'):
        _same(getattr(ref, fn)(), getattr(port, fn)())
    assert ref.nnz == port.nnz and ref.version == port.version
    assert ref.overall_avg() == port.overall_avg()
    ref.grow(nbr_users=ref.nbr_users + 2)
    port.grow(nbr_users=port.nbr_users + 2)
    assert ref.version == port.version
    _same(ref.user_counts(), port.user_counts())
    assert ref.get(3, 5) == port.get(3, 5)


@pytest.mark.parametrize('name', DATASETS)
def test_padded_segment_gather_and_rows_identical(request, name):
    ref, port = _stores(request, name)
    ptr, items, vals = ref.csr()
    rows = np.arange(0, ref.nbr_users, 3)
    for L in (1, 8, 64):
        a = jax_ratings.padded_segment_gather(ptr, rows, L, items, vals)
        b = port_ratings.padded_segment_gather(ptr, rows, L, items, vals)
        for x, y in zip(a, b):
            _same(x, y)
    for axis in ('user', 'item'):
        for x, y in zip(ref.padded_rows(axis), port.padded_rows(axis)):
            for xa, ya in zip(x, y):
                _same(xa, ya)


@pytest.mark.parametrize('name', DATASETS)
@pytest.mark.parametrize('kw', [{}, {'pad_to': 256}, {'cap': 4}])
def test_pad_rated_lists_identical(request, name, kw):
    ref, port = _stores(request, name)
    users = np.array([0, 5, 3, ref.nbr_users - 1, 5])
    a = jax_topk.pad_rated_lists(ref, users, **kw)
    b = port_topk.pad_rated_lists(port, users, **kw)
    for x, y in zip(a, b):
        _same(x, y)


def test_synthetic_ratings_split_and_sigmoid_identical():
    a = jax_ml.synthetic_ratings(120, 70, 2000, rank=4, seed=9)
    b = port_ml.synthetic_ratings(120, 70, 2000, rank=4, seed=9)
    for x, y in zip(a, b):
        _same(x, y)
    ta, tb = jax_ml.train_test_split(*a, seed=3), \
        port_ml.train_test_split(*b, seed=3)
    for x, y in zip(ta[0], tb[0]):
        _same(x, y)
    _same(ta[1], tb[1])
    x = np.linspace(-8, 8, 33)
    _same(jax_math.sigmoid(x), port_math.sigmoid(x))


def _jax_model(small_dataset):
    from mfrec_tpu.models.gd import GDRecommender
    (u, i, v), _ = small_dataset
    m = GDRecommender(int(u.max()) + 1, int(i.max()) + 1,
                      {'nbr_features': 5})
    m.seed(4)
    m.set_ratings(u, i, v)
    m.init_feature_normal()
    m.compute_items_bias_bk()
    m.compute_users_bias_bk()
    m.set_user_label(2, 'alice')
    return m


def _assert_same_state(a, b):
    for name in ('P', 'Q', 'users_bias', 'items_bias'):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.overall_bias == b.overall_bias
    assert a.dimensionality == b.dimensionality
    assert a.users.labels == b.users.labels
    assert a.items.labels == b.items.labels
    for x, y in zip(a.ratings.coo(), b.ratings.coo()):
        _same(x, y)


def test_state_saved_by_jax_loads_in_port(small_dataset, tmp_path):
    from mfrec_tpu_torch import interop
    m = _jax_model(small_dataset)
    m.save_state(os.path.join(tmp_path, 'j'))
    p = interop.load_jax_state(os.path.join(tmp_path, 'j'), device='cpu')
    _assert_same_state(m, p)
    assert p.users.index['alice'] == 2
    assert p.device.type == 'cpu'


def test_state_saved_by_port_loads_in_jax(small_dataset, tmp_path):
    from mfrec_tpu.models.gd import GDRecommender as JaxGD
    from mfrec_tpu_torch import interop
    m = _jax_model(small_dataset)
    m.save_state(os.path.join(tmp_path, 'j'))
    p = interop.load_jax_state(os.path.join(tmp_path, 'j'), device='cpu')
    p.save_state(os.path.join(tmp_path, 'p'))
    back = JaxGD(4, 6)
    back.load_state(os.path.join(tmp_path, 'p'))
    _assert_same_state(m, back)
    # and the model snapshot (factors only) too
    p.save_model_snapshot(os.path.join(tmp_path, 's'))
    back.load_model_snapshot(os.path.join(tmp_path, 's'))
    np.testing.assert_array_equal(back.Q, m.Q)
    np.testing.assert_array_equal(back.P, m.P)
