'''B1's plain version (``ops.bias_refit_kernel.bias_refit_ref``) on the CPU,
over the segment tables of the alternating engine's layouts, against the
numpy refit (``MFRecommender.compute_items_bias_bk`` /
``compute_users_bias_bk``): within one f32 ulp an element, rows with no
rating exactly 0.  The store has a never-rated user and item and a hot
item whose ratings span several batches.  Also: the wrapper on CPU
tensors is the plain version; ``compute_biases_bk_on_device`` over CPU
tables counts ``bias.device_refits``; a CPU model's training entries keep
the numpy refit (bit for bit the JAX model's biases) and count no device
refit.  B1 itself runs on a card only (``tests/test_torch_gpu.py``).'''
import numpy as np
import pytest
import torch

from mfrec_tpu.models.gd import GDRecommender as JaxGD
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.ops import bias_refit_kernel as b1
from mfrec_tpu_torch.ops import sgd_mf
from mfrec_tpu_torch.utils import profiling

torch.set_num_threads(1)

U, I, N, B = 3_000, 260, 30_000, 256
HOT = 2_600            # the hot item's ratings: ten batches of B, and a
                       # block row of B1 (BLOCK_ROW)


def store(seed=0):
    '''(u, i, v): users 0..U-2 and items 0..I-2 rated (user U-1 and item
    I-1 never), item 0 by HOT users, half stars in [1, 5].'''
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U - 1, N).astype(np.int32)
    i = rng.integers(1, I - 1, N).astype(np.int32)
    u[:HOT] = rng.permutation(U - 1)[np.arange(HOT) % (U - 1)]
    i[:HOT] = 0
    v = (rng.integers(2, 11, N) / 2.0).astype(np.float32)
    return u, i, v


def model(seed=0, device='cpu', **params):
    m = GDRecommender(U, I, dict({'nbr_features': 4, 'batch_size': B,
                                  'min_epochs': 1, 'max_epochs': 1,
                                  'inner_steps': 2,
                                  'inner_steps_implicit': 2,
                                  'feature_init': 0.05}, **params),
                      device=device)
    m.seed(3)
    m.set_ratings(*store(seed))
    return m


def tables(m, W):
    '''The user- and item-axis layouts of ``m``'s store with their
    segment tables on the CPU.'''
    u, i, v = m.ratings.coo()
    return tuple(sgd_mf.PassLayout(
        sgd_mf.sorted_pass_layout(u, i, v, B, axis=axis, max_window=W),
        axis, 'cpu', segments=True) for axis in ('user', 'item'))


def numpy_biases(m):
    m.compute_overall_avg()
    m.compute_items_bias_bk()
    m.compute_users_bias_bk()
    return m.items_bias.copy(), m.users_bias.copy()


def within_ulp(got, want):
    got = np.asarray(got, np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize('K2,K3', [(0.01, 0.01), (25.0, 10.0)])
@pytest.mark.parametrize('W', [128, 512])
def test_plain_version_matches_numpy(W, K2, K3):
    m = model(regularization_users_bias=K2, regularization_items_bias=K3)
    want_i, want_u = numpy_biases(m)
    p_layout, q_layout = tables(m, W)
    hot = q_layout.segments
    assert hot.longest == HOT and hot.longest_segments >= 10
    bi = b1.bias_refit_ref(q_layout.segments, I, m.overall_bias, K3)
    bu = b1.bias_refit_ref(p_layout.segments, U, m.overall_bias, K2, bi=bi)
    assert bi.dtype == bu.dtype == torch.float32
    within_ulp(bi.numpy(), want_i)
    within_ulp(bu.numpy(), want_u)
    assert bi[I - 1] == 0 and bu[U - 1] == 0
    assert want_i[I - 1] == 0 and want_u[U - 1] == 0
    assert np.abs(want_i).max() > 0.1 and np.abs(want_u).max() > 0.1


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    m = model(seed=1)
    numpy_biases(m)
    p_layout, q_layout = tables(m, 128)
    mu = m.overall_bias
    bi = b1.bias_refit(q_layout.segments, I, mu, 0.01)
    assert torch.equal(bi, b1.bias_refit_ref(q_layout.segments, I, mu, 0.01))
    bu = b1.bias_refit(p_layout.segments, U, mu, 0.01, bi=bi)
    assert torch.equal(bu, b1.bias_refit_ref(p_layout.segments, U, mu, 0.01,
                                             bi=bi))
    assert b1.bias_refit.launches == 0       # nothing launched on the CPU


def test_wrapper_checks_its_inputs():
    m = model(seed=2)
    p_layout, q_layout = tables(m, 128)
    with pytest.raises(ValueError, match='rows past'):
        b1.bias_refit(q_layout.segments, I - 2, 3.5, 0.01)
    with pytest.raises(ValueError, match='ent_fix'):
        b1.bias_refit(p_layout.segments, U, 3.5, 0.01,
                      bi=torch.zeros(I - 2))
    with pytest.raises(ValueError, match='float32'):
        b1.bias_refit(p_layout.segments, U, 3.5, 0.01,
                      bi=torch.zeros(I, dtype=torch.float64))


def test_refit_over_tables_counts_a_device_refit():
    '''``compute_biases_bk_on_device`` over CPU segment tables (the
    plain version in B1's place): the numpy biases within an ulp, numpy
    f32 arrays, one ``bias.device_refits``.'''
    m = model(seed=3)
    want_i, want_u = numpy_biases(m)
    p_layout, q_layout = tables(m, 512)
    m.items_bias = m.users_bias = None
    profiling.collect()
    profiling.enable()
    try:
        m.compute_biases_bk_on_device(p_layout, q_layout)
        rec = profiling.collect()
    finally:
        profiling.disable()
    assert rec.counters == {'bias.device_refits': 1}
    assert isinstance(m.items_bias, np.ndarray)
    assert m.items_bias.dtype == m.users_bias.dtype == np.float32
    within_ulp(m.items_bias, want_i)
    within_ulp(m.users_bias, want_u)


@pytest.mark.parametrize('entry', ['train', 'feature_training_bias',
                                   'feature_training_implicit'])
def test_cpu_model_keeps_the_numpy_refit(entry):
    '''A CPU model's training entries on the alternating engine refit
    with numpy: no device refit counted, the biases bit for bit the JAX
    model's over the same store (the learned-bias entry's before its
    epochs).'''
    m = model(seed=4, engine='alternating')
    seen = {}
    orig = GDRecommender._dispatch_engine

    def spy(self, engine, mode, verbose):
        seen['bias'] = (self.items_bias.copy(), self.users_bias.copy())
        return orig(self, engine, mode, verbose)

    profiling.collect()
    profiling.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(GDRecommender, '_dispatch_engine', spy)
            if entry == 'train':
                m.train(handle_bias=True)
            else:
                getattr(m, entry)()
        rec = profiling.collect()
    finally:
        profiling.disable()
    assert 'bias.device_refits' not in rec.counters
    j = JaxGD(U, I, {'nbr_features': 4})
    j.set_ratings(*store(4))
    j.compute_overall_avg()
    j.compute_items_bias_bk()
    j.compute_users_bias_bk()
    got_i, got_u = seen['bias'] if entry == 'feature_training_bias' else \
        (m.items_bias, m.users_bias)
    np.testing.assert_array_equal(got_i, np.asarray(j.items_bias))
    np.testing.assert_array_equal(got_u, np.asarray(j.users_bias))
    assert m.overall_bias == j.overall_bias
