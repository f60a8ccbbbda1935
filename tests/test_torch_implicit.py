'''The SVD++ tier, the agg-only tier and the fixed side's type on the
CPU, held to the JAX package.

Numerics held to, by test (the bound and its reason as in
tests/test_torch_train.py: f32 sums in another order can flip one bf16
rounding of a gradient term, which moves a factor by at most
lr * 2^-8 * |g| / cnt):
- the epoch with ``use_kernel=True, ff_dtype=None`` (K1's plain version,
  f32 fixed side) against ``make_alternating_epoch(use_pallas_full=True,
  pallas_interpret=True, ff_dtype=None)``: factors within 1e-4, RMSE
  within 1e-5 relative;
- the agg-only tier (``use_agg_kernel``, K4's plain version) against the
  XLA path, ``make_alternating_epoch(use_pallas_full=False)``: K4's
  one-hot product is that path's einsum.  Same bounds;
- ``make_alternating_implicit_epoch`` on both numerics paths (the
  Pallas one with the JAX base epoch in interpret mode) and through both
  aggregation and item-step routes (per batch, or one launch over the
  segment table: ``scan_aggregate`` and ``step_aggregate``): factors and
  Y within 1e-4, RMSE within 1e-5 relative;
- ``GDRecommender(device='cpu').feature_training_implicit()`` against
  the JAX model (engine pinned to 'alternating': under the suite's
  8-device mesh the JAX model's 'auto' picks the sharded tier): RMSE
  history within 1e-5 relative, P, Q, Y within 1e-4, predictions within
  1e-4.'''
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mfrec_tpu.models.gd import GDRecommender as JaxGD
from mfrec_tpu.ops import sgd_mf as jax_sgd
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.ops import sgd_mf

# The suite runs in several xdist workers on one machine; torch's default
# of one intra-op thread per core then oversubscribes the cores, and its
# small CPU ops slow down a hundredfold.  Every worker imports this file.
torch.set_num_threads(1)

FACTOR_ATOL = 1e-4
RMSE_RTOL = 1e-5


def _stream(U=60, I=40, N=2000, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, U, N).astype(np.int32),
            rng.integers(0, I, N).astype(np.int32),
            rng.uniform(1, 5, N).astype(np.float32))


def _setup(k, W=32, U=60, I=40, B=256, segments=False):
    u, i, v = _stream(U, I)
    lay = {a: jax_sgd.sorted_pass_layout(u, i, v, B, axis=a, max_window=W)
           for a in ('user', 'item')}
    rng = np.random.default_rng(k)
    P = rng.normal(0, 0.1, (U + W, k)).astype(np.float32)
    Q = rng.normal(0, 0.1, (I + W, k)).astype(np.float32)
    bu = rng.normal(0, 0.1, U + W).astype(np.float32)
    bi = rng.normal(0, 0.1, I + W).astype(np.float32)
    Pa, Qa = jax_sgd.augment_factors(P, Q, bu, bi)
    jl = tuple(tuple(jnp.asarray(x) for x in lay[a][:-1])
               for a in ('user', 'item'))
    tl = tuple(sgd_mf.PassLayout(lay[a], a, 'cpu', segments=segments)
               for a in ('user', 'item'))
    counts = np.bincount(u, minlength=U).astype(np.float32)
    nrm = np.zeros(U + W, np.float32)
    nrm[:U] = np.where(counts > 0, 1.0 / np.sqrt(np.maximum(counts, 1.0)),
                       0.0)
    return Pa, Qa, jl, tl, np.float32(v.mean()), nrm, W


def _close(got, want, atol=FACTOR_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize('bias_mode', ['fixed', 'learned'])
def test_f32_fixed_side_matches_jax(bias_mode):
    '''ff_dtype=None keeps the fixed side f32 on the kernel path, as
    the JAX epoch does.'''
    Pa, Qa, jl, tl, mu, _, W = _setup(6)
    kw = dict(lr=0.1, K=0.02, lr_bu=0.05, lr_bi=0.07, K_bu=0.01, K_bi=0.03,
              bias_mode=bias_mode, inner_steps=3)
    ep_j = jax_sgd.make_alternating_epoch(
        W, W, donate=False, use_pallas_full=True, pallas_interpret=True,
        ff_dtype=None, **kw)
    ep_t = sgd_mf.make_alternating_epoch(W, W, use_kernel=True,
                                         ff_dtype=None, **kw)
    Pj, Qj = jnp.asarray(Pa), jnp.asarray(Qa)
    Pt, Qt = torch.from_numpy(Pa.copy()), torch.from_numpy(Qa.copy())
    for _ in range(2):
        Pj, Qj, rj = ep_j(Pj, Qj, jnp.float32(mu), *jl)
        Pt, Qt, rt = ep_t(Pt, Qt, mu, *tl)
        _close(Pt, Pj)
        _close(Qt, Qj)
        assert float(rt) == pytest.approx(float(rj), rel=RMSE_RTOL)


@pytest.mark.parametrize('row_mean', [True, False])
@pytest.mark.parametrize('bias_mode', ['fixed', 'learned', 'none'])
def test_agg_tier_matches_jax_xla_path(bias_mode, row_mean):
    Pa, Qa, jl, tl, mu, _, W = _setup(6)
    kw = dict(lr=0.1 if row_mean else 0.01, K=0.02, lr_bu=0.05, lr_bi=0.07,
              K_bu=0.01, K_bi=0.03, bias_mode=bias_mode, inner_steps=3,
              row_mean=row_mean)
    ep_j = jax_sgd.make_alternating_epoch(W, W, donate=False, **kw)
    ep_t = sgd_mf.make_alternating_epoch(W, W, use_agg_kernel=True, **kw)
    Pj, Qj = jnp.asarray(Pa), jnp.asarray(Qa)
    Pt, Qt = torch.from_numpy(Pa.copy()), torch.from_numpy(Qa.copy())
    for scale in (1.0, 0.7):
        Pj, Qj, rj = ep_j(Pj, Qj, jnp.float32(mu), *jl, jnp.float32(scale))
        Pt, Qt, rt = ep_t(Pt, Qt, mu, *tl, np.float32(scale))
        _close(Pt, Pj)
        _close(Qt, Qj)
        assert float(rt) == pytest.approx(float(rj), rel=RMSE_RTOL)


def test_agg_tier_refuses_logistic_link():
    with pytest.raises(ValueError):
        jax_sgd.make_alternating_epoch(32, 32, 0.1, 0.02, link='logistic',
                                       use_pallas_agg=True)
    with pytest.raises(ValueError):
        sgd_mf.make_alternating_epoch(32, 32, 0.1, 0.02, link='logistic',
                                      use_agg_kernel=True)
    with pytest.raises(ValueError):
        sgd_mf.make_alternating_epoch(32, 32, 0.1, 0.02, ff_dtype='float16')


@pytest.fixture
def jax_base_interpret(monkeypatch):
    '''The JAX implicit and FN epochs pass no ``pallas_interpret`` to
    their base epoch: run it in interpret mode on the CPU.'''
    orig = jax_sgd.make_alternating_epoch

    def interpreted(*args, **kwargs):
        if kwargs.get('use_pallas_full'):
            kwargs['pallas_interpret'] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jax_sgd, 'make_alternating_epoch', interpreted)


@pytest.mark.parametrize('use_kernel,segments', [(False, False),
                                                 (False, True),
                                                 (True, False),
                                                 (True, True)])
def test_implicit_epoch_matches_jax(use_kernel, segments,
                                    jax_base_interpret):
    k = 6
    Pa, Qa, jl, tl, mu, nrm, W = _setup(k, segments=segments)
    rng = np.random.default_rng(9)
    Y = rng.normal(0, 0.05, (40 + W, k)).astype(np.float32)
    T = 3 if use_kernel else 4
    args = (W, W, 0.1, 0.08, 0.02, 0.03)
    ep_j = jax_sgd.make_alternating_implicit_epoch(
        *args, donate=False, inner_steps=T, use_pallas_full=use_kernel)
    ep_t = sgd_mf.make_alternating_implicit_epoch(*args, inner_steps=T,
                                                  use_kernel=use_kernel)
    Pj, Qj, Yj = jnp.asarray(Pa), jnp.asarray(Qa), jnp.asarray(Y)
    Pt, Qt, Yt = (torch.from_numpy(x.copy()) for x in (Pa, Qa, Y))
    nrm_t = torch.from_numpy(nrm)
    for scale in (1.0, 0.7):
        Pj, Qj, Yj, rj = ep_j(Pj, Qj, Yj, jnp.float32(mu), *jl,
                              jnp.asarray(nrm), jnp.float32(scale))
        Pt, Qt, Yt, rt = ep_t(Pt, Qt, Yt, mu, *tl, nrm_t, np.float32(scale))
        _close(Pt, Pj)
        _close(Qt, Qj)
        _close(Yt, Yj)
        assert float(rt) == pytest.approx(float(rj), rel=RMSE_RTOL)
    assert float(Yt.abs().max()) > 0


def _params(**over):
    p = {'nbr_features': 6, 'min_epochs': 3, 'max_epochs': 3,
         'batch_size': 512, 'inner_steps_implicit': 4, 'feature_init': 0.05,
         'engine': 'alternating'}
    p.update(over)
    return p


@pytest.mark.parametrize('over', [{}, {'lr_decay': 0.8},
                                  {'learning_rate': 0.1, 'engine': 'fused'}])
def test_model_matches_jax(small_dataset, over):
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    a = JaxGD(U, I, _params(**over))
    b = GDRecommender(U, I, _params(**over), device='cpu')
    for m in (a, b):
        m.seed(3)
        m.set_ratings(u, i, v)
        m.feature_training_implicit()
    np.testing.assert_allclose(b.get_rmse_history(), a.get_rmse_history(),
                               rtol=RMSE_RTOL)
    assert len(b.rmse_history) == 3
    for name in ('P', 'Q', 'Y'):
        got, want = getattr(b, name), np.asarray(getattr(a, name))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=FACTOR_ATOL, rtol=0)
    for uu, ii in test[:20, :2].astype(int):
        assert b.predict_rating_implicit(ii, uu) == pytest.approx(
            a.predict_rating_implicit(ii, uu), abs=1e-4)


def test_implicit_converges(small_dataset):
    '''tests/test_sgd_kernels.py's SVD++ quality check, on the port: the
    RMSE falls, Y learns, and engine='fused' lands on the same tier.'''
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = {'min_epochs': 25, 'max_epochs': 25, 'nbr_features': 6,
              'learning_rate': 0.2, 'regularization_model': 0.02,
              'engine': 'alternating', 'batch_size': 1024, 'inner_steps': 4}
    out = []
    for engine in ('alternating', 'fused'):
        m = GDRecommender(U, I, dict(params, engine=engine), device='cpu')
        m.seed(0)
        m.set_ratings(u, i, v)
        m.feature_training_implicit()
        out.append(m)
    hist = out[0].get_rmse_history()
    assert hist[-1] < hist[0] - 0.03
    assert np.abs(out[0].Y).max() > 0
    assert np.isfinite(out[0].predict_rating_implicit(1, 1))
    np.testing.assert_allclose(out[1].Y, out[0].Y, atol=1e-6)


def test_sharded_engine_raises():
    u, i, v = _stream(20, 10, 200)
    m = GDRecommender(20, 10, _params(engine='alternating_sharded'),
                      device='cpu')
    m.set_ratings(u, i, v)
    with pytest.raises(NotImplementedError, match='item 9'):
        m.feature_training_implicit()
