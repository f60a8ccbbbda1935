'''The port's serial, fused, funk-fused and multi-regularization tiers on
the CPU, held to the JAX package on the same seeded inputs.

Tolerances, by test:
- ``reference_numpy``: the copy against the original, bit for bit;
- ``batch_ratings``: byte for byte;
- the serial epoch (S1's plain version) against
  ``sgd_mf.serial_feature_epoch``: within 1e-6 absolute (measured
  <= 3e-8).  Both round every step to f32 in the same order, but XLA on
  the CPU contracts a multiply and an add into one FMA where it can, a
  few f32 ulps apart;
- the port's funk model against ``funk_train_oracle`` (float64): the JAX
  package's own tolerance for its serial tier (atol 2e-3, rtol 1e-3,
  ``tests/test_sgd_kernels.py:19``);
- the mini-batch epochs and models (fused, funk-fused, multi-reg, FN
  fused) against their JAX functions: factors within 1e-5 absolute, RMSE
  within 1e-5 relative (measured <= 3e-7).  A row that repeats in a
  batch takes its entries' sum in one add (the fixed-order scatter),
  where JAX's scatter on the CPU adds them one by one; f32 sums in
  another order, and XLA's FMA contraction.'''
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mfrec_tpu.models.fn import FNRecommender as JaxFN
from mfrec_tpu.models.gd import GDRecommender as JaxGD
from mfrec_tpu.ops import fn as jax_fn_ops
from mfrec_tpu.ops import reference_numpy as jax_ref
from mfrec_tpu.ops import sgd_mf as jax_sgd
from mfrec_tpu_torch.models.base import Error
from mfrec_tpu_torch.models.fn import FNRecommender
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.ops import fn as fn_ops
from mfrec_tpu_torch.ops import reference_numpy as port_ref
from mfrec_tpu_torch.ops import serial_kernel, sgd_mf

torch.set_num_threads(1)

SERIAL_ATOL = 1e-6
TIER_ATOL = 1e-5
TIER_RTOL = 1e-5
ORACLE = dict(atol=2e-3, rtol=1e-3)


def t(a):
    return torch.from_numpy(np.array(a))


def _stream(U, I, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, U, n).astype(np.int32),
            rng.integers(0, I, n).astype(np.int32),
            rng.integers(1, 6, n).astype(np.float32))


def _coo(tiny_dataset):
    (u, i, v), _ = tiny_dataset
    return u, i, v.astype(np.float32), int(u.max()) + 1, int(i.max()) + 1


# ----------------------------------------------------------- pins / layout
def test_reference_numpy_copy_is_identical(tiny_dataset):
    '''The port's copy of ``ops/reference_numpy.py`` against the original:
    each oracle on the same inputs, bit for bit.'''
    u, i, v, U, I = _coo(tiny_dataset)
    idx = np.stack([u, i], 1)
    rng = np.random.default_rng(0)
    bi0, bu0 = rng.normal(0, 0.05, I), rng.normal(0, 0.05, U)
    for mode in ('none', 'fixed', 'learned'):
        outs = []
        for mod in (jax_ref, port_ref):
            uo, vo = np.full((3, I), 0.1), np.full((3, U), 0.1)
            bi, bu = bi0.copy(), bu0.copy()
            h = mod.funk_train_oracle(2, 2, 1e-4, 3, 0.1, 0.01, 0.02, uo, vo,
                                      idx, v.astype(np.float64),
                                      bias_mode=mode, overall_avg=3.5,
                                      items_bias=bi, users_bias=bu,
                                      lr_users=0.005, lr_items=0.005,
                                      K_bias_users=0.01, K_bias_items=0.02)
            outs.append((h, uo, vo, bi, bu))
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
    for kernel in ('logistic', 'linear'):
        outs = []
        for mod in (jax_ref, port_ref):
            uo = np.random.default_rng(1).normal(0, 0.1, (3, I))
            vo = np.random.default_rng(2).normal(0, 0.1, (3, U))
            bi, bu = np.zeros(I), np.zeros(U)
            r = mod.kmf_train_oracle(2, 3, 0.01, 0.02, 0.02, 0.01, uo, vo,
                                     idx, v.astype(np.float64), bi, bu,
                                     kernel=kernel)
            outs.append((r, uo, vo, bi, bu))
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
    assert jax_ref.estimator(1, 0.3, 0.2, 4, 0.1, 0.0, 1, 3.5, 0.1, -0.2) \
        == port_ref.estimator(1, 0.3, 0.2, 4, 0.1, 0.0, 1, 3.5, 0.1, -0.2)
    assert jax_ref.clamping(7.0) == port_ref.clamping(7.0)


def test_fn_oracle_copy_is_identical():
    rng = np.random.default_rng(5)
    U, I, k = 12, 9, 3
    u, i, v = _stream(U, I, 60, 6)
    ids = [np.unique(i[u == x]) for x in range(U)]
    vals = [np.full(len(a), 3.0) for a in ids]
    outs = []
    for mod in (jax_ref, port_ref):
        Q, X, Y = (rng.normal(0, 0.1, (I, k)) for _ in range(3))
        bu, bi = np.zeros(U), np.zeros(I)
        r = mod.fn_train_oracle(2, 0.01, 0.01, 0.01, 0.02, 0.01, 0.01, 3.5,
                                Q, X, Y, bu, bi, np.stack([u, i], 1),
                                v.astype(np.float64), ids, vals)
        outs.append((r, Q, X, Y, bu, bi))
        rng = np.random.default_rng(5)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('seed', [None, 0, 7])
@pytest.mark.parametrize('B', [64, 300])
def test_batch_ratings_byte_identical(tiny_dataset, seed, B):
    u, i, v, _, _ = _coo(tiny_dataset)
    a = jax_sgd.batch_ratings(u, i, v, B, seed=seed)
    b = sgd_mf.batch_ratings(u, i, v, B, seed=seed)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_scatter_plan_sums_each_row_in_stream_order():
    '''``plan_add_``: every entry of a batch lands on its row, a row's
    entries summed in stream order (checked against a float32 fold),
    masked-out entries left out; the same result on a second run.'''
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 7, (3, 50))
    valid = rng.random((3, 50)) < 0.7
    vals = rng.normal(0, 1, (3, 50, 2)).astype(np.float32)
    plan = sgd_mf.scatter_plan(rows, 'cpu', valid=valid)
    target = torch.zeros(7, 2)
    for b in range(3):
        sgd_mf.plan_add_(target, t(vals[b]), plan, b)
    want = np.zeros((7, 2), np.float32)
    for b in range(3):
        part = np.zeros((7, 2), np.float32)
        seen = np.zeros(7, bool)
        for j in range(50):
            if valid[b, j]:
                r = rows[b, j]
                part[r] = vals[b, j] if not seen[r] else part[r] + vals[b, j]
                seen[r] = True
        want = want + part
    np.testing.assert_array_equal(target.numpy(), want)


# ------------------------------------------------------------ serial tier
@pytest.mark.parametrize('masks', [(True, True), (True, False),
                                   (False, True)])
@pytest.mark.parametrize('mode', ['none', 'fixed', 'learned'])
def test_serial_epoch_matches_jax(mode, masks):
    U, I, n, k, f = 30, 20, 400, 4, 1
    u, i, r = _stream(U, I, n, 0)
    rng = np.random.default_rng(1)
    P = rng.normal(0.1, 0.05, (U, k)).astype(np.float32)
    Q = rng.normal(0.1, 0.05, (I, k)).astype(np.float32)
    bu = rng.normal(0, 0.1, U).astype(np.float32)
    bi = rng.normal(0, 0.1, I).astype(np.float32)
    cache = np.where(rng.random(n) < 0.5, rng.uniform(1, 5, n),
                     0).astype(np.float32)
    args = (f, k, 0.1, 0.01, 0.02)
    rates = (0.005, 0.006, 0.012, 0.004)
    kw = dict(bias_mode=mode, update_users=masks[0], update_items=masks[1])
    want = jax_sgd.serial_feature_epoch(
        jnp.asarray(P[:, f]), jnp.asarray(Q[:, f]), jnp.asarray(cache),
        jnp.asarray(u), jnp.asarray(i), jnp.asarray(r), *args,
        jnp.float32(3.5), jnp.asarray(bu), jnp.asarray(bi), *rates,
        P=jnp.asarray(P), Q=jnp.asarray(Q), **kw)
    got = serial_kernel.serial_feature_epoch_ref(
        t(P[:, f]), t(Q[:, f]), t(cache), t(u), t(i), t(r), *args, 3.5,
        t(bu), t(bi), *rates, P=t(P), Q=t(Q), **kw)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=SERIAL_ATOL)
    # the dispatching op (CPU tensors take the plain version) agrees
    again = sgd_mf.serial_feature_epoch(
        t(P[:, f]), t(Q[:, f]), t(cache), t(u), t(i), t(r), *args, 3.5,
        t(bu), t(bi), *rates, P=t(P), Q=t(Q), **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_serial_epoch_refuses_bad_inputs():
    u, i, r = _stream(5, 4, 10, 0)
    z = torch.zeros
    with pytest.raises(ValueError):
        serial_kernel.serial_epoch(z(5), z(4), z(10), t(u), t(i), t(r), 0, 1,
                                   0.1, 0.01, 0.02, 3.5, z(5), z(4), 0, 0, 0,
                                   0, bias_mode='learned')     # no P, Q
    with pytest.raises(ValueError):
        serial_kernel.serial_epoch(z(5), z(4), z(10), t(u).long(), t(i),
                                   t(r), 0, 1, 0.1, 0.01, 0.02, 3.5, z(5),
                                   z(4), 0, 0, 0, 0)           # int64 ids
    with pytest.raises(ValueError):
        serial_kernel.serial_epoch(z(5), z(4), z(10), t(u), t(i), t(r), 0, 1,
                                   0.1, 0.01, 0.02, 3.5, z(5), z(4), 0, 0, 0,
                                   0, bias_mode='bogus')


@pytest.mark.parametrize('bias_mode', ['none', 'fixed', 'learned'])
def test_funk_model_matches_oracle(tiny_dataset, bias_mode):
    '''The port twin of ``tests/test_sgd_kernels.py:19``: the port's
    ``engine='funk'`` model against ``funk_train_oracle`` on the same
    stream (the model's own shuffle), the same biases and rates.'''
    u, i, v, U, I = _coo(tiny_dataset)
    dim, f_init, lr, K = 3, 0.1, 0.01, 0.02
    m = GDRecommender(U, I, {'nbr_features': dim, 'feature_init': f_init,
                             'learning_rate': lr, 'regularization_model': K,
                             'learning_rate_users': 0.005,
                             'learning_rate_items': 0.005,
                             'regularization_users_bias': 0.012,
                             'regularization_items_bias': 0.004,
                             'min_epochs': 3, 'max_epochs': 3,
                             'engine': 'funk'}, device='cpu')
    m.seed(11)
    m.set_ratings(u, i, v)
    m.compute_overall_avg()
    m.compute_items_bias_bk()
    m.compute_users_bias_bk()
    mu, bu0, bi0 = m.overall_bias, m.users_bias.copy(), m.items_bias.copy()
    su, si, sv = m.ratings.shuffled(
        int(np.random.default_rng(11).integers(2 ** 31)))
    if bias_mode == 'learned':
        m.feature_training_bias()
    else:
        m.train(handle_bias=bias_mode == 'fixed')
    uo, vo = np.full((dim, I), f_init), np.full((dim, U), f_init)
    bi, bu = bi0.astype(np.float64), bu0.astype(np.float64)
    jax_ref.funk_train_oracle(3, 3, 1e-4, dim, f_init, lr, K, uo, vo,
                              np.stack([su, si], 1), sv.astype(np.float64),
                              bias_mode=bias_mode, overall_avg=mu,
                              items_bias=bi, users_bias=bu,
                              lr_users=0.005, lr_items=0.005,
                              K_bias_users=0.012, K_bias_items=0.004)
    np.testing.assert_allclose(m.Q.T, uo, **ORACLE)
    np.testing.assert_allclose(m.P.T, vo, **ORACLE)
    if bias_mode == 'learned':
        np.testing.assert_allclose(m.users_bias, bu, **ORACLE)
        np.testing.assert_allclose(m.items_bias, bi, **ORACLE)


# ------------------------------------------------------ mini-batch epochs
def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TIER_ATOL)


def _rmse_close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=TIER_RTOL)


def _batched(small_dataset, B=256):
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    return sgd_mf.batch_ratings(u, i, v.astype(np.float32), B, seed=0), U, I


@pytest.mark.parametrize('bias_mode', ['none', 'fixed', 'learned'])
def test_fused_epoch_matches_jax(small_dataset, bias_mode):
    (ub, ib, rb, mb), U, I = _batched(small_dataset)
    rng = np.random.default_rng(2)
    P = rng.normal(0, 0.1, (U, 6)).astype(np.float32)
    Q = rng.normal(0, 0.1, (I, 6)).astype(np.float32)
    bu = rng.normal(0, 0.2, U).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    kw = dict(lr_bu=0.01, lr_bi=0.02, K_bu=0.01, K_bi=0.03,
              bias_mode=bias_mode)
    jep = jax_sgd.make_fused_epoch(256, 0.02, 0.02, donate=False, **kw)
    pep = sgd_mf.make_fused_epoch(256, 0.02, 0.02, **kw)
    js = jax_sgd.MFState(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(bu),
                         jnp.asarray(bi), jnp.float32(3.6),
                         jnp.zeros_like(jnp.asarray(Q)))
    ps = sgd_mf.MFState(t(P), t(Q), t(bu), t(bi), torch.tensor(3.6))
    plan = sgd_mf.fused_plan(ub, ib, 'cpu')
    for _ in range(3):
        js, jr = jep(js, *(jnp.asarray(a) for a in (ub, ib, rb, mb)),
                     None, None)
        ps, pr = pep(ps, *(t(a) for a in (ub, ib, rb, mb)), plan=plan)
        _rmse_close(pr, jr)
    for a, b in zip(ps[:4], js[:4]):
        _close(a, b)


def test_fused_implicit_epoch_matches_jax(small_dataset):
    (ub, ib, rb, mb), U, I = _batched(small_dataset)
    from mfrec_tpu_torch.data.movielens import ratings_from_arrays
    (u, i, v), _ = small_dataset
    fl, _, fm = fn_ops.padded_user_lists(ratings_from_arrays(u, i, v, U, I))
    rng = np.random.default_rng(3)
    P, Q, Y = (rng.normal(0, 0.1, (n, 5)).astype(np.float32)
               for n in (U, I, I))
    bu = rng.normal(0, 0.2, U).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    jep = jax_sgd.make_fused_epoch(256, 0.02, 0.02, bias_mode='fixed',
                                   implicit=True, donate=False)
    pep = sgd_mf.make_fused_epoch(256, 0.02, 0.02, bias_mode='fixed',
                                  implicit=True)
    js = jax_sgd.MFState(*(jnp.asarray(a) for a in (P, Q, bu, bi)),
                         jnp.float32(3.6), jnp.asarray(Y))
    ps = sgd_mf.MFState(t(P), t(Q), t(bu), t(bi), torch.tensor(3.6), t(Y))
    for _ in range(2):
        js, jr = jep(js, *(jnp.asarray(a) for a in (ub, ib, rb, mb)),
                     jnp.asarray(fl), jnp.asarray(fm))
        ps, pr = pep(ps, *(t(a) for a in (ub, ib, rb, mb)), t(fl), t(fm))
        _rmse_close(pr, jr)
    for a, b in ((ps.P, js.P), (ps.Q, js.Q), (ps.Y, js.Y)):
        _close(a, b)


def test_multi_reg_epoch_matches_jax(small_dataset):
    (ub, ib, rb, mb), U, I = _batched(small_dataset)
    rng = np.random.default_rng(4)
    P = rng.normal(0, 0.1, (U, 4)).astype(np.float32)
    Q = rng.normal(0, 0.1, (I, 4)).astype(np.float32)
    bu = rng.normal(0, 0.2, U).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    Ks = np.asarray([0.0, 0.02, 0.2], np.float32)
    jep = jax_sgd.make_multi_reg_epoch(0.02, bias_mode='fixed')
    pep = sgd_mf.make_multi_reg_epoch(0.02, bias_mode='fixed')
    jP, jQ = jnp.tile(jnp.asarray(P)[None], (3, 1, 1)), \
        jnp.tile(jnp.asarray(Q)[None], (3, 1, 1))
    pP, pQ = t(P)[None].repeat(3, 1, 1), t(Q)[None].repeat(3, 1, 1)
    for _ in range(2):
        jP, jQ, jr = jep(jP, jQ, jnp.asarray(Ks), jnp.asarray(bu),
                         jnp.asarray(bi), jnp.float32(3.6),
                         *(jnp.asarray(a) for a in (ub, ib, rb, mb)))
        pP, pQ, pr = pep(pP, pQ, t(Ks), t(bu), t(bi), 3.6,
                         *(t(a) for a in (ub, ib, rb, mb)))
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr),
                                   rtol=TIER_RTOL)
    _close(pP, jP)
    _close(pQ, jQ)


@pytest.mark.parametrize('bias_mode', ['none', 'fixed'])
def test_funk_fused_feature_epoch_matches_jax(small_dataset, bias_mode):
    (ub, ib, rb, mb), U, I = _batched(small_dataset)
    rng = np.random.default_rng(5)
    pf = rng.normal(0.1, 0.05, (U, 1)).astype(np.float32)
    qf = rng.normal(0.1, 0.05, (I, 1)).astype(np.float32)
    cb = rng.uniform(1, 4, ub.shape).astype(np.float32)
    jep = jax_sgd.make_funk_fused_feature_epoch(0.01, 0.02,
                                                bias_mode=bias_mode)
    pep = sgd_mf.make_funk_fused_feature_epoch(0.01, 0.02,
                                               bias_mode=bias_mode)
    jp, jq = jnp.asarray(pf), jnp.asarray(qf)
    pp, pq = t(pf), t(qf)
    for _ in range(3):
        jp, jq, jr = jep(jp, jq, jnp.float32(0.03),
                         *(jnp.asarray(a) for a in (ub, ib, rb, mb, cb)))
        pp, pq, pr = pep(pp, pq, 0.03, *(t(a) for a in (ub, ib, rb, mb, cb)))
        _rmse_close(pr, jr)
    _close(pp, jp)
    _close(pq, jq)
    _close(sgd_mf.funk_fused_update_cache(pp, pq, t(ub), t(ib), t(cb)),
           jax_sgd.funk_fused_update_cache(jp, jq, jnp.asarray(ub),
                                           jnp.asarray(ib), jnp.asarray(cb)))


def test_funk_fused_learned_epoch_matches_jax(small_dataset):
    (ub, ib, rb, mb), U, I = _batched(small_dataset)
    rng = np.random.default_rng(6)
    pf = rng.normal(0.1, 0.05, (U, 1)).astype(np.float32)
    qf = rng.normal(0.1, 0.05, (I, 1)).astype(np.float32)
    bu = rng.normal(0, 0.2, U).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    off = rng.normal(0, 0.1, ub.shape).astype(np.float32)
    rates = (0.01, 0.005, 0.006, 0.02, 0.012, 0.004)
    jep = jax_sgd.make_funk_fused_learned_epoch(*rates)
    pep = sgd_mf.make_funk_fused_learned_epoch(*rates)
    js = [jnp.asarray(a) for a in (pf, qf, bu, bi)]
    ps = [t(a) for a in (pf, qf, bu, bi)]
    for _ in range(3):
        *js, jr = jep(*js, jnp.float32(3.6), jnp.float32(0.02),
                      *(jnp.asarray(a) for a in (ub, ib, rb, mb, off)))
        *ps, pr = pep(*ps, 3.6, 0.02, *(t(a) for a in (ub, ib, rb, mb, off)))
        _rmse_close(pr, jr)
    for a, b in zip(ps, js):
        _close(a, b)


def test_update_cache_matches_jax():
    u, i, _ = _stream(30, 20, 300, 8)
    rng = np.random.default_rng(9)
    pf, qf = rng.normal(0.5, 0.5, 30), rng.normal(0.5, 0.5, 20)
    cache = np.where(rng.random(300) < 0.5, 3.0, 0.0)
    bu, bi = rng.normal(0, 0.3, 30), rng.normal(0, 0.3, 20)
    for mode in ('none', 'fixed'):
        args = [a.astype(np.float32) for a in (pf, qf, cache)]
        want = jax_sgd.update_cache(*(jnp.asarray(a) for a in args),
                                    jnp.asarray(u), jnp.asarray(i),
                                    jnp.float32(3.5),
                                    jnp.asarray(bu.astype(np.float32)),
                                    jnp.asarray(bi.astype(np.float32)),
                                    bias_mode=mode)
        got = sgd_mf.update_cache(*(t(a) for a in args), t(u), t(i), 3.5,
                                  t(bu.astype(np.float32)),
                                  t(bi.astype(np.float32)), bias_mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SERIAL_ATOL, rtol=0)


# ---------------------------------------------------------------- models
def _pair(cls_pair, U, I, params, seed):
    out = []
    for cls, kw in ((cls_pair[0], {}), (cls_pair[1], {'device': 'cpu'})):
        m = cls(U, I, params, **kw)
        m.seed(seed)
        out.append(m)
    return out


@pytest.mark.parametrize('bias_mode', ['none', 'fixed', 'learned'])
@pytest.mark.parametrize('engine', ['fused', 'funk', 'funk_fused'])
def test_gd_engines_match_jax(tiny_dataset, engine, bias_mode):
    '''``train()`` / ``feature_training_bias()`` on each engine: the RMSE
    history and the factors against the JAX model from the same seed.'''
    u, i, v, U, I = _coo(tiny_dataset)
    params = {'min_epochs': 3, 'max_epochs': 3, 'nbr_features': 3,
              'learning_rate': 0.01, 'engine': engine, 'batch_size': 128}
    models = _pair((JaxGD, GDRecommender), U, I, params, 5)
    for m in models:
        m.set_ratings(u, i, v)
        if bias_mode == 'learned':
            m.feature_training_bias()
        else:
            m.train(handle_bias=bias_mode == 'fixed')
    jm, pm = models
    assert len(jm.rmse_history) == len(pm.rmse_history)
    np.testing.assert_allclose(pm.rmse_history, jm.rmse_history,
                               rtol=TIER_RTOL)
    for name in ('P', 'Q', 'users_bias', 'items_bias'):
        if getattr(jm, name) is None:          # 'none' computes no biases
            assert getattr(pm, name) is None
        else:
            _close(getattr(pm, name), getattr(jm, name))


def test_fn_fused_model_matches_jax(tiny_dataset):
    '''``FNRecommender(engine='fused')`` against the JAX model from the
    same handed-in state (the two packages draw FN's random init from
    different generators): RMSE history, profiles, X and Y.'''
    u, i, v, U, I = _coo(tiny_dataset)
    params = {'nbr_epochs': 3, 'nbr_features': 4, 'engine': 'fused',
              'batch_size': 128, 'min_improvement': -1.0}
    rng = np.random.default_rng(0)
    init = [rng.normal(0, 0.1, (I, 4)).astype(np.float32) for _ in range(3)]
    models = _pair((JaxFN, FNRecommender), U, I, params, 1)
    for m in models:
        m.set_ratings(u, i, v)
        m.Q, m.X, m.Y = (a.copy() for a in init)
        m.users_bias = np.zeros(U, np.float32)
        m.items_bias = np.zeros(I, np.float32)
        m.train(initialize_model=False)
    jm, pm = models
    np.testing.assert_allclose(pm.rmse_history, jm.rmse_history,
                               rtol=TIER_RTOL)
    for name in ('P', 'Q', 'X', 'Y', 'users_bias', 'items_bias'):
        _close(getattr(pm, name), getattr(jm, name))


def test_fn_epoch_matches_jax(tiny_dataset):
    '''``ops.fn.make_fn_epoch`` against the JAX epoch on one state.'''
    from mfrec_tpu_torch.data.movielens import ratings_from_arrays
    u, i, v, U, I = _coo(tiny_dataset)
    fl, fv, fm = fn_ops.padded_user_lists(ratings_from_arrays(u, i, v, U, I))
    ub, ib, rb, mb = sgd_mf.batch_ratings(u, i, v, 100, seed=1)
    rng = np.random.default_rng(7)
    arrs = [rng.normal(0, 0.1, (I, 3)).astype(np.float32) for _ in range(3)]
    bu = rng.normal(0, 0.2, U).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    rates = (0.01, 0.005, 0.006, 0.02, 0.01, 0.03)
    js = jax_fn_ops.FNState(*(jnp.asarray(a) for a in (*arrs, bu, bi)),
                            jnp.float32(3.6))
    ps = fn_ops.FNState(*(t(a) for a in (*arrs, bu, bi)), torch.tensor(3.6))
    jep = jax_fn_ops.make_fn_epoch(*rates, K_y=0.04, donate=False)
    pep = fn_ops.make_fn_epoch(*rates, K_y=0.04)
    for _ in range(2):
        js, jr = jep(js, *(jnp.asarray(a) for a in (ub, ib, rb, mb, fl, fv,
                                                      fm)))
        ps, pr = pep(ps, *(t(a) for a in (ub, ib, rb, mb, fl, fv, fm)))
        _rmse_close(pr, jr)
    for a, b in zip(ps[:5], js[:5]):
        _close(a, b)


# -------------------------------------------------------------- refusals
@pytest.mark.parametrize('engine', ['dsgd', 'alternating_sharded',
                                    'alternating_ring'])
def test_multi_device_engines_raise_naming_item_9(engine):
    u, i, v = _stream(20, 10, 200, 0)
    m = GDRecommender(20, 10, {'engine': engine, 'nbr_features': 2},
                      device='cpu')
    m.set_ratings(u, i, v)
    with pytest.raises(NotImplementedError, match='item 9'):
        m.train(handle_bias=True)


@pytest.mark.parametrize('over', [{'lr_decay': 0.9},
                                  {'lr_plateau_decay': 0.9},
                                  {'resilience': 1}])
@pytest.mark.parametrize('engine', ['fused', 'funk', 'funk_fused'])
def test_alternating_only_options_refused_as_in_jax(engine, over):
    '''The JAX model's refusals of the options only 'alternating' wires,
    word for word.'''
    u, i, v = _stream(20, 10, 200, 0)
    msgs = []
    for m in (JaxGD(20, 10, dict(over, engine=engine)),
              GDRecommender(20, 10, dict(over, engine=engine),
                            device='cpu')):
        m.set_ratings(u, i, v)
        with pytest.raises(Exception) as exc:
            m.train(handle_bias=True)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(Error):
        GDRecommender(20, 10, dict(over, engine=engine),
                      device='cpu').train()
