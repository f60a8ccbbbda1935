'''The port's WRMF/ALS slice on the CPU, held to the JAX package.

Numerics held to, by test:
- K2's plain version ``pcg_solve_ref`` against the Pallas kernel
  (``pcg_solve_resident(interpret=True)``) and the XLA loop
  (``ops.als.pcg_solve``), and the port's plain loop ``pcg_solve`` against
  the XLA loop: atol 1e-4, rtol 1e-3 (tests/test_als.py:303; f32 sums in
  another order);
- the CG systems ``cg_system`` against the JAX expressions of
  ``_bucket_cg_body`` (ops/als.py:99-106), in f32 to a few ulps of the
  largest entry: a Gram rounded to bf16 misses that by orders of
  magnitude;
- the bucket bodies ``_bucket_cg_body`` (XLA loop, and the Pallas
  numerics) and ``_bucket_solve`` (f32 and bf16 Gram) against the JAX
  functions, one bucket at a time, alpha 0 and 2: atol 1e-4, rtol 1e-3;
- ``als_wrmf_train`` against the JAX package on the CPU (the XLA loop,
  ``pcg_impl='auto'``): the exact solver's factors after 1 epoch within
  atol 5e-3, rtol 5e-2 (tests/test_als.py:234), the numpy oracle as
  tests/test_als.py:19-47 holds it, CG with the 6->3 warm schedule within
  a prediction rms of 1e-3 (tests/test_als.py:323) and the multi-epoch
  objective within 2e-3 relative (tests/test_als.py:207);
- ``WRMFRecommender(device='cpu')`` against the JAX model (engine pinned
  to 'als': under the suite's 8-device mesh the JAX model's 'auto' picks
  the sharded engine), and the ML-100K floors of
  tests/test_acceptance_ml100k.py:59-75;
- the copies in chip_smoke.py of bench.py's data generator (byte for
  byte) and P@n gate (the same numbers).'''
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import bench
import chip_smoke
from mfrec_tpu.data import ml100k_like as jax_ml100k
from mfrec_tpu.data.movielens import ratings_from_arrays as jax_rfa
from mfrec_tpu.eval.metrics import precision_recall as jax_precision_recall
from mfrec_tpu.models.wrmf import WRMFRecommender as JaxWRMF
from mfrec_tpu.ops import als as jax_als
from mfrec_tpu.ops.pallas_cg import pcg_solve_resident
from mfrec_tpu_torch import interop
from mfrec_tpu_torch.data import ml100k_like
from mfrec_tpu_torch.data.movielens import ratings_from_arrays
from mfrec_tpu_torch.eval.metrics import precision_recall
from mfrec_tpu_torch.models.base import Error
from mfrec_tpu_torch.models.wrmf import WRMFRecommender
from mfrec_tpu_torch.ops import als
from mfrec_tpu_torch.ops import cg_kernel

CG_TOL = dict(atol=1e-4, rtol=1e-3)
FACTOR_TOL = dict(atol=5e-3, rtol=5e-2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _systems(R, k, kind, seed):
    '''Seeded (M, b, x0) numpy systems: 'warm'/'cold' are the B B^T + 3I
    systems of tests/test_als.py:287-303 from a random or zero start;
    'b0' has b = 0; 'solved' is M = I with x0 = b (r = 0: every step
    size takes its guard); 'identity' M = I from a random start.'''
    rng = np.random.default_rng(seed)
    if kind in ('solved', 'identity'):
        M = np.broadcast_to(np.eye(k, dtype=np.float32), (R, k, k)).copy()
    else:
        B = rng.normal(0, 1, (R, k, k)).astype(np.float32)
        M = np.einsum('rij,rkj->rik', B, B) + 3.0 * np.eye(k,
                                                            dtype=np.float32)
    b = np.zeros((R, k), np.float32) if kind == 'b0' else \
        rng.normal(0, 1, (R, k)).astype(np.float32)
    x0 = np.zeros((R, k), np.float32) if kind == 'cold' else \
        b.copy() if kind == 'solved' else \
        rng.normal(0, 0.1, (R, k)).astype(np.float32)
    return M.astype(np.float32), b, x0


def _asym_systems(R, k, L, seed, alpha=2.0):
    '''The CG path's assembly on random buckets: with alpha > 0 the
    bf16-weighted Gram is not symmetric.'''
    rng = np.random.default_rng(seed)
    n = 3 * k + 50
    F = rng.normal(0, 0.3, (n, k)).astype(np.float32)
    idx = rng.integers(0, n, (R, L)).astype(np.int32)
    val = rng.uniform(1, 5, (R, L)).astype(np.float32)
    mask = (rng.random((R, L)) > 0.2).astype(np.float32)
    out = rng.normal(0, 0.1, (R, k)).astype(np.float32)
    return F, out, idx, val, mask


def _jax_pcg(M, b, x0, steps):
    xla = np.asarray(jax_als.pcg_solve(jnp.asarray(M), jnp.asarray(b),
                                       jnp.asarray(x0), steps))
    pallas = np.asarray(pcg_solve_resident(
        jnp.asarray(M), jnp.asarray(b), jnp.asarray(x0), steps, rb=16,
        interpret=True))
    return xla, pallas


@pytest.mark.parametrize('start', ['warm', 'cold'])
@pytest.mark.parametrize('steps', [0, 1, 5])
@pytest.mark.parametrize('k', [8, 20, 64])
def test_pcg_ref_matches_jax(k, steps, start):
    '''R=37 is no block multiple of the Pallas kernel (rb=16: padded
    with identity systems there, not here).'''
    M, b, x0 = _systems(37, k, start, seed=k + steps)
    xla, pallas = _jax_pcg(M, b, x0, steps)
    ref = cg_kernel.pcg_solve_ref(_t(M), _t(b), _t(x0), steps).numpy()
    np.testing.assert_allclose(ref, pallas, **CG_TOL)
    np.testing.assert_allclose(ref, xla, **CG_TOL)
    loop = als.pcg_solve(_t(M), _t(b), _t(x0), steps).numpy()
    np.testing.assert_allclose(loop, xla, **CG_TOL)
    if steps == 0:
        np.testing.assert_array_equal(ref, x0)


@pytest.mark.parametrize('kind', ['b0', 'solved', 'identity', 'asym'])
def test_pcg_ref_guards_and_asymmetric(kind):
    k, steps = 20, 5
    if kind == 'asym':
        F, out, idx, val, mask = _asym_systems(37, k, 24, seed=1)
        Ft = _t(F)
        M, b, x0 = (x.numpy() for x in als.cg_system(
            Ft.to(torch.bfloat16), _t(out), als._hh(Ft, 0.015),
            torch.arange(37), _t(idx), _t(val), _t(mask), 1.0, 2.0))
        assert np.abs(M - M.transpose(0, 2, 1)).max() > 1e-3
    else:
        M, b, x0 = _systems(37, k, kind, seed=2)
    xla, pallas = _jax_pcg(M, b, x0, steps)
    ref = cg_kernel.pcg_solve_ref(_t(M), _t(b), _t(x0), steps).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(ref, pallas, **CG_TOL)
    np.testing.assert_allclose(ref, xla, **CG_TOL)
    if kind == 'solved':                # a = beta = 0 from the first step
        np.testing.assert_array_equal(ref, x0)
    if kind == 'b0':
        assert np.abs(ref).max() < np.abs(x0).max()


def test_pcg_kernel_wrapper_on_cpu():
    '''CPU tensors run the plain version and launch nothing; what the
    kernel does not take raises.'''
    M, b, x0 = (_t(a) for a in _systems(9, 16, 'warm', seed=4))
    before = cg_kernel.pcg_solve_kernel.launches
    got = cg_kernel.pcg_solve_kernel(M, b, x0, 4)
    assert torch.equal(got, cg_kernel.pcg_solve_ref(M, b, x0, 4))
    empty = cg_kernel.pcg_solve_kernel(M[:0], b[:0], x0[:0], 4)
    assert tuple(empty.shape) == (0, 16)
    assert cg_kernel.pcg_solve_kernel.launches == before
    bad = [(M.double(), b, x0, 4), (M, b[:, :8], x0, 4), (M, b, x0, -1),
           (M[:, :, :8], b, x0, 4), (M.transpose(1, 2), b, x0, 4)]
    big = torch.zeros(1, 257, 257)
    bad.append((big, torch.zeros(1, 257), torch.zeros(1, 257), 1))
    for args in bad:
        with pytest.raises(ValueError):
            cg_kernel.pcg_solve_kernel(*args)


@pytest.mark.parametrize('alpha', [0.0, 2.0])
def test_cg_system_matches_jax_assembly(alpha):
    '''M and b in f32 from exact products of bf16 values, as the JAX
    einsums with preferred_element_type=f32 give them; a Gram rounded to
    bf16 (what torch.bmm on bf16 tensors returns) fails the same check.'''
    k, R, L = 16, 29, 40
    F, out, idx, val, mask = _asym_systems(R, k, L, seed=3)
    Fj = jnp.asarray(F)
    HHreg = Fj.T @ Fj + 0.015 * jnp.eye(k, dtype=jnp.float32)
    # the JAX expressions of _bucket_cg_body (mfrec_tpu/ops/als.py:99-106)
    A = Fj.astype(jnp.bfloat16)[jnp.asarray(idx)]
    cm1 = jnp.where(alpha > 0, alpha * jnp.asarray(val), 1.0) \
        * jnp.asarray(mask)
    Ab = A.astype(jnp.bfloat16)
    Awb = Ab * cm1[..., None].astype(jnp.bfloat16)
    Mj = np.asarray(HHreg[None] + jnp.einsum(
        'rlk,rlm->rkm', Awb, Ab, preferred_element_type=jnp.float32))
    bj = np.asarray(jnp.einsum('rl,rlk->rk', (1.0 + cm1) * jnp.asarray(mask),
                               Ab, preferred_element_type=jnp.float32))
    Ft = _t(F)
    M, b, x0 = als.cg_system(Ft.to(torch.bfloat16), _t(out),
                             als._hh(Ft, 0.015), torch.arange(R), _t(idx),
                             _t(val), _t(mask), 1.0, alpha)
    assert M.dtype == torch.float32 and b.dtype == torch.float32
    # f32 sums of L products in another order: a few ulps of the
    # largest entry
    tight = dict(atol=2e-6 * float(np.abs(Mj).max()), rtol=1e-6)
    np.testing.assert_allclose(M.numpy(), Mj, **tight)
    np.testing.assert_allclose(b.numpy(), bj, atol=2e-6 * float(
        np.abs(bj).max()), rtol=1e-6)
    np.testing.assert_array_equal(x0.numpy(), out)
    rounded = M.to(torch.bfloat16).float().numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(rounded, Mj, **tight)


def _stream(seed):
    '''900 draws over 70 users x 50 items, ratings 1..5; users 66..69 and
    items 47..49 never rated.'''
    rng = np.random.default_rng(seed)
    n = 900
    u = rng.integers(0, 66, n).astype(np.int32)       # rows 66..69 empty
    i = rng.integers(0, 47, n).astype(np.int32)       # items 47..49 empty
    v = rng.integers(1, 6, n).astype(np.float32)
    return u, i, v


@pytest.mark.parametrize('alpha', [0.0, 2.0])
@pytest.mark.parametrize('body', ['cg_xla', 'cg_pallas', 'exact_f32',
                                  'exact_bf16'])
def test_bucket_bodies_match_jax(body, alpha):
    U, I = 70, 50
    r = ratings_from_arrays(*_stream(seed=1), U, I)
    k, reg = 12, 0.015
    rng = np.random.default_rng(7)
    Q = rng.normal(0, 0.3, (I, k)).astype(np.float32)
    P = rng.normal(0, 0.1, (U, k)).astype(np.float32)
    f32 = jnp.float32
    for rows, idx, val, mask in r.padded_rows(axis='user'):
        jargs = (jnp.asarray(rows), jnp.asarray(idx), jnp.asarray(val),
                 jnp.asarray(mask), f32(1.0), f32(alpha), f32(reg))
        targs = (_t(rows), _t(idx), _t(val), _t(mask), 1.0, alpha, reg)
        if body.startswith('cg'):
            impl = body[3:]
            Qj = jnp.asarray(Q)
            HHreg = Qj.T @ Qj + reg * jnp.eye(k, dtype=f32)
            want = jax_als._bucket_cg_body(
                Qj.astype(jnp.bfloat16), jnp.asarray(P), HHreg, *jargs,
                4, pcg_impl=impl)
            got = als._bucket_cg_body(
                _t(Q).to(torch.bfloat16), _t(P), als._hh(_t(Q), reg),
                *targs, 4, pcg_impl=impl)
        else:
            bf16 = body == 'exact_bf16'
            Qj = jnp.asarray(Q)
            want = jax_als._bucket_solve(
                Qj, jnp.asarray(P), (Qj.T @ Qj).astype(f32), *jargs,
                gram_dtype=jnp.bfloat16 if bf16 else None)
            got = als._bucket_solve(
                _t(Q), _t(P), als._hh(_t(Q)), *targs,
                gram_dtype=torch.bfloat16 if bf16 else None)
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got, want, **CG_TOL)
        others = np.setdiff1d(np.arange(U), rows)
        np.testing.assert_array_equal(got[others], P[others])
        assert np.abs(got[rows] - P[rows]).max() > 0


def _train_pair(r_t, r_j, P0, Q0, **kw):
    Pj, Qj = jax_als.als_wrmf_train(jnp.asarray(P0), jnp.asarray(Q0),
                                    r_j.padded_rows(axis='user'),
                                    r_j.padded_rows(axis='item'), **kw)
    Pt, Qt = als.als_wrmf_train(_t(P0), _t(Q0), r_t.padded_rows(axis='user'),
                                r_t.padded_rows(axis='item'), **kw)
    return (np.asarray(Pj), np.asarray(Qj)), (Pt.numpy(), Qt.numpy())


def _binary(dataset):
    (u, i, v), _ = dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    ones = np.ones_like(v)
    return (ratings_from_arrays(u, i, ones, U, I),
            jax_rfa(u, i, ones, U, I), U, I)


def _init(U, I, k=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, (U, k)).astype(np.float32),
            rng.normal(0, 0.1, (I, k)).astype(np.float32))


def _pred_rms(a, b):
    d = a[0] @ a[1].T - b[0] @ b[1].T
    return float(np.sqrt((d ** 2).mean()))


@pytest.mark.parametrize('kw', [{}, {'gram_dtype': 'bf16'},
                                {'alpha': 2.0}])
def test_train_exact_one_epoch_matches_jax(small_dataset, kw):
    (u, i, v), _ = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    vals = v if 'alpha' in kw else np.ones_like(v)
    r_t, r_j = ratings_from_arrays(u, i, vals, U, I), jax_rfa(u, i, vals,
                                                               U, I)
    P0, Q0 = _init(U, I)
    jkw, tkw = dict(kw), dict(kw)
    if 'gram_dtype' in kw:
        jkw['gram_dtype'], tkw['gram_dtype'] = jnp.bfloat16, torch.bfloat16
    Pj, Qj = jax_als.als_wrmf_train(jnp.asarray(P0), jnp.asarray(Q0),
                                    r_j.padded_rows(axis='user'),
                                    r_j.padded_rows(axis='item'),
                                    nbr_epochs=1, **jkw)
    Pt, Qt = als.als_wrmf_train(_t(P0), _t(Q0), r_t.padded_rows(axis='user'),
                                r_t.padded_rows(axis='item'), nbr_epochs=1,
                                **tkw)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), **FACTOR_TOL)
    np.testing.assert_allclose(Qt.numpy(), np.asarray(Qj), **FACTOR_TOL)


def _bool_sparse(r):
    '''Reference datasets.py:13-32 format (tests/test_als.py:10-16).'''
    u, i, _ = r.coo()
    rows_u = np.r_[0, np.bincount(u, minlength=r.nbr_users)].astype(np.int32)
    order = np.argsort(i, kind='stable')
    rows_i = np.r_[0, np.bincount(i, minlength=r.nbr_items)].astype(np.int32)
    return rows_u, i.astype(np.int32), rows_i, u[order].astype(np.int32)


def test_train_matches_numpy_oracle():
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    users, items, vals = synthetic_ratings(40, 25, 350, seed=5)
    r = ratings_from_arrays(users, items, np.ones_like(vals), 40, 25)
    dim, f_init, c_pos, reg = 6, 0.1, 1, 0.015
    uo = np.full((dim, 25), f_init)
    vo = np.full((dim, 40), f_init)
    ru, cu, ri, ci = _bool_sparse(r)
    als.als_wrmf_oracle(1, dim, uo, vo, ru, cu, ri, ci, 40, 25, c_pos=c_pos,
                        k=reg)
    # the port's copy of the oracle is the JAX package's
    uj, vj = np.full((dim, 25), f_init), np.full((dim, 40), f_init)
    jax_als.als_wrmf_oracle(1, dim, uj, vj, ru, cu, ri, ci, 40, 25,
                            c_pos=c_pos, k=reg)
    np.testing.assert_array_equal(uo, uj)
    np.testing.assert_array_equal(vo, vj)
    P, Q = als.als_wrmf_train(torch.full((40, dim), f_init),
                              torch.full((25, dim), f_init),
                              r.padded_rows(axis='user'),
                              r.padded_rows(axis='item'), nbr_epochs=1,
                              c_pos=c_pos, reg=reg)
    P, Q = P.numpy().astype(np.float64), Q.numpy().astype(np.float64)
    P[r.user_counts() == 0] = 0.0
    Q[r.item_counts() == 0] = 0.0
    vo[:, r.user_counts() == 0] = 0.0
    uo[:, r.item_counts() == 0] = 0.0
    np.testing.assert_allclose(P.T, vo, atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(Q.T, uo, atol=5e-3, rtol=1e-2)


def _objective(P, Q, r, reg=0.015):
    U, I = P.shape[0], Q.shape[0]
    uu, ii, _ = r.coo()
    obs = np.zeros((U, I), bool)
    obs[uu, ii] = True
    C = np.where(obs, 2.0, 1.0)
    S = P.astype(np.float64) @ Q.astype(np.float64).T
    return float((C * (obs - S) ** 2).sum()
                 + reg * ((P ** 2).sum() + (Q ** 2).sum()))


def test_train_cg_warm_schedule_matches_jax(small_dataset):
    '''CG 6 -> 3 steps after 2 epochs: 6 epochs against the JAX package's
    CG in prediction space; 10 epochs against the JAX exact solver in
    objective space (the same level set).'''
    r_t, r_j, U, I = _binary(small_dataset)
    P0, Q0 = _init(U, I)
    kw = dict(solver='cg', cg_steps=6, cg_warm_steps=3, cg_warmup_epochs=2)
    jx, pt = _train_pair(r_t, r_j, P0, Q0, nbr_epochs=6, **kw)
    assert _pred_rms(jx, pt) < 1e-3
    je, _ = _train_pair(r_t, r_j, P0, Q0, nbr_epochs=10)
    _, pw = _train_pair(r_t, r_j, P0, Q0, nbr_epochs=10, **kw)
    oe, ow = _objective(*je, r_t), _objective(*pw, r_t)
    assert abs(ow - oe) / oe < 2e-3, (oe, ow)


def test_train_pallas_numerics_match_jax(small_dataset):
    '''pcg_impl='pallas' on CPU tensors: K2's plain version against the
    Pallas kernel in interpret mode, epoch for epoch.'''
    r_t, r_j, U, I = _binary(small_dataset)
    P0, Q0 = _init(U, I)
    jx, pt = _train_pair(r_t, r_j, P0, Q0, nbr_epochs=3, solver='cg',
                         cg_steps=4, pcg_impl='pallas')
    assert _pred_rms(jx, pt) < 1e-3


def test_train_leaves_inputs_alone(small_dataset):
    '''The JAX function is pure; the port's updates in place only on its
    own copies (CPU tensors share numpy's memory).'''
    r_t, _, U, I = _binary(small_dataset)
    P0, Q0 = _init(U, I)
    Pn, Qn = P0.copy(), Q0.copy()
    Pt, Qt = torch.from_numpy(P0), torch.from_numpy(Q0)
    for solver in ('exact', 'cg'):
        als.als_wrmf_train(Pt, Qt, r_t.padded_rows(axis='user'),
                           r_t.padded_rows(axis='item'), nbr_epochs=1,
                           solver=solver)
    np.testing.assert_array_equal(P0, Pn)
    np.testing.assert_array_equal(Q0, Qn)


def _model_pair(u, i, v, U, I, params, seed=3):
    jparams = dict(params, engine='als')
    a, b = JaxWRMF(U, I, jparams), WRMFRecommender(U, I, params,
                                                   device='cpu')
    for m in (a, b):
        m.seed(seed)
        m.set_ratings(u, i, v)
    return a, b


def test_parameters_match_jax():
    a, b = JaxWRMF(5, 7), WRMFRecommender(5, 7, device='cpu')
    assert a.PARAMETERS_INDEX == b.PARAMETERS_INDEX
    for attr in a.PARAMETERS_INDEX.values():
        assert getattr(a, attr) == getattr(b, attr), attr
    assert b._default_predictor_mode == a._default_predictor_mode == 'dot'


@pytest.mark.parametrize('params', [
    {'nbr_epochs': 1, 'nbr_features': 8},
    {'nbr_epochs': 6, 'nbr_features': 8, 'solver': 'cg', 'cg_steps': 6,
     'cg_warm_steps': 3, 'cg_warmup_epochs': 2},
    # one epoch: from a constant init only rounding breaks the columns'
    # tie, and the iteration amplifies it (tests/test_als.py:19-23)
    {'nbr_epochs': 1, 'nbr_features': 6, 'init_mode': 'constant',
     'regularization_model': 0.015}])
def test_model_matches_jax(params):
    u, i, v = _stream(seed=2)
    U, I = 70, 50                           # with rows and items never rated
    a, b = _model_pair(u, i, np.ones_like(v), U, I, params)
    a0, b0 = _model_pair(u, i, np.ones_like(v), U, I,
                         dict(params, nbr_epochs=0))
    for m in (a0, b0):
        m.train()
    np.testing.assert_array_equal(np.asarray(a0.P), b0.P)   # the same init
    np.testing.assert_array_equal(np.asarray(a0.Q), b0.Q)
    for m in (a, b):
        m.train()
    Pa, Qa = np.asarray(a.P), np.asarray(a.Q)
    assert b.P.dtype == np.float32 and b.P.shape == Pa.shape
    if params.get('solver') == 'cg':
        assert _pred_rms((Pa, Qa), (b.P, b.Q)) < 1e-3
    else:
        np.testing.assert_allclose(b.P, Pa, **FACTOR_TOL)
        np.testing.assert_allclose(b.Q, Qa, **FACTOR_TOL)
    # rows and items with no interactions come out zero
    assert not b.P[66:].any() and not b.Q[47:].any()
    assert np.abs(b.P[:66]).max() > 0
    items, users = np.arange(40), np.arange(40) % 66
    np.testing.assert_allclose(b.predict_batch(items, users),
                               a.predict_batch(items, users), **FACTOR_TOL)
    assert b.predict(3, 4) == pytest.approx(float(b.Q[3] @ b.P[4]))
    assert b.predict_rating_by_label('user4', 'item3') == b.predict(3, 4)
    assert b.predict_rating_by_label('user4', 'nobody') == 0.0


@pytest.mark.parametrize('over,exc', [
    ({'engine': 'als_sharded'}, NotImplementedError),
    ({'engine': 'no_such_engine'}, Error)])
def test_unported_engines_raise(over, exc):
    u, i, v = _stream(seed=3)
    m = WRMFRecommender(70, 50, dict({'nbr_epochs': 1}, **over),
                        device='cpu')
    m.set_ratings(u, i, np.ones_like(v))
    with pytest.raises(exc):
        m.train()


def test_wrmf_precision_floor():
    '''tests/test_acceptance_ml100k.py:59-75's operating point on the
    port's copy of the generator (CG, 30 epochs, 20 features, reg
    0.015), and the port's precision_recall against the JAX function on
    the same factors.'''
    (u, i, v), test = ml100k_like.u1_split(seed=0)
    test = test.astype(np.float64)
    m = WRMFRecommender(ml100k_like.N_USERS, ml100k_like.N_ITEMS,
                        {'nbr_epochs': 30, 'nbr_features': 20,
                         'regularization_model': 0.015, 'solver': 'cg',
                         'neighborhood': 1500}, device='cpu')
    m.set_ratings(u, i, np.ones_like(v))
    m.train()
    p5 = precision_recall(m, test, nbr_recommendations=5)
    p10 = precision_recall(m, test, nbr_recommendations=10)
    assert p5[0] >= 0.34, p5
    assert p10[0] >= 0.25, p10
    a = JaxWRMF(jax_ml100k.N_USERS, jax_ml100k.N_ITEMS)
    a.set_ratings(u, i, np.ones_like(v))
    a.P, a.Q = m.P.copy(), m.Q.copy()
    np.testing.assert_allclose(p5, jax_precision_recall(a, test, 5),
                               rtol=0, atol=1e-12)


def test_implicit_data_copy_is_exact():
    got = chip_smoke.make_implicit_data(300, 120, 9000, seed=4)
    want = bench.make_implicit_data(300, 120, 9000, seed=4)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_ranking_gate_copy_matches_bench():
    '''The torch copy of the P@n gate gives the original's numbers on the
    same factors (item 0 left unmasked where a user's list is padded, as
    the original's scatter does on the CPU); ``strict=True`` masks every
    train item and can only lose hits.'''
    U, I = 400, 150
    tu_, ti_, te_u, te_i = bench.make_implicit_data(U, I, 30000, seed=1)
    ones = np.ones(tu_.shape[0], np.float32)
    r_j, r_t = jax_rfa(tu_, ti_, ones, U, I), ratings_from_arrays(
        tu_, ti_, ones, U, I)
    m = WRMFRecommender(U, I, {'nbr_epochs': 4, 'nbr_features': 8,
                               'solver': 'cg'}, device='cpu')
    m.set_ratings(tu_, ti_, ones)
    m.train()
    want = bench._als_ranking_gate(m.P, m.Q, r_j, te_u, te_i, U, I, n=5,
                                   max_users=300)
    got = chip_smoke.als_ranking_gate(m.P, m.Q, r_t, te_u, te_i, U, I, n=5,
                                      max_users=300, device='cpu')
    assert got == pytest.approx(want, abs=1e-12)
    strict = chip_smoke.als_ranking_gate(m.P, m.Q, r_t, te_u, te_i, U, I,
                                         n=5, max_users=300, device='cpu',
                                         strict=True)
    assert strict[0] <= got[0] and strict[1] <= got[1]
    # the model's own top-n masks every train item: the strict gate's lists
    users, order, starts, ends = chip_smoke._gate_users(te_u, 300)
    top, _ = m.recommend_batch(users, 5)
    hits = chip_smoke._hits(top, te_i, order, starts, ends, 0)
    assert hits / (users.size * 5) == pytest.approx(strict[0], abs=1e-12)


def test_jax_checkpoint_carries_across(small_dataset, tmp_path):
    '''A JAX WRMF checkpoint loads into the port's WRMFRecommender (named
    by the caller) with the same predictions and top-N lists.'''
    (u, i, v), test = small_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    a = JaxWRMF(U, I, {'nbr_epochs': 3, 'nbr_features': 8, 'engine': 'als'})
    a.set_ratings(u, i, np.ones_like(v))
    a.train()
    path = str(tmp_path / 'wrmf')
    a.save_state(path)
    b = interop.load_jax_state(path, device='cpu',
                               model_class=WRMFRecommender)
    assert isinstance(b, WRMFRecommender)
    tu, ti = test[:, 0].astype(int), test[:, 1].astype(int)
    np.testing.assert_allclose(b.predict_batch(ti, tu),
                               np.asarray(a.predict_batch(ti, tu)),
                               atol=1e-6)
    ids_a, _ = a.recommend_batch(np.arange(20), 5)
    ids_b, _ = b.recommend_batch(np.arange(20), 5)
    np.testing.assert_array_equal(np.asarray(ids_a), ids_b)
    c = interop.from_numpy(a.P, a.Q, None, None, None, a.ratings.coo(),
                           device='cpu', model_class=WRMFRecommender)
    np.testing.assert_array_equal(c.recommend_batch(np.arange(20), 5)[0],
                                  ids_b)
