'''S2's plain versions (``ops/kmf_serial_kernel.py``) on the CPU, held to
the JAX package's ``kmf_serial_epoch`` and driver loop and to the numpy
oracle of the reference's ``kmf_train.pyx``.

Tolerances, by test:
- ``tree_dot`` against the lane-by-lane walk it mirrors (numpy f32
  scalars): bit for bit; against a float64 dot: within (ceil(k / 32) +
  6) * 2^-24 of the products' absolute sum, the rounding of that many
  f32 steps;
- the plain epoch against JAX ``kmf_serial_epoch`` on the CPU, over 3
  epochs: state and rmse within 1e-6 absolute (measured <= 3e-7).  Both
  round every step to f32 in the same order but the dot: XLA sums P[u] @
  Q[i] in its own order, and contracts a multiply and an add into one FMA
  where it can;
- against ``reference_numpy.kmf_train_oracle`` (float64): the JAX
  package's own tolerance for its serial tier (``tests/test_kmf.py``:
  atol 2e-3, rtol 1e-2);
- the converge entry against the JAX driver loop: the same epoch count,
  each rmse within 1e-6;
- the wrapper on CPU tensors against the plain version: bit for bit.'''
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mfrec_tpu.engine.trainer import ConvergenceDriver
from mfrec_tpu.ops import kmf as jax_kmf
from mfrec_tpu_torch.ops import kmf as kmf_ops
from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
from mfrec_tpu_torch.ops.reference_numpy import kmf_train_oracle

torch.set_num_threads(1)

SERIAL_ATOL = 1e-6
ORACLE = dict(atol=2e-3, rtol=1e-2)
MASKS = [(True, True), (True, False), (False, True)]
RATES = (0.01, 0.1, 0.1, 0.007)


def _inputs(U=30, I=20, n=300, k=8, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        u=rng.integers(0, U, n).astype(np.int32),
        i=rng.integers(0, I, n).astype(np.int32),
        r=rng.integers(1, 6, n).astype(np.float32),
        P=rng.normal(0, 0.1, (U, k)).astype(np.float32),
        Q=rng.normal(0, 0.1, (I, k)).astype(np.float32),
        bu=rng.normal(0, 0.1, U).astype(np.float32),
        bi=rng.normal(0, 0.1, I).astype(np.float32))


def _torch(d):
    return ([torch.from_numpy(d[x].copy()) for x in ('P', 'Q', 'bu', 'bi')]
            + [torch.from_numpy(d[x]) for x in ('u', 'i', 'r')])


def _jax(d):
    return [jnp.asarray(d[x]) for x in ('P', 'Q', 'bu', 'bi', 'u', 'i', 'r')]


def _lane_walk(a, b):
    '''The kernel's dot, lane by lane in numpy f32 scalars.'''
    f32 = np.float32
    k = a.shape[0]
    part = []
    for lane in range(32):
        p = f32(0.0)
        for col in range(lane, -(-k // 32) * 32, 32):
            x = a[col] if col < k else f32(0.0)
            y = b[col] if col < k else f32(0.0)
            p = f32(p + f32(x * y))
        part.append(p)
    for off in (16, 8, 4, 2, 1):
        part = [f32(part[j] + part[j ^ off]) for j in range(32)]
    assert len(set(x.tobytes() for x in part)) == 1
    return part[0]


@pytest.mark.parametrize('k', [1, 8, 31, 33, 40, 64, 66, 256])
def test_tree_dot_matches_lane_walk_and_float64(k):
    rng = np.random.default_rng(k)
    a = rng.normal(0, 1, (6, k)).astype(np.float32)
    b = rng.normal(0, 1, (6, k)).astype(np.float32)
    a[0, :min(k, 3)] = -0.0                      # signed zeros stay exact
    got = sk.tree_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for row in range(6):
        assert got[row].tobytes() == _lane_walk(a[row], b[row]).tobytes()
        one = sk.tree_dot(torch.from_numpy(a[row]), torch.from_numpy(b[row]))
        assert one.numpy().tobytes() == got[row].tobytes()
    prod = a.astype(np.float64) * b.astype(np.float64)
    bound = (-(-k // 32) + 6) * 2.0 ** -24 * np.abs(prod).sum(-1)
    assert (np.abs(got - prod.sum(-1)) <= bound).all()


def test_epoch_scalars_round_like_jax():
    sc = sk.epoch_scalars(0.1, 0.3, 0.7, 0.007, 1.0, 5.0)
    assert sc['lr'] == float(np.float32(0.1))
    assert sc['K_items'] == float(np.float32(0.7))
    assert sc['rng'] == 4.0 and sc['lo'] == 1.0
    assert sk.epoch_scalars(0, 0, 0, 0, 0.5, 1.2)['rng'] == \
        float(np.float32(1.2 - 0.5))


@pytest.mark.parametrize('masks', MASKS)
@pytest.mark.parametrize('kernel', ['logistic', 'linear'])
def test_epoch_ref_matches_jax(kernel, masks):
    d = _inputs()
    uu, ui = masks
    j = _jax(d)
    t = _torch(d)
    for _ in range(3):
        j_out = jax_kmf.kmf_serial_epoch(*j, *RATES, kernel=kernel,
                                         update_users=uu, update_items=ui)
        j[:4] = j_out[:4]
        t_out = sk.kmf_serial_epoch_ref(*t, *RATES, kernel, 1.0, 5.0, uu, ui)
    for a, b in zip(j_out, t_out):
        np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                   atol=SERIAL_ATOL, rtol=0)
    # a masked side stays as it was, bit for bit
    for side, on, names in ((0, uu, ('P', 'bu')), (1, ui, ('Q', 'bi'))):
        if not on:
            for name, got in zip(names, (t[side], t[side + 2])):
                np.testing.assert_array_equal(got.numpy(), d[name])


@pytest.mark.parametrize('kernel', ['logistic', 'linear'])
def test_epoch_ref_matches_oracle(tiny_dataset, kernel):
    (u, i, v), _ = tiny_dataset
    U, I = int(u.max()) + 1, int(i.max()) + 1
    dim = 4
    rng = np.random.default_rng(0)
    P0 = rng.normal(0, 0.1, (U, dim))
    Q0 = rng.normal(0, 0.1, (I, dim))
    lr = 0.005 if kernel == 'linear' else 0.01
    uo, vo = Q0.T.copy(), P0.T.copy()
    bu_o, bi_o = np.zeros(U), np.zeros(I)
    kmf_train_oracle(3, dim, lr, 0.1, 0.1, 0.007, uo, vo, np.stack([u, i], 1),
                     v.astype(np.float64), bi_o, bu_o, kernel=kernel)
    st = [torch.from_numpy(a.astype(np.float32)) for a in
          (P0, Q0, np.zeros(U), np.zeros(I))]
    ids = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (u, i)]
    r = torch.from_numpy(v.astype(np.float32))
    P, Q, bu, bi, _ = sk.kmf_serial_converge_ref(
        *st, *ids, r, lr, 0.1, 0.1, 0.007, kernel, min_epochs=3,
        max_epochs=3)
    np.testing.assert_allclose(P.numpy().T, vo, **ORACLE)
    np.testing.assert_allclose(Q.numpy().T, uo, **ORACLE)
    np.testing.assert_allclose(bu.numpy(), bu_o, atol=ORACLE['atol'])
    np.testing.assert_allclose(bi.numpy(), bi_o, atol=ORACLE['atol'])


def _jax_driver(d, kernel, rule, masks=(True, True), lr=0.01):
    '''The JAX model's driver loop (``mfrec_tpu/models/kmf.py:333-351``)
    around ``kmf_serial_epoch``.'''
    driver = ConvergenceDriver(*rule)
    j = _jax(d)

    def one_epoch(st):
        *st, rmse = jax_kmf.kmf_serial_epoch(
            *st, *j[4:], lr, *RATES[1:], kernel=kernel,
            update_users=masks[0], update_items=masks[1])
        return tuple(st), rmse

    st = driver.run(one_epoch, tuple(j[:4]))
    return st, driver.history


@pytest.mark.parametrize('rule', [(5, 5, 0.0), (1, 40, 0.01), (1, 3, -1.0),
                                  (0, 0, 0.0)])
@pytest.mark.parametrize('kernel', ['logistic', 'linear'])
def test_converge_ref_matches_jax_driver(kernel, rule):
    d = _inputs(n=120, seed=3)
    st, hist = _jax_driver(d, kernel, rule)
    t = _torch(d)
    got = sk.kmf_serial_converge_ref(*t, *RATES, kernel, min_epochs=rule[0],
                                     max_epochs=rule[1],
                                     min_improvement=rule[2])
    assert len(got[4]) == len(hist)
    np.testing.assert_allclose(got[4], hist, atol=SERIAL_ATOL, rtol=0)
    for a, b in zip(st, got[:4]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                   atol=SERIAL_ATOL, rtol=0)
    if rule == (1, 40, 0.01):                 # the rule stopped it early
        assert 1 <= len(hist) < 40


def test_converge_ref_stops_on_divergence():
    '''A linear link at a rate that blows up: the JAX driver raises after
    the first non-finite rmse; the plain version stops there, that rmse
    last.'''
    d = _inputs(n=200, seed=4)
    with pytest.raises(FloatingPointError) as ei:
        _jax_driver(d, 'linear', (30, 30, 0.0), lr=0.3)
    t = _torch(d)
    hist = sk.kmf_serial_converge_ref(*t, 0.3, *RATES[1:], 'linear',
                                      min_epochs=30, max_epochs=30)[4]
    assert not math.isfinite(hist[-1])
    assert all(math.isfinite(x) for x in hist[:-1]) and 2 < len(hist) < 30
    assert 'at epoch %d ' % (len(hist) - 1) in str(ei.value)


def test_wrappers_on_cpu_tensors_are_the_plain_versions():
    d = _inputs(n=90, seed=5)
    before = (sk.kmf_serial_converge.launches, sk.kmf_serial_converge.epochs)
    for entry, ref, kw in (
            (sk.kmf_serial_epoch, sk.kmf_serial_epoch_ref, {}),
            (kmf_ops.kmf_serial_epoch, sk.kmf_serial_epoch_ref, {}),
            (sk.kmf_serial_converge, sk.kmf_serial_converge_ref,
             dict(min_epochs=2, max_epochs=4, min_improvement=0.0))):
        a, b = _torch(d), _torch(d)
        got = entry(*a, *RATES, 'logistic', 1.0, 5.0, True, False, **kw)
        want = ref(*b, *RATES, 'logistic', 1.0, 5.0, True, False, **kw)
        for x, y in zip(got[:4], want[:4]):
            assert torch.equal(x, y)
        if isinstance(got[4], list):
            assert got[4] == want[4] and len(got[4]) == 4
        else:
            assert torch.equal(got[4], want[4])
    assert (sk.kmf_serial_converge.launches,
            sk.kmf_serial_converge.epochs) == before


def test_stream_edge_cases():
    '''n = 1, one (u, i) repeated, one user's fold-in stream with a
    duplicated pair: the plain version walks exactly what it is given
    (the JAX epoch agrees within the serial tolerance).'''
    d = _inputs(n=40, seed=6)
    cases = {'one': (d['u'][:1], d['i'][:1], d['r'][:1]),
             'repeat': (np.full(25, 3, np.int32), np.full(25, 7, np.int32),
                        d['r'][:25]),
             'fold_in': (np.full(12, 2, np.int32),
                         np.r_[d['i'][:11], d['i'][3]].astype(np.int32),
                         d['r'][:12])}
    for name, (u, i, r) in cases.items():
        dd = dict(d, u=u, i=i, r=r)
        j = _jax(dd)
        t = _torch(dd)
        for kernel in ('logistic', 'linear'):
            jo = jax_kmf.kmf_serial_epoch(*j, *RATES, kernel=kernel)
            to = sk.kmf_serial_epoch_ref(*_torch(dd), *RATES, kernel)
            for a, b in zip(jo, to):
                np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                           atol=SERIAL_ATOL, rtol=0,
                                           err_msg=name)
        assert t[4].shape[0] == len(u)


def test_checks_refuse_what_the_kernel_does_not_take():
    d = _inputs(n=10)
    t = _torch(d)
    with pytest.raises(ValueError):
        sk.kmf_serial_epoch(*t, *RATES, 'sigmoid')
    with pytest.raises(ValueError):              # k > 256
        sk.kmf_serial_epoch(torch.zeros(30, 257), torch.zeros(20, 257),
                            *t[2:], *RATES)
    with pytest.raises(ValueError):              # int64 ids
        sk.kmf_serial_epoch(*t[:4], t[4].long(), t[5], t[6], *RATES)
    with pytest.raises(ValueError):              # empty stream
        sk.kmf_serial_converge(*t[:4], t[4][:0], t[5][:0], t[6][:0], *RATES)
    with pytest.raises(ValueError):              # P, Q widths differ
        sk.kmf_serial_epoch(t[0], t[1][:, :4].contiguous(), *t[2:], *RATES)
