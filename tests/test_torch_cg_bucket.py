'''The fused K2 bucket kernel's plain version and wrapper on the CPU, held
to the JAX package.

Numerics held to, by test:
- ``cg_bucket_ref`` and ``cg_bucket_kernel`` on CPU tensors against the
  JAX body ``_bucket_cg_body(..., pcg_impl='pallas')``
  (mfrec_tpu/ops/als.py:88-117; its Pallas PCG in interpret mode on the
  CPU, as ``pcg_solve_resident`` runs there): atol 1e-4, rtol 1e-3
  (tests/test_als.py:303; f32 sums in another order), rows outside the
  bucket bit-identical, ``steps=0`` returning x0 exactly.  On the CPU the
  port never runs a kernel (ROADMAP: "On CPU the JAX model path never
  runs Pallas"), so these hold the plain version's numerics, which the
  card's kernel is held to in tests/test_torch_gpu.py;
- the wrapper's M and b (``return_system``) against the JAX einsums with
  ``preferred_element_type=f32`` to a few ulps of the largest entry;
  ``cg_system`` reading the same bits from ``_fixed_bf16``'s padded copy
  as from the unpadded one;
- ``chip_smoke``'s float64 Gram and its bound (``gram_within``, what the
  card's kernel is held to): the plain version's M within it at the
  ALS path's counts, a Gram rounded to bf16 outside it;
- the wrapper's guards: dtype, shape (the fixed side's padded width
  included), device, contiguity, alignment and k.'''
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from mfrec_tpu.ops import als as jax_als
from mfrec_tpu_torch.data.movielens import ratings_from_arrays
from mfrec_tpu_torch.ops import als
from mfrec_tpu_torch.ops import cg_kernel

CG_TOL = dict(atol=1e-4, rtol=1e-3)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _buckets(seed, U=60, I=45, n=1400):
    '''Ratings 1..5 over U users x I items; users' buckets (L 8 to 64)
    hold rows with fewer entries than L.'''
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    v = rng.integers(1, 6, n).astype(np.float32)
    return ratings_from_arrays(u, i, v, U, I).padded_rows(axis='user'), U, I


def _jax_body(Q, P, bucket, k, c_pos, alpha, reg, steps):
    f32 = jnp.float32
    Qj = jnp.asarray(Q)
    HHreg = Qj.T @ Qj + reg * jnp.eye(k, dtype=f32)
    rows, idx, val, mask = (jnp.asarray(x) for x in bucket)
    return np.asarray(jax_als._bucket_cg_body(
        Qj.astype(jnp.bfloat16), jnp.asarray(P), HHreg, rows, idx, val, mask,
        f32(c_pos), f32(alpha), f32(reg), steps, pcg_impl='pallas'))


@pytest.mark.parametrize('fn', ['ref', 'wrapper'])
@pytest.mark.parametrize('alpha', [0.0, 2.0])
@pytest.mark.parametrize('k', [8, 12, 20])
def test_cg_bucket_matches_jax(k, alpha, fn):
    '''Every user bucket of a small data set, c_pos 1.7, 4 PCG steps.'''
    buckets, U, I = _buckets(seed=k)
    reg, c_pos, steps = 0.015, 1.7, 4
    rng = np.random.default_rng(3)
    Q = rng.normal(0, 0.3, (I, k)).astype(np.float32)
    P = rng.normal(0, 0.1, (U, k)).astype(np.float32)
    call = cg_kernel.cg_bucket_ref if fn == 'ref' \
        else cg_kernel.cg_bucket_kernel
    assert any(float(b[3].sum(1).min()) < b[1].shape[1] for b in buckets)
    for bucket in buckets:
        want = _jax_body(Q, P, bucket, k, c_pos, alpha, reg, steps)
        out = _t(P)
        got = call(als._fixed_bf16(_t(Q)), out, als._hh(_t(Q), reg),
                   *(_t(x) for x in bucket), c_pos, alpha, steps)
        assert got is out
        got = got.numpy()
        np.testing.assert_allclose(got, want, **CG_TOL)
        rows = bucket[0]
        others = np.setdiff1d(np.arange(U), rows)
        np.testing.assert_array_equal(got[others], P[others])
        assert np.abs(got[rows] - P[rows]).max() > 0


@pytest.mark.parametrize('fn', ['ref', 'wrapper'])
def test_cg_bucket_zero_steps_returns_x0(fn):
    buckets, U, I = _buckets(seed=5)
    k = 12
    rng = np.random.default_rng(4)
    Q = rng.normal(0, 0.3, (I, k)).astype(np.float32)
    P = rng.normal(0, 0.1, (U, k)).astype(np.float32)
    call = cg_kernel.cg_bucket_ref if fn == 'ref' \
        else cg_kernel.cg_bucket_kernel
    for bucket in buckets:
        got = call(als._fixed_bf16(_t(Q)), _t(P), als._hh(_t(Q), 0.015),
                   *(_t(x) for x in bucket), 1.0, 0.0, 0)
        np.testing.assert_array_equal(got.numpy(), P)


@pytest.mark.parametrize('alpha', [0.0, 2.0])
@pytest.mark.parametrize('k', [12, 20])
def test_cg_bucket_system_matches_jax_assembly(k, alpha):
    '''M and b from ``return_system`` against the JAX einsums
    (mfrec_tpu/ops/als.py:99-106) in f32, a few ulps of the largest
    entry, from the fixed side as ``cg_epoch`` passes it (bf16, padded
    to 8 columns); ``cg_system`` gives the same bits from the unpadded
    bf16 copy.'''
    R, L = 29, 40
    F, out, idx, val, mask = (
        np.asarray(x) for x in _asym(R, k, L, seed=k))
    Fj = jnp.asarray(F)
    HHreg = Fj.T @ Fj + 0.015 * jnp.eye(k, dtype=jnp.float32)
    Ab = Fj.astype(jnp.bfloat16)[jnp.asarray(idx)]
    cm1 = jnp.where(alpha > 0, alpha * jnp.asarray(val), 1.7) \
        * jnp.asarray(mask)
    Awb = Ab * cm1[..., None].astype(jnp.bfloat16)
    Mj = np.asarray(HHreg[None] + jnp.einsum(
        'rlk,rlm->rkm', Awb, Ab, preferred_element_type=jnp.float32))
    bj = np.asarray(jnp.einsum('rl,rlk->rk', (1.0 + cm1) * jnp.asarray(mask),
                               Ab, preferred_element_type=jnp.float32))
    Ft = _t(F)
    Fpad = als._fixed_bf16(Ft)
    assert Fpad.shape[1] == cg_kernel.padded_k(k) > k
    args = (als._hh(Ft, 0.015), torch.arange(R, dtype=torch.int32),
            _t(idx), _t(val), _t(mask), 1.7, alpha, 3)
    _, M, b = cg_kernel.cg_bucket_kernel(Fpad, _t(out), *args,
                                         return_system=True)
    M2, b2, _ = als.cg_system(Ft.to(torch.bfloat16), _t(out), *args[:-1])
    tight = dict(atol=2e-6 * float(np.abs(Mj).max()), rtol=1e-6)
    np.testing.assert_allclose(M.numpy(), Mj, **tight)
    np.testing.assert_allclose(b.numpy(), bj, atol=2e-6 * float(
        np.abs(bj).max()), rtol=1e-6)
    assert torch.equal(M, M2) and torch.equal(b, b2)


def _asym(R, k, L, seed):
    rng = np.random.default_rng(seed)
    n = 3 * k + 50
    F = rng.normal(0, 0.3, (n, k)).astype(np.float32)
    idx = rng.integers(0, n, (R, L)).astype(np.int32)
    val = rng.uniform(1, 5, (R, L)).astype(np.float32)
    mask = (rng.random((R, L)) > 0.2).astype(np.float32)
    out = rng.normal(0, 0.1, (R, k)).astype(np.float32)
    return F, out, idx, val, mask


@pytest.mark.parametrize('L', [8, 256, 2048])
def test_gram_bound_holds_plain_and_rejects_bf16(L):
    '''``chip_smoke.gram_within``, the bound the card's kernel is held to:
    the plain version's f32 Gram (a sum over L terms) lies within it at
    the ALS path's counts, the same Gram rounded to bf16 does not.'''
    d = chip_smoke.cg_bucket_data(5, L, 16, seed=L, device='cpu', hot=True)
    _, M, b = cg_kernel.cg_bucket_ref(d['Fb'], d['out'].clone(), d['HH'],
                                      d['rows'], d['idx'], d['val'],
                                      d['mask'], 1.0, 2.0, 3,
                                      return_system=True)
    M64, b64, SM, Sb = chip_smoke.cg_bucket_f64(
        d['Fb'], d['HH'], d['idx'], d['val'], d['mask'], 1.0, 2.0, 16)
    counts = chip_smoke.bucket_counts(d['mask'])
    assert int(counts[0]) == L
    ok, errM, errb, ratio = chip_smoke.gram_within(M, b, M64, b64, SM, Sb,
                                                   d['HH'], counts)
    assert ok and ratio <= 1.0, (errM, errb, ratio)
    rounded = M.to(torch.bfloat16).float()
    assert not chip_smoke.gram_within(rounded, b, M64, b64, SM, Sb,
                                      d['HH'], counts)[0]


def test_bucket_counts_read_the_mask():
    mask = torch.tensor([[1, 1, 0, 0], [1, 0, 1, 0], [0, 0, 0, 0],
                         [1, 1, 1, 1]], dtype=torch.float32)
    assert chip_smoke.bucket_counts(mask).tolist() == [2, 3, 0, 4]


def test_fixed_side_copy():
    '''One bf16 copy per half-sweep, padded with zero columns to a
    multiple of 8 on every device (the one place that pads).'''
    F = torch.randn(7, 20)
    Fb = als._fixed_bf16(F)
    assert Fb.dtype == torch.bfloat16 and tuple(Fb.shape) == (7, 24)
    assert torch.equal(Fb[:, :20], F.to(torch.bfloat16))
    assert not bool(Fb[:, 20:].any())
    assert tuple(als._fixed_bf16(torch.randn(7, 16)).shape) == (7, 16)
    assert [cg_kernel.padded_k(k) for k in (1, 8, 12, 20, 64, 130, 256)] == \
        [8, 8, 16, 24, 64, 136, 256]


def _bad_args():
    d = chip_smoke.cg_bucket_data(6, 8, 12, seed=2, device='cpu')
    base = dict(Fb=d['Fb'], out=d['out'], HH=d['HH'], rows=d['rows'],
                idx=d['idx'], val=d['val'], mask=d['mask'], steps=3)
    big = torch.zeros((4, 257))
    buf = torch.zeros(d['Fb'].numel() + 1, dtype=torch.bfloat16)
    return [
        ('Fb unpadded', dict(base, Fb=d['Fb'][:, :12].contiguous())),
        ('Fb off a 16-byte boundary', dict(base, Fb=buf[1:].view(
            d['Fb'].shape))),
        ('Fb f32', dict(base, Fb=d['Fb'].float())),
        ('Fb columns', dict(base, Fb=torch.nn.functional.pad(
            d['Fb'], (0, 8)))),
        ('out f64', dict(base, out=d['out'].double())),
        ('out not contiguous', dict(base, out=d['out'].t().contiguous().t())),
        ('HH shape', dict(base, HH=d['HH'][:8, :8].contiguous())),
        ('rows int64', dict(base, rows=d['rows'].long())),
        ('idx int64', dict(base, idx=d['idx'].long())),
        ('val shape', dict(base, val=d['val'][:, :4].contiguous())),
        ('mask f16', dict(base, mask=d['mask'].half())),
        ('mask on meta', dict(base, mask=d['mask'].to('meta'))),
        ('steps < 0', dict(base, steps=-1)),
        ('k > 256', dict(base, out=big, Fb=big.to(torch.bfloat16),
                         HH=torch.zeros((257, 257)))),
    ]


@pytest.mark.parametrize('case', range(14))
def test_cg_bucket_wrapper_raises(case):
    name, a = _bad_args()[case]
    with pytest.raises(ValueError):
        cg_kernel.cg_bucket_kernel(a['Fb'], a['out'], a['HH'], a['rows'],
                                   a['idx'], a['val'], a['mask'], 1.0, 0.0,
                                   a['steps'])


def test_cg_bucket_wrapper_empty_bucket():
    d = chip_smoke.cg_bucket_data(0, 8, 12, seed=0, device='cpu')
    out0 = d['out'].clone()
    before = cg_kernel.cg_bucket_kernel.launches
    got, M, b = cg_kernel.cg_bucket_kernel(
        d['Fb'], d['out'], d['HH'], d['rows'], d['idx'], d['val'],
        d['mask'], 1.0, 0.0, 3, return_system=True)
    assert torch.equal(got, out0) and M.shape == (0, 12, 12) \
        and b.shape == (0, 12)
    assert cg_kernel.cg_bucket_kernel.launches == before


def test_phase2_cases_on_cpu():
    '''chip_smoke's fused-K2 checks run end to end on CPU tensors (the
    plain version against itself and the float64 Gram), as the card runs
    them against the kernel.'''
    d = chip_smoke.cg_bucket_data(9, 64, 20, seed=3, device='cpu',
                                  holes=True, empty_row=True)
    rec = chip_smoke.cg_bucket_case('cpu', d, 3, c_pos=1.7, alpha=2.0)
    assert rec['ok'] and rec['launches'] == 0


def test_cg_bucket_bound_counts_what_the_inputs_ask():
    '''``chip_smoke.cg_bucket_bound`` from a bucket's ids and mask: at
    alpha 0 and a power-of-two bf16(c_pos) the Gram is symmetric, k(k+1)
    per real entry, and no values are read; otherwise 2 k^2 and the
    values too; the fixed side counts its distinct named rows; the tensor
    cores and the f32 cores overlap (the larger time, not the sum).'''
    k, steps = 64, 3
    idx = torch.tensor([[0, 1, 1, 0], [2, 2, 2, 2]], dtype=torch.int32)
    mask = torch.tensor([[1, 1, 1, 0], [1, 0, 0, 0]], dtype=torch.float32)
    R, L, nnz, n_fix = 2, 4, 4, 3
    cb = chip_smoke

    def want(gram, vbytes):
        nbytes = 4 * R * L + vbytes * nnz + 2 * n_fix * k + 4 * k * k + \
            4 * R + 8 * R * k
        f32 = (k if vbytes == 4 else 2 * k) * nnz + \
            2 * R * k * k * (steps + 1)
        t = max(gram * nnz / cb.PEAK_BF16_TENSOR_FLOPS,
                f32 / cb.PEAK_F32_FLOPS)
        return 1e3 * max(t, nbytes / cb.PEAK_BYTES)

    for c_pos, alpha, gram, vbytes in ((1.0, 0.0, k * (k + 1), 4),
                                       (4.0, 0.0, k * (k + 1), 4),
                                       (1.7, 0.0, 2 * k * k, 4),
                                       (1.0, 2.0, 2 * k * k, 8)):
        ms, by = cb.cg_bucket_bound(idx, mask, k, steps, c_pos, alpha)
        assert ms == pytest.approx(want(gram, vbytes), rel=1e-12), c_pos
        assert by in ('bytes', 'operations')
    big = torch.zeros((1, 20000), dtype=torch.int32)
    ms, by = cb.cg_bucket_bound(big, torch.ones((1, 20000)), k, steps,
                                1.0, 0.0)
    # one hot row: the tensor-core time alone, the f32 time not added
    assert by == 'operations' and ms == pytest.approx(
        1e3 * k * (k + 1) * 20000 / cb.PEAK_BF16_TENSOR_FLOPS, rel=1e-12)
