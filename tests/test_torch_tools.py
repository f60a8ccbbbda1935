'''The port's measurement tools on the CPU (``mfrec_tpu_torch.tools``),
held to the JAX tools and the JAX bench.

- ``bench_data.make_data`` / ``bias_floor_rmse`` against ``bench.py``:
  byte for byte;
- ``sgd_mf.init_state``: the JAX modes and shapes (its normal draws come
  from a ``torch.Generator``, so the epochs below start from handed-in
  factors);
- the A/B tool's 'old' epoch (P1's plain version) against
  ``tools/ab_kernel.build('old')``'s epoch with the Pallas body in
  interpret mode, and its 'new' epoch (K1's plain version) against
  ``build('new')`` (the JAX epoch in interpret mode through a
  monkeypatched ``make_alternating_epoch``), from the same factors, two
  epochs: K1's tolerances (factors atol 5e-3 + rtol 5e-2, RMSE 1e-3
  relative), as ``chip_smoke.py`` states them;
- both tools' ``main`` at a tiny size on ``device='cpu'``.

The JAX tool's ``build`` reads its data as module globals that only its
main block sets: the tests set them (``raising=False``).'''
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as jax_pl

import bench
import chip_smoke
from mfrec_tpu.ops import sgd_mf as jax_sgd
from mfrec_tpu_torch.ops import probe_kernel as p2
from mfrec_tpu_torch.ops import sgd_mf
from mfrec_tpu_torch.tools import ab_kernel, bench_data, kernel_probe
from tools import ab_kernel as jax_ab

# the suite runs in several xdist workers: one intra-op thread each
torch.set_num_threads(1)

ATOL, RTOL, RMSE_RTOL = 5e-3, 5e-2, 1e-3
SMALL = dict(U=60, I=40, N=3000, K=6, BATCH=256, INNER=2, CHUNK=128)


@pytest.mark.parametrize('shape', [(50, 30, 2000, 0), (300, 97, 12345, 3)])
def test_bench_data_byte_identical(shape):
    U, I, N, seed = shape
    want = bench.make_data(U, I, N, seed=seed)
    got = bench_data.make_data(U, I, N, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    f_w, bu_w, bi_w = bench.bias_floor_rmse(*want, U, I)
    f_g, bu_g, bi_g = bench_data.bias_floor_rmse(*got, U, I)
    assert f_g == f_w
    assert bu_g.tobytes() == bu_w.tobytes()
    assert bi_g.tobytes() == bi_w.tobytes()
    assert chip_smoke.bias_floor_rmse(*got, U, I) == f_w


@pytest.mark.parametrize('mode', ['constant', 'normal'])
def test_init_state(mode):
    want = jax_sgd.init_state(7, 5, 4, feature_init=0.2, mode=mode)
    a = sgd_mf.init_state(7, 5, 4, feature_init=0.2, mode=mode, seed=3,
                          device='cpu')
    b = sgd_mf.init_state(7, 5, 4, feature_init=0.2, mode=mode, seed=3,
                          device='cpu')
    for name in ('P', 'Q', 'bu', 'bi', 'mu'):
        x, w = getattr(a, name), np.asarray(getattr(want, name))
        assert tuple(x.shape) == w.shape and x.dtype == torch.float32
        assert torch.equal(x, getattr(b, name))
    if mode == 'constant':
        np.testing.assert_array_equal(a.P.numpy(), np.asarray(want.P))
    else:
        assert 0.1 < float(a.P.std()) < 0.3 and float(a.bu.abs().sum()) == 0
    with pytest.raises(ValueError):
        sgd_mf.init_state(2, 2, 2, mode='uniform', device='cpu')


def test_port_entry_points_default_to_the_card():
    '''``init_state`` and ``init_fn_state`` place their tensors on the
    card unless told otherwise; without one they raise.'''
    from mfrec_tpu_torch.ops import fn as fn_ops
    if torch.cuda.is_available():
        assert sgd_mf.init_state(2, 2, 2).P.is_cuda
        assert fn_ops.init_fn_state(2, 3, 2).Q.is_cuda
        return
    with pytest.raises(RuntimeError):
        sgd_mf.init_state(2, 2, 2)
    with pytest.raises(RuntimeError):
        fn_ops.init_fn_state(2, 3, 2)


@pytest.fixture
def jax_tool(monkeypatch):
    '''``tools/ab_kernel.py`` at a small size on the CPU: its module
    globals set, its Pallas call and the JAX epoch's in interpret mode.'''
    users, items, vals = bench.make_data(SMALL['U'], SMALL['I'],
                                         SMALL['N'])
    floor, bu_fit, bi_fit = bench.bias_floor_rmse(users, items, vals,
                                                  SMALL['U'], SMALL['I'])
    for name, val in dict(SMALL, users=users, items=items, vals=vals,
                          bu_fit=bu_fit, bi_fit=bi_fit,
                          mu=jnp.float32(vals.mean())).items():
        monkeypatch.setattr(jax_ab, name, val, raising=False)

    def pallas_call(*args, **kwargs):
        kwargs['interpret'] = True
        return jax_pl.pallas_call(*args, **kwargs)

    shim = types.SimpleNamespace(
        pallas_call=pallas_call, program_id=jax_pl.program_id,
        num_programs=jax_pl.num_programs, when=jax_pl.when, ds=jax_pl.ds,
        BlockSpec=jax_pl.BlockSpec)
    monkeypatch.setattr(jax_ab, 'pl', shim)
    orig = jax_sgd.make_alternating_epoch

    def interpreted(*args, **kwargs):
        if kwargs.get('use_pallas_full'):
            kwargs['pallas_interpret'] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jax_sgd, 'make_alternating_epoch', interpreted)
    return users, items, vals, bu_fit, bi_fit, floor


@pytest.mark.parametrize('variant', ['old', 'new'])
def test_ab_epochs_match_jax_tool(jax_tool, variant):
    users, items, vals, bu_fit, bi_fit, _ = jax_tool
    ep_j, (Pj, Qj), pl_j, ql_j = jax_ab.build(variant)
    layouts = ab_kernel.make_layouts(users, items, vals, 'cpu',
                                     batch=SMALL['BATCH'])
    assert layouts[0].W == 128 and layouts[1].W == 128
    ep_t, (Pt, Qt) = ab_kernel.build(
        variant, layouts, bu_fit, bi_fit, SMALL['U'], SMALL['I'],
        SMALL['K'], SMALL['INNER'], factors=(np.asarray(Pj), np.asarray(Qj)))
    mu = float(np.float32(vals.mean()))
    for _ in range(2):
        Pj, Qj, rj = ep_j(Pj, Qj, jnp.float32(mu), pl_j, ql_j)
        Pt, Qt, rt = ep_t(Pt, Qt, mu, *layouts)
        for got, want in ((Pt, Pj), (Qt, Qj)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=RTOL)
        assert float(rt) == pytest.approx(float(rj), rel=RMSE_RTOL)


def test_ab_main_on_cpu(capsys):
    res = ab_kernel.main(['--users', '60', '--items', '40', '--ratings',
                          '3000', '--rank', '6', '--batch', '256',
                          '--inner-steps', '2', '--reps', '2', '--epochs',
                          '1', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'rep 1 old' in out and 'new kernel speedup' in out
    for v in ('old', 'new'):
        assert len(res[v]) == 2 and len(res['rmse_' + v]) == 2
        assert np.isfinite(res['rmse_' + v]).all()
        assert res['rmse_' + v][-1] < res['rmse_' + v][0]
    with pytest.raises(ValueError):
        ab_kernel.build('newest', ab_kernel.make_layouts(
            *bench_data.make_data(20, 10, 200), 'cpu', batch=64), None, None)


@pytest.mark.parametrize('mode', ['', 'all2d', 'hiT', 'grp'])
def test_kernel_probe_main_on_cpu(mode, capsys):
    res = kernel_probe.main([mode, '--reps', '1', '--n-batch', '2',
                             '--iters', '1', '--batch', '256', '--chunk',
                             '128', '--device', 'cpu'])
    out = capsys.readouterr().out
    if mode in ('', 'all2d'):
        cases = kernel_probe.cases_of(mode, 256, 128)
        assert set(res) == set(cases) and 'median' in out
        assert all(np.isfinite(v['t2']) for v in res.values())
    elif mode == 'hiT':
        assert set(res) == {'marg_8_32', 'marg_32_64', 't8'}
    else:
        assert set(res) == {'G8_bigF', 'G32_bigF', 'G8_smallF',
                            'G32_smallF'}


def test_kernel_probe_data_is_the_jax_tools():
    '''``probe_data`` draws the JAX tool's inputs (its numpy stream).'''
    data = kernel_probe.probe_data('cpu', batch=kernel_probe.B)
    rng = np.random.default_rng(0)
    for k in (64, 66, 128):
        want = (rng.normal(0, 0.3, (128, k)).astype(np.float32),
                rng.normal(0, 0.3, (kernel_probe.B, k)).astype(np.float32),
                rng.uniform(1, 5, kernel_probe.B).astype(np.float32),
                np.ones(kernel_probe.B, np.float32),
                np.sort(rng.integers(0, 128, kernel_probe.B)).astype(
                    np.int32))
        for a, b in zip(data[k], want):
            assert a.numpy().tobytes() == b.tobytes()
    assert kernel_probe.cases_of('')[0] == ('full', 66, 8192)
    # run_one keeps the JAX signature: its 1D variants take the module's CH
    small = kernel_probe.probe_data('cpu', ks=(8,), batch=16384)[8]
    for variant, ch in (('no_acc', kernel_probe.CH), ('all2d_no_acc', 4096)):
        got = kernel_probe.run_one(*small, variant, 1, 8, ch=4096)
        want = p2.probe_step_ref(*small, variant, 1, ch)
        assert torch.equal(got[0], want[0])
    with pytest.raises(ValueError):
        kernel_probe.cases_of('nope')
