'''K4 (sorted-window aggregation) on the CPU, held to the JAX package.

The plain version ``window_aggregate_ref`` against the Pallas kernel in
interpret mode (set up as tests/test_pallas_window_agg.py sets it up) and
against ``_agg_window`` in sum and mean mode; the layout-level
``scan_aggregate`` route and the per-batch route of the port's
``_scan_window_agg`` against the JAX scan.

Tolerances: counts exactly; sums atol 1e-5 + rtol 1e-5 -- both sides
round the same f32 inputs to the same bf16 values, and only the f32
order of the sum differs.'''
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mfrec_tpu.ops import sgd_mf as jax_sgd
from mfrec_tpu.ops.pallas_window_agg import window_aggregate as jax_window_agg
from mfrec_tpu_torch.ops import sgd_mf, window_agg_kernel
from mfrec_tpu_torch.ops.window_agg_kernel import (window_aggregate,
                                                   window_aggregate_ref)

# The suite runs in several xdist workers on one machine; torch's default
# of one intra-op thread per core then oversubscribes the cores, and its
# small CPU ops slow down a hundredfold.  Every worker imports this file.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(k, W, case, seed=0):
    rng = np.random.default_rng(seed)
    B = 1000 if case == 'ragged' else 1024
    g = rng.normal(0, 1, (B, k)).astype(np.float32)
    kl = rng.integers(0, W, B).astype(np.int32)
    mask = (rng.random(B) > 0.2).astype(np.float32)
    if case == 'none_masked':
        mask[:] = 1.0
    elif case == 'all_masked':
        mask[:] = 0.0
    elif case == 'duplicates':
        kl = rng.choice(np.array([0, 3, W - 1], np.int32), B)
    return g, kl, mask


@pytest.mark.parametrize('case', ['none_masked', 'all_masked', 'duplicates',
                                  'ragged'])
@pytest.mark.parametrize('W', [64, 512])
@pytest.mark.parametrize('k', [8, 64, 66, 130])
def test_plain_matches_pallas(k, W, case):
    g, kl, mask = _inputs(k, W, case, seed=k + W)
    B = g.shape[0]
    gm = g * mask[:, None]
    # a batch that is no multiple of the chunk runs as one chunk
    js, jc = jax_window_agg(jnp.asarray(gm), jnp.asarray(kl),
                            jnp.asarray(mask), W,
                            chunk=128 if B % 128 == 0 else B, interpret=True)
    ts, tc = window_aggregate(torch.from_numpy(g), torch.from_numpy(kl),
                              torch.from_numpy(mask), W)
    assert ts.shape == (W, k) and tc.shape == (W,)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    if case == 'all_masked':
        assert not ts.abs().max() and not tc.max()


@pytest.mark.parametrize('row_mean', [False, True])
@pytest.mark.parametrize('case', ['none_masked', 'duplicates', 'ragged'])
@pytest.mark.parametrize('k', [8, 66])
def test_agg_window_matches_jax(k, case, row_mean):
    W = 64
    g, kl, mask = _inputs(k, W, case, seed=3 * k)
    want = jax_sgd._agg_window(jnp.asarray(g), jnp.asarray(kl),
                               jnp.asarray(mask), W, 128, row_mean)
    got = sgd_mf._agg_window(torch.from_numpy(g), torch.from_numpy(kl),
                             torch.from_numpy(mask), W, row_mean)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _layout(axis, W=16, U=60, I=40, N=1500, B=128, seed=2):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.uniform(1, 5, N).astype(np.float32)
    return jax_sgd.sorted_pass_layout(u, i, v, B, axis=axis, max_window=W)


@pytest.mark.parametrize('mean', [False, True])
@pytest.mark.parametrize('axis', ['user', 'item'])
def test_scan_routes_match_jax(axis, mean):
    '''The phase aggregation ``target += gsum`` batch after batch: the
    layout-level route (segment table, ``scan_aggregate``'s plain
    version) and the per-batch route (one ``window_aggregate`` per
    batch) against the JAX scan, from a non-zero target.'''
    lay = _layout(axis)
    W = lay[-1]
    rng = np.random.default_rng(7)
    k, rows = 10, 60 + 40 + W
    Y = rng.normal(0, 1, (rows, k)).astype(np.float32)
    T0 = rng.normal(0, 1, (rows, k)).astype(np.float32)

    def jsrc(u, i, r, m):
        return jnp.asarray(Y)[i] * r[:, None] + jnp.asarray(Y)[u]

    want = jax_sgd._scan_window_agg(jnp.asarray(T0),
                                    tuple(jnp.asarray(a) for a in lay[:-1]),
                                    jsrc, W, 128, mean)
    Yt = torch.from_numpy(Y)

    def tsrc(u, i, r, m):
        return Yt[i] * r[:, None] + Yt[u]

    for segments in (False, True):
        pl = sgd_mf.PassLayout(lay, axis, 'cpu', segments=segments)
        got = sgd_mf._scan_window_agg(torch.from_numpy(T0.copy()), pl, tsrc,
                                      W, mean)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scan_aggregate_ref_order():
    '''A row's per-batch sums are added in batch order, each segment
    summed (or averaged) on its own: checked against a float64 loop.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    lay = _layout('item', W=8, N=800, B=64)
    fix, r, m, kl, lo = lay[0], lay[2], lay[3], lay[4], lay[5]
    seg = hk.build_segments(fix, r, m, kl, lo, lay[-1], 'cpu')
    n = int(seg.ent_r.shape[0])
    rng = np.random.default_rng(1)
    vals = rng.normal(0, 1, (n, 5)).astype(np.float32)
    for mean in (False, True):
        got = window_agg_kernel.scan_aggregate(
            torch.zeros((48, 5)), torch.from_numpy(vals), seg, mean)
        want = np.zeros((48, 5))
        ptr = seg.seg_ptr.numpy()
        ent_row = seg.ent_row.numpy()
        v16 = torch.from_numpy(vals).to(torch.bfloat16).double().numpy()
        for s in range(ptr.shape[0] - 1):
            part = v16[ptr[s]:ptr[s + 1]].sum(0)
            want[ent_row[ptr[s]]] += part / (ptr[s + 1] - ptr[s]) \
                if mean else part
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrapper_checks():
    g = torch.zeros((4, 3))
    kl = torch.tensor([0, 1, 2, 9], dtype=torch.int32)
    m = torch.tensor([1.0, 1.0, 1.0, 0.0])
    gsum, cnt = window_aggregate(g, kl, m, 4)     # id 9 is masked out
    assert cnt.tolist() == [1.0, 1.0, 1.0, 0.0]
    with pytest.raises(ValueError):
        window_aggregate(g, kl, torch.ones(4), 4)            # 9 >= W
    with pytest.raises(ValueError):
        window_aggregate(g, kl.long(), m, 4)                 # int64 ids
    with pytest.raises(ValueError):
        window_aggregate(g.double(), kl, m, 4)
    with pytest.raises(ValueError):
        window_aggregate(torch.zeros((4, 257)), kl, m, 4)    # k > 256
    with pytest.raises(ValueError):
        window_aggregate(torch.zeros((8, 3))[::2], kl, m, 4)  # strided
    with pytest.raises(ValueError):                          # no fallback
        window_aggregate(g.to('meta'), kl.to('meta'), m.to('meta'), 4,
                         check_ids=False)
    ref = window_aggregate_ref(g, kl, m, 4)
    assert torch.equal(ref[1], cnt)


def _step_case(seed=4, W=8, U=50, I=30, N=1200, B=64, k=5):
    '''An item layout whose hot items span several batches, with
    overlapping windows, seeded factors, G and the biases.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, N).astype(np.int32)
    i = np.minimum(rng.geometric(0.12, N) - 1, I - 1).astype(np.int32)
    v = rng.uniform(1, 5, N).astype(np.float32)
    lay = jax_sgd.sorted_pass_layout(u, i, v, B, axis='item', max_window=W)
    seg = hk.build_segments(lay[0], lay[2], lay[3], lay[4], lay[5], W, 'cpu')
    f = {name: torch.from_numpy(rng.normal(0, 0.3, shape).astype(np.float32))
         for name, shape in (('X', (I + W, k)), ('Y', (I + W, k)),
                             ('G', (U + W, k)), ('bu', (U + W,)),
                             ('bi', (I + W,)))}
    return lay, seg, f


def _per_batch_step(lay, f, K_x, K_y, step, row_mean, fn):
    '''The per-batch item step of make_alternating_implicit_epoch (Y) or
    make_fn_alternating_epoch (X and Y), window by window.'''
    ub, ib, rb, mb, kl, lo, W = (torch.from_numpy(np.asarray(a))
                                 if not isinstance(a, int) else a
                                 for a in lay)
    X, Y, G = f['X'].clone(), f['Y'].clone(), f['G']
    mu = torch.tensor(3.1)
    for b, start in enumerate(lo.tolist()):
        winX, winY = X[start:start + W], Y[start:start + W]
        kll = kl[b].long()
        Gu = G[ub[b].long()]
        gY = Gu - K_y * winY[kll]
        if fn:
            resid = rb[b] - (mu + f['bu'][ub[b].long()] + f['bi'][ib[b].long()])
            gX = resid[:, None] * Gu - K_x * winX[kll]
            agg = sgd_mf._agg_window(torch.cat([gX, gY], 1), kl[b], mb[b],
                                     W, row_mean)
            k = Gu.shape[1]
            winX.copy_(winX + step * agg[:, :k])
            winY.copy_(winY + step * agg[:, k:])
        else:
            winY.copy_(winY + step * sgd_mf._agg_window(gY, kl[b], mb[b], W,
                                                        row_mean))
    return X, Y


@pytest.mark.parametrize('row_mean', [True, False])
@pytest.mark.parametrize('kind', ['svdpp', 'fn'])
def test_step_aggregate_ref_is_the_per_batch_loop(kind, row_mean):
    '''The fused item step's plain version equals the per-batch
    ``_agg_window`` loop it replaces, bit for bit on the CPU: SVD++'s Y,
    and FN's X (weighted by the entries' residuals) and Y together.'''
    lay, seg, f = _step_case()
    assert seg.longest_segments >= 3          # a row spans several batches
    step, K_x, K_y = 0.07, 0.02, 0.03
    wantX, wantY = _per_batch_step(lay, f, K_x, K_y, step, row_mean,
                                   kind == 'fn')
    X, Y = f['X'].clone(), f['Y'].clone()
    if kind == 'fn':
        mu = torch.tensor(3.1)
        resid = seg.ent_r - (mu + f['bu'][seg.ent_fix.long()]
                             + f['bi'][seg.ent_row.long()])
        out = window_agg_kernel.step_aggregate(
            (X, Y), f['G'], seg, coef=(resid, None), decay=(K_x, K_y),
            step=step, row_mean=row_mean)
        assert out[0] is X and out[1] is Y
        assert torch.equal(X, wantX)
    else:
        window_agg_kernel.step_aggregate((Y,), f['G'], seg, decay=(K_y,),
                                         step=step, row_mean=row_mean)
        assert torch.equal(X, f['X'])
    assert torch.equal(Y, wantY)
    assert float((Y - f['Y']).abs().max()) > 0


def test_step_aggregate_nothing_masked_in():
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    lay, _, f = _step_case()
    seg = hk.build_segments(lay[0], lay[2], np.zeros_like(lay[3]), lay[4],
                            lay[5], lay[-1], 'cpu')
    Y = f['Y'].clone()
    window_agg_kernel.step_aggregate((Y,), f['G'], seg, decay=(0.1,),
                                     step=0.5)
    assert torch.equal(Y, f['Y'])


def test_step_aggregate_checks():
    lay, seg, f = _step_case()
    Y, G = f['Y'], f['G']
    step = window_agg_kernel.step_aggregate
    with pytest.raises(ValueError):                     # three targets
        step((Y, Y, Y), G, seg, coef=(None,) * 3, decay=(0.0,) * 3)
    with pytest.raises(ValueError):                     # k * 2 > 256
        step((torch.zeros((40, 130)),) * 2, torch.zeros((60, 130)), seg)
    with pytest.raises(ValueError):                     # G too short
        step((Y,), G[:3], seg)
    with pytest.raises(ValueError):                     # f64 target
        step((Y.double(),), G, seg)
    with pytest.raises(ValueError):                     # coef of the wrong size
        step((Y,), G, seg, coef=(torch.ones(3),))
    with pytest.raises(ValueError):                     # no fallback
        step((Y.to('meta'),), G.to('meta'), seg._replace(**{
            f_: getattr(seg, f_).to('meta') for f_ in (
                'blk_row', 'blk_seg0', 'blk_seg1', 'seg_ptr', 'ent_fix',
                'ent_m', 'ent_row')}))
