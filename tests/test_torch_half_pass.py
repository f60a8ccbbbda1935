'''K1 (the fused sorted-window batch step) on the CPU: the port's plain
version against the Pallas kernel in interpret mode, the host layout
against the JAX package's, and the CUDA kernel's row-by-row schedule
(played here in plain torch from the segment table) against the
batch-by-batch one.

Numerics held to, by test:
- ``half_pass_batch_ref`` vs ``half_pass_batch(..., interpret=True)``
  (tloop, grid and resident bodies): the Pallas numerics (bf16 window
  read, bf16 ``eff*ff``, f32 or bf16-product dot by the k <= 128 gate).
  The two round at the same places and differ only in f32 summation
  order: window within 2e-5, SSE within 1e-5 relative.
- the same against the float64 numpy twin of
  ``tests/test_pallas_half_pass.py`` (no bf16 at all): that file's bf16
  tolerances, atol 2e-2 / rtol 5e-2 for T=3, SSE 5e-3 relative.
- layouts and augmented factors: byte-identical.
- segment schedule vs ``half_pass_ref``: the same per-row arithmetic in
  the same order, within 1e-6.'''
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mfrec_tpu.ops import sgd_mf as jax_sgd
from mfrec_tpu.ops.pallas_half_pass import half_pass_batch, half_pass_group
from mfrec_tpu_torch.ops import half_pass_kernel as hk
from mfrec_tpu_torch.ops import sgd_mf

VARIANTS = {
    'tloop': dict(tloop=True, all2d=True),
    'grid': dict(tloop=False, all2d=True, cache_onehot=True, chunk=64),
    'resident': dict(resident=True, all2d=True, chunk=64),
}
# name -> (k, options); every case freezes the last column (lrv = 0)
CASES = {
    'identity': (10, {}),
    'logistic': (10, dict(link='logistic', clamp_pred=False, mu=0.0)),
    'bias_none': (10, dict(bias_none=True)),
    'no_row_mean': (10, dict(row_mean=False, lr=0.02)),
    'no_clamp': (10, dict(clamp_pred=False)),
    'ff_bf16': (10, dict(ff_bf16=True)),
    'k130': (130, {}),
}


def _batch(k, seed, B=256, W=32, ff_bf16=False, lr=0.1):
    rng = np.random.default_rng(seed)
    win = rng.normal(0, 0.3, (W, k)).astype(np.float32)
    ff = rng.normal(0, 0.3, (B, k)).astype(np.float32)
    if ff_bf16:
        ff = torch.from_numpy(ff).to(torch.bfloat16).float().numpy()
    r = rng.uniform(1, 5, B).astype(np.float32)
    m = (rng.random(B) > 0.1).astype(np.float32)
    kl = np.sort(rng.integers(0, W, B)).astype(np.int32)
    lrv = np.full(k, lr, np.float32)
    lrv[-1] = 0.0
    regv = np.full(k, 0.02, np.float32)
    regv[-1] = 0.0
    return win, ff, r, m, kl, lrv, regv


def _ref(win, ff, r, m, kl, lrv, regv, mu, W, T, ff_bf16=False, **opt):
    t = torch.from_numpy
    ff_t = t(ff).to(torch.bfloat16) if ff_bf16 else t(ff)
    out, sse = hk.half_pass_batch_ref(t(win), ff_t, t(r), t(m), t(kl),
                                      t(lrv), t(regv), mu, W, T, **opt)
    return out.numpy(), float(sse)


@pytest.mark.parametrize('variant', sorted(VARIANTS))
@pytest.mark.parametrize('case', sorted(CASES))
def test_batch_ref_matches_pallas_interpret(case, variant):
    k, opt = CASES[case]
    opt = dict(opt)
    mu = opt.pop('mu', 3.4)
    ff_bf16 = opt.pop('ff_bf16', False)
    lr = opt.pop('lr', 0.1)
    W, T, B = 32, 3, 256
    win, ff, r, m, kl, lrv, regv = _batch(k, seed=k + len(case), B=B, W=W,
                                          ff_bf16=ff_bf16, lr=lr)
    jv = dict(VARIANTS[variant])
    jv.setdefault('chunk', B)
    ffj = jnp.asarray(ff).astype(jnp.bfloat16) if ff_bf16 else \
        jnp.asarray(ff)
    want, sse_w = half_pass_batch(
        jnp.asarray(win), ffj, jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(kl), jnp.asarray(lrv), jnp.asarray(regv), mu, W,
        interpret=True, inner_steps=T, dot_sum=k <= 128, **opt, **jv)
    got, sse = _ref(win, ff, r, m, kl, lrv, regv, mu, W, T, ff_bf16, **opt)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)
    assert abs(sse - float(sse_w)) <= 1e-5 * max(float(sse_w), 1.0)
    np.testing.assert_array_equal(got[:, -1], win[:, -1])   # frozen


@pytest.mark.parametrize('link', ['identity', 'logistic'])
def test_batch_ref_matches_numpy_twin(link):
    '''The float64 numpy twin of tests/test_pallas_half_pass.py, with its
    bf16 tolerances (the port rounds where the Pallas kernel does).'''
    W, T, k, B = 32, 3, 10, 256
    win0, ff, r, m, kl, lrv, regv = _batch(k, seed=7, B=B, W=W)
    mu, lo, hi = (0.0, 1.0, 5.0) if link == 'logistic' else (3.4, 1.0, 5.0)
    win = win0.astype(np.float64)
    for t in range(T):
        fu = win[kl]
        s = (fu * ff).sum(-1)
        if link == 'logistic':
            sig = 1.0 / (1.0 + np.exp(-s))
            err = (r - (lo + sig * (hi - lo))) * m
            eff = err * sig * (1.0 - sig) * (hi - lo)
        else:
            err = (r - np.clip(mu + s, lo, hi)) * m
            eff = err
        if t == 0:
            sse_first = (err ** 2).sum()
        g = eff[:, None] * ff - regv[None, :] * fu * m[:, None]
        gsum = np.zeros((W, k))
        cnt = np.zeros(W)
        for b in range(B):
            gsum[kl[b]] += g[b] * m[b]
            cnt[kl[b]] += m[b]
        win = win + lrv[None, :] * gsum / np.maximum(cnt, 1.0)[:, None]
    got, sse = _ref(win0, ff, r, m, kl, lrv, regv, mu, W, T,
                    clamp_pred=link != 'logistic', link=link)
    np.testing.assert_allclose(got, win, atol=2e-2, rtol=5e-2)
    assert abs(sse - sse_first) / sse_first < 5e-3


def _stream(U=60, I=40, N=2000, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, U, N).astype(np.int32),
            rng.integers(0, I, N).astype(np.int32),
            rng.uniform(1, 5, N).astype(np.float32))


@pytest.mark.parametrize('axis', ['user', 'item'])
@pytest.mark.parametrize('batch,window', [(256, 32), (100, 7), (4096, 512)])
def test_sorted_pass_layout_byte_identical(axis, batch, window):
    u, i, v = _stream()
    want = jax_sgd.sorted_pass_layout(u, i, v, batch, axis=axis,
                                      max_window=window)
    got = sgd_mf.sorted_pass_layout(u, i, v, batch, axis=axis,
                                    max_window=window)
    assert got[-1] == want[-1]
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_augment_and_split_byte_identical():
    rng = np.random.default_rng(3)
    P = rng.normal(size=(7, 4)).astype(np.float32)
    Q = rng.normal(size=(5, 4)).astype(np.float32)
    bu = rng.normal(size=7).astype(np.float32)
    bi = rng.normal(size=5).astype(np.float32)
    want = jax_sgd.augment_factors(P, Q, bu, bi)
    for got in (sgd_mf.augment_factors(P, Q, bu, bi),
                [t.numpy() for t in sgd_mf.augment_factors(
                    *map(torch.from_numpy, (P, Q, bu, bi)))]):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    back = sgd_mf.split_factors(*want)
    for a, b in zip(back, jax_sgd.split_factors(*want)):
        np.testing.assert_array_equal(a, b)
    assert float(sgd_mf.clamp(torch.tensor(7.0))) == 5.0
    assert sgd_mf.clamp(np.float32(0.2), 1.0, 4.0) == 1.0


def segment_schedule(F_upd, F_fix, seg, lrv, regv, mu, T, **opt):
    '''The CUDA kernel's schedule in plain torch: per block, its row
    through its segments in order, T sweeps each.  One segment is a
    one-row batch step (W=1, kl=0) of ``half_pass_batch_ref``.'''
    sse = torch.zeros(())
    for x in range(seg.blk_row.shape[0]):
        row = int(seg.blk_row[x])
        w = F_upd[row:row + 1].clone()
        for s in range(int(seg.blk_seg0[x]), int(seg.blk_seg1[x])):
            e0, e1 = int(seg.seg_ptr[s]), int(seg.seg_ptr[s + 1])
            ff = F_fix[seg.ent_fix[e0:e1].long()]
            assert float(seg.seg_cnt[s]) == float(
                seg.ent_m[e0:e1].to(torch.bfloat16).float().sum())
            w, sse_s = hk.half_pass_batch_ref(
                w, ff, seg.ent_r[e0:e1], seg.ent_m[e0:e1],
                torch.zeros(e1 - e0, dtype=torch.long), lrv, regv, mu, 1,
                T, **opt)
            sse = sse + sse_s
        F_upd[row] = w[0]
    return sse


@pytest.mark.parametrize('axis', ['user', 'item'])
@pytest.mark.parametrize('opt', [{}, dict(link='logistic', clamp_pred=False),
                                 dict(row_mean=False)])
def test_segment_schedule_equals_batch_schedule(axis, opt):
    '''Rows do not interact: per row, its segments in batch order, T
    sweeps each, equals the batch-by-batch half-pass -- with boundary
    rows split across batches, padding slots (m=0, kl=0) left out and
    untouched rows of each window unchanged.'''
    U, I = 60, 40
    u, i, v = _stream(U, I, N=3000, seed=11)
    lay = sgd_mf.sorted_pass_layout(u, i, v, 64, axis=axis, max_window=16)
    pl_ = sgd_mf.PassLayout(lay, axis, 'cpu', segments=True)
    seg = pl_.segments
    assert int((seg.blk_seg1 - seg.blk_seg0).max()) > 1   # spans batches
    n_upd, n_fix = (U, I) if axis == 'user' else (I, U)
    rng = np.random.default_rng(2)
    k = 8
    F_upd = torch.from_numpy(
        rng.normal(0, 0.3, (n_upd + pl_.W, k)).astype(np.float32))
    F_fix = torch.from_numpy(
        rng.normal(0, 0.3, (n_fix, k)).astype(np.float32))
    lrv = torch.full((k,), 0.1 if opt.get('row_mean', True) else 0.01)
    regv = torch.full((k,), 0.02)
    a, b = F_upd.clone(), F_upd.clone()
    sse_a = hk.half_pass_ref(a, F_fix, pl_.batches(), pl_.W, lrv, regv,
                             3.4, 3, **opt)
    sse_b = segment_schedule(b, F_fix, seg, lrv, regv, 3.4, 3, **opt)
    torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
    assert abs(float(sse_a) - float(sse_b)) <= 1e-6 * float(sse_a)
    assert int(seg.ent_r.shape[0]) == len(v)   # every rating, no padding
    assert sorted(set(seg.blk_row.tolist())) == sorted(set(
        (u if axis == 'user' else i).tolist()))
    lens = (seg.seg_ptr[seg.blk_seg1.long()]
            - seg.seg_ptr[seg.blk_seg0.long()])
    assert (lens[:-1] >= lens[1:]).all() and int(lens[0]) == seg.longest


def test_half_pass_group_matches_port_half_pass():
    '''K1d: ``half_pass_group`` (G batches per call, overlapping windows,
    masked filler rows) in interpret mode against the port's half-pass
    over the same batches, batch by batch and row by row.'''
    rng = np.random.default_rng(3)
    G, B, k, W, T, n_rows = 4, 128, 10, 32, 3, 80
    F = rng.normal(0, 0.3, (n_rows + W, k)).astype(np.float32)
    F_fix = rng.normal(0, 0.3, (G * B, k)).astype(np.float32)
    fix = np.arange(G * B, dtype=np.int32).reshape(G, B)
    r = rng.uniform(1, 5, (G, B)).astype(np.float32)
    m = (rng.random((G, B)) > 0.1).astype(np.float32)
    m[-1, B // 2:] = 0.0
    kl = np.sort(rng.integers(0, W, (G, B)), axis=1).astype(np.int32)
    lo = np.array([0, 20, 45, 46], np.int32)    # 0/20 and 45/46 overlap
    lrv = np.full(k, 0.1, np.float32)
    lrv[-1] = 0.0
    regv = np.full(k, 0.02, np.float32)
    regv[-1] = 0.0
    want, sse_w = half_pass_group(
        jnp.asarray(F), jnp.asarray(F_fix[fix]), jnp.asarray(r),
        jnp.asarray(m), jnp.asarray(kl), jnp.asarray(lo), jnp.asarray(lrv),
        jnp.asarray(regv), 3.4, W, chunk=64, interpret=True, inner_steps=T,
        dot_sum=True)
    t = torch.from_numpy
    got = t(F.copy())
    launches = hk.half_pass.launches
    sse = hk.half_pass(got, t(F_fix), tuple(map(t, (fix, r, m, kl, lo))), W,
                       t(lrv), t(regv), 3.4, T)
    assert hk.half_pass.launches == launches      # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert abs(float(sse) - float(sse_w)) <= 1e-5 * float(sse_w)
    seg = hk.build_segments(fix, r, m, kl, lo, W, 'cpu')
    rows = t(F.copy())
    segment_schedule(rows, t(F_fix), seg, t(lrv), t(regv), 3.4, T)
    np.testing.assert_allclose(rows.numpy(), np.asarray(want), atol=2e-5)


def test_wrapper_refusals():
    t = torch.from_numpy
    W, k = 8, 4
    F = torch.zeros(20, k)
    batches = tuple(map(t, (np.zeros((1, 4), np.int32),
                            np.ones((1, 4), np.float32),
                            np.ones((1, 4), np.float32),
                            np.zeros((1, 4), np.int32),
                            np.zeros(1, np.int32))))
    lrv = regv = torch.zeros(k)
    with pytest.raises(ValueError):                 # f64 factors
        hk.half_pass(F.double(), F, batches, W, lrv, regv, 3.0)
    with pytest.raises(ValueError):                 # unknown link
        hk.half_pass(F, F, batches, W, lrv, regv, 3.0, link='tanh')
    with pytest.raises(ValueError):                 # lrv of the wrong k
        hk.half_pass(F, F, batches, W, torch.zeros(k + 1), regv, 3.0)
    with pytest.raises(ValueError):                 # window past the end
        hk.half_pass(F[:5], F, batches, W, lrv, regv, 3.0)
    with pytest.raises(ValueError):                 # kl outside the window
        hk.build_segments(np.zeros((1, 2), np.int32), np.ones((1, 2)),
                          np.ones((1, 2)), np.array([[0, W]]), [0], W, 'cpu')
    # padding slots may carry any kl: they are left out
    seg = hk.build_segments(np.zeros((1, 2), np.int32), np.ones((1, 2)),
                            np.array([[1.0, 0.0]]), np.array([[3, 99]]), [5],
                            W, 'cpu')
    assert seg.blk_row.tolist() == [8] and seg.ent_r.shape[0] == 1


@pytest.mark.parametrize('small', [False, True])
@pytest.mark.parametrize('axis', ['user', 'item'])
def test_block_lengths_and_cluster_rows_match_numpy(axis, small,
                                                    monkeypatch):
    '''The segment table's block order and host-side block lengths
    (``blk_len``, ``n_cluster``: they choose K1's cluster rows and the
    item step's block rows) against a numpy oracle: each updated row's
    masked-in ratings counted from the layout; K1's cluster rows (at
    least CLUSTER_ROW ratings and CLUSTER_SEG per segment) first, then the
    rest, each longest first with ties in row order.  ``small`` lowers
    the thresholds so that this small layout has cluster rows.'''
    if small:
        monkeypatch.setattr(hk, 'CLUSTER_ROW', 70)
        monkeypatch.setattr(hk, 'CLUSTER_SEG', 30)
    U, I = 60, 40
    u, i, v = _stream(U, I, N=3000, seed=5)
    lay = sgd_mf.sorted_pass_layout(u, i, v, 64, axis=axis, max_window=16)
    fix = lay[1] if axis == 'user' else lay[0]
    m = lay[3].copy()
    m[0, :7] = 0.0                           # some masked-out ratings
    seg = hk.build_segments(fix, lay[2], m, lay[4], lay[5], lay[-1], 'cpu')
    key = lay[5][:, None] + lay[4]
    counts = np.bincount(key[m != 0])
    nseg = np.array([sum(bool(((key[b] == x) & (m[b] != 0)).any())
                         for b in range(key.shape[0]))
                     for x in range(counts.size)])
    present = np.flatnonzero(counts)
    order = present[np.argsort(-counts[present], kind='stable')]
    clu = (counts >= hk.CLUSTER_ROW) & (counts >= hk.CLUSTER_SEG * nseg)
    want = [x for x in order if clu[x]] + [x for x in order if not clu[x]]
    assert seg.blk_row.tolist() == want
    np.testing.assert_array_equal(seg.blk_len, counts[want])
    assert seg.blk_len.dtype == np.int64 and seg.longest == counts.max()
    assert seg.n_cluster == int(clu.sum())
    assert (seg.n_cluster > 0) == (small and axis == 'item')
    assert seg.n_wide == int((counts >= hk.WIDE_ROW).sum())
    for thr in (1, 40, 80, 10 ** 9):
        assert int((seg.blk_len >= thr).sum()) == int((counts >= thr).sum())


@pytest.mark.parametrize('cap,cluster', [
    (40, None), (40, (25, 8)), (7, (3, 8)), (500, None), (500, (25, 4))])
def test_stage_split_counts(cap, cluster, monkeypatch):
    '''The host-side counts behind ``k1.resident_entries`` and
    ``k1.streamed_entries`` on a hand-built table: they sum to the
    masked-in entries and split each segment at the capacity given
    (``stage_caps`` reads it from the kernel): an 8-warp block's ``cap``,
    and with ``cluster`` = (cap_c, slices) a cluster row's segment in
    ``slices`` slices of ceil(n / slices), each staging cap_c (without, a
    cluster row counts as 8-warp blocks, as at k > WIDE_MAX_K); a brute
    force count of every (row, batch) segment as the oracle; a second call
    answers from the table's memo.'''
    monkeypatch.setattr(hk, 'CLUSTER_ROW', 300)
    monkeypatch.setattr(hk, 'CLUSTER_SEG', 100)
    # row 0: 150, 330 and 2 entries over three batches (a cluster row at
    # the lowered thresholds); row 1: 40, 41 and 39; rows 2-5 short
    lens = [[150, 40, 5, 7, 0, 12], [330, 41, 0, 9, 3, 1],
            [2, 39, 6, 0, 8, 40]]
    B = 400
    nb = len(lens)
    kl = np.zeros((nb, B), np.int32)
    m = np.zeros((nb, B), np.float32)
    for b, row_lens in enumerate(lens):
        ids = np.repeat(np.arange(6), row_lens)
        kl[b, :ids.size] = ids
        m[b, :ids.size] = 1.0
    m[1, 5] = 0.0                                   # one masked-out entry
    fix = np.arange(nb * B, dtype=np.int32).reshape(nb, B) % 50
    seg = hk.build_segments(fix, np.ones((nb, B)), m, kl,
                            np.zeros(nb, np.int32), 8, 'cpu')
    assert seg.n_cluster == 1
    resident = streamed = 0
    for b in range(nb):
        for row in range(6):
            n = int(((kl[b] == row) & (m[b] != 0)).sum())
            if cluster is None or row != 0:
                parts, c = [n], cap
            else:
                c, slices = cluster
                piece = -(-n // slices)
                parts = [min(max(n - q * piece, 0), piece)
                         for q in range(slices)]
            for x in parts:
                resident += min(x, c)
                streamed += x - min(x, c)
    got = hk.stage_split(seg, cap, cluster)
    assert got == (resident, streamed)
    assert sum(got) == int((m != 0).sum()) == int(seg.ent_r.numel())
    # the longest segment has 330 entries
    assert resident > 0
    assert (streamed == 0) == (cluster is None and cap >= 330)
    seg.memo[('stage_split', cap, cluster)] = (-1, -1)
    assert hk.stage_split(seg, cap, cluster) == (-1, -1)
