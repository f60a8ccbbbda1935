'''S1's converge entry and schedule on the CPU.

- The plain converge entry (``serial_kernel.serial_converge`` on CPU
  tensors) against the JAX model's per-feature loop
  (``mfrec_tpu/models/gd.py:910-927`` around ``sgd_mf.
  serial_feature_epoch``): the same epoch count, each epoch's rmse and
  the feature's columns and biases after it within 1e-6 absolute (XLA on
  the CPU contracts a multiply and an add into one FMA, the port rounds
  each; ``tests/test_torch_engines.py``'s serial tolerance).
- The rule ``converge_continues`` against a copy of that loop and the
  model's ``_converge_feature`` on hand-built rmse sequences: equal.
- ``build_schedule``: every (chunk, round) group shares no row, every
  rating comes after the earlier ratings it depends on, the marks
  (where each row is read, which rating stores it) as a brute-force
  scan finds them.
- The kernel's walk over the schedule, written out in torch (lanes,
  their registers and shuffles, the row table loaded one chunk ahead,
  several epochs in one launch): bit for bit the epochs of
  ``serial_feature_epoch_ref``, on streams with heavy repeats and on
  fold-in streams.  A schedule that reads a row from the table before
  its last writer stored it fails here.
'''
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mfrec_tpu.ops import sgd_mf as jax_sgd
from mfrec_tpu_torch.models.gd import GDRecommender
from mfrec_tpu_torch.ops import serial_kernel as sk

torch.set_num_threads(1)

SERIAL_ATOL = 1e-6
RATES = (0.005, 0.006, 0.012, 0.004)        # lr_bu, lr_bi, K_bu, K_bi
MASKS = [(True, True), (True, False), (False, True)]


def t(a):
    return torch.from_numpy(np.array(a))


def _case(U, I, n, k, seed, fold=None):
    '''A seeded stream, its columns, biases and half-filled cache;
    ``fold='user'`` (``'item'``): every rating on user (item) 0 and
    distinct items (users), as a fold-in streams them.  (U, I >= 2 where
    the columns are updated: a column of a one-row P is P's own memory.)'''
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    if fold == 'user':
        u[:], i = 0, rng.permutation(I)[:n].astype(np.int32)
    elif fold == 'item':
        i[:], u = 0, rng.permutation(U)[:n].astype(np.int32)
    return dict(u=u, i=i, r=rng.integers(1, 6, n).astype(np.float32),
                cache=np.where(rng.random(n) < 0.5, rng.uniform(1, 5, n),
                               0).astype(np.float32),
                P=rng.normal(0.1, 0.05, (U, k)).astype(np.float32),
                Q=rng.normal(0.1, 0.05, (I, k)).astype(np.float32),
                bu=rng.normal(0, 0.1, U).astype(np.float32),
                bi=rng.normal(0, 0.1, I).astype(np.float32))


def _jax_feature(d, f, mode, masks, min_e, max_e, min_imp, lr=0.01):
    '''The JAX model's per-feature loop, copied (``mfrec_tpu/models/
    gd.py:910-927``): each epoch's (pf, qf, bu, bi, rmse).'''
    P, Q = jnp.asarray(d['P']), jnp.asarray(d['Q'])
    pf, qf = P[:, f], Q[:, f]
    bu, bi = jnp.asarray(d['bu']), jnp.asarray(d['bi'])
    out = []
    rmse, epoch = 2.0, 0
    rmse_last = rmse
    while epoch < min_e or rmse <= rmse_last - min_imp:
        if epoch >= max_e:
            break
        rmse_last = rmse
        pf, qf, bu, bi, rmse_dev = jax_sgd.serial_feature_epoch(
            pf, qf, jnp.asarray(d['cache']), jnp.asarray(d['u']),
            jnp.asarray(d['i']), jnp.asarray(d['r']), f, P.shape[1], 0.1, lr,
            0.02, jnp.float32(3.5), bu, bi, *RATES, bias_mode=mode,
            update_users=masks[0], update_items=masks[1], P=P, Q=Q)
        rmse = float(rmse_dev)
        out.append(tuple(np.asarray(x) for x in (pf, qf, bu, bi)) + (rmse,))
        epoch += 1
    return out


def _port_feature(fn, d, f, mode, masks, min_e, max_e, min_imp, lr=0.01,
                  **kw):
    P, Q = t(d['P']), t(d['Q'])
    return fn(P[:, f].contiguous(), Q[:, f].contiguous(), t(d['cache']),
              t(d['u']), t(d['i']), t(d['r']), f, P.shape[1], 0.1, lr, 0.02,
              3.5, t(d['bu']), t(d['bi']), *RATES, bias_mode=mode,
              update_users=masks[0], update_items=masks[1], P=P, Q=Q,
              min_epochs=min_e, max_epochs=max_e, min_improvement=min_imp,
              **kw)


# ------------------------------------------------- the converge entry
@pytest.mark.parametrize('masks', MASKS)
@pytest.mark.parametrize('mode', ['none', 'fixed', 'learned'])
def test_converge_matches_jax(mode, masks):
    '''The plain converge entry against the JAX per-feature loop: the
    rule stops it before max_epochs (min_improvement 1e-2), the epoch
    counts are equal, each epoch's rmse and state within 1e-6.'''
    d = _case(12, 9, 120, 3, seed=5)
    f, min_e, max_e, min_imp = 1, 2, 12, 1e-2
    want = _jax_feature(d, f, mode, masks, min_e, max_e, min_imp, lr=0.1)
    got = _port_feature(sk.serial_converge, d, f, mode, masks, min_e, max_e,
                        min_imp, lr=0.1)
    assert len(got[4]) == len(want) < max_e
    np.testing.assert_allclose(got[4], [w[4] for w in want], rtol=0,
                               atol=SERIAL_ATOL)
    for e in range(1, len(want) + 1):        # the state after epoch e
        part = _port_feature(sk.serial_converge_ref, d, f, mode, masks, e,
                             e, min_imp, lr=0.1)
        assert len(part[4]) == e
        for a, w in zip(part[:4], want[e - 1][:4]):
            np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                       atol=SERIAL_ATOL)


def test_converge_cpu_is_the_epoch_loop():
    '''On CPU tensors the converge entry is ``serial_feature_epoch_ref``
    looped under the rule: bit for bit, no plan, no launch.'''
    d = _case(12, 9, 100, 3, seed=2)
    before = sk.serial_converge.launches
    got = _port_feature(sk.serial_converge, d, 0, 'fixed', (True, True), 3,
                        3, 0.0)
    P, Q = t(d['P']), t(d['Q'])
    pf, qf, bu, bi = (P[:, 0].contiguous(), Q[:, 0].contiguous(),
                      t(d['bu']), t(d['bi']))
    for _ in range(3):
        rmse = sk.serial_feature_epoch_ref(
            pf, qf, t(d['cache']), t(d['u']), t(d['i']), t(d['r']), 0, 3,
            0.1, 0.01, 0.02, 3.5, bu, bi, *RATES, bias_mode='fixed')[4]
    for a, b in zip(got[:4], (pf, qf, bu, bi)):
        assert torch.equal(a, b)
    assert got[4][-1] == float(rmse)
    assert sk.serial_converge.launches == before


@pytest.mark.parametrize('mode', ['none', 'fixed', 'learned'])
def test_converge_on_columns_updates_cache(mode):
    '''``_run_funk``'s call: the converge entry on P's and Q's column
    with ``update_cache``, against copies run by
    ``serial_feature_epoch_ref``, written back, and ``sgd_mf.
    update_cache`` (not learned): bit for bit, the other columns
    untouched.'''
    from mfrec_tpu_torch.ops import sgd_mf
    d = _case(12, 9, 100, 3, seed=4)
    f = 1
    P, Q, cache = t(d['P']), t(d['Q']), t(d['cache'])
    bu, bi = t(d['bu']), t(d['bi'])
    hist = sk.serial_converge(
        P[:, f], Q[:, f], cache, t(d['u']), t(d['i']), t(d['r']), f, 3, 0.1,
        0.05, 0.02, 3.5, bu, bi, *RATES, bias_mode=mode, P=P, Q=Q,
        min_epochs=2, max_epochs=6, min_improvement=1e-3,
        update_cache=True)[4]
    P0, Q0, c0 = t(d['P']), t(d['Q']), t(d['cache'])
    pf, qf = P0[:, f].clone(), Q0[:, f].clone()
    b0, i0 = t(d['bu']), t(d['bi'])
    want = []
    while sk.converge_continues(len(want), *(want[-1:] or [2.0]),
                                *(want[-2:-1] or [2.0]), 2, 6, 1e-3):
        want.append(float(sk.serial_feature_epoch_ref(
            pf, qf, c0, t(d['u']), t(d['i']), t(d['r']), f, 3, 0.1, 0.05,
            0.02, 3.5, b0, i0, *RATES, bias_mode=mode, P=P0, Q=Q0)[4]))
    if mode != 'learned':
        c0 = sgd_mf.update_cache(pf, qf, c0, t(d['u']), t(d['i']), 3.5, b0,
                                 i0, bias_mode=mode)
    P0[:, f], Q0[:, f] = pf, qf
    assert hist == want
    for a, b in ((P, P0), (Q, Q0), (cache, c0), (bu, b0), (bi, i0)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- the rule
def _jax_loop(seq, min_e, max_e, min_imp):
    '''The JAX model's loop (``mfrec_tpu/models/gd.py:910-927``) over a
    given rmse sequence: the rmse it reads.'''
    it = iter(seq)
    seen = []
    rmse, epoch = 2.0, 0
    rmse_last = rmse
    while epoch < min_e or rmse <= rmse_last - min_imp:
        if epoch >= max_e:
            break
        rmse_last = rmse
        rmse = next(it)
        seen.append(rmse)
        epoch += 1
    return seen


def _rule_loop(seq, min_e, max_e, min_imp):
    it = iter(seq)
    seen, rmse, rmse_last = [], 2.0, 2.0
    while sk.converge_continues(len(seen), rmse, rmse_last, min_e, max_e,
                                min_imp):
        rmse_last, rmse = rmse, next(it)
        seen.append(rmse)
    return seen


RULE_CASES = [
    # stops when the improvement falls under min_improvement
    ([1.5, 1.2, 1.1, 1.09, 1.085, 1.0], 2, 10, 0.02),
    # rmse == rmse_last - min_improvement exactly: continues
    ([1.0, 0.75, 0.5, 0.375, 0.375], 1, 10, 0.25),
    ([1.75, 1.5, 1.25, 1.0, 0.75, 0.5], 0, 4, 0.25),
    # min_epochs past max_epochs: max wins
    ([1.0] * 10, 8, 5, 1e-4),
    # max_epochs 0, and min_epochs 0 with min_improvement > 0: no epoch
    ([1.0] * 3, 3, 0, 1e-4),
    ([1.0] * 3, 0, 5, 1e-4),
    # min_improvement <= 0: runs while not worse, up to max
    ([1.0, 1.0, 1.0, 1.25, 1.0], 0, 9, 0.0),
    ([1.0, 1.5, 2.5, 2.0, 4.0], 0, 9, -1.0),
    # rising rmse after min_epochs, and NaN: stop
    ([1.0, 1.5, 1.0, 0.5], 1, 9, 1e-4),
    ([1.0, float('nan'), 0.5, 0.25], 1, 9, 1e-4),
    # f32 values widened, as the kernel and the wrapper read them
    ([float(np.float32(x)) for x in (1.1, 1.0999, 1.0998, 1.09, 1.2)], 2,
     9, 1e-4),
    # float epoch bounds
    ([1.0] * 6, 2.5, 4.5, 1.0),
]


@pytest.mark.parametrize('case', range(len(RULE_CASES)))
def test_rule_matches_host_loop(case):
    seq, min_e, max_e, min_imp = RULE_CASES[case]
    want = _jax_loop(seq, min_e, max_e, min_imp)
    assert _rule_loop(seq, min_e, max_e, min_imp) == want
    m = GDRecommender(4, 4, {'min_epochs': min_e, 'max_epochs': max_e,
                             'min_improvement': min_imp}, device='cpu')
    m.rmse_history = []
    it = iter(seq)
    m._converge_feature(lambda: next(it), 0, False)
    np.testing.assert_array_equal(m.rmse_history, want)


def test_epoch_bounds_read_as_the_rule():
    for x in (0, 1, 2.5, 4.0, -3, 1e12, float('inf'), -float('inf')):
        b = sk._epoch_bound(x)
        for ep in range(8):
            assert (ep < x) == (ep < b) and (ep >= x) == (ep >= b)
    with pytest.raises(ValueError):
        sk._epoch_bound(float('nan'))


# --------------------------------------------------------- the schedule
STREAMS = [
    # (U, I, n, fold): heavy repeats, chunk edges, fold-in streams
    (3, 2, 1, None), (8, 8, 5, None), (2, 3, 31, None), (8, 5, 32, None),
    (4, 8, 33, None), (8, 8, 64, None), (6, 7, 65, None), (8, 8, 100, None),
    (1, 1, 40, None), (40, 30, 500, None), (2, 50, 20, 'user'),
    (2, 80, 70, 'user'), (60, 2, 45, 'item')]


def _brute_marks(u, i):
    '''Each rating's cyclic previous and next rating on the same id, by
    scanning the stream twice over.'''
    n = len(u)
    out = []
    for ids in (u, i):
        prev, nxt = np.empty(n, int), np.empty(n, int)
        for s in range(n):
            prev[s] = next(p % n for p in range(s - 1, s - 1 - n, -1)
                           if ids[p % n] == ids[s])
            nxt[s] = next(q % n for q in range(s + 1, s + 1 + n)
                          if ids[q % n] == ids[s])
        out.append((prev, nxt))
    return out


@pytest.mark.parametrize('stream', STREAMS)
def test_schedule_is_exact(stream):
    U, I, n, fold = stream
    d = _case(U, I, n, 2, seed=n, fold=fold)
    u, i = d['u'], d['i']
    w = sk.decode_schedule(sk.build_schedule(u, i))
    s = np.arange(n)
    group = (s // sk.CHUNK) * sk.CHUNK + w['round']
    assert (w['round'] < sk.CHUNK).all()
    nch = -(-n // sk.CHUNK)
    # each rating after the earlier ones it depends on
    for a in range(n):
        for b in range(a + 1, n):
            if u[a] == u[b] or i[a] == i[b]:
                assert group[a] < group[b]
    for side, ids in enumerate((u, i)):
        for g in np.unique(group):            # a group shares no row
            at = group == g
            assert len(np.unique(ids[at])) == at.sum()
        prev, nxt = _brute_marks(u, i)[side]
        src = w['usrc' if side == 0 else 'isrc']
        lane = w['ulane' if side == 0 else 'ilane']
        last = w['ulast' if side == 0 else 'ilast']
        ch, pch = s // sk.CHUNK, prev // sk.CHUNK
        within = (prev < s) & (pch == ch)
        before = ~within & (pch == (ch - 1) % nch)
        np.testing.assert_array_equal(
            src, np.where(within, sk.SRC_IN,
                          np.where(before, sk.SRC_PREV, sk.SRC_TABLE)))
        np.testing.assert_array_equal(lane, prev % sk.CHUNK)
        np.testing.assert_array_equal(
            last, ~((nxt > s) & (nxt // sk.CHUNK == ch)))
    assert sk.chunk_rounds(sk.build_schedule(u, i)) == sum(
        w['round'][c * sk.CHUNK:(c + 1) * sk.CHUNK].max() + 1
        for c in range(nch))


def test_longest_chain():
    assert sk.longest_chain(np.array([0, 1, 0, 2]),
                            np.array([0, 0, 1, 2])) == 2
    assert sk.longest_chain(np.array([0, 1, 1, 2]),
                            np.array([0, 0, 1, 1])) == 4
    d = _case(2, 50, 20, 1, seed=0, fold='user')
    assert sk.longest_chain(d['u'], d['i']) == 20
    assert sk.longest_chain(np.arange(9), np.arange(9)) == 1


def test_plan_table_and_device_memory():
    '''The plan's table holds the stream's distinct rows: a 20-rating
    fold-in on the rank-64 ML-10M-shape model fits, a stream over 40,000
    users and items does not (its ids are then the global ones).'''
    rng = np.random.default_rng(0)
    items = rng.choice(10_677, 20, replace=False)
    fold = sk.serial_plan(np.full(20, 69_878), items, device='cpu')
    assert fold.table and (fold.nu, fold.ni) == (1, 20)
    np.testing.assert_array_equal(fold.ucols.numpy(), [69_878])
    np.testing.assert_array_equal(fold.icols.numpy()[fold.li.numpy()],
                                  items)
    assert fold.rounds == 20
    u, i = rng.integers(0, 40_000, 90_000), rng.integers(0, 40_000, 90_000)
    big = sk.serial_plan(u, i, device='cpu')
    assert not big.table
    np.testing.assert_array_equal(big.lu.numpy(), u)
    with pytest.raises(ValueError):
        sk.serial_plan(u, i, device='cpu', smem=True)
    assert not sk.serial_plan(u[:50], i[:50], device='cpu', smem=False).table


# ------------------------------------------- the walk over the schedule
def _walk(d, f, mode, masks, epochs, lr=0.01):
    '''``csrc/serial_funk.cu``'s walk in torch: warp 0's lanes as vectors
    of 32, the table read one chunk ahead, rows passed between lanes as
    the schedule says, ``epochs`` epochs in one launch.  Returns the
    columns, biases and each epoch's rmse.'''
    u, i, n = d['u'].astype(np.int64), d['i'].astype(np.int64), len(d['u'])
    k = d['P'].shape[1]
    sc = sk.epoch_scalars(f, k, 0.1, lr, 0.02, 3.5, *RATES, 1.0, 5.0)
    w = sk.decode_schedule(sk.build_schedule(u, i))
    P, Q = t(d['P']), t(d['Q'])
    pf, qf = P[:, f].contiguous(), Q[:, f].contiguous()
    bu, bi = t(d['bu']), t(d['bi'])
    cache, r = t(d['cache']), t(d['r'])
    ul, il = torch.from_numpy(u), torch.from_numpy(i)
    learned = mode == 'learned'
    if learned:
        a0, a1 = sk.seq_dot(P[ul], Q[il]), P[ul, f] * Q[il, f]
    else:
        alt = ((sc['mu'] + bi[il]) + bu[ul] if mode == 'fixed'
               else torch.ones_like(cache))
        a0 = torch.where(cache > 0, cache, alt)
    nch = -(-n // sk.CHUNK)
    lanes = np.arange(sk.CHUNK)

    def at(c):
        s = c * sk.CHUNK + lanes
        return s, s < n, np.minimum(s, n - 1)

    def rows(c):                      # the table as it is now
        _, ok, s = at(c)
        return [x[ids[s]].clone() for x, ids in
                ((pf, u), (qf, i), (bu, u), (bi, i))]

    m0, held = rows(0), rows(nch - 1)
    hist = []
    for _ in range(epochs):
        sse = torch.zeros(())
        for c in range(nch):
            m1 = rows((c + 1) % nch)
            s_raw, ok, s = at(c)
            x = [v.clone() for v in m0]

            def take(src, mine):
                for side, (a, b) in enumerate(((0, 2), (1, 3))):
                    key = 'usrc' if side == 0 else 'isrc'
                    lane = w['ulane' if side == 0 else 'ilane'][s]
                    m = torch.from_numpy(mine & (w[key][s] == src))
                    for j in (a, b):
                        x[j] = torch.where(m, held[j][lane], x[j])

            take(sk.SRC_PREV, ok)
            lvl = np.where(ok, w['round'][s], 0)
            e2 = torch.zeros(sk.CHUNK)
            for rr in range(int(lvl.max()) + 1):
                if rr:
                    take(sk.SRC_IN, ok & (lvl == rr))
                act = torch.from_numpy(ok & (lvl == rr))
                cf, mf, ub, ib = x
                if learned:
                    tt = ((sc['mu'] + ib) + ub + a0[s]) - a1[s]
                    p = torch.clamp(tt + cf * mf, sc['lo'], sc['hi'])
                else:
                    p = torch.clamp(a0[s] + cf * mf, sc['lo'], sc['hi'])
                p = torch.clamp(p + sc['trailing'], sc['lo'], sc['hi'])
                err = r[s] - p
                new = [cf + sc['lr'] * (err * mf - sc['K'] * cf)
                       if masks[0] else cf,
                       mf + sc['lr'] * (err * cf - sc['K'] * mf)
                       if masks[1] else mf,
                       ub + sc['lr_bu'] * (err - sc['K_bu'] * ub),
                       ib + sc['lr_bi'] * (err - sc['K_bi'] * ib)]
                for j in range(4):
                    held[j] = torch.where(act, new[j], held[j])
                e2 = torch.where(act, err * err, e2)
            for j, (ids, last) in enumerate(((u, 'ulast'), (i, 'ilast'),
                                             (u, 'ulast'), (i, 'ilast'))):
                if j >= 2 and not learned:
                    continue
                st = ok & (w[last][s] == 1)
                col = (pf, qf, bu, bi)[j]
                col[ids[s[st]]] = held[j][torch.from_numpy(st)]
            for j in range(sk.CHUNK):
                sse = sse + e2[j]
            m0 = m1
        hist.append(torch.sqrt(sse / torch.tensor(float(n))))
    return pf, qf, bu, bi, hist


WALK_STREAMS = [(8, 8, 5, None), (4, 8, 33, None), (8, 5, 64, None),
                (6, 7, 65, None), (8, 8, 150, None), (1, 1, 40, None),
                (40, 30, 300, None), (2, 50, 20, 'user'),
                (2, 80, 45, 'user'), (60, 2, 45, 'item')]


@pytest.mark.parametrize('stream', WALK_STREAMS)
@pytest.mark.parametrize('mode', ['none', 'fixed', 'learned'])
def test_schedule_walk_matches_serial(mode, stream):
    U, I, n, fold = stream
    d = _case(U, I, n, 3, seed=7 + n, fold=fold)
    masks = {None: (True, True), 'user': (True, False),
             'item': (False, True)}[fold]
    f, epochs = 1, 3
    got = _walk(d, f, mode, masks, epochs)
    P, Q = t(d['P']), t(d['Q'])
    pf, qf = P[:, f].contiguous(), Q[:, f].contiguous()
    bu, bi = t(d['bu']), t(d['bi'])
    for e in range(epochs):
        rmse = sk.serial_feature_epoch_ref(
            pf, qf, t(d['cache']), t(d['u']), t(d['i']), t(d['r']), f, 3,
            0.1, 0.01, 0.02, 3.5, bu, bi, *RATES, bias_mode=mode,
            update_users=masks[0], update_items=masks[1], P=P, Q=Q)[4]
        assert torch.equal(got[4][e], rmse), e
    for a, b in zip(got[:4], (pf, qf, bu, bi)):
        assert torch.equal(a, b)
