'''S2's plan (``ops/kmf_serial_kernel.py kmf_plan``) on the CPU: the
schedule the kernel runs, checked against a brute-force walk of the
stream, and a plain walk of the stream in the kernel's order (chunk by
chunk; in a chunk the warps' job lists interleaved, the highest warp
first, so a round's ratings run in reverse order; every row read from
where the plan says: the warp's previous job, an earlier rating's slot
of the chunk, the chunk before's, or the row table as it stood a chunk
earlier; the chunk's last writer of a row storing it; sse added in
stream order) against ``kmf_serial_epoch_ref``.

Tolerances: none.  The plan is integer data and must equal the brute
force; the walk runs the plain version's own per-rating step
(``rating_step``) on the same rows in another order, which can change
no bit if the plan is right, so it is compared bit for bit (P, Q,
biases and every epoch's rmse).'''
import numpy as np
import pytest
import torch

from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
from mfrec_tpu_torch.ops import serial_kernel

torch.set_num_threads(1)

C = sk.CHUNK
MASKS = [(True, True), (True, False), (False, True)]
RATES = (0.01, 0.1, 0.1, 0.007)
EPOCHS = 3
# the rounds an epoch of phase k (c)'s stream takes at C = 32: the u1
# train split of the ML-100K-shaped data, shuffled by a serial
# KMFRecommender's first draw from seed 0
PHASE_K_ROUNDS = 4893


def _stream(name):
    '''(U, I, u, i, r) of a named stream, ids with repeats.'''
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith('n='):
        n = int(name[2:])
        U, I = 12, 40
        u = rng.integers(0, U, n)
        i = rng.integers(0, I, n)
    elif name == 'repeat':                   # one (u, i), 40 times
        U, I, n = 6, 9, 40
        u, i = np.full(n, 3), np.full(n, 7)
    elif name == 'fold_in':                  # one user, a pair twice
        U, I, n = 5, 40, 21
        u = np.full(n, 2)
        i = np.r_[rng.choice(I, n - 1, replace=False), 0]
        i[-1] = i[4]
    else:                                    # 'hot_item': item 0 in half
        U, I, n = 30, 25, 97
        u = rng.integers(0, U, n)
        i = np.where(rng.random(n) < 0.5, 0, rng.integers(1, I, n))
    r = rng.integers(1, 6, n).astype(np.float32)
    return U, I, u.astype(np.int32), i.astype(np.int32), r


STREAMS = ['n=1', 'n=2', 'n=3', 'n=31', 'n=32', 'n=33', 'n=64', 'n=65',
           'repeat', 'fold_in', 'hot_item']


def _brute(u, i):
    '''The schedule by a walk of the stream, rating by rating: each
    rating's round, and for each side its source, the lane of the rating
    it reads, whether it writes the row last in its chunk.'''
    n = len(u)
    nch = -(-n // C)
    rnd = np.zeros(n, np.int64)
    sides = []
    for ids in (u, i):
        src, lane, last = (np.zeros(n, np.int64) for _ in range(3))
        for s in range(n):
            c = s // C
            prev = next(p % n for p in range(s - 1, s - 1 - n, -1)
                        if ids[p % n] == ids[s])
            nxt = next(q % n for q in range(s + 1, s + 1 + n)
                       if ids[q % n] == ids[s])
            if prev < s and prev // C == c:
                src[s] = serial_kernel.SRC_IN
            elif prev // C == (c - 1) % nch:
                src[s] = serial_kernel.SRC_PREV
            else:
                src[s] = serial_kernel.SRC_TABLE
            lane[s] = prev % C
            last[s] = not (nxt > s and nxt // C == c)
        sides.append((src, lane, last))
    for s in range(n):
        c = s // C
        dep = [rnd[p] + 1 for p in range(c * C, s)
               if u[p] == u[s] or i[p] == i[s]]
        rnd[s] = max(dep, default=0)
    return rnd, sides


def _fields(plan):
    '''The plan's records, by position: stream index, ids, rating, the
    word's fields, the warp that runs it.'''
    rec = plan.rec.numpy().astype(np.int64)
    w = rec[:plan.n, 2]
    pos = np.arange(plan.n)
    wst = plan.wst.numpy()
    warp = np.array([np.searchsorted(wst[p // C, :sk.WARPS + 1], p % C,
                                     'right') - 1 for p in pos])
    return dict(s=(pos // C) * C + (w & 31), u=rec[:plan.n, 0],
                i=rec[:plan.n, 1], r=rec[:plan.n, 3].astype(np.int32)
                .view(np.float32), usrc=(w >> 5) & 3, ulane=(w >> 7) & 31,
                isrc=(w >> 12) & 3, ilane=(w >> 14) & 31,
                ulast=(w >> 19) & 1, ilast=(w >> 20) & 1,
                ureg=(w & sk.REG_U) > 0, ireg=(w & sk.REG_I) > 0,
                uwait=(w & sk.WAIT_U) > 0, iwait=(w & sk.WAIT_I) > 0,
                notify=(w & sk.NOTIFY) > 0, sync=(w & sk.SYNC) > 0,
                ustore=(w & sk.STORE_U) > 0,
                istore=(w & sk.STORE_I) > 0, warp=warp)


@pytest.mark.parametrize('name', STREAMS)
def test_plan_is_exact(name):
    '''The records are the stream, each chunk's own ratings; the rounds,
    sources, lanes and last-writer marks equal a brute-force walk, and a
    round's ratings share no row; each warp's jobs run in round order,
    and a side read from a slot of the chunk is marked to wait when
    another warp writes it, and to come from registers exactly when the
    warp's previous job wrote it.'''
    U, I, u, i, r = _stream(name)
    n = len(u)
    plan = sk.kmf_plan(u, i, r, device='cpu')
    nch = -(-n // C)
    assert (plan.n, plan.nch) == (n, nch)
    assert plan.rec.shape == (nch * C, 4)
    assert plan.wst.shape == (nch, sk.WARP_TABLE)
    assert plan.rec.dtype == plan.wst.dtype == torch.int32
    f = _fields(plan)
    rnd, sides = _brute(u, i)
    s = f['s']
    assert sorted(s.tolist()) == list(range(n))
    np.testing.assert_array_equal(s // C, np.arange(n) // C)
    np.testing.assert_array_equal(f['u'], u[s])
    np.testing.assert_array_equal(f['i'], i[s])
    assert f['r'].tobytes() == r[s].tobytes()
    assert (plan.rec.numpy()[n:] == 0).all()
    for side, (src, lane, last) in zip('ui', sides):
        np.testing.assert_array_equal(f[side + 'src'], src[s])
        np.testing.assert_array_equal(f[side + 'lane'], lane[s])
        np.testing.assert_array_equal(f[side + 'last'], last[s])
    wst = plan.wst.numpy()
    total = 0
    for c in range(nch):
        size = min(C, n - c * C)
        starts = wst[c, :sk.WARPS + 1]
        assert starts[0] == 0 and starts[-1] == size
        assert (np.diff(starts) >= 0).all()
        lo = c * C
        at = s[lo:lo + size] - lo                     # lanes, by position
        for rr in range(rnd[lo:lo + size].max() + 1):
            grp = np.flatnonzero(rnd[lo:lo + size] == rr) + lo
            assert len(np.unique(u[grp])) == len(grp)
            assert len(np.unique(i[grp])) == len(grp)
        total += rnd[lo:lo + size].max() + 1
        where = {int(lane): lo + p for p, lane in enumerate(at)}  # lane->pos
        waited = set()
        for w in range(sk.WARPS):
            jobs = range(lo + starts[w], lo + starts[w + 1])
            assert (f['warp'][list(jobs)] == w).all()
            assert (np.diff(rnd[s[list(jobs)]]) >= 0).all()
            for k_, p in enumerate(jobs):
                mine = False                  # a slot this warp wrote
                for side in 'ui':
                    if f[side + 'src'][p] != serial_kernel.SRC_IN:
                        assert not f[side + 'reg'][p]
                        assert not f[side + 'wait'][p]
                        continue
                    q = where[int(f[side + 'lane'][p])]
                    assert f[side + 'wait'][p] == (f['warp'][q] != w)
                    assert f[side + 'reg'][p] == (k_ > 0 and q == p - 1)
                    if f[side + 'wait'][p]:
                        waited.add(q)
                    mine |= f['warp'][q] == w and q != p - 1
                assert f['sync'][p] == mine
        for p in range(lo, lo + size):
            assert f['notify'][p] == (p in waited)
    # a side is stored in the slot exactly when the next rating on its row
    # reads it there: from the chunk after, or from this chunk but not
    # from its warp's registers
    pos_of = np.empty(n, np.int64)
    pos_of[s] = np.arange(n)
    for side, ids in (('u', u), ('i', i)):
        for p in range(n):
            nxt = next(q % n for q in range(s[p] + 1, s[p] + 1 + n)
                       if ids[q % n] == ids[s[p]])
            q = pos_of[nxt]
            read = f[side + 'src'][q] == serial_kernel.SRC_PREV or (
                f[side + 'src'][q] == serial_kernel.SRC_IN
                and not f[side + 'reg'][q])
            assert f[side + 'store'][p] == read
    assert plan.rounds == total == serial_kernel.chunk_rounds(
        serial_kernel.build_schedule(u, i))


def plan_walk(P, Q, bu, bi, plan, kernel, masks, epochs):
    '''The kernel's walk of ``plan`` in plain torch: three slot buffers
    that turn over chunk by chunk, each slot (a rating's lane) holding a
    user row and bias and an item row and bias; at the start the last
    chunk's rows in the buffer before chunk 0's and chunk 0's table rows
    in its own; at each chunk's start the next chunk's table rows copied
    from P, Q, bu, bi as they stand then.  In a chunk the warps' job
    lists run interleaved, the highest warp first, a job only once the
    jobs whose slots it reads have run; a side marked ``REG_*`` comes
    from the warp's previous job.  Updates P, Q, bu, bi in place and
    returns them and each epoch's rmse (0-dim tensors).'''
    rec = plan.rec.numpy()
    wst = plan.wst.numpy()
    n, nch = plan.n, plan.nch
    sc = sk.epoch_scalars(*RATES, 1.0, 5.0)
    uu, ui = masks
    bufs = [[[None, None] for _ in range(C)] for _ in range(3)]

    def chunk(c):
        return rec[c * C:c * C + min(C, n - c * C)]

    def fill(buf, c, only_table):
        for u, i, w, _ in chunk(c):
            for side, src in ((0, (w >> 5) & 3), (1, (w >> 12) & 3)):
                if not only_table or src == serial_kernel.SRC_TABLE:
                    bufs[buf][w & 31][side] = (
                        (P[u].clone(), bu[u].clone()) if side == 0
                        else (Q[i].clone(), bi[i].clone()))

    fill(2, nch - 1, False)
    fill(0, 0, True)
    g, hist = 0, []
    for _ in range(epochs):
        e2 = [None] * n
        for c in range(nch):
            cur, prv = g % 3, (g + 2) % 3
            fill((g + 1) % 3, (c + 1) % nch, True)
            head = [int(wst[c, w]) for w in range(sk.WARPS)]
            regs = [None] * sk.WARPS
            done = set()
            left = min(C, n - c * C)
            while left:
                ran = False
                for w in reversed(range(sk.WARPS)):
                    if head[w] == wst[c, w + 1]:
                        continue
                    u, i, wd, rb = (int(x) for x in rec[c * C + head[w]])
                    j = wd & 31
                    srcs = (((wd >> 5) & 3, (wd >> 7) & 31, sk.REG_U),
                            ((wd >> 12) & 3, (wd >> 14) & 31, sk.REG_I))
                    if any(src == serial_kernel.SRC_IN and lane not in done
                           for src, lane, _ in srcs):
                        continue
                    rows = []
                    for side, (src, lane, reg) in enumerate(srcs):
                        if wd & reg:
                            assert regs[w][0] == lane
                            rows.append(regs[w][1][side])
                        elif src == serial_kernel.SRC_PREV:
                            rows.append(bufs[prv][lane][side])
                        elif src == serial_kernel.SRC_IN:
                            rows.append(bufs[cur][lane][side])
                        else:
                            rows.append(bufs[cur][j][side])
                    (x, xb), (y, yb) = rows
                    rv = torch.tensor(np.int32(rb).view(np.float32))
                    err, x, y, xb, yb = sk.rating_step(x, y, xb, yb, rv, sc,
                                                       kernel, uu, ui)
                    # a side no later rating reads from the slot is not
                    # stored there: a read of it would find None
                    bufs[cur][j] = [(x, xb) if wd & sk.STORE_U else None,
                                    (y, yb) if wd & sk.STORE_I else None]
                    regs[w] = (j, [(x, xb), (y, yb)])
                    e2[c * C + j] = err * err
                    if uu and (wd >> 19) & 1:
                        P[u], bu[u] = x, xb
                    if ui and (wd >> 20) & 1:
                        Q[i], bi[i] = y, yb
                    done.add(j)
                    head[w] += 1
                    left -= 1
                    ran = True
                assert ran, 'no warp can run: the plan deadlocks'
            g += 1
        sse = torch.zeros((), dtype=torch.float32)
        for v in e2:
            sse = sse + v
        hist.append(torch.sqrt(sse / torch.tensor(float(n))))
    return P, Q, bu, bi, hist


def _state(U, I, k, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(0, 0.1, (U, k)), rng.normal(0, 0.1, (I, k)),
        rng.normal(0, 0.1, U), rng.normal(0, 0.1, I))]


@pytest.mark.parametrize('masks', MASKS)
@pytest.mark.parametrize('kernel', ['logistic', 'linear'])
@pytest.mark.parametrize('name', STREAMS)
def test_plan_walk_matches_plain(name, kernel, masks):
    '''The walk in the kernel's order, 3 epochs, against the plain
    version's 3 epochs: P, Q, biases and every rmse bit for bit (so a
    masked side stays as it was).'''
    U, I, u, i, r = _stream(name)
    k = 40 if name == 'fold_in' else 8
    plan = sk.kmf_plan(u, i, r, device='cpu')
    got = plan_walk(*_state(U, I, k, 1), plan, kernel, masks, EPOCHS)
    want = _state(U, I, k, 1)
    ids = [torch.from_numpy(a) for a in (u, i, r)]
    hist = []
    for _ in range(EPOCHS):
        hist.append(sk.kmf_serial_epoch_ref(*want, *ids, *RATES, kernel, 1.0,
                                            5.0, *masks)[4])
    for a, b in zip(got[:4], want):
        assert torch.equal(a, b)
    assert [x.numpy().tobytes() for x in got[4]] == \
        [x.numpy().tobytes() for x in hist]


def test_phase_k_stream_rounds():
    '''Phase k (c)'s stream (``chip_smoke.kmf_serial_timing``: the u1
    train split, 80,000 ratings, shuffled as ``engine='serial'`` shuffles
    it) takes 4,893 rounds an epoch in chunks of 32; its longest
    dependency chain is 992 ratings.'''
    from mfrec_tpu_torch.data import ml100k_like
    from mfrec_tpu_torch.models.kmf import KMFRecommender
    (tu, ti, tv), _ = ml100k_like.u1_split(seed=0)
    m = KMFRecommender(ml100k_like.N_USERS, ml100k_like.N_ITEMS,
                       {'engine': 'serial'}, device='cpu')
    m.seed(0)
    m.set_ratings(tu, ti, tv)
    m.init_feature_normal(0.0, 0.1)
    u, i, r = m.ratings.shuffled(int(m.rng.integers(2 ** 31)))
    plan = sk.kmf_plan(u, i, r, device='cpu')
    assert (plan.n, plan.nch, plan.rounds) == (80_000, 2_500, PHASE_K_ROUNDS)
    wst = plan.wst.numpy()
    assert (wst[:, sk.WARPS] == C).all() and (np.diff(wst[:, :sk.WARPS + 1],
                                                      axis=1) >= 0).all()
    assert serial_kernel.longest_chain(u, i) == 992


def test_plan_refuses_what_it_cannot_schedule():
    with pytest.raises(ValueError):
        sk.kmf_plan(np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32), device='cpu')
    with pytest.raises(ValueError):
        sk.kmf_plan(np.zeros(3, np.int32), np.zeros(2, np.int32),
                    np.zeros(3, np.float32), device='cpu')


def test_cpu_entries_take_a_plan_and_ignore_it():
    '''A plan given to the entries on CPU tensors changes nothing: they
    are the plain versions.'''
    U, I, u, i, r = _stream('n=33')
    ids = [torch.from_numpy(a) for a in (u, i, r)]
    plan = sk.kmf_plan(u, i, r, device='cpu')
    a, b = _state(U, I, 8, 2), _state(U, I, 8, 2)
    got = sk.kmf_serial_converge(*a, *ids, *RATES, min_epochs=2,
                                 max_epochs=2, plan=plan)
    want = sk.kmf_serial_converge_ref(*b, *ids, *RATES, min_epochs=2,
                                      max_epochs=2)
    for x, y in zip(got[:4], want[:4]):
        assert torch.equal(x, y)
    assert got[4] == want[4]
