'''K3's plain PyTorch twin and the plain top-n against the JAX package:
the Pallas kernel in interpret mode (as tests/test_pallas_topk.py runs
it) and the XLA ``topn_scores``.  The CUDA kernel itself is checked
against the twin on a GPU by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: exact mode, ids equal on every slot the reference fills and
scores within 1e-5 (f32 sums in another order); fast mode, scores within
rtol 2^-10 / atol 1e-5 (one quantization step), ids equal except where
the reference's neighbouring scores lie within that tolerance (quasi-ties
may order differently: the Pallas packed merge breaks them by the higher
id, the port by the lower).'''
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfrec_tpu.ops import topk as jax_topk
from mfrec_tpu.ops.pallas_topk import pad_items_for_pallas, topn_scores_pallas
from mfrec_tpu_torch.ops import topk as port_topk
from mfrec_tpu_torch.ops import topn_kernel
from mfrec_tpu_torch.ops.topn_kernel import (NEG, kernel_rated_lists,
                                             topn_agreement,
                                             topn_scores_kernel,
                                             topn_scores_ref)

EXACT = dict(atol=1e-5, rtol=0.0, tie=1e-5)
FAST = dict(atol=1e-5, rtol=2.0 ** -10, tie=None)
MODES = ('bias', 'dot_plus_one', 'dot', 'logistic')


def assert_topn_match(idx, scores, ref_idx, ref_scores, n, atol, rtol,
                      tie=None):
    '''``ref_*`` may hold n+1 columns: the extra one tells a quasi-tie at
    the cut from a wrong id.'''
    ok, err, swaps = topn_agreement(idx, scores, ref_idx, ref_scores, n,
                                    atol, rtol, tie)
    assert ok, (err, swaps)


def _case(B, I, k, L, seed, mode='bias'):
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 0.5, (B, k)).astype(np.float32)
    Q = rng.normal(0, 0.5, (I, k)).astype(np.float32)
    bu = rng.normal(0, 0.2, B).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    mu = 3.5
    # the model layer's mapping of each mode onto mu + bu + bi + dot
    if mode in ('dot', 'dot_plus_one'):
        bu[:], bi[:] = 0.0, 0.0
        mu = 1.0 if mode == 'dot_plus_one' else 0.0
    elif mode == 'logistic':
        mu = 0.0
    ridx = np.zeros((B, max(L, 1)), np.int32)
    rmask = np.zeros((B, max(L, 1)), np.float32)
    for b in range(B):
        c = int(rng.integers(L // 2, L + 1)) if L else 0
        ridx[b, :c] = np.sort(rng.choice(I, c, replace=False))
        rmask[b, :c] = 1.0
    return P, Q, bu, bi, mu, ridx, rmask


def _twin(P, Q, bu, bi, mu, ridx, rmask, n, fast=False):
    ri, rc = kernel_rated_lists(ridx, rmask)
    t = torch.from_numpy
    return topn_scores_ref(t(P), t(Q), t(bu), t(bi), mu, n, t(ri), t(rc),
                           bf16_dot=fast, packed=fast)


def _pallas(P, Q, bu, bi, mu, ridx, rmask, n, block, fast=False):
    Qp, bip = pad_items_for_pallas(Q, bi, block)
    idx, s = topn_scores_pallas(
        jnp.asarray(P), jnp.asarray(Qp), jnp.asarray(bu), jnp.asarray(bip),
        mu, n=n, block=block, interpret=True, rated_idx=jnp.asarray(ridx),
        rated_mask=jnp.asarray(rmask),
        score_dtype='bfloat16' if fast else None, packed_merge=fast)
    return np.asarray(idx), np.asarray(s)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('L', [0, 24])
def test_twin_matches_pallas_exact(mode, L):
    '''I=1500 (not a block multiple), k=66, every mode, with and without
    rated masks.'''
    P, Q, bu, bi, mu, ridx, rmask = _case(6, 1500, 66, L, seed=L + 1,
                                          mode=mode)
    n = 10
    ref = _pallas(P, Q, bu, bi, mu, ridx, rmask, n + 1, block=1024)
    idx, s = _twin(P, Q, bu, bi, mu, ridx, rmask, n)
    assert_topn_match(idx, s, *ref, n, **EXACT)
    for b in range(6):
        assert not set(idx[b].tolist()) & set(ridx[b][rmask[b] > 0].tolist())


@pytest.mark.parametrize('n', [1, 7, 15, 40])
def test_twin_matches_pallas_n_past_unrated(n):
    '''n from 1 to past the count of unrated items (I=40, 26-30 rated):
    the slots beyond it hold NEG in both.'''
    P, Q, bu, bi, mu, ridx, rmask = _case(5, 40, 66, 30, seed=n)
    ref = _pallas(P, Q, bu, bi, mu, ridx, rmask, min(n + 1, 40), block=128)
    idx, s = _twin(P, Q, bu, bi, mu, ridx, rmask, n)
    assert_topn_match(idx, s, *ref, n, **EXACT)
    unrated = 40 - rmask.sum(1)
    np.testing.assert_array_equal((s.numpy() > NEG / 2).sum(1),
                                  np.minimum(unrated, n))


@pytest.mark.parametrize('L', [0, 24])
@pytest.mark.parametrize('mode', ['bias', 'dot_plus_one'])
def test_twin_fast_matches_pallas_fast(mode, L):
    '''bf16 score products + packed merge against the Pallas kernel's
    fast path (score_dtype='bfloat16', packed_merge=True).'''
    P, Q, bu, bi, mu, ridx, rmask = _case(6, 1500, 66, L, seed=7 + L,
                                          mode=mode)
    n = 12
    ref = _pallas(P, Q, bu, bi, mu, ridx, rmask, n + 1, block=1024,
                  fast=True)
    idx, s = _twin(P, Q, bu, bi, mu, ridx, rmask, n, fast=True)
    assert_topn_match(idx, s, *ref, n, **FAST)
    # each score is its item's bf16-product score quantized toward -inf
    rb = torch.from_numpy
    Pb = rb(P).to(torch.bfloat16).float()
    Qb = rb(Q).to(torch.bfloat16).float()
    full = (((Pb @ Qb.T) + mu) + rb(bu)[:, None]) + rb(bi)[None, :]
    own = torch.gather(full, 1, idx.long()).numpy()
    valid = s.numpy() > NEG / 2
    assert (s.numpy()[valid] <= own[valid]).all()
    assert (s.numpy()[valid] >= own[valid] - 2.0 ** -10 * np.abs(
        own[valid]) - 1e-6).all()


@pytest.mark.parametrize('predictor', MODES)
@pytest.mark.parametrize('L', [0, 16])
def test_plain_topn_matches_jax_xla(predictor, L):
    '''The port's plain topn_scores against mfrec_tpu.ops.topk.'''
    P, Q, bu, bi, mu, ridx, rmask = _case(7, 333, 66, L, seed=3)
    n = 9
    ref_idx, ref_s = jax_topk.topn_scores(
        jnp.asarray(P), jnp.asarray(Q), jnp.asarray(bu), jnp.asarray(bi),
        jnp.float32(mu), jnp.asarray(ridx), jnp.asarray(rmask), n + 1,
        predictor=predictor)
    t = torch.from_numpy
    idx, s = port_topk.topn_scores(t(P), t(Q), t(bu), t(bi), mu, t(ridx),
                                   t(rmask), n, predictor=predictor)
    assert_topn_match(idx, s, ref_idx, ref_s, n, **EXACT)


def test_kernel_rated_lists_compacts_and_sorts():
    idx = np.array([[3, 5, 0, 0], [9, 1, 4, 7], [2, 8, 6, 0]], np.int32)
    mask = np.array([[1, 1, 0, 0], [1, 0, 1, 1], [1, 1, 1, 0]], np.float32)
    ri, rc = kernel_rated_lists(idx, mask)
    np.testing.assert_array_equal(rc, [2, 3, 3])
    np.testing.assert_array_equal(ri[0, :2], [3, 5])
    np.testing.assert_array_equal(ri[1, :3], [4, 7, 9])
    np.testing.assert_array_equal(ri[2, :3], [2, 6, 8])
    # already-compact CSR rows pass through unchanged
    good = np.array([[1, 4, 0], [2, 3, 9]], np.int32)
    ri, rc = kernel_rated_lists(good, np.array([[1, 1, 0], [1, 1, 1]]))
    np.testing.assert_array_equal(ri, good)


def test_twin_tie_order_lower_id_first():
    P = np.ones((1, 4), np.float32)
    Q = np.zeros((6, 4), np.float32)
    Q[[1, 4]] = 1.0                       # two equal best scores
    z = np.zeros(1, np.float32)
    idx, s = _twin(P, Q, z, np.zeros(6, np.float32), 0.0,
                   np.zeros((1, 1), np.int32), np.zeros((1, 1)), 3)
    np.testing.assert_array_equal(idx[0], [1, 4, 0])


def test_wrapper_on_cpu_runs_twin_and_builds_nothing(monkeypatch):
    from mfrec_tpu_torch.ops import _cuda_build

    def no_build(*a, **k):
        raise AssertionError('CPU tensors must not build the kernel')

    monkeypatch.setattr(_cuda_build, 'load', no_build)
    P, Q, bu, bi, mu, ridx, rmask = _case(4, 100, 8, 6, seed=0)
    ri, rc = kernel_rated_lists(ridx, rmask)
    t = torch.from_numpy
    before = topn_scores_kernel.launches
    got = topn_scores_kernel(t(P), t(Q), t(bu), t(bi), mu, 5, t(ri), t(rc))
    want = topn_scores_ref(t(P), t(Q), t(bu), t(bi), mu, 5, t(ri), t(rc))
    assert topn_scores_kernel.launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize('bad', ['dtype', 'noncontig', 'n_gt_I', 'n_zero',
                                 'bf16_exact', 'k_too_big', 'cnt_alone',
                                 'shape'])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    P = torch.zeros(3, 8)
    Q = torch.zeros(20, 8)
    bu, bi = torch.zeros(3), torch.zeros(20)
    kw = {}
    n = 5
    if bad == 'dtype':
        P = P.double()
    elif bad == 'noncontig':
        Q = torch.zeros(8, 20).T
    elif bad == 'n_gt_I':
        n = 21
    elif bad == 'n_zero':
        n = 0
    elif bad == 'bf16_exact':
        Q = Q.to(torch.bfloat16)
    elif bad == 'k_too_big':
        P, Q = torch.zeros(3, 300), torch.zeros(20, 300)
    elif bad == 'cnt_alone':
        kw['rated_cnt'] = torch.zeros(3, dtype=torch.int32)
    elif bad == 'shape':
        bi = torch.zeros(19)
    with pytest.raises(ValueError):
        topn_scores_kernel(P, Q, bu, bi, 0.0, n, **kw)


def test_model_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    from mfrec_tpu_torch.models.gd import GDRecommender
    with pytest.raises(RuntimeError):
        GDRecommender(4, 6)
    assert topn_kernel.MAX_N == 1024


@pytest.mark.parametrize('B,I,n,slots', [
    (1, 1, 1, 264), (1, 5000, 10, 264), (65, 5000, 10, 264),
    (256, 10_677, 10, 264), (1024, 360_000, 10, 264), (1025, 2000, 10, 132),
    (65_535, 3000, 10, 264), (7, 3000, 1024, 132), (40, 3000, 40, 132)])
def test_plan_covers_every_tile_once(B, I, n, slots):
    '''Every split is non-empty, the splits cover the item tiles, and the
    grid fits the resident blocks in one wave unless the user tiles
    alone exceed them.'''
    p = topn_kernel.topn_plan(B, I, n, slots)
    tiles = -(-I // topn_kernel.ITEM_TILE)
    assert p['tiles'] == tiles
    assert p['user_tiles'] == -(-B // topn_kernel.USER_TILE)
    sizes = [t1 - t0 for t0, t1 in (topn_kernel.split_tiles(
        tiles, p['splits'], s) for s in range(p['splits']))]
    assert sum(sizes) == tiles and min(sizes) >= 1
    assert max(sizes) == p['tiles_per_split']
    assert p['splits'] * p['user_tiles'] <= max(slots, p['user_tiles'])
    if p['splits'] > 1:
        assert min(sizes) >= topn_kernel.MIN_TILES_PER_SPLIT


@pytest.mark.parametrize('n,route,launches', [
    (1, 'running', 2), (32, 'running', 2), (33, 'sort', 2),
    (1024, 'sort', 2)])
def test_plan_routes_by_n(n, route, launches):
    '''n <= RUN_MAX keeps a running list, larger n sorts tiles; each call
    is at most two launches.'''
    p = topn_kernel.topn_plan(256, 10_677, n, 264)
    assert topn_kernel.RUN_MAX == 32
    assert (p['route'], p['launches']) == (route, launches)
    m = min(n, topn_kernel.ITEM_TILE)
    want = 256 * p['splits'] * n if route == 'running' \
        else 256 * p['tiles'] * m
    assert p['workspace'] == want


@pytest.mark.parametrize('B,I,splits,tps,ws,launches', [
    (1024, 360_000, 16, 176, 1024 * 16 * 10, 2),   # the bench shape
    (256, 10_677, 42, 2, 256 * 42 * 10, 2),         # the serving batch
    (64, 200, 1, 2, 0, 1),                          # one split: one launch
    (4096, 10_677, 4, 21, 4096 * 4 * 10, 2)])
def test_plan_at_the_main_shapes(B, I, splits, tps, ws, launches):
    '''At 132 SMs x 2 blocks: 16 splits of 175-176 tiles at the bench
    shape, 42 of 2 at the serving batch; a single split writes the
    result itself.'''
    p = topn_kernel.topn_plan(B, I, 10, 264)
    assert (p['splits'], p['tiles_per_split'], p['workspace'],
            p['launches']) == (splits, tps, ws, launches)


@pytest.mark.parametrize('tiles,splits', [(1, 1), (2813, 16), (84, 42),
                                          (84, 33), (19, 7), (5, 5)])
def test_split_tiles_cut_evenly(tiles, splits):
    '''The splits' tile ranges cover every tile once, none empty, their
    sizes at most one apart.'''
    cuts = [topn_kernel.split_tiles(tiles, splits, s) for s in range(splits)]
    assert cuts[0][0] == 0 and cuts[-1][1] == tiles
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    sizes = [t1 - t0 for t0, t1 in cuts]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
