'''K3, K1, K2, K4, P1, P2, S1, S2 and B1 on a CUDA device: each kernel against its
plain version, and a CUDA model against the same model on the CPU.  Every case
is marked ``gpu`` and skips without a card.  This file imports no JAX,
so on a GPU host without it run it alone, without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: K3 exact mode scores within 1e-4 (f32 sums in another
order), ids equal unless the twin's neighbouring scores lie within 1e-5;
fast mode within one quantization step (rtol 2^-10, atol 1e-5).  K1:
the bf16 tolerances of tests/test_pallas_half_pass.py (window atol
5e-3, rtol 5e-2; SSE 1e-3 relative): kernel and plain version round to
bf16 at the same places, but an f32 ulp from FMA contraction or
summation order can flip one bf16 rounding of the window read.  K2:
atol 1e-4, rtol 1e-3 (tests/test_als.py:303, f32 sums in another
order); the fused K2's M and b against a float64 Gram within
``chip_smoke.gram_within``'s bound, x within K2's.  K4: counts exactly,
sums atol 1e-5 + rtol 1e-5 (the same bf16 rows summed in f32 in another
order); K4's item step: atol 1e-5 plus 1 % of the largest change
(STEP_UPD_TOL, below); K4's gathered error phase: K4's tolerance plus
2^-7 of the largest term, on under 1 % of the elements (AGG_FLIP,
below).  The SVD++ and FN epochs of
a CUDA model against a CPU model's, P1 and P2 and the A/B tool's 'old'
epoch: K1's tolerances.  S1 against its plain version: bit for bit
(both round every step to f32 in one order, no FMA); the fold-in's new
row on the card against the CPU plain path: bit for bit; the fused,
funk-fused and FN fused tiers: two runs on the card bit-identical (their
scatter-adds run in a fixed order), against the CPU within 1e-5 (1e-4
for FN): f32 sums in another order.  S2 against its plain version on
the card: bit for bit, both links (the card's expf equals torch.exp
there), on streams around its 32-rating chunks, a hot item and rows far
past shared memory too; a CUDA KMF model against a CPU one: the alternating tier's RMSE
history within 1e-2 relative and its factors within K1's tolerance (K1
reads the window in bf16, the CPU model's XLA-branch math in f32), the
fold-in's new row and rmse within 1e-6 (the CPU's exp may differ from
the card's by an ulp).  B1 against its plain version and the numpy
refit: within one f32 ulp (f64 sums in another order), a second launch
bit-identical.'''
import numpy as np
import pytest
import torch

from mfrec_tpu_torch.ops.topn_kernel import (kernel_rated_lists,
                                             topn_agreement,
                                             topn_scores_kernel,
                                             topn_scores_ref)

pytestmark = pytest.mark.gpu
EXACT = dict(atol=1e-4, rtol=0.0, tie=1e-5)
FAST = dict(atol=1e-5, rtol=2.0 ** -10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _case(B, I, k, L, seed):
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 0.5, (B, k)).astype(np.float32)
    Q = rng.normal(0, 0.5, (I, k)).astype(np.float32)
    bu = rng.normal(0, 0.2, B).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    ridx = np.zeros((B, L), np.int32)
    for b in range(B):
        ridx[b] = np.sort(rng.choice(I, L, replace=False))
    return P, Q, bu, bi, ridx, np.ones((B, L), np.float32)


@pytest.mark.parametrize('fast', [False, True])
@pytest.mark.parametrize('shape', [(37, 3001, 64, 10, 40),
                                   (5, 300, 66, 7, 3),
                                   (21, 7000, 64, 32, 50),
                                   (21, 7000, 64, 33, 50),
                                   (19, 2000, 128, 1024, 90)])
def test_kernel_matches_twin(cuda, fast, shape):
    B, I, k, n, L = shape
    P, Q, bu, bi, ridx, rmask = _case(B, I, k, L, seed=B)
    ri, rc = kernel_rated_lists(ridx, rmask)
    args = [torch.from_numpy(a).to(cuda) for a in (P, Q, bu, bi)]
    r = [torch.from_numpy(a).to(cuda) for a in (ri, rc)]
    before = topn_scores_kernel.launches
    idx, s = topn_scores_kernel(*args, 3.5, n, *r, bf16_dot=fast,
                                packed=fast)
    torch.cuda.synchronize()
    assert topn_scores_kernel.launches == before + 1
    ref = topn_scores_ref(*args, 3.5, min(n + 1, I), *r, bf16_dot=fast,
                          packed=fast)
    ok, err, swaps = topn_agreement(idx.cpu(), s.cpu(), ref[0].cpu(),
                                    ref[1].cpu(), n,
                                    **(FAST if fast else EXACT))
    assert ok, (err, swaps)


@pytest.mark.parametrize('fast', [False, True])
def test_cuda_model_matches_cpu_model(cuda, fast):
    from mfrec_tpu_torch import interop
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    u, i, v = synthetic_ratings(400, 300, 9000, rank=4, seed=1)
    rng = np.random.default_rng(2)
    P = rng.normal(0, 0.3, (400, 16)).astype(np.float32)
    Q = rng.normal(0, 0.3, (300, 16)).astype(np.float32)
    bu = rng.normal(0, 0.1, 400).astype(np.float32)
    bi = rng.normal(0, 0.1, 300).astype(np.float32)
    gpu, cpu = (interop.from_numpy(P, Q, bu, bi, 3.6, (u, i, v),
                                   device=d) for d in ('cuda', 'cpu'))
    users = np.arange(0, 400, 7)
    for pred in ('predict', 'predict_rating_with_bias'):
        before = topn_scores_kernel.launches
        got = gpu.recommend_batch(users, 10, predictor=pred, fast=fast)
        assert topn_scores_kernel.launches == before + 1
        ref = cpu.recommend_batch(users, 11, predictor=pred, fast=fast)
        ok, err, swaps = topn_agreement(*got, *ref, 10,
                                        **(FAST if fast else EXACT))
        assert ok, (pred, err, swaps)


def _one_past_split(B, n, slots, lo=2000, min_tiles=1):
    '''The first I >= lo whose last split in the plan (at ``min_tiles``
    tiles a split or more) is one tile that holds one item (I one past
    the split boundary before it).'''
    from mfrec_tpu_torch.ops.topn_kernel import (ITEM_TILE, split_tiles,
                                                 topn_plan)
    for I in range(lo + (1 - lo) % ITEM_TILE, lo + 200_000, ITEM_TILE):
        p = topn_plan(B, I, n, slots, min_tiles)
        last = split_tiles(p['tiles'], p['splits'], p['splits'] - 1)
        if p['splits'] > 1 and last[0] == p['tiles'] - 1:
            return I
    raise AssertionError('no such I')


def _edge_inputs(B, I, k, n, L, edge, seed):
    '''Seeded inputs with one of the redesigned kernel's edges: 'ties'
    (every other Q row and item bias a copy of the one before),
    'bounds' (every user rated the first and last item of every item
    tile, hence of every split), 'all_but' (user 0 rated all but n - 1
    items).'''
    from mfrec_tpu_torch.ops.topn_kernel import ITEM_TILE
    P, Q, bu, bi, ridx, rmask = _case(B, I, k, L, seed)
    if edge == 'ties':
        Q[1::2], bi[1::2] = Q[0:I - 1:2], bi[0:I - 1:2]
    elif edge == 'bounds':
        starts = np.arange(0, I, ITEM_TILE)
        marks = np.unique(np.concatenate(
            [starts, np.minimum(starts + ITEM_TILE, I) - 1]))
        ridx = np.tile(marks.astype(np.int32), (B, 1))
        rmask = np.ones(ridx.shape, np.float32)
    elif edge == 'all_but':
        rng = np.random.default_rng(seed + 1)
        keep = rng.choice(I, n - 1, replace=False)
        rest = np.setdiff1d(np.arange(I, dtype=np.int32), keep)
        wide = np.zeros((B, rest.size), np.int32)
        wmask = np.zeros((B, rest.size), np.float32)
        wide[0], wmask[0] = rest, 1.0
        wide[1:, :L], wmask[1:, :L] = ridx[1:], rmask[1:]
        ridx, rmask = wide, wmask
    return P, Q, bu, bi, ridx, rmask


K3_MODES = {'exact': (False, False), 'fast': (True, True),
            'fast_f32q': (True, False)}


def _k3_check(cuda, P, Q, bu, bi, ridx, rmask, n, mode):
    fast, q_bf16 = K3_MODES[mode]
    ri, rc = kernel_rated_lists(ridx, rmask)
    args = [torch.from_numpy(a).to(cuda) for a in (P, Q, bu, bi)]
    if q_bf16:
        args[1] = args[1].to(torch.bfloat16)
    r = [torch.from_numpy(a).to(cuda) for a in (ri, rc)]
    before = topn_scores_kernel.launches
    idx, s = topn_scores_kernel(*args, 3.5, n, *r, bf16_dot=fast,
                                packed=fast)
    torch.cuda.synchronize()
    assert topn_scores_kernel.launches == before + 1
    ref = topn_scores_ref(*args, 3.5, min(n + 1, Q.shape[0]), *r,
                          bf16_dot=fast, packed=fast)
    ok, err, swaps = topn_agreement(idx.cpu(), s.cpu(), ref[0].cpu(),
                                    ref[1].cpu(), n,
                                    **(FAST if fast else EXACT))
    assert ok, (err, swaps)
    return idx.cpu().numpy(), s.cpu().numpy()


@pytest.mark.parametrize('mode', list(K3_MODES))
@pytest.mark.parametrize('shape', [
    # B off the 64-user tile
    (1, 5000, 64, 10, 20), (65, 5000, 64, 10, 20), (129, 3001, 64, 10, 20),
    (1025, 2000, 64, 10, 20),
    # I under one 128-item tile
    (9, 100, 64, 10, 5), (9, 11, 64, 10, 0),
    # n either side of the running list's limit, and the largest n
    (17, 4000, 64, 1, 30), (17, 4000, 64, 32, 30), (17, 4000, 64, 33, 30),
    (7, 3000, 64, 1024, 30),
    # k off the 128-byte chunk
    (40, 3000, 1, 10, 10), (40, 3000, 3, 10, 10), (40, 3000, 66, 10, 10),
    (40, 3000, 256, 10, 10), (40, 3000, 256, 40, 10)])
def test_kernel_edge_shapes(cuda, mode, shape):
    B, I, k, n, L = shape
    _k3_check(cuda, *_case(B, I, k, L, seed=I + k), n, mode)


@pytest.mark.parametrize('mode', list(K3_MODES))
@pytest.mark.parametrize('n', [10, 32, 33])
def test_kernel_one_item_past_a_split(cuda, mode, n, monkeypatch):
    '''A split of one tile that holds one item (splits of one tile
    allowed for the case).'''
    from mfrec_tpu_torch.ops import topn_kernel as tk
    monkeypatch.setattr(tk, 'MIN_TILES_PER_SPLIT', 1)
    fast, q_bf16 = K3_MODES[mode]
    slots = tk._slots(tk._library(), cuda, int(q_bf16), 64, n, fast)
    I = _one_past_split(70, n, slots)
    idx, _ = _k3_check(cuda, *_case(70, I, 64, 20, seed=3), n, mode)
    assert idx.max() < I


@pytest.mark.parametrize('mode', list(K3_MODES))
@pytest.mark.parametrize('n', [7, 32, 40])
def test_kernel_ties_order_by_id(cuda, mode, n):
    B, I = 70, 3001
    P, Q, bu, bi, ridx, rmask = _edge_inputs(B, I, 64, n, 0, 'ties', 5)
    Pz = P.copy()
    idx, s = _k3_check(cuda, Pz, Q, bu, bi, ridx, rmask, n, mode)
    # equal scores keep the lower id first
    same = s[:, 1:] == s[:, :-1]
    assert (idx[:, 1:][same] > idx[:, :-1][same]).all()
    assert same.any()


@pytest.mark.parametrize('mode', list(K3_MODES))
@pytest.mark.parametrize('n', [10, 33])
def test_kernel_rated_on_tile_bounds(cuda, mode, n):
    from mfrec_tpu_torch.ops.topn_kernel import ITEM_TILE
    B, I = 66, 5000
    P, Q, bu, bi, ridx, rmask = _edge_inputs(B, I, 64, n, 0, 'bounds', 6)
    # the bounds score best, so a missed mask shows
    bi[ridx[0]] += 50.0
    idx, _ = _k3_check(cuda, P, Q, bu, bi, ridx, rmask, n, mode)
    assert not np.isin(idx, ridx[0]).any()
    assert ridx[0][1] == ITEM_TILE - 1


@pytest.mark.parametrize('mode', list(K3_MODES))
@pytest.mark.parametrize('n', [5, 32, 40])
def test_kernel_all_but_n_minus_1_rated(cuda, mode, n):
    B, I = 9, 3000
    idx, s = _k3_check(cuda, *_edge_inputs(B, I, 64, n, 30, 'all_but', 7),
                       n, mode)
    assert (s[0, :n - 1] > -1e38).all() and s[0, n - 1] < -1e38


K1_TOL = dict(atol=5e-3, rtol=5e-2)


def _k1_batches(nb, B, W, n_upd, n_fix, seed):
    rng = np.random.default_rng(seed)
    lo = np.sort(rng.integers(0, n_upd - W, nb)).astype(np.int32)
    kl = np.sort(rng.integers(0, W, (nb, B)), axis=1).astype(np.int32)
    m = (rng.random((nb, B)) > 0.1).astype(np.float32)
    r = rng.uniform(1, 5, (nb, B)).astype(np.float32)
    fix = rng.integers(0, n_fix, (nb, B)).astype(np.int32)
    return fix, r, m, kl, lo


def _stage_batches(kind, cap, n_fix, seed):
    '''Batches whose segments sit around K1's staging capacity ``cap``
    (window W = 8, rows 0..7 from lo = 0): ``'straddle'``, one batch with
    segments of cap - 1, cap and cap + 1 entries beside short rows;
    ``'mixed'``, three batches in which row 0's segments are cap - 5,
    cap + 7 and 3 entries long, so that one row's segments take both
    paths; ``'cluster'``, a row of CLUSTER_ROW ratings over three batches
    (a cluster row, each block staging up to ``cap`` of its slice).'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    rng = np.random.default_rng(seed)
    if kind == 'straddle':
        lens = [[cap - 1, cap, cap + 1] + [20] * 5]
    elif kind == 'mixed':
        lens = [[cap - 5] + [30] * 7, [cap + 7] + [30] * 7, [3] + [30] * 7]
    else:
        third = hk.CLUSTER_ROW // 3
        lens = [[third] + [40] * 7, [third] + [40] * 7,
                [hk.CLUSTER_ROW - 2 * third] + [40] * 7]
    B = max(sum(x) for x in lens) + 16
    nb = len(lens)
    kl = np.zeros((nb, B), np.int32)
    m = np.zeros((nb, B), np.float32)
    for b, row_lens in enumerate(lens):
        ids = np.repeat(np.arange(8), row_lens)
        kl[b, :ids.size] = ids
        m[b, :ids.size] = 1.0
    r = rng.uniform(1, 5, (nb, B)).astype(np.float32)
    fix = rng.integers(0, n_fix, (nb, B)).astype(np.int32)
    return fix, r, m, kl, np.zeros(nb, np.int32)


@pytest.mark.parametrize('k,opts', [
    (66, {}), (66, {'link': 'logistic', 'clamp_pred': False}),
    (66, {'bias_none': True}), (66, {'row_mean': False}),
    (66, {'clamp_pred': False}), (130, {}), (10, {'f32_fix': True}),
    (102, {}), (102, {'f32_fix': True}),
    (66, {'f32_fix': True, 'link': 'logistic', 'clamp_pred': False}),
    (66, {'stage': 'straddle'}), (102, {'stage': 'straddle', 'f32_fix': True}),
    (130, {'stage': 'straddle'}), (66, {'stage': 'mixed'}),
    (102, {'stage': 'mixed', 'f32_fix': True}),
    (66, {'stage': 'mixed', 'link': 'logistic', 'clamp_pred': False}),
    (66, {'stage': 'cluster'}), (102, {'stage': 'cluster', 'f32_fix': True})])
def test_half_pass_kernel_matches_plain(cuda, k, opts):
    '''K1 against its plain version, and a second launch from the same
    factors bit-identical.  ``stage``: segments below, at and above the
    staging capacity, a row whose segments take both paths, or a cluster
    row (``_stage_batches``), at the capacity the kernel states
    (``stage_geometry``); the split ``stage_split`` counts holds the
    entries either side of it.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    opts = dict(opts)
    f32_fix = opts.pop('f32_fix', False)
    stage = opts.pop('stage', None)
    nb, B, W, n_upd, n_fix, T = 5, 2048, 64, 400, 300, 16
    link = opts.get('link', 'identity')
    cap = hk.stage_geometry(k, not f32_fix, link=link)[0]
    if stage is None:
        batches = _k1_batches(nb, B, W, n_upd, n_fix, seed=k)
    else:
        W = 8
        batches = _stage_batches(stage, cap, n_fix, seed=k)
    rng = np.random.default_rng(1)
    F0 = torch.from_numpy(
        rng.normal(0, 0.1, (n_upd, k)).astype(np.float32)).to(cuda)
    Ffix = torch.from_numpy(
        rng.normal(0, 0.1, (n_fix, k)).astype(np.float32)).to(cuda)
    if not f32_fix:
        Ffix = Ffix.to(torch.bfloat16)
    lrv = torch.full((k,), 0.01 if opts.get('row_mean') is False else 0.1,
                     device=cuda)
    lrv[-1] = 0.0
    regv = torch.full((k,), 0.02, device=cuda)
    seg = hk.build_segments(*batches, W, cuda)
    resident, streamed = hk.stage_split(
        seg, *hk.stage_caps(k, not f32_fix, link))
    assert resident + streamed == int(seg.ent_r.numel())
    if stage == 'straddle':
        assert streamed == 1
    elif stage == 'mixed':
        assert streamed == 7
    elif stage == 'cluster':
        assert seg.n_cluster == 1
    tb = tuple(torch.from_numpy(a).to(cuda) for a in batches)
    mu = 0.0 if opts.get('link') == 'logistic' else 3.4
    Fk, Fp, Fa = F0.clone(), F0.clone(), F0.clone()
    before = hk.half_pass.launches
    sse_k = hk.half_pass(Fk, Ffix, tb, W, lrv, regv, mu, T, segments=seg,
                         **opts)
    torch.cuda.synchronize()
    assert hk.half_pass.launches == before + 1
    sse_a = hk.half_pass(Fa, Ffix, tb, W, lrv, regv, mu, T, segments=seg,
                         **opts)
    sse_p = hk.half_pass_ref(Fp, Ffix, tb, W, lrv, regv, mu, T, **opts)
    torch.testing.assert_close(Fk, Fp, **K1_TOL)
    assert abs(float(sse_k) - float(sse_p)) <= 1e-3 * float(sse_p)
    assert torch.equal(Fk, Fa) and float(sse_k) == float(sse_a)
    assert torch.equal(Fk[:, -1], F0[:, -1])            # frozen column
    assert float((Fk - F0).abs().max()) > 0


@pytest.mark.parametrize('link', ['identity', 'logistic'])
@pytest.mark.parametrize('fix_bf16', [True, False])
@pytest.mark.parametrize('k', [6, 64, 66, 102, 128, 130, 160, 256])
def test_half_pass_stage_fits_blocks_per_sm(cuda, k, fix_bf16, link):
    '''K1's staging capacity and the occupancy it was sized for, as the
    kernel computes them (``stage_geometry``): an 8-warp block holds its
    staged entries four to an SM at up to four column slots (k <= 128),
    at least two beyond; a cluster row's block (k <= WIDE_MAX_K) two to
    an SM, over CLUSTER slices, staging more than an 8-warp block.  A
    change to the kernel's shared-memory layout that costs a block an SM
    fails here.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    cap, slices, blocks = hk.stage_geometry(k, fix_bf16, link=link)
    assert slices == 1 and cap >= 32
    if -(-k // 32) <= 4:
        assert blocks == 4
    else:
        assert blocks >= 2
    if k <= hk.WIDE_MAX_K:
        cap_c, slices_c, blocks_c = hk.stage_geometry(k, fix_bf16, True,
                                                      link)
        assert (slices_c, blocks_c) == (8, 2) and cap_c > cap
        assert hk.stage_caps(k, fix_bf16, link) == (cap, (cap_c, slices_c))
    else:
        assert hk.stage_caps(k, fix_bf16, link) == (cap, None)
    if (k, fix_bf16) == (66, True):
        assert (cap, cap_c) == (360, 726)
    if (k, fix_bf16) == (102, False):
        assert (cap, cap_c) == (117, 240)


def test_half_pass_bf16_round_matches_torch(cuda):
    '''K1's product rounding (``bf16_round2``: one packed conversion for
    two values) against torch's bf16 conversion (round to nearest even)
    on every finite f32 bit pattern, subnormals and the values that round
    up to +-inf among them, 2^28 patterns at a time; bits compared.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    step = 1 << 28
    checked = 0
    for start in range(0, 1 << 32, step):
        bits = torch.arange(start, start + step, dtype=torch.int64,
                            device=cuda)
        bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
            torch.int32)
        x = bits.view(torch.float32)
        del bits
        finite = torch.isfinite(x)
        got = hk.bf16_round_kernel(x).view(torch.int32)
        want = x.to(torch.bfloat16).float().view(torch.int32)
        assert torch.equal(got[finite], want[finite]), hex(start)
        checked += int(finite.sum())
    assert checked == (1 << 32) - (1 << 24)      # all but exponent 255


def test_half_pass_kernel_long_rows(cuda):
    '''Rows of at least CLUSTER_ROW ratings run as thread-block clusters
    on a second stream beside the 8-warp blocks: both against the plain
    version.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    nb, B, W, k, T = 3, 8192, 16, 66, 8
    rng = np.random.default_rng(9)
    kl = np.sort(rng.integers(0, W, (nb, B)), axis=1).astype(np.int32)
    kl[:, : 3 * B // 4] = 0                  # one row of 3 x 6144 + ratings
    lo = np.zeros(nb, np.int32)
    m = np.ones((nb, B), np.float32)
    r = rng.uniform(1, 5, (nb, B)).astype(np.float32)
    fix = rng.integers(0, 500, (nb, B)).astype(np.int32)
    seg = hk.build_segments(fix, r, m, kl, lo, W, cuda)
    assert seg.n_cluster == 1 and seg.longest >= 9 * B // 4
    F0 = torch.from_numpy(
        rng.normal(0, 0.1, (W, k)).astype(np.float32)).to(cuda)
    Ffix = torch.from_numpy(rng.normal(0, 0.1, (500, k)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    lrv = torch.full((k,), 0.1, device=cuda)
    regv = torch.full((k,), 0.02, device=cuda)
    tb = tuple(torch.from_numpy(a).to(cuda) for a in (fix, r, m, kl, lo))
    Fk, Fp = F0.clone(), F0.clone()
    sse_k = hk.half_pass(Fk, Ffix, tb, W, lrv, regv, 3.4, T, segments=seg)
    sse_p = hk.half_pass_ref(Fp, Ffix, tb, W, lrv, regv, 3.4, T)
    torch.testing.assert_close(Fk, Fp, **K1_TOL)
    assert abs(float(sse_k) - float(sse_p)) <= 1e-3 * float(sse_p)


def test_cuda_epoch_matches_cpu_epoch(cuda):
    '''The epoch with use_kernel=True on CUDA tensors (K1) against the
    same epoch on CPU tensors (K1's plain version).'''
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import sgd_mf
    u, i, v = synthetic_ratings(500, 300, 20000, rank=4, seed=4)
    keep = np.unique(u.astype(np.int64) * 300 + i, return_index=True)[1]
    u, i, v = u[keep], i[keep], v[keep]
    W, k = 64, 18
    lay = {a: sgd_mf.sorted_pass_layout(u, i, v, 4096, axis=a,
                                        max_window=W)
           for a in ('user', 'item')}
    rng = np.random.default_rng(0)
    Pa, Qa = sgd_mf.augment_factors(
        rng.normal(0, 0.1, (500 + W, k - 2)).astype(np.float32),
        rng.normal(0, 0.1, (300 + W, k - 2)).astype(np.float32),
        np.zeros(500 + W, np.float32), np.zeros(300 + W, np.float32))
    ep = sgd_mf.make_alternating_epoch(W, W, 0.15, 0.02, inner_steps=32,
                                       use_kernel=True)
    out = {}
    for dev in ('cpu', 'cuda'):
        pl_ = sgd_mf.PassLayout(lay['user'], 'user', dev,
                                segments=dev == 'cuda')
        ql_ = sgd_mf.PassLayout(lay['item'], 'item', dev,
                                segments=dev == 'cuda')
        # copies: the epoch updates the factors in place
        P = torch.from_numpy(Pa.copy()).to(dev)
        Q = torch.from_numpy(Qa.copy()).to(dev)
        before = hk.half_pass.launches
        for _ in range(2):
            P, Q, rmse = ep(P, Q, float(v.mean()), pl_, ql_)
        assert hk.half_pass.launches == before + (4 if dev == 'cuda' else 0)
        out[dev] = (P.cpu(), Q.cpu(), float(rmse))
    torch.testing.assert_close(out['cuda'][0], out['cpu'][0], **K1_TOL)
    torch.testing.assert_close(out['cuda'][1], out['cpu'][1], **K1_TOL)
    assert out['cuda'][2] == pytest.approx(out['cpu'][2], rel=1e-3)


def test_cuda_model_trains_through_k1(cuda):
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    u, i, v = synthetic_ratings(800, 400, 30000, rank=4, seed=5)
    m = GDRecommender(800, 400, {'nbr_features': 16, 'min_epochs': 3,
                                 'max_epochs': 3, 'inner_steps': 32,
                                 'feature_init': 0.05}, device='cuda')
    m.set_ratings(u, i, v)
    before = hk.half_pass.launches
    m.train(handle_bias=True)
    assert hk.half_pass.launches == before + 6
    h = m.get_rmse_history()
    assert np.isfinite(h).all() and h[-1] < h[0]
    assert m.P.shape == (800, 16) and isinstance(m.P, np.ndarray)
    idx, _ = m.recommend_batch(np.arange(8), 5)
    assert idx.shape == (8, 5)


# K2: the tolerance of tests/test_als.py:303 (f32 sums in another order)
K2_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize('start', ['spd', 'cold'])
@pytest.mark.parametrize('steps', [0, 1, 5])
@pytest.mark.parametrize('k', [8, 20, 64, 130, 256])
def test_pcg_kernel_matches_plain(cuda, k, steps, start):
    '''R=37 (no multiple of a block's 4 systems); k=256 streams M from
    device memory, the others keep it in shared memory.'''
    import chip_smoke
    from mfrec_tpu_torch.ops import cg_kernel
    M, b, x0 = chip_smoke.pcg_systems(37, k, start, seed=k + steps,
                                      device='cuda')
    before = cg_kernel.pcg_solve_kernel.launches
    got = cg_kernel.pcg_solve_kernel(M, b, x0, steps)
    torch.cuda.synchronize()
    assert cg_kernel.pcg_solve_kernel.launches == before + 1
    torch.testing.assert_close(got, cg_kernel.pcg_solve_ref(M, b, x0, steps),
                               **K2_TOL)
    if steps == 0:
        assert torch.equal(got, x0)


@pytest.mark.parametrize('kind', ['b0', 'solved', 'identity', 'asym'])
@pytest.mark.parametrize('k', [20, 64, 256])
def test_pcg_kernel_guards_and_asymmetric(cuda, kind, k):
    import chip_smoke
    from mfrec_tpu_torch.ops import cg_kernel
    M, b, x0 = chip_smoke.pcg_systems(37, k, kind, seed=3, device='cuda')
    if kind == 'asym':
        assert float((M - M.transpose(1, 2)).abs().max()) > 0
    got = cg_kernel.pcg_solve_kernel(M, b, x0, 5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, cg_kernel.pcg_solve_ref(M, b, x0, 5),
                               **K2_TOL)
    if kind == 'solved':
        assert torch.equal(got, x0)


# the fused K2 (gather, tensor-core Gram, PCG, write-back in one launch):
# M and b against a float64 Gram of the same bf16 operands within
# chip_smoke.gram_within's bound, (ceil(count / 32) + 72) 2^-24 of the
# absolute sum of the terms (plus 2^-24 |HHreg|; b: + 36): the tensor
# cores' truncating accumulation over a chunk of 32 exact products, then
# one IEEE add per chunk.  x against the plain version within K2_TOL, or as close
# to the float64 iteration as the plain version within a factor of 2
# (chip_smoke.cg_bucket_case: f32 PCG trajectories drift apart mid-solve).
@pytest.mark.parametrize('alpha', [0.0, 2.0])
@pytest.mark.parametrize('steps', [0, 3, 6])
@pytest.mark.parametrize('L', [8, 64, 1024, 16384])
@pytest.mark.parametrize('k', [8, 20, 64, 130, 256])
def test_cg_bucket_kernel_matches_plain(cuda, k, L, steps, alpha):
    '''R=37 rows of random counts (R=3 with one full row at L=16,384, the
    hot item's regime); k=8 and 20 pad the tiles with zero columns, k=20
    and 130 the fixed side's rows to 16 bytes, k=256 streams M.'''
    import chip_smoke
    d = chip_smoke.cg_bucket_data(3 if L >= 16384 else 37, L, k,
                                  seed=k + L + steps, device='cuda',
                                  hot=L >= 16384)
    rec = chip_smoke.cg_bucket_case('k=%d L=%d' % (k, L), d, steps,
                                    c_pos=1.7, alpha=alpha)
    assert rec['launches'] == 1
    assert rec['untouched']
    assert rec['gram_ok'], rec
    assert rec['ok'], rec


@pytest.mark.parametrize('kind', ['holes', 'empty_row', 'two_a_block',
                                  'odd_L'])
@pytest.mark.parametrize('k', [20, 64, 130])
def test_cg_bucket_kernel_masks_and_blocks(cuda, kind, k):
    '''Masks with holes inside a row's count (the count is found from the
    mask, not assumed a prefix), a row with no entry (M = HHreg, b = 0),
    R=4,099 rows (two systems a block), and L=37 (rows of ids, values and
    mask that are no whole 16-byte copies: 4-byte copies).'''
    import chip_smoke
    R = 4099 if kind == 'two_a_block' else 37
    d = chip_smoke.cg_bucket_data(R, 37 if kind == 'odd_L' else 256, k,
                                  seed=k, device='cuda',
                                  holes=kind == 'holes',
                                  empty_row=kind == 'empty_row')
    rec = chip_smoke.cg_bucket_case(kind, d, 3, c_pos=1.7, alpha=2.0)
    assert rec['ok'], rec


def test_cg_bucket_kernel_guards(cuda):
    '''R=0 launches nothing; what the kernel does not take raises (the
    fixed side too narrow or off a 16-byte boundary included); a second
    launch on the same inputs gives the same bits.'''
    import chip_smoke
    from mfrec_tpu_torch.ops import cg_kernel
    d = chip_smoke.cg_bucket_data(37, 64, 64, seed=1, device='cuda')
    args = (d['HH'], d['rows'], d['idx'], d['val'], d['mask'], 1.0, 2.0, 3)
    a = cg_kernel.cg_bucket_kernel(d['Fb'], d['out'].clone(), *args)
    b = cg_kernel.cg_bucket_kernel(d['Fb'], d['out'].clone(), *args)
    assert torch.equal(a, b)
    before = cg_kernel.cg_bucket_kernel.launches
    e = chip_smoke.cg_bucket_data(0, 8, 64, seed=0, device='cuda')
    cg_kernel.cg_bucket_kernel(e['Fb'], e['out'], e['HH'], e['rows'],
                               e['idx'], e['val'], e['mask'], 1.0, 0.0, 3)
    assert cg_kernel.cg_bucket_kernel.launches == before
    buf = torch.zeros(d['Fb'].numel() + 1, dtype=torch.bfloat16,
                      device=cuda)
    bad = [dict(Fb=d['Fb'].float()), dict(rows=d['rows'].long()),
           dict(mask=d['mask'][:, :32]), dict(out=d['out'].t()),
           dict(HH=d['HH'].cpu()), dict(Fb=d['Fb'][:, :56].contiguous()),
           dict(Fb=buf[1:].view(d['Fb'].shape))]
    for over in bad:
        kw = dict(d, **over)
        with pytest.raises(ValueError):
            cg_kernel.cg_bucket_kernel(kw['Fb'], kw['out'], kw['HH'],
                                       kw['rows'], kw['idx'], kw['val'],
                                       kw['mask'], 1.0, 0.0, 3)


def test_als_products_are_full_f32(cuda):
    '''With TF32 switched on process-wide, the ALS path's f32 products
    (the Gram HHreg, the bucket Gram, the plain loop's mat-vec) still
    agree with a float64 product to f32 accuracy; TF32 keeps about three
    decimal digits.'''
    import chip_smoke
    from mfrec_tpu_torch.ops import als
    prev = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rng = np.random.default_rng(6)
        F = torch.from_numpy(rng.normal(0, 0.3, (5000, 64)).astype(
            np.float32)).to(cuda)
        HH = als._hh(F, 0.015)
        want = F.double().T @ F.double() + 0.015 * torch.eye(
            64, dtype=torch.float64, device=cuda)
        torch.testing.assert_close(HH.double(), want, atol=1e-4, rtol=1e-5)
        M, b, x0 = chip_smoke.pcg_systems(64, 64, 'asym', seed=2,
                                          device='cuda')
        x = als.pcg_solve(M, b, x0, 3)
        assert torch.get_float32_matmul_precision() == 'high'
        ref = als.pcg_solve(M.double(), b.double(), x0.double(), 3)
        torch.testing.assert_close(x.double(), ref, atol=1e-5, rtol=1e-4)
    finally:
        torch.set_float32_matmul_precision(prev)


def test_cuda_wrmf_trains_through_k2(cuda):
    '''solver='cg' on CUDA: every bucket is one launch of the fused K2 (and
    none of the M-given entry), and the model lands where the same model on the CPU (the plain loop) does;
    the exact solver on CUDA against the CPU too.'''
    import chip_smoke
    from mfrec_tpu_torch.models.wrmf import WRMFRecommender
    from mfrec_tpu_torch.ops import cg_kernel
    u, i, _, _ = chip_smoke.make_implicit_data(900, 300, 40000, seed=2)
    ones = np.ones(u.shape[0], np.float32)
    # two epochs (6 PCG steps, then 3): the ALS iteration is chaotic over
    # many epochs, so longer runs are compared by objective, not factors
    for params in ({'solver': 'cg', 'cg_steps': 6, 'cg_warm_steps': 3,
                    'cg_warmup_epochs': 1, 'nbr_epochs': 2},
                   {'solver': 'exact', 'nbr_epochs': 1}):
        out = {}
        for dev in ('cuda', 'cpu'):
            m = WRMFRecommender(900, 300, dict(params, nbr_features=32),
                                device=dev)
            m.seed(1)
            m.set_ratings(u, i, ones)
            before = cg_kernel.cg_bucket_kernel.launches
            before_pcg = cg_kernel.pcg_solve_kernel.launches
            m.train()
            n = len(m.ratings.padded_rows(axis='user')) + \
                len(m.ratings.padded_rows(axis='item'))
            want = n * params['nbr_epochs'] \
                if dev == 'cuda' and params['solver'] == 'cg' else 0
            assert cg_kernel.cg_bucket_kernel.launches == before + want
            assert cg_kernel.pcg_solve_kernel.launches == before_pcg
            out[dev] = m.P @ m.Q.T
        rms = float(np.sqrt(((out['cuda'] - out['cpu']) ** 2).mean()))
        assert rms < 1e-3, (params['solver'], rms)


# K4: the same bf16 rows, f32 sums in another order
K4_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('k,W,B,case', [
    (8, 64, 3000, 'random'), (64, 512, 16384, 'sorted'),
    (66, 128, 16384, 'sorted'), (130, 512, 3001, 'random'),
    (256, 16, 2000, 'one_id'), (1, 1, 777, 'random'),
    (66, 128, 4096, 'all_masked'), (33, 40, 0, 'random'),
    (66, 128, 16384, 'one_id'), (16, 512, 100, 'random'),
    (64, 4000, 9000, 'random'), (256, 1, 300, 'random')])
def test_window_agg_kernel_matches_plain(cuda, k, W, B, case):
    '''Unsorted and sorted ids, one row holding the whole batch, mostly
    empty rows (B < W), W=1, k=1 and 256, and a window too wide for the
    index list's counts in shared memory (W=4000).'''
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    rng = np.random.default_rng(k + W + B)
    g = rng.normal(0, 1, (B, k)).astype(np.float32)
    kl = rng.integers(0, W, B).astype(np.int32)
    if case == 'sorted':
        kl.sort()
    elif case == 'one_id':
        kl[:] = W // 2
    m = (rng.random(B) > 0.1).astype(np.float32)
    if case == 'all_masked':
        m[:] = 0.0
    t = [torch.from_numpy(a).to(cuda) for a in (g, kl, m)]
    before = wak.window_aggregate.launches
    gs, cnt = wak.window_aggregate(*t, W)
    torch.cuda.synchronize()
    assert wak.window_aggregate.launches == before + 1
    rs, rc = wak.window_aggregate_ref(*t, W)
    assert torch.equal(cnt, rc)
    torch.testing.assert_close(gs, rs, **K4_TOL)
    again, _ = wak.window_aggregate(*t, W)
    assert torch.equal(again, gs)                   # no atomics


@pytest.mark.parametrize('mean', [False, True])
@pytest.mark.parametrize('k', [10, 64, 200])
def test_scan_aggregate_kernel_matches_plain(cuda, k, mean):
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    u, i, v = synthetic_ratings(400, 300, 30000, rank=4, seed=k)
    lay = sgd_mf.sorted_pass_layout(u, i, v, 2048, axis='item',
                                    max_window=64)
    seg = hk.build_segments(lay[0], lay[2], lay[3], lay[4], lay[5], 64, cuda)
    rng = np.random.default_rng(k)
    vals = torch.from_numpy(rng.normal(0, 1, (int(seg.ent_r.shape[0]), k))
                            .astype(np.float32)).to(cuda)
    t0 = torch.from_numpy(rng.normal(0, 1, (300 + 64, k)).astype(
        np.float32)).to(cuda)
    before = wak.scan_aggregate.launches
    got = wak.scan_aggregate(t0.clone(), vals, seg, mean)
    torch.cuda.synchronize()
    assert wak.scan_aggregate.launches == before + 1
    want = wak.scan_aggregate_ref(t0.clone(), vals, seg, mean)
    torch.testing.assert_close(got, want, **K4_TOL)


# K4's gathered phases against their plain versions.  The sum mode sums
# the same bf16 rows as the plain version, in another f32 order where a
# heavy row's warps split a segment: K4_TOL, or, where that row's long
# sum cancels, at most twice as far from the float64 sum of the same bf16
# rows as the plain version (``chip_smoke._k4_ok``, as K4's phase entry
# is held on the whole ML-10M layouts).  The error mode's dot is a
# warp's fused multiply-adds where the plain version rounds each product
# and sums in torch's order, so an error may differ by an f32 ulp and
# round one term err * q to the neighbouring bf16 value (about one term
# in 10^5): each such flip moves a row's sum by at most 2^-8 of the
# largest term, and under 1 % of the elements differ beyond K4_TOL.
AGG_FLIP = 2.0 ** -7


@pytest.mark.parametrize('mode', ['gather', 'error'])
@pytest.mark.parametrize('k', [3, 64, 100, 256])
def test_gather_aggregate_kernels_match_plain(cuda, mode, k,
                                              record_property):
    '''``gather_aggregate`` and ``error_aggregate`` against their plain
    versions on a user layout with a heavy user above the block threshold
    (AGG_BLOCK_ROW) over several batches, users with one rating and users
    with none; k is the gathered rows' width (the error mode's target is
    k - 2 wide, as Qaug is to G); a second launch is bit-identical.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    rng = np.random.default_rng(k + len(mode))
    U, I, N, W = 700, 3000, 40000, 64
    u = rng.integers(0, U - 100, N).astype(np.int32)
    u[:5000] = 3                     # a heavy user over several batches
    u[5000:5040] = np.arange(U - 100, U - 60)       # one rating each
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.uniform(1, 5, N).astype(np.float32)
    lay = sgd_mf.sorted_pass_layout(u, i, v, 2048, axis='user',
                                    max_window=W)
    seg = hk.build_segments(lay[1], lay[2], lay[3], lay[4], lay[5], W, cuda)
    assert int(seg.blk_len[0]) >= wak.AGG_BLOCK_ROW
    assert seg.longest_segments >= 2
    kt = k if mode == 'gather' else k - 2
    src = torch.from_numpy(rng.normal(0, 1, (I + W, k)).astype(
        np.float32)).to(cuda)
    t0 = torch.from_numpy(rng.normal(0, 1, (U + W, kt)).astype(
        np.float32)).to(cuda)
    if mode == 'gather':
        run, ref, args = wak.gather_aggregate, wak.gather_aggregate_ref, \
            (src, seg)
    else:
        prow = torch.from_numpy(rng.normal(0, 0.3, (U + W, k)).astype(
            np.float32)).to(cuda)
        run, ref, args = wak.error_aggregate, wak.error_aggregate_ref, \
            (prow, src, seg, 3.6, 1.0, 5.0)
    before = run.launches
    got = run(t0.clone(), *args)
    again = run(t0.clone(), *args)
    torch.cuda.synchronize()
    assert run.launches == before + 2
    want = ref(t0.clone(), *args)
    assert torch.equal(got, again)
    assert torch.equal(got[U - 50:U], t0[U - 50:U])          # no ratings
    assert float((want - t0).abs().max()) > 0
    diff = (got - want).abs()
    tol = K4_TOL['atol'] + K4_TOL['rtol'] * want.abs()
    if mode == 'gather':
        import chip_smoke
        exact = wak.scan_aggregate_ref(t0.double(), src[seg.ent_fix.long()],
                                       seg)
        ok, err, k64, p64 = chip_smoke._k4_ok(got, want, exact)
        record_property('gather_mode', dict(max_abs_err=err,
                                            kernel_err_f64=k64,
                                            plain_err_f64=p64))
        assert ok, (err, k64, p64)
        return
    f = seg.ent_fix.long()
    d = (prow[seg.ent_row.long()] * src[f]).sum(-1) + 3.6
    terms = ((seg.ent_r - d.clamp(1.0, 5.0)) * seg.ent_m)[:, None] * \
        src[f][:, :kt]
    tmax = float(terms.abs().max())
    over = float((diff > tol).float().mean())
    record_property('error_mode', dict(max_abs_err=float(diff.max()),
                                       largest_term=tmax, share_over=over))
    assert bool((diff <= tol + AGG_FLIP * tmax).all())
    assert over < 1e-2


@pytest.mark.parametrize('rounded', [True, False])
@pytest.mark.parametrize('k', [3, 64, 100, 256])
def test_profile_aggregate_kernel_matches_plain(cuda, k, rounded,
                                                record_property):
    '''``profile_aggregate`` (FN's phase 1; unrounded, the served
    profiles) against its plain version on a user layout whose heaviest
    user has 17,653 ratings (the Netflix Prize set's most, over several
    batches: the 16-warp block path), a user above AGG_BLOCK_ROW in one
    batch, users with one rating and users with none.  Kernel and plain
    version make the same rows (the product rounded, then the sum: no
    FMA), so the rows' bf16 values agree and only a heavy row's f32 sum
    order differs: K4_TOL, or at most twice as far from the float64 sum
    of the same rows as the plain version (``chip_smoke._k4_ok``).  A
    second launch is bit-identical.'''
    import chip_smoke
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    rng = np.random.default_rng(k + 7 * rounded)
    U, I, N, W = 900, 18000, 60000, 64
    u = rng.integers(10, U - 100, N).astype(np.int32)
    u[:17653] = 3                    # the heaviest user, several batches
    u[17653:20653] = 5               # above AGG_BLOCK_ROW
    u[20653:20693] = np.arange(U - 100, U - 60)      # one rating each
    i = rng.integers(0, I, N).astype(np.int32)
    i[:17653] = rng.permutation(I)[:17653]
    v = (rng.integers(2, 11, N) / 2).astype(np.float32)
    lay = sgd_mf.sorted_pass_layout(u, i, v, 4096, axis='user',
                                    max_window=W)
    seg = hk.build_segments(lay[1], lay[2], lay[3], lay[4], lay[5], W, cuda)
    assert seg.longest == 17653 and seg.longest_segments >= 4
    assert int((seg.blk_len >= wak.AGG_BLOCK_ROW).sum()) == 2

    def t(*shape, s=1.0):
        return torch.from_numpy(rng.normal(0, s, shape).astype(
            np.float32)).to(cuda)

    X, Y, bi = t(I + W, k, s=0.05), t(I + W, k, s=0.05), t(I + W, s=0.3)
    bu, t0 = t(U + W, s=0.3), t(U + W, k)
    mu = torch.tensor(3.6)
    args = (X, Y, bu, bi, seg, mu, rounded)
    before = wak.profile_aggregate.launches
    got = wak.profile_aggregate(t0.clone(), *args)
    again = wak.profile_aggregate(t0.clone(), *args)
    torch.cuda.synchronize()
    assert wak.profile_aggregate.launches == before + 2
    want = wak.profile_aggregate_ref(t0.clone(), *args)
    assert torch.equal(got, again)
    assert torch.equal(got[U - 50:U], t0[U - 50:U])          # no ratings
    f = seg.ent_fix.long()
    res = seg.ent_r - (mu.to(cuda) + bu[seg.ent_row.long()] + bi[f])
    rows = res[:, None] * X[f] + Y[f]
    exact = wak.scan_aggregate_ref(t0.double(), rows, seg, rounded=rounded)
    ok, err, k64, p64 = chip_smoke._k4_ok(got, want, exact)
    record_property('profile_mode', dict(max_abs_err=err, kernel_err_f64=k64,
                                         plain_err_f64=p64))
    assert ok, (err, k64, p64)


def test_fn_epoch_memory_does_not_scale_with_entries(cuda):
    '''An FN epoch on CUDA layouts with segment tables, and the served
    profiles after it, hold no tensor of one row an entry: their peak
    memory above the inputs stays under a few [U, k+2] factor tensors
    and the per-entry scalars of the X/Y step, at a shape where one [n,
    k] f32 tensor would be 10 times that.'''
    from mfrec_tpu_torch.ops import fn as fn_ops
    from mfrec_tpu_torch.ops import sgd_mf
    U, I, N, k, W = 2000, 400, 2_000_000, 100, 512
    rng = np.random.default_rng(7)
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.uniform(1, 5, N).astype(np.float32)
    pl_, ql_ = (sgd_mf.PassLayout(sgd_mf.sorted_pass_layout(
        u, i, v, 16384, axis=a, max_window=W), a, cuda, segments=True)
        for a in ('user', 'item'))

    def t(*shape, s=0.05):
        return torch.from_numpy(rng.normal(0, s, shape).astype(
            np.float32)).to(cuda)

    Pa, Qa = sgd_mf.augment_factors(torch.zeros((U + W, k), device=cuda),
                                    t(I + W, k), t(U + W), t(I + W))
    X, Y = t(I + W, k), t(I + W, k)
    nrm = torch.full((U + W,), 1.0 / np.sqrt(N / U), device=cuda)
    ep = fn_ops.make_fn_alternating_epoch(
        W, W, 0.15, 0.15, 0.15, 0.15, 0.015, 0.007, 0.007, inner_steps=4,
        use_kernel=True)
    mu = torch.tensor(3.6)
    ep(Pa, Qa, X, Y, mu, pl_, ql_, nrm)              # builds, warms up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    *_, rmse = ep(Pa, Qa, X, Y, mu, pl_, ql_, nrm)
    served = fn_ops.user_profiles(fn_ops.FNState(
        Q=Qa[:I, :k], X=X[:I], Y=Y[:I], bu=Pa[:, k], bi=Qa[:I, k + 1],
        mu=mu), pl_, nrm)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - base
    factor = Pa.nbytes
    assert np.isfinite(float(rmse)) and bool(torch.isfinite(served).all())
    # the X/Y step's residuals and their terms: 20 bytes an entry
    assert above <= 12 * factor + 20 * N, (above, factor)
    assert above * 10 < N * k * 4, (above, N * k * 4)


def test_svdpp_epoch_memory_does_not_scale_with_entries(cuda):
    '''An SVD++ epoch on a CUDA layout with a segment table holds no
    tensor of one row an entry: its peak memory above its inputs stays
    under a few [U, k+2] factor tensors, at a shape where one [n, k] f32
    tensor would be 50 times that.'''
    from mfrec_tpu_torch.ops import sgd_mf
    U, I, N, k, W = 2000, 400, 2_000_000, 100, 512
    rng = np.random.default_rng(7)
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.uniform(1, 5, N).astype(np.float32)
    pl_, ql_ = (sgd_mf.PassLayout(sgd_mf.sorted_pass_layout(
        u, i, v, 16384, axis=a, max_window=W), a, cuda, segments=True)
        for a in ('user', 'item'))

    def t(*shape, s=0.05):
        return torch.from_numpy(rng.normal(0, s, shape).astype(
            np.float32)).to(cuda)

    Pa, Qa = sgd_mf.augment_factors(t(U + W, k), t(I + W, k),
                                    t(U + W), t(I + W))
    Y = t(I + W, k)
    nrm = torch.full((U + W,), 1.0 / np.sqrt(N / U), device=cuda)
    ep = sgd_mf.make_alternating_implicit_epoch(
        W, W, 0.15, 0.15, 0.015, 0.015, inner_steps=4, use_kernel=True)
    ep(Pa, Qa, Y, 3.6, pl_, ql_, nrm)                 # builds, warms up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    *_, rmse = ep(Pa, Qa, Y, 3.6, pl_, ql_, nrm)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - base
    factor = Pa.nbytes
    assert np.isfinite(float(rmse))
    assert above <= 12 * factor, (above, factor)
    assert above * 50 < N * k * 4, (above, N * k * 4)


def _tier_inputs(dev, W=64, k=16, U=500, I=300):
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    from mfrec_tpu_torch.ops import sgd_mf
    u, i, v = synthetic_ratings(U, I, 20000, rank=4, seed=4)
    keep = np.unique(u.astype(np.int64) * I + i, return_index=True)[1]
    u, i, v = u[keep], i[keep], v[keep]
    lay = {a: sgd_mf.sorted_pass_layout(u, i, v, 4096, axis=a,
                                        max_window=W)
           for a in ('user', 'item')}
    pl_, ql_ = (sgd_mf.PassLayout(lay[a], a, dev, segments=dev == 'cuda')
                for a in ('user', 'item'))
    rng = np.random.default_rng(0)
    Pa, Qa = sgd_mf.augment_factors(
        rng.normal(0, 0.1, (U + W, k)).astype(np.float32),
        rng.normal(0, 0.1, (I + W, k)).astype(np.float32),
        rng.normal(0, 0.1, U + W).astype(np.float32),
        rng.normal(0, 0.1, I + W).astype(np.float32))
    XY = rng.normal(0, 0.05, (2, I + W, k)).astype(np.float32)
    cnt = np.bincount(u, minlength=U + W).astype(np.float32)
    nrm = np.where(cnt > 0, 1.0 / np.sqrt(np.maximum(cnt, 1.0)), 0.0)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    return (t(Pa), t(Qa), t(XY[0]), t(XY[1]), float(v.mean()), pl_, ql_,
            t(nrm), W, ql_.nbr_batches)


@pytest.mark.parametrize('tier', ['implicit', 'fn'])
def test_cuda_tier_epochs_match_cpu(cuda, tier):
    '''Two SVD++ or FN epochs with use_kernel=True on CUDA tensors (K1,
    FN's user side through K1f, K4's phase launches and the item step)
    against the same epochs on CPU tensors (their plain versions: the
    per-batch item step).'''
    from mfrec_tpu_torch.ops import fn as fn_ops
    from mfrec_tpu_torch.ops import frozen_half_pass_kernel as fk
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    out = {}
    for dev in ('cpu', 'cuda'):
        Pa, Qa, X, Y, mu, pl_, ql_, nrm, W, nq = _tier_inputs(dev)
        if tier == 'implicit':
            ep = sgd_mf.make_alternating_implicit_epoch(
                W, W, 0.15, 0.15, 0.02, 0.02, inner_steps=8, use_kernel=True)
            state = (Pa, Qa, Y)
        else:
            ep = fn_ops.make_fn_alternating_epoch(
                W, W, 0.15, 0.15, 0.15, 0.15, 0.02, 0.007, 0.007,
                inner_steps=8, use_kernel=True)
            state = (Pa, Qa, X, Y)
        fns = (hk.half_pass, fk.frozen_half_pass, wak.scan_aggregate,
               wak.gather_aggregate, wak.error_aggregate,
               wak.window_aggregate, wak.step_aggregate,
               wak.profile_aggregate)
        counts = [f.launches for f in fns]
        for _ in range(2):
            *state, rmse = ep(*state, mu, pl_, ql_, nrm)
        got = tuple(f.launches - c for f, c in zip(fns, counts))
        # FN's user half-pass through K1f, its item half-pass through K1;
        # the item step: one launch per epoch, none per batch; the user
        # phases through K4g's gathered entries (SVD++'s sum and error
        # modes, FN's profile and error modes), none through scan_aggregate
        want = (4, 0, 0, 2, 2, 0, 2, 0) if tier == 'implicit' else \
            (2, 2, 0, 0, 2, 0, 2, 2)
        assert got == (want if dev == 'cuda' else (0,) * 8)
        out[dev] = [x.cpu() for x in state] + [float(rmse)]
    for a, b in zip(out['cuda'][:-1], out['cpu'][:-1]):
        torch.testing.assert_close(a, b, **K1_TOL)
    assert out['cuda'][-1] == pytest.approx(out['cpu'][-1], rel=1e-3)


def test_cuda_agg_tier_matches_cpu(cuda):
    '''The agg-only tier: K4 once per batch and sweep.'''
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    out = {}
    for dev in ('cpu', 'cuda'):
        Pa, Qa, _, _, mu, pl_, ql_, _, W, nq = _tier_inputs(dev)
        ep = sgd_mf.make_alternating_epoch(W, W, 0.15, 0.02, inner_steps=4,
                                           use_agg_kernel=True)
        before = wak.window_aggregate.launches
        Pa, Qa, rmse = ep(Pa, Qa, mu, pl_, ql_)
        want = 4 * (pl_.nbr_batches + nq) if dev == 'cuda' else 0
        assert wak.window_aggregate.launches == before + want
        out[dev] = (Pa.cpu(), Qa.cpu(), float(rmse))
    torch.testing.assert_close(out['cuda'][0], out['cpu'][0], **K1_TOL)
    torch.testing.assert_close(out['cuda'][1], out['cpu'][1], **K1_TOL)
    assert out['cuda'][2] == pytest.approx(out['cpu'][2], rel=1e-3)


def test_cuda_models_train_svdpp_and_fn(cuda):
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    from mfrec_tpu_torch.models.fn import FNRecommender
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    u, i, v = synthetic_ratings(800, 400, 30000, rank=4, seed=5)
    gd = GDRecommender(800, 400, {'nbr_features': 16, 'min_epochs': 3,
                                  'max_epochs': 3, 'inner_steps_implicit': 8,
                                  'feature_init': 0.05}, device='cuda')
    fn = FNRecommender(800, 400, {'nbr_features': 16, 'nbr_epochs': 3,
                                  'inner_steps': 8, 'feature_init': 0.05,
                                  'min_improvement': -1.0}, device='cuda')
    def phase_launches():
        return (wak.scan_aggregate.launches + wak.gather_aggregate.launches
                + wak.error_aggregate.launches
                + wak.profile_aggregate.launches)

    # two an epoch; FN's call also sums its served profiles (one launch)
    for m, train, n in ((gd, gd.feature_training_implicit, 6),
                        (fn, fn.train, 7)):
        m.set_ratings(u, i, v)
        before = phase_launches()
        train()
        assert phase_launches() == before + n
        h = m.get_rmse_history()
        assert np.isfinite(h).all() and h[-1] < h[0]
        assert isinstance(m.P, np.ndarray) and np.isfinite(m.Y).all()
    assert np.isfinite(gd.predict_rating_implicit(3, 5))
    idx, _ = fn.recommend_batch(np.arange(8), 5,
                                predictor='predict_rating_with_bias')
    assert idx.shape == (8, 5)


@pytest.mark.parametrize('k', [1, 8, 66, 130, 256])
def test_half_pass_old_kernel_matches_plain(cuda, k):
    '''P1 against its plain version (K1's tolerances), a 32-warp row at
    k=66; the per-batch entry with the JAX signature too.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import half_pass_old_kernel as p1
    nb, B, W, n_upd, n_fix, T = 4, 2048, 64, 400, 300, 8
    fix, r, m, kl, lo = _k1_batches(nb, B, W, n_upd, n_fix, seed=k)
    if k == 66:
        kl[:3, :1500] = 0                  # one row of 4,500 ratings
        kl.sort(axis=1)
        m[:3, :1500] = 1                   # all masked in
        lo[:3] = lo[0]
    rng = np.random.default_rng(k)
    F0 = torch.from_numpy(
        rng.normal(0, 0.1, (n_upd, k)).astype(np.float32)).to(cuda)
    Ffix = torch.from_numpy(rng.normal(0, 0.1, (n_fix, k)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    lrv = torch.full((k,), 0.15, device=cuda)
    regv = torch.full((k,), 0.02, device=cuda)
    seg = hk.build_segments(fix, r, m, kl, lo, W, cuda)
    assert seg.n_wide == (1 if k == 66 else 0)
    tb = tuple(torch.from_numpy(a).to(cuda) for a in (fix, r, m, kl, lo))
    Fk, Fp = F0.clone(), F0.clone()
    before = p1.half_pass_old.launches
    sse_k = p1.half_pass_old(Fk, Ffix, tb, W, lrv, regv, 3.4, T,
                             segments=seg)
    torch.cuda.synchronize()
    assert p1.half_pass_old.launches == before + 1
    sse_p = p1.half_pass_old_ref(Fp, Ffix, tb, W, lrv, regv, 3.4, T)
    torch.testing.assert_close(Fk, Fp, **K1_TOL)
    assert abs(float(sse_k) - float(sse_p)) <= 1e-3 * float(sse_p)
    assert float((Fk - F0).abs().max()) > 0
    win = F0[int(lo[0]):int(lo[0]) + W].contiguous()
    args = (Ffix[tb[0][0].long()].contiguous(), tb[1][0], tb[2][0], tb[3][0],
            lrv, regv, 3.4, W, 1024, T)
    got, sse_b = p1.half_pass_batch_old(win, *args)
    want, sse_w = p1.half_pass_batch_old_ref(win, *args)
    torch.testing.assert_close(got, want, **K1_TOL)
    assert abs(float(sse_b) - float(sse_w)) <= 1e-3 * float(sse_w)


@pytest.mark.parametrize('k', [8, 66, 128])
def test_probe_kernel_matches_plain(cuda, k):
    '''Every P2 variant ('full' also on bf16 fixed rows), a chain of 3
    calls on 2 problems, against its plain version: the windows at K1's
    tolerances, each entry's change within 1 % of the largest change (the
    no_acc variants only shrink the window); some m = 0.'''
    from mfrec_tpu_torch.ops import probe_kernel as p2
    rng = np.random.default_rng(k)
    G, B, W, T = 2, 1024, 128, 3
    m = (rng.random((G, B)) > 0.1).astype(np.float32)
    data = [rng.normal(0, 0.3, (G, W, k)), rng.normal(0, 0.3, (G, B, k)),
            rng.uniform(1, 5, (G, B)), m,
            np.sort(rng.integers(0, W, (G, B)), axis=1)]
    t = [torch.from_numpy(np.ascontiguousarray(a, np.int32 if j == 4
                                               else np.float32)).to(cuda)
         for j, a in enumerate(data)]
    lrv = torch.full((k,), 0.1, device=cuda)
    regv = torch.full((k,), 0.02, device=cuda)
    ff16 = [t[0], t[1].to(torch.bfloat16)] + t[2:]
    for variant, args in [(v, t) for v in sorted(p2.VARIANTS)] + \
            [('full', ff16)]:
        before = p2.probe_chain.launches
        got, sse = p2.probe_chain(*args, lrv, regv, variant, T, n_chain=3,
                                  ch=256)
        torch.cuda.synchronize()
        assert p2.probe_chain.launches == before + 1
        want, sse_w = p2.probe_chain_ref(*args, lrv, regv, variant, T,
                                         n_chain=3, ch=256)
        torch.testing.assert_close(got, want, **K1_TOL, msg=variant)
        moved = float((want - t[0]).abs().max())
        assert moved > 0, variant
        torch.testing.assert_close(got - t[0], want - t[0], rtol=0,
                                   atol=1e-2 * moved, msg=variant)
        assert abs(float(sse) - float(sse_w)) <= 1e-3 * float(sse_w), variant


def test_cuda_old_epoch_matches_cpu(cuda):
    '''The A/B tool's 'old' epoch on the card (P1) against the same epoch
    on CPU tensors (P1's plain version), from the same factors.'''
    from mfrec_tpu_torch.ops import half_pass_old_kernel as p1
    from mfrec_tpu_torch.tools import ab_kernel, bench_data
    u, i, v = bench_data.make_data(500, 300, 20000)
    _, bu, bi = bench_data.bias_floor_rmse(u, i, v, 500, 300)
    out = {}
    for dev in ('cpu', 'cuda'):
        lay = ab_kernel.make_layouts(u, i, v, dev, batch=4096)
        ep, (P, Q) = ab_kernel.build('old', lay, bu, bi, 500, 300, 16, 8,
                                     seed=1)
        before = p1.half_pass_old.launches
        for _ in range(2):
            P, Q, rmse = ep(P, Q, float(v.mean()), *lay)
        assert p1.half_pass_old.launches == before + (4 if dev == 'cuda'
                                                      else 0)
        out[dev] = (P.cpu(), Q.cpu(), float(rmse))
    torch.testing.assert_close(out['cuda'][0], out['cpu'][0], **K1_TOL)
    torch.testing.assert_close(out['cuda'][1], out['cpu'][1], **K1_TOL)
    assert out['cuda'][2] == pytest.approx(out['cpu'][2], rel=1e-3)


@pytest.mark.parametrize('path', ['sgd', 'svdpp', 'fn', 'logistic',
                                  'logistic_f32', 'bias_none'])
@pytest.mark.parametrize('k', [6, 64, 66, 102, 130, 256])
def test_half_pass_instantiations_match_plain(cuda, k, path):
    '''K1 against its plain version for every build and column shape a
    path of the port launches: SGD (bf16 fixed rows), SVD++ (f32), FN
    (f32, learned biases, user factors frozen), the logistic link on
    either fixed side, bias_mode 'none'; k=6 one column slot, 66, 102
    (SVD++'s width, f = 100) and 130 full slots plus the packed tail
    columns, 64 and 256 full slots only.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import sgd_mf
    nb, B, W, n_upd, n_fix, T = 3, 1024, 32, 200, 150, 8
    batches = _k1_batches(nb, B, W, n_upd, n_fix, seed=k + len(path))
    rng = np.random.default_rng(k)
    F0 = torch.from_numpy(
        rng.normal(0, 0.1, (n_upd, k)).astype(np.float32)).to(cuda)
    Ffix = torch.from_numpy(
        rng.normal(0, 0.1, (n_fix, k)).astype(np.float32)).to(cuda)
    if path in ('sgd', 'logistic', 'bias_none'):
        Ffix = Ffix.to(torch.bfloat16)
    learned = path == 'fn'
    lrv, regv = (torch.from_numpy(a).to(cuda) for a in sgd_mf.column_rates(
        k - 2, True, 0.15, 0.02, 0.02, 0.05, 0.05, 0.02, 0.02, learned,
        freeze_user_factors=learned))
    opts = {'logistic': dict(link='logistic', clamp_pred=False),
            'logistic_f32': dict(link='logistic', clamp_pred=False),
            'bias_none': dict(bias_none=True)}.get(path, {})
    mu = 0.0 if path.startswith('logistic') else 3.4
    seg = hk.build_segments(*batches, W, cuda)
    tb = tuple(torch.from_numpy(a).to(cuda) for a in batches)
    Fk, Fp, Fa = F0.clone(), F0.clone(), F0.clone()
    before = hk.half_pass.launches
    sse_k = hk.half_pass(Fk, Ffix, tb, W, lrv, regv, mu, T, segments=seg,
                         **opts)
    torch.cuda.synchronize()
    assert hk.half_pass.launches == before + 1
    sse_a = hk.half_pass(Fa, Ffix, tb, W, lrv, regv, mu, T, segments=seg,
                         **opts)
    sse_p = hk.half_pass_ref(Fp, Ffix, tb, W, lrv, regv, mu, T, **opts)
    torch.testing.assert_close(Fk, Fp, **K1_TOL)
    assert abs(float(sse_k) - float(sse_p)) <= 1e-3 * float(sse_p)
    assert torch.equal(Fk, Fa) and float(sse_k) == float(sse_a)
    assert float((Fk - F0).abs().max()) > 0
    frozen = lrv == 0
    assert torch.equal(Fk[:, frozen], F0[:, frozen])


@pytest.mark.parametrize('k', [66, 130])
@pytest.mark.parametrize('delta', [-1, 0])
def test_half_pass_cluster_threshold(cuda, k, delta):
    '''A row of CLUSTER_ROW - 1 ratings (8-warp block) and one of
    CLUSTER_ROW (a cluster), over three batches, against the plain version;
    a second launch from the same factors is bit-identical (the cluster's
    partials are summed in rank order).'''
    _cluster_case(cuda, k, delta, seed=k - delta)


@pytest.mark.parametrize('f32_fix', [False, True])
@pytest.mark.parametrize('delta', [-1, 0])
def test_half_pass_cluster_threshold_logistic(cuda, delta, f32_fix):
    '''As test_half_pass_cluster_threshold through the logistic link's
    builds (bf16 and f32 fixed rows), whose cluster rows run the same
    cluster kernel.'''
    _cluster_case(cuda, 66, delta, seed=7 - delta, f32_fix=f32_fix,
                  link='logistic', clamp_pred=False)


def _cluster_case(cuda, k, delta, seed, f32_fix=False, **opts):
    '''A row of CLUSTER_ROW + delta ratings beside short rows, over
    three batches: the kernel against its plain version and a second
    launch bit-identical.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    n = hk.CLUSTER_ROW + delta
    nb, B, W, T = 3, 8192, 16, 8
    rng = np.random.default_rng(seed)
    kl = np.sort(rng.integers(1, W, (nb, B)), axis=1).astype(np.int32)
    kl[:2, :3 * B // 4] = 0
    kl[2, :n - 3 * B // 2] = 0
    kl.sort(axis=1)
    lo = np.zeros(nb, np.int32)
    m = np.ones((nb, B), np.float32)
    r = rng.uniform(1, 5, (nb, B)).astype(np.float32)
    fix = rng.integers(0, 700, (nb, B)).astype(np.int32)
    seg = hk.build_segments(fix, r, m, kl, lo, W, cuda)
    assert int(seg.blk_len[0]) == n and seg.n_cluster == (delta == 0)
    F0 = torch.from_numpy(
        rng.normal(0, 0.1, (W, k)).astype(np.float32)).to(cuda)
    Ffix = torch.from_numpy(rng.normal(0, 0.1, (700, k)).astype(
        np.float32)).to(cuda)
    if not f32_fix:
        Ffix = Ffix.to(torch.bfloat16)
    lrv = torch.full((k,), 0.1, device=cuda)
    regv = torch.full((k,), 0.02, device=cuda)
    tb = tuple(torch.from_numpy(a).to(cuda) for a in (fix, r, m, kl, lo))
    mu = 0.0 if opts.get('link') == 'logistic' else 3.4
    Fk, Fp, Fa = F0.clone(), F0.clone(), F0.clone()
    sse_k = hk.half_pass(Fk, Ffix, tb, W, lrv, regv, mu, T, segments=seg,
                         **opts)
    sse_a = hk.half_pass(Fa, Ffix, tb, W, lrv, regv, mu, T, segments=seg,
                         **opts)
    sse_p = hk.half_pass_ref(Fp, Ffix, tb, W, lrv, regv, mu, T, **opts)
    torch.testing.assert_close(Fk, Fp, **K1_TOL)
    assert abs(float(sse_k) - float(sse_p)) <= 1e-3 * float(sse_p)
    assert torch.equal(Fk, Fa) and float(sse_k) == float(sse_a)
    assert float((Fk - F0).abs().max()) > 0


def _k1f_batches(kind, warp_cap, block_cap, n_fix, seed):
    '''K1f's row shapes: ``'random'``, five batches of random windows
    (W = 64, masks with holes); ``'caps'``, one batch whose rows hold
    warp_cap and warp_cap + 1, block_cap and block_cap + 1 ratings beside
    short rows (W = 8), each side of where a row leaves a warp and where
    its records leave shared memory; ``'heavy'``, row 0 with 8,200 of
    each of two batches' ratings (16,400, at least CLUSTER_ROW: the
    table's leading cluster row, most of its records past shared memory)
    beside short rows (W = 16).'''
    rng = np.random.default_rng(seed)
    if kind == 'random':
        return _k1_batches(5, 2048, 64, 400, n_fix, seed), 64
    if kind == 'caps':
        lens = [[warp_cap, warp_cap + 1, block_cap, block_cap + 1]
                + [30] * 4]
        W = 8
    else:
        lens = [[8200] + [50] * 15] * 2
        W = 16
    B = max(sum(x) for x in lens) + 16
    nb = len(lens)
    kl = np.zeros((nb, B), np.int32)
    m = np.zeros((nb, B), np.float32)
    for b, row_lens in enumerate(lens):
        ids = np.repeat(np.arange(len(row_lens)), row_lens)
        kl[b, :ids.size] = ids
        m[b, :ids.size] = 1.0
    r = rng.uniform(1, 5, (nb, B)).astype(np.float32)
    fix = rng.integers(0, n_fix, (nb, B)).astype(np.int32)
    return (fix, r, m, kl, np.zeros(nb, np.int32)), W


@pytest.mark.parametrize('kind', ['random', 'caps', 'heavy'])
@pytest.mark.parametrize('k,T,opts', [
    (102, 32, {}), (102, 8, {}), (66, 32, {}), (66, 8, {}),
    (102, 8, {'row_mean': False}), (66, 64, {}), (130, 8, {}),
    (102, 8, {'clamp_pred': False})])
def test_frozen_half_pass_matches_plain(cuda, kind, k, T, opts):
    '''K1f (FN's user half-pass: f32 fixed rows, every rate but b_u's
    zero) against K1's plain version with FN's rates and against its
    own, K1's tolerances; a second launch bit-identical; every column but
    b_u's untouched; one K1f launch and no K1 launch; ``k1f.entries`` the
    table's entries while recording.'''
    from mfrec_tpu_torch.ops import frozen_half_pass_kernel as fk
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.utils import profiling
    warp_cap, block_cap, _ = fk.geometry(k)
    n_fix = 700
    batches, W = _k1f_batches(kind, warp_cap, block_cap, n_fix,
                              seed=k + T + len(opts))
    seg = hk.build_segments(*batches, W, cuda)
    n_long, _, n_ovf = fk.long_rows(seg, warp_cap, block_cap)
    if kind == 'caps':
        assert (n_long, n_ovf) == (3, 1)
    elif kind == 'heavy':
        assert seg.n_cluster == 1 and int(seg.blk_len[0]) == 16400
        assert n_ovf == 16400 - block_cap
    rng = np.random.default_rng(k)
    n_upd = int(batches[4].max()) + W
    P = rng.normal(0, 0.1, (n_upd, k - 2)).astype(np.float32)
    Q = rng.normal(0, 0.1, (n_fix, k - 2)).astype(np.float32)
    bu = rng.normal(0, 0.3, n_upd).astype(np.float32)
    bi = rng.normal(0, 0.3, n_fix).astype(np.float32)
    F0, Ffix = (torch.from_numpy(a).to(cuda)
                for a in sgd_mf.augment_factors(P, Q, bu, bi))
    lrv, regv = (torch.from_numpy(a).to(cuda) for a in sgd_mf.column_rates(
        k - 2, True, 0.15, 0.02, 0.02,
        0.01 if opts.get('row_mean') is False else 0.15, 0.15, 0.01, 0.01,
        True, freeze_user_factors=True))
    mu = 3.4
    tb = tuple(torch.from_numpy(a).to(cuda) for a in batches)
    Fk, Fa, Fp, Ft = F0.clone(), F0.clone(), F0.clone(), F0.clone()
    before = (fk.frozen_half_pass.launches, hk.half_pass.launches)
    profiling.collect()
    profiling.enable()
    try:
        sse_k = fk.frozen_half_pass(Fk, Ffix, tb, W, lrv, regv, mu, k - 2, T,
                                    segments=seg, **opts)
        torch.cuda.synchronize()
    finally:
        profiling.disable()
        counters = profiling.collect().counters
    assert (fk.frozen_half_pass.launches - before[0],
            hk.half_pass.launches - before[1]) == (1, 0)
    assert counters == {'k1f.entries': int(seg.ent_r.numel())}
    sse_a = fk.frozen_half_pass(Fa, Ffix, tb, W, lrv, regv, mu, k - 2, T,
                                segments=seg, **opts)
    sse_p = hk.half_pass_ref(Fp, Ffix, tb, W, lrv, regv, mu, T, **opts)
    sse_t = fk.frozen_half_pass_ref(Ft, Ffix, tb, W, lrv, regv, mu, k - 2,
                                    T, **opts)
    for want, sse_w in ((Fp, sse_p), (Ft, sse_t)):
        torch.testing.assert_close(Fk, want, **K1_TOL)
        assert abs(float(sse_k) - float(sse_w)) <= 1e-3 * float(sse_w)
    assert torch.equal(Fk, Fa) and float(sse_k) == float(sse_a)
    moving = torch.zeros(k, dtype=torch.bool, device=cuda)
    moving[k - 2] = True
    assert torch.equal(Fk[:, ~moving], F0[:, ~moving])
    assert float((Fk[:, k - 2] - F0[:, k - 2]).abs().max()) > 0


@pytest.mark.parametrize('k', [6, 66, 102, 128, 130, 256])
def test_frozen_half_pass_geometry(cuda, k):
    '''K1f's shared memory and registers leave four blocks an SM at up to
    four column slots (k <= 128), at least two beyond; a long row's block
    keeps eight warps' records.'''
    from mfrec_tpu_torch.ops import frozen_half_pass_kernel as fk
    warp_cap, block_cap, blocks = fk.geometry(k)
    assert block_cap == 8 * warp_cap and warp_cap >= 256
    assert blocks == 4 if k <= 128 else blocks >= 2


# the item step against its plain version: within K4's atol plus 1 % of
# the largest change.  The first segment of a row sums the same bf16
# terms in another f32 order; the row then differs by an ulp, which can
# flip one bf16 rounding of a later segment's term (2^-9 of it) -- far
# below 1 % of what the step moves.
STEP_UPD_TOL = 1e-2


@pytest.mark.parametrize('kind,k', [('svdpp', 64), ('fn', 64), ('svdpp', 3),
                                    ('svdpp', 256), ('fn', 128),
                                    ('fn_x', 130)])
@pytest.mark.parametrize('row_mean', [True, False])
def test_step_aggregate_kernel_matches_plain(cuda, kind, k, row_mean,
                                             record_property):
    '''The fused item step against its plain version on an item layout
    with hot rows above the block threshold (STEP_BLOCK_ROW) that span
    several batches, SVD++'s Y and FN's X (residual-weighted) and Y (2k
    up to 256), or FN's X alone (its launch when 2k > 256); a second
    launch from the same targets is bit-identical.
    Each target's error, largest change and whether K4's tolerance alone
    would hold go to the junit XML (``--junitxml``).'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    rng = np.random.default_rng(k + len(kind))
    U, I, N = 3000, 200, 60000
    u = rng.integers(0, U, N).astype(np.int32)
    i = np.minimum(rng.geometric(0.02, N) - 1, I - 1).astype(np.int32)
    i[:3000] = 0                     # a hot item over two batches of 2048
    v = rng.uniform(1, 5, N).astype(np.float32)
    lay = sgd_mf.sorted_pass_layout(u, i, v, 2048, axis='item',
                                    max_window=64)
    seg = hk.build_segments(lay[0], lay[2], lay[3], lay[4], lay[5], 64, cuda)
    assert int(seg.blk_len[0]) >= 2 * wak.STEP_BLOCK_ROW
    assert seg.longest_segments >= 2
    G = torch.from_numpy(rng.normal(0, 0.1, (U + 64, k)).astype(
        np.float32)).to(cuda)
    T0 = [torch.from_numpy(rng.normal(0, 0.1, (I + 64, k)).astype(
        np.float32)).to(cuda) for _ in range(2 if kind == 'fn' else 1)]
    coef = (torch.from_numpy(rng.normal(0, 1, int(seg.ent_r.shape[0]))
                             .astype(np.float32)).to(cuda), None) \
        if kind.startswith('fn') else (None,)
    kw = dict(coef=coef, decay=(0.02, 0.03)[:len(T0)], step=0.1,
              row_mean=row_mean)
    before = wak.step_aggregate.launches
    got = wak.step_aggregate([t.clone() for t in T0], G, seg, **kw)
    again = wak.step_aggregate([t.clone() for t in T0], G, seg, **kw)
    torch.cuda.synchronize()
    assert wak.step_aggregate.launches == before + 2
    want = wak.step_aggregate_ref([t.clone() for t in T0], G, seg, **kw)
    for x, (a, b, w, t0) in enumerate(zip(got, again, want, T0)):
        moved = float((w - t0).abs().max())
        diff = (a - w).abs()
        record_property('target%d' % x, dict(
            max_abs_err=float(diff.max()), moved=moved,
            k4_tol_alone=bool((diff <= K4_TOL['atol']
                               + K4_TOL['rtol'] * w.abs()).all())))
        assert moved > 0
        torch.testing.assert_close(a, w, rtol=0,
                                   atol=K4_TOL['atol'] + STEP_UPD_TOL * moved)
        assert torch.equal(a, b)


# S1, the serial Funk tier: the kernel against its plain version bit for
# bit (both compute every step in f32 in one order, no FMA), for every
# template instance (3 bias modes x the row table in shared or in device
# memory) and every fold-in mask, per epoch and converged.
def _s1_case(cuda, U, I, n, k, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    return dict(uidx=t(rng.integers(0, U, n).astype(np.int32)),
                iidx=t(rng.integers(0, I, n).astype(np.int32)),
                r=t(rng.integers(1, 6, n).astype(np.float32)),
                cache=t(np.where(rng.random(n) < 0.5, rng.uniform(1, 5, n),
                                 0).astype(np.float32)),
                P=t(rng.normal(0.1, 0.05, (U, k)).astype(np.float32)),
                Q=t(rng.normal(0.1, 0.05, (I, k)).astype(np.float32)),
                bu=t(rng.normal(0, 0.1, U).astype(np.float32)),
                bi=t(rng.normal(0, 0.1, I).astype(np.float32)))


def _s1_run(fn, d, f, mode, upd_u, upd_i, **kw):
    P, Q = d['P'], d['Q']
    return fn(P[:, f].contiguous(), Q[:, f].contiguous(), d['cache'],
              d['uidx'], d['iidx'], d['r'], f, P.shape[1], 0.1, 0.01, 0.02,
              3.53, d['bu'].clone(), d['bi'].clone(), 0.005, 0.006, 0.012,
              0.004, bias_mode=mode, update_users=upd_u, update_items=upd_i,
              P=P, Q=Q, **kw)


@pytest.mark.parametrize('smem', [True, False])
@pytest.mark.parametrize('masks', [(True, True), (True, False),
                                   (False, True), (False, False)])
@pytest.mark.parametrize('mode', ['none', 'fixed', 'learned'])
def test_serial_funk_kernel_matches_plain(cuda, mode, masks, smem):
    from mfrec_tpu_torch.ops import serial_kernel as sk
    d = _s1_case(cuda, 120, 70, 700, 5, seed=3)
    before = sk.serial_converge.launches
    got = _s1_run(sk.serial_epoch, d, 2, mode, *masks, smem=smem)
    again = _s1_run(sk.serial_epoch, d, 2, mode, *masks, smem=smem)
    torch.cuda.synchronize()
    assert sk.serial_converge.launches == before + 2
    want = _s1_run(sk.serial_feature_epoch_ref, d, 2, mode, *masks)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, w)
        assert torch.equal(a, b)


@pytest.mark.parametrize('n', [1, 31, 32, 33, 65])
def test_serial_funk_kernel_short_streams(cuda, n):
    '''Streams shorter than, equal to and just past the 32-rating chunks
    (a fold-in streams a user's few ratings).'''
    from mfrec_tpu_torch.ops import serial_kernel as sk
    d = _s1_case(cuda, 40, 30, n, 4, seed=n)
    for mode in ('fixed', 'learned'):
        got = _s1_run(sk.serial_epoch, d, 0, mode, True, False)
        want = _s1_run(sk.serial_feature_epoch_ref, d, 0, mode, True, False)
        for a, w in zip(got, want):
            assert torch.equal(a, w)


def _s1_converge_case(fn, d, f, mode, masks, **kw):
    return _s1_run(fn, d, f, mode, *masks, min_epochs=3, max_epochs=40,
                   min_improvement=3e-3, **kw)


@pytest.mark.parametrize('smem', [True, False])
@pytest.mark.parametrize('masks', [(True, True), (True, False),
                                   (False, True), (False, False)])
@pytest.mark.parametrize('mode', ['none', 'fixed', 'learned'])
def test_serial_converge_kernel_matches_plain(cuda, mode, masks, smem):
    '''The converge entry: one launch for the feature, its columns,
    biases, every epoch's rmse and the epoch count those of the plain
    loop under the same rule.'''
    from mfrec_tpu_torch.ops import serial_kernel as sk
    d = _s1_case(cuda, 90, 60, 300, 4, seed=11)
    before = sk.serial_converge.launches
    got = _s1_converge_case(sk.serial_converge, d, 1, mode, masks, smem=smem)
    torch.cuda.synchronize()
    assert sk.serial_converge.launches == before + 1
    want = _s1_converge_case(sk.serial_converge_ref, d, 1, mode, masks)
    assert 3 <= len(got[4]) == len(want[4])
    assert got[4] == want[4]
    for a, w in zip(got[:4], want[:4]):
        assert torch.equal(a, w)


@pytest.mark.parametrize('smem', [True, False])
@pytest.mark.parametrize('mode', ['none', 'fixed', 'learned'])
def test_serial_converge_on_columns_with_cache(cuda, mode, smem):
    '''The model's call: the converge entry on P's and Q's column (stride
    k) with the cache update in the launch, against its plain version:
    P, Q, biases, cache, every epoch's rmse bit for bit; and a feature
    that runs no epoch (max_epochs 0) still freezes into the cache, in
    one launch of no epoch.'''
    from mfrec_tpu_torch.ops import serial_kernel as sk
    d = _s1_case(cuda, 90, 60, 400, 4, seed=21)

    def run(fn, max_epochs, **kw):
        P, Q = d['P'].clone(), d['Q'].clone()
        cache, bu, bi = d['cache'].clone(), d['bu'].clone(), d['bi'].clone()
        hist = fn(P[:, 2], Q[:, 2], cache, d['uidx'], d['iidx'], d['r'], 2,
                  4, 0.1, 0.01, 0.02, 3.53, bu, bi, 0.005, 0.006, 0.012,
                  0.004, bias_mode=mode, P=P, Q=Q, min_epochs=3,
                  max_epochs=max_epochs, min_improvement=3e-3,
                  update_cache=True, **kw)[4]
        return hist, (P, Q, cache, bu, bi)

    for max_epochs in (40, 0):
        before = sk.serial_converge.launches
        got = run(sk.serial_converge, max_epochs, smem=smem)
        torch.cuda.synchronize()
        assert sk.serial_converge.launches == before + (
            1 if max_epochs or mode != 'learned' else 0)
        want = run(sk.serial_converge_ref, max_epochs)
        assert got[0] == want[0]
        for a, w in zip(got[1], want[1]):
            assert torch.equal(a, w)


@pytest.mark.parametrize('n', [1, 20, 32, 33, 64, 97])
def test_serial_converge_fold_in_streams(cuda, n):
    '''A fold-in's stream (one user, distinct items; one item, distinct
    users) converged in one launch, bit for bit, in both memory paths.'''
    from mfrec_tpu_torch.ops import serial_kernel as sk
    d = _s1_case(cuda, 120, 110, n, 4, seed=n)
    for side, masks in ((0, (True, False)), (1, (False, True))):
        ids = d['uidx' if side == 0 else 'iidx']
        other = d['iidx' if side == 0 else 'uidx']
        ids.fill_(7)
        other.copy_(torch.randperm(110, device=cuda)[:n].int())
        for smem in (True, False):
            got = _s1_converge_case(sk.serial_converge, d, 0, 'fixed', masks,
                                    smem=smem)
            want = _s1_converge_case(sk.serial_converge_ref, d, 0, 'fixed',
                                     masks)
            assert got[4] == want[4]
            for a, w in zip(got[:4], want[:4]):
                assert torch.equal(a, w)


def test_cuda_foldin_matches_cpu(cuda):
    '''add_user on a CUDA model (S1, then K3 for the new user's list)
    against the same fold-in on a CPU model from the same state: the new
    row bit for bit, the same top-5; S1 launched once a feature.'''
    from mfrec_tpu_torch import interop
    from mfrec_tpu_torch.ops import serial_kernel as sk
    rng = np.random.default_rng(0)
    U, I, k = 80, 60, 6
    u = rng.integers(0, U, 900).astype(np.int32)
    i = rng.integers(0, I, 900).astype(np.int32)
    v = rng.integers(1, 6, 900).astype(np.float32)
    P = rng.normal(0, 0.1, (U, k)).astype(np.float32)
    Q = rng.normal(0, 0.1, (I, k)).astype(np.float32)
    bu = rng.normal(0, 0.2, U).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    out = {}
    for dev in ('cuda', 'cpu'):
        m = interop.from_numpy(P, Q, bu, bi, 3.5, (u, i, v), device=dev,
                               parameters={'min_epochs': 5,
                                           'max_epochs': 30,
                                           'learning_rate': 0.01})
        m.seed(3)
        before = sk.serial_converge.launches
        new = m.add_user('new', np.arange(7), np.full(7, 5.0))
        if dev == 'cuda':
            assert sk.serial_converge.launches == before + k
        out[dev] = (m.P[new].copy(), m.rmse_history, m.find_recommended_items(
            user_index=new, nbr_recommendations=5,
            predictor='predict_rating_with_bias'))
    np.testing.assert_array_equal(out['cuda'][0], out['cpu'][0])
    assert out['cuda'][1] == out['cpu'][1]
    assert out['cuda'][2][0] == out['cpu'][2][0]


def test_cuda_add_item_matches_cpu(cuda):
    '''add_item on a CUDA model against a CPU model from the same
    state: the new row and every epoch's rmse bit for bit.'''
    from mfrec_tpu_torch import interop
    rng = np.random.default_rng(5)
    U, I, k = 70, 50, 5
    u = rng.integers(0, U, 700).astype(np.int32)
    i = rng.integers(0, I, 700).astype(np.int32)
    v = rng.integers(1, 6, 700).astype(np.float32)
    P = rng.normal(0, 0.1, (U, k)).astype(np.float32)
    Q = rng.normal(0, 0.1, (I, k)).astype(np.float32)
    bu = rng.normal(0, 0.2, U).astype(np.float32)
    bi = rng.normal(0, 0.2, I).astype(np.float32)
    out = {}
    for dev in ('cuda', 'cpu'):
        m = interop.from_numpy(P, Q, bu, bi, 3.5, (u, i, v), device=dev,
                               parameters={'min_epochs': 3,
                                           'max_epochs': 50,
                                           'min_improvement': 1e-5,
                                           'learning_rate': 0.02})
        m.seed(4)
        new = m.add_item('new', np.arange(0, 60, 2), np.full(30, 4.0))
        out[dev] = (m.Q[new].copy(), m.rmse_history)
    np.testing.assert_array_equal(out['cuda'][0], out['cpu'][0])
    assert out['cuda'][1] == out['cpu'][1]


@pytest.mark.parametrize('bias', ['none', 'fixed', 'learned'])
def test_cuda_funk_engine_one_launch_a_feature(cuda, bias):
    '''engine='funk' on a CUDA model: S1 launched once a feature, the
    epochs and the factors those of a CPU model.'''
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops import serial_kernel as sk
    rng = np.random.default_rng(2)
    U, I, k = 60, 40, 3
    u = rng.integers(0, U, 600).astype(np.int32)
    i = rng.integers(0, I, 600).astype(np.int32)
    v = rng.integers(1, 6, 600).astype(np.float32)
    outs = {}
    for dev in ('cuda', 'cpu'):
        m = GDRecommender(U, I, {'nbr_features': k, 'engine': 'funk',
                                 'min_epochs': 2, 'max_epochs': 25,
                                 'learning_rate': 0.01}, device=dev)
        m.seed(1)
        m.set_ratings(u, i, v)
        before = (sk.serial_converge.launches, sk.serial_converge.epochs)
        if bias == 'learned':
            m.feature_training_bias()
        else:
            m.train(handle_bias=bias == 'fixed')
        if dev == 'cuda':
            assert sk.serial_converge.launches == before[0] + k
            assert sk.serial_converge.epochs == before[1] + len(
                m.rmse_history)
        outs[dev] = (m.P.copy(), m.Q.copy(), list(m.rmse_history))
    for a, b in zip(outs['cuda'], outs['cpu']):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('engine', ['fused', 'funk_fused'])
def test_cuda_minibatch_tiers_repeat(cuda, engine):
    '''The fused and funk-fused tiers on the card: two runs from one seed
    give bit-identical factors (fixed-order scatter-adds, no atomics),
    and agree with a CPU model within f32 rounding of other sum
    orders.'''
    from mfrec_tpu_torch.models.gd import GDRecommender
    rng = np.random.default_rng(1)
    U, I = 200, 120
    u = rng.integers(0, U, 5000).astype(np.int32)
    i = np.minimum(rng.zipf(1.5, 5000) - 1, I - 1).astype(np.int32)
    v = rng.integers(1, 6, 5000).astype(np.float32)
    outs = []
    for dev in ('cuda', 'cuda', 'cpu'):
        m = GDRecommender(U, I, {'min_epochs': 4, 'max_epochs': 4,
                                 'nbr_features': 4, 'learning_rate': 0.01,
                                 'engine': engine, 'batch_size': 1024},
                          device=dev)
        m.seed(9)
        m.set_ratings(u, i, v)
        m.feature_training_bias()
        outs.append((m.P.copy(), m.Q.copy(), m.users_bias.copy()))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)
    for a, c in zip(outs[0], outs[2]):
        np.testing.assert_allclose(a, c, atol=1e-5)


def test_cuda_fn_fused_matches_cpu(cuda):
    '''FNRecommender(engine='fused') on the card: repeats bit for bit and
    agrees with a CPU model (other f32 sum orders: within 1e-4).'''
    from mfrec_tpu_torch.models.fn import FNRecommender
    rng = np.random.default_rng(2)
    U, I = 150, 90
    u = rng.integers(0, U, 3000).astype(np.int32)
    i = rng.integers(0, I, 3000).astype(np.int32)
    v = rng.integers(1, 6, 3000).astype(np.float32)
    outs = []
    for dev in ('cuda', 'cuda', 'cpu'):
        m = FNRecommender(U, I, {'nbr_epochs': 3, 'nbr_features': 5,
                                 'engine': 'fused', 'batch_size': 512,
                                 'min_improvement': -1.0}, device=dev)
        m.seed(4)
        m.set_ratings(u, i, v)
        m.train()
        outs.append((m.P.copy(), m.X.copy(), m.Y.copy()))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)
    for a, c in zip(outs[0], outs[2]):
        np.testing.assert_allclose(a, c, atol=1e-4)


# ------------------------------------------------------------------- S2
S2_KS = [1, 8, 40, 64, 66, 256]
S2_MASKS = [(True, True), (True, False), (False, True)]


def _s2_case(dev, U, I, n, k, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dict(P=t(rng.normal(0, 0.1, (U, k)).astype(np.float32)),
                Q=t(rng.normal(0, 0.1, (I, k)).astype(np.float32)),
                bu=t(rng.normal(0, 0.1, U).astype(np.float32)),
                bi=t(rng.normal(0, 0.1, I).astype(np.float32)),
                uidx=t(rng.integers(0, U, n).astype(np.int32)),
                iidx=t(rng.integers(0, I, n).astype(np.int32)),
                r=t(rng.integers(1, 6, n).astype(np.float32)))


def _s2_run(fn, d, kernel, masks, lr=0.01, **kw):
    '''``fn`` (an S2 entry or its plain version) on copies of ``d``'s
    state, at KMF's default rates.'''
    st = [d[x].clone() for x in ('P', 'Q', 'bu', 'bi')]
    return fn(*st, d['uidx'], d['iidx'], d['r'], lr, 0.1, 0.1, 0.007,
              kernel, 1.0, 5.0, *masks, **kw)


def _s2_same(got, want):
    for a, w in zip(got[:4], want[:4]):
        assert torch.equal(a, w)
    if isinstance(got[4], list):
        assert got[4] == want[4]
    else:
        assert torch.equal(got[4], want[4])


@pytest.mark.parametrize('masks', S2_MASKS)
@pytest.mark.parametrize('kernel', ['logistic', 'linear'])
@pytest.mark.parametrize('k', S2_KS)
def test_kmf_serial_kernel_matches_plain(cuda, k, kernel, masks):
    '''S2, one epoch a launch, against its plain version on the card:
    P, Q, biases and the rmse bit for bit; a second launch the same.'''
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    d = _s2_case(cuda, 30, 20, 200, k, seed=k)
    before = sk.kmf_serial_converge.launches
    got = _s2_run(sk.kmf_serial_epoch, d, kernel, masks)
    again = _s2_run(sk.kmf_serial_epoch, d, kernel, masks)
    torch.cuda.synchronize()
    assert sk.kmf_serial_converge.launches == before + 2
    _s2_same(got, _s2_run(sk.kmf_serial_epoch_ref, d, kernel, masks))
    _s2_same(got, again)


@pytest.mark.parametrize('n', [1, 2, 3, 31, 33])
def test_kmf_serial_kernel_short_and_repeated_streams(cuda, n):
    '''n = 1, 2, 3 (the ids' look-ahead wraps), one (u, i) repeated, and
    a fold-in stream of one user with a duplicated pair.'''
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    d = _s2_case(cuda, 12, 40, n, 66, seed=n)
    streams = [dict(d)]
    streams.append(dict(d, uidx=torch.full_like(d['uidx'], 3),
                        iidx=torch.full_like(d['iidx'], 5)))
    fold = torch.randperm(40, device=cuda)[:n].int()
    fold[-1] = fold[0]
    streams.append(dict(d, uidx=torch.full_like(d['uidx'], 7), iidx=fold))
    for s in streams:
        for kernel in ('logistic', 'linear'):
            for masks in S2_MASKS:
                kw = dict(min_epochs=3, max_epochs=3)
                _s2_same(_s2_run(sk.kmf_serial_converge, s, kernel, masks,
                                 **kw),
                         _s2_run(sk.kmf_serial_converge_ref, s, kernel,
                                 masks, **kw))


def _s2_hot_item(dev, seed=11):
    '''A stream whose item 0 takes half the ratings (long chains).'''
    d = _s2_case(dev, 30, 25, 300, 40, seed=seed)
    rng = np.random.default_rng(seed)
    hot = np.where(rng.random(300) < 0.5, 0, rng.integers(1, 25, 300))
    return dict(d, iidx=torch.from_numpy(hot.astype(np.int32)).to(dev))


@pytest.mark.parametrize('n', [31, 32, 33, 64, 65, 1000])
def test_kmf_serial_kernel_chunk_edges(cuda, n):
    '''Streams that end at, before and after a chunk's edge (S2 runs
    chunks of 32 ratings in rounds), 3 epochs in one launch, both links,
    the three masks (n = 1,000: logistic, both sides updated), bit for
    bit against the plain version.'''
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    d = _s2_case(cuda, 40, 60, n, 40, seed=100 + n)
    cases = ([('logistic', (True, True))] if n == 1000 else
             [(kernel, masks) for kernel in ('logistic', 'linear')
              for masks in S2_MASKS])
    kw = dict(min_epochs=3, max_epochs=3)
    for kernel, masks in cases:
        _s2_same(_s2_run(sk.kmf_serial_converge, d, kernel, masks, **kw),
                 _s2_run(sk.kmf_serial_converge_ref, d, kernel, masks, **kw))


@pytest.mark.parametrize('masks', S2_MASKS)
def test_kmf_serial_kernel_hot_item_and_large_table(cuda, masks):
    '''A hot item (half the stream, 2 epochs), and a stream whose rows
    (3,000 users, 2,000 items, k = 64: about 1.3 MB with their biases)
    are far more than a block's shared memory (1 epoch), bit for bit
    against the plain version; then the hot stream again on P and Q
    that lie 4 bytes off a 16-byte boundary (the rows copied 4 bytes at
    a time).'''
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    hot = _s2_hot_item(cuda)
    kw = dict(min_epochs=2, max_epochs=2)
    _s2_same(_s2_run(sk.kmf_serial_converge, hot, 'logistic', masks, **kw),
             _s2_run(sk.kmf_serial_converge_ref, hot, 'logistic', masks,
                     **kw))
    big = _s2_case(cuda, 3000, 2000, 1500, 64, seed=12)
    _s2_same(_s2_run(sk.kmf_serial_epoch, big, 'linear', masks),
             _s2_run(sk.kmf_serial_epoch_ref, big, 'linear', masks))
    off = dict(hot)
    for name in ('P', 'Q'):
        t = hot[name]
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        off[name] = buf[1:].view(t.shape)
        off[name].copy_(t)
        assert off[name].data_ptr() % 16 != 0
    _s2_same(_s2_run(sk.kmf_serial_converge, off, 'logistic', masks, **kw),
             _s2_run(sk.kmf_serial_converge_ref, hot, 'logistic', masks,
                     **kw))


def test_kmf_serial_plan_is_checked(cuda):
    '''A plan is the stream's: one built for another length or on the
    CPU is refused; a plan passed in is used as built.'''
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    d = _s2_case(cuda, 12, 40, 50, 8, seed=13)
    plan = sk.kmf_plan(d['uidx'], d['iidx'], d['r'], cuda)
    assert plan.rounds > 0 and plan.rec.is_cuda
    _s2_same(_s2_run(sk.kmf_serial_epoch, d, 'logistic', (True, True),
                     plan=plan),
             _s2_run(sk.kmf_serial_epoch_ref, d, 'logistic', (True, True)))
    with pytest.raises(ValueError):
        _s2_run(sk.kmf_serial_epoch, d, 'logistic', (True, True),
                plan=sk.kmf_plan(d['uidx'][:40], d['iidx'][:40],
                                 d['r'][:40], cuda))
    with pytest.raises(ValueError):
        _s2_run(sk.kmf_serial_epoch, d, 'logistic', (True, True),
                plan=sk.kmf_plan(d['uidx'], d['iidx'], d['r'], 'cpu'))


@pytest.mark.parametrize('rule', [(12, 12, 0.0), (1, 60, 0.01),
                                  (0, 0, 0.0)])
@pytest.mark.parametrize('kernel', ['logistic', 'linear'])
def test_kmf_serial_converge_matches_plain(cuda, kernel, rule):
    '''The converge entry: one launch for a call's epochs, every epoch's
    rmse and the count those of the plain loop under the same rule (no
    launch when the rule runs none).'''
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    d = _s2_case(cuda, 25, 18, 150, 8, seed=7)
    kw = dict(min_epochs=rule[0], max_epochs=rule[1],
              min_improvement=rule[2])
    before = (sk.kmf_serial_converge.launches, sk.kmf_serial_converge.epochs)
    got = _s2_run(sk.kmf_serial_converge, d, kernel, (True, True), **kw)
    torch.cuda.synchronize()
    n_ep = len(got[4])
    assert (sk.kmf_serial_converge.launches,
            sk.kmf_serial_converge.epochs) == (before[0] + (n_ep > 0),
                                               before[1] + n_ep)
    _s2_same(got, _s2_run(sk.kmf_serial_converge_ref, d, kernel,
                          (True, True), **kw))
    if rule[1] == 60:
        assert 1 <= n_ep < 60


def test_kmf_serial_converge_stops_on_divergence(cuda):
    '''A stream that blows up: the launch stops after the first
    non-finite rmse, as the plain loop does.'''
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    d = _s2_case(cuda, 25, 18, 150, 8, seed=8)
    kw = dict(min_epochs=30, max_epochs=30)
    got = _s2_run(sk.kmf_serial_converge, d, 'linear', (True, True), lr=0.3,
                  **kw)
    want = _s2_run(sk.kmf_serial_converge_ref, d, 'linear', (True, True),
                   lr=0.3, **kw)
    assert 1 < len(got[4]) == len(want[4]) < 30
    assert not np.isfinite(got[4][-1])
    assert [x for x in got[4] if np.isfinite(x)] == \
        [x for x in want[4] if np.isfinite(x)]


@pytest.mark.parametrize('kernel', ['logistic', 'linear'])
def test_kmf_serial_chain_probe(cuda, kernel):
    '''S2's chain probe (the bound's one-rating chain, measured apart from
    S2) launches at every width S2 takes and gives a positive time, and
    refuses a width S2 does not take.'''
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    for k in (1, 40, 66, 256):
        ns = sk.chain_latency_ns(k, kernel, cuda, n=1 << 12, iters=2)
        assert np.isfinite(ns) and ns > 0
    with pytest.raises(ValueError):
        sk.chain_latency_ns(257, kernel, cuda)


def test_cuda_kmf_matches_cpu(cuda):
    '''A CUDA KMFRecommender against a CPU one from the same seed:
    ``train()`` on the alternating tier (K1's logistic build, f32 fixed
    side, against the CPU's XLA-branch math: the RMSE history within 1e-2
    relative, the factors within K1's bf16 tolerance); then, from the
    CUDA model's trained state, ``recommend_batch`` through K3 against
    the CPU's plain top-n (K3's exact tolerance) and ``add_user`` through
    S2 (one launch, 200 epochs) against the CPU's plain path (the new row
    and every epoch's rmse within 1e-6, the same top-5).'''
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    from mfrec_tpu_torch.models.kmf import KMFRecommender
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    u, i, v = synthetic_ratings(300, 200, 6000, rank=6, seed=1)
    models, hist = {}, {}
    for dev in ('cuda', 'cpu'):
        m = KMFRecommender(300, 200, {'nbr_features': 8, 'nbr_epochs': 3,
                                      'batch_size': 2048, 'inner_steps': 8},
                           device=dev)
        m.seed(0)
        m.set_ratings(u, i, v)
        before = hk.half_pass.launches
        m.train()
        assert hk.half_pass.launches - before == (6 if dev == 'cuda' else 0)
        models[dev], hist[dev] = m, list(m.rmse_history)
    c, p = models['cuda'], models['cpu']
    np.testing.assert_allclose(hist['cuda'], hist['cpu'], rtol=1e-2)
    for name in ('P', 'Q'):
        torch.testing.assert_close(torch.from_numpy(getattr(c, name)),
                                   torch.from_numpy(getattr(p, name)),
                                   **K1_TOL)
    for name in ('P', 'Q', 'users_bias', 'items_bias'):
        setattr(p, name, getattr(c, name).copy())
    users = np.arange(16)
    before = topn_scores_kernel.launches
    k_idx, k_s = c.recommend_batch(users, 10)
    assert topn_scores_kernel.launches == before + 1
    t_idx, t_s = p.recommend_batch(users, 11)
    ok, err, _ = topn_agreement(k_idx, k_s, t_idx, t_s, 10, EXACT['atol'],
                                tie=EXACT['tie'])
    assert ok, err
    rows = {}
    for m in (c, p):
        m.seed(5)
        m.nbr_epochs = 200                       # the shipped fold-in depth
        before = sk.kmf_serial_converge.launches
        new = m.add_user('new', np.arange(9, dtype=np.int32),
                         np.full(9, 5.0, np.float32))
        assert sk.kmf_serial_converge.launches - before == \
            (1 if m is c else 0)
        rows[m.device.type] = (m.P[new].copy(), list(m.rmse_history),
                               m.find_recommended_items(
                                   new, nbr_recommendations=5)[0])
    assert len(rows['cuda'][1]) == len(rows['cpu'][1]) == 200
    np.testing.assert_allclose(rows['cuda'][0], rows['cpu'][0], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(rows['cuda'][1], rows['cpu'][1], atol=1e-6,
                               rtol=0)
    assert rows['cuda'][2] == rows['cpu'][2]


# ----------------------------------------------------------------- B1
# B1, the BellKor bias refit on the card, against its plain version and
# the numpy refit: within one f32 ulp an element (only the f64 sums'
# order differs), rows with no rating exactly 0, a second launch
# bit-identical
B1_U, B1_I, B1_B = 3_000, 260, 256


def _b1_model(device, hot, seed=0, **params):
    '''A GD model of B1_U users and B1_I items: user B1_U - 1 and item
    B1_I - 1 never rated, item 0 rated by ``hot`` users (one of B1's
    block rows past BLOCK_ROW), half stars.'''
    from mfrec_tpu_torch.models.gd import GDRecommender
    rng = np.random.default_rng(seed)
    n = 30_000 + hot
    u = rng.integers(0, B1_U - 1, n).astype(np.int32)
    i = rng.integers(1, B1_I - 1, n).astype(np.int32)
    u[:hot] = np.arange(hot) % (B1_U - 1)
    i[:hot] = 0
    v = (rng.integers(2, 11, n) / 2.0).astype(np.float32)
    m = GDRecommender(B1_U, B1_I, dict({
        'nbr_features': 4, 'batch_size': B1_B, 'min_epochs': 1,
        'max_epochs': 1, 'inner_steps': 2, 'inner_steps_implicit': 2,
        'feature_init': 0.05, 'engine': 'alternating'}, **params),
        device=device)
    m.seed(3)
    m.set_ratings(u, i, v)
    return m


def _b1_numpy(m):
    m.compute_overall_avg()
    m.compute_items_bias_bk()
    m.compute_users_bias_bk()
    return m.items_bias.copy(), m.users_bias.copy()


@pytest.mark.parametrize('hot', [2_600, 2_999])
@pytest.mark.parametrize('W', [128, 512])
def test_bias_refit_kernel_matches_twin_and_numpy(cuda, W, hot):
    from mfrec_tpu_torch.ops import bias_refit_kernel as b1
    from mfrec_tpu_torch.ops import sgd_mf
    m = _b1_model('cpu', hot, regularization_users_bias=25.0,
                  regularization_items_bias=10.0)
    want_i, want_u = _b1_numpy(m)
    mu = m.overall_bias
    u, i, v = m.ratings.coo()
    tabs = {dev: tuple(sgd_mf.PassLayout(sgd_mf.sorted_pass_layout(
        u, i, v, B1_B, axis=axis, max_window=W), axis, dev,
        segments=True).segments for axis in ('user', 'item'))
        for dev in ('cuda', 'cpu')}
    p_seg, q_seg = tabs['cuda']
    assert q_seg.longest == hot > b1.BLOCK_ROW
    before = b1.bias_refit.launches
    runs = []
    for _ in range(2):
        bi = b1.bias_refit(q_seg, B1_I, mu, 10.0)
        bu = b1.bias_refit(p_seg, B1_U, mu, 25.0, bi=bi)
        runs.append((bi.cpu().numpy(), bu.cpu().numpy()))
    assert b1.bias_refit.launches - before == 4
    (gi, gu), (gi2, gu2) = runs
    assert np.array_equal(gi, gi2) and np.array_equal(gu, gu2)
    for dev, (ps, qs) in tabs.items():
        ti = b1.bias_refit_ref(qs, B1_I, mu, 10.0)
        tu = b1.bias_refit_ref(ps, B1_U, mu, 25.0, bi=ti)
        np.testing.assert_array_max_ulp(gi, ti.cpu().numpy(), maxulp=1)
        np.testing.assert_array_max_ulp(gu, tu.cpu().numpy(), maxulp=1)
    np.testing.assert_array_max_ulp(gi, want_i, maxulp=1)
    np.testing.assert_array_max_ulp(gu, want_u, maxulp=1)
    assert gi[B1_I - 1] == 0 and gu[B1_U - 1] == 0
    assert np.abs(want_i).max() > 0.1 and np.abs(want_u).max() > 0.1


@pytest.mark.parametrize('entry', ['train', 'feature_training_bias',
                                   'feature_training_implicit',
                                   'train_fused'])
def test_cuda_model_refits_on_the_card(cuda, entry):
    '''A CUDA model on the alternating engine refits its biases on the
    card: one ``bias.device_refits`` a call, its layouts fetched before
    the refit, the biases within an ulp of a CPU model's numpy refit; the
    fused engine and a CPU model count none.'''
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.utils import profiling
    seen, counts = {}, {}
    orig = GDRecommender._dispatch_engine

    def spy(self, engine, mode, verbose):
        seen[self.device.type] = (self.items_bias.copy(),
                                  self.users_bias.copy())
        return orig(self, engine, mode, verbose)

    for dev in ('cuda', 'cpu'):
        m = _b1_model(dev, 2_600, **({'engine': 'fused'}
                                     if entry == 'train_fused' else {}))
        profiling.collect()
        profiling.enable()
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(GDRecommender, '_dispatch_engine', spy)
                for _ in range(2):
                    if entry.startswith('train'):
                        m.train(handle_bias=True)
                    else:
                        getattr(m, entry)()
            rec = profiling.collect()
        finally:
            profiling.disable()
        counts[dev] = rec.counters.get('bias.device_refits', 0)
        if entry != 'feature_training_bias':
            seen[dev] = (m.items_bias, m.users_bias)
        names = [s.name for s in rec.spans if s.name.endswith(
            ('.layouts', '.bias'))]
        if entry != 'train_fused':
            pre = 'svdpp' if entry.endswith('implicit') else 'gd'
            assert names == [pre + '.layouts', pre + '.bias'] * 2
    assert counts == {'cuda': 0 if entry == 'train_fused' else 2, 'cpu': 0}
    for got, want in zip(seen['cuda'], seen['cpu']):
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
