'''K3, K1, K2, K4, P1 and P2 on a CUDA device: each kernel against its plain
version, and a CUDA model against the same model on the CPU.  Every case
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
order).  K4: counts exactly, sums atol 1e-5 + rtol 1e-5 (the same bf16
rows summed in f32 in another order); K4's item step: atol 1e-5 plus 1 %
of the largest change (STEP_UPD_TOL, below).  The SVD++ and FN epochs of
a CUDA model against a CPU model's, P1 and P2 and the A/B tool's 'old'
epoch: K1's tolerances.'''
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


K1_TOL = dict(atol=5e-3, rtol=5e-2)


def _k1_batches(nb, B, W, n_upd, n_fix, seed):
    rng = np.random.default_rng(seed)
    lo = np.sort(rng.integers(0, n_upd - W, nb)).astype(np.int32)
    kl = np.sort(rng.integers(0, W, (nb, B)), axis=1).astype(np.int32)
    m = (rng.random((nb, B)) > 0.1).astype(np.float32)
    r = rng.uniform(1, 5, (nb, B)).astype(np.float32)
    fix = rng.integers(0, n_fix, (nb, B)).astype(np.int32)
    return fix, r, m, kl, lo


@pytest.mark.parametrize('k,opts', [
    (66, {}), (66, {'link': 'logistic', 'clamp_pred': False}),
    (66, {'bias_none': True}), (66, {'row_mean': False}),
    (66, {'clamp_pred': False}), (130, {}), (10, {'f32_fix': True})])
def test_half_pass_kernel_matches_plain(cuda, k, opts):
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    opts = dict(opts)
    f32_fix = opts.pop('f32_fix', False)
    nb, B, W, n_upd, n_fix, T = 5, 2048, 64, 400, 300, 16
    batches = _k1_batches(nb, B, W, n_upd, n_fix, seed=k)
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
    tb = tuple(torch.from_numpy(a).to(cuda) for a in batches)
    mu = 0.0 if opts.get('link') == 'logistic' else 3.4
    Fk, Fp = F0.clone(), F0.clone()
    before = hk.half_pass.launches
    sse_k = hk.half_pass(Fk, Ffix, tb, W, lrv, regv, mu, T, segments=seg,
                         **opts)
    torch.cuda.synchronize()
    assert hk.half_pass.launches == before + 1
    sse_p = hk.half_pass_ref(Fp, Ffix, tb, W, lrv, regv, mu, T, **opts)
    torch.testing.assert_close(Fk, Fp, **K1_TOL)
    assert abs(float(sse_k) - float(sse_p)) <= 1e-3 * float(sse_p)
    assert torch.equal(Fk[:, -1], F0[:, -1])            # frozen column
    assert float((Fk - F0).abs().max()) > 0


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
    '''solver='cg' on CUDA: every bucket's solve is one K2 launch, and the
    model lands where the same model on the CPU (the plain loop) does;
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
            before = cg_kernel.pcg_solve_kernel.launches
            m.train()
            n = len(m.ratings.padded_rows(axis='user')) + \
                len(m.ratings.padded_rows(axis='item'))
            want = n * params['nbr_epochs'] \
                if dev == 'cuda' and params['solver'] == 'cg' else 0
            assert cg_kernel.pcg_solve_kernel.launches == before + want
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
    K4's phase launches and the item step) against the same epochs on CPU
    tensors (their plain versions: the per-batch item step).'''
    from mfrec_tpu_torch.ops import fn as fn_ops
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
        counts = (hk.half_pass.launches, wak.scan_aggregate.launches,
                  wak.window_aggregate.launches, wak.step_aggregate.launches)
        for _ in range(2):
            *state, rmse = ep(*state, mu, pl_, ql_, nrm)
        got = (hk.half_pass.launches - counts[0],
               wak.scan_aggregate.launches - counts[1],
               wak.window_aggregate.launches - counts[2],
               wak.step_aggregate.launches - counts[3])
        # the item step: one launch per epoch, none per batch
        assert got == ((4, 4, 0, 2) if dev == 'cuda' else (0, 0, 0, 0))
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
    for m, train in ((gd, gd.feature_training_implicit), (fn, fn.train)):
        m.set_ratings(u, i, v)
        before = wak.scan_aggregate.launches
        train()
        assert wak.scan_aggregate.launches == before + 6
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
@pytest.mark.parametrize('k', [6, 64, 66, 130, 256])
def test_half_pass_instantiations_match_plain(cuda, k, path):
    '''K1 against its plain version for every build and column shape a
    path of the port launches: SGD (bf16 fixed rows), SVD++ (f32), FN
    (f32, learned biases, user factors frozen), the logistic link on
    either fixed side, bias_mode 'none'; k=6 is the packed tail slot
    alone, 66 and 130 full slots plus a packed tail, 64 and 256 full
    slots only.'''
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
    Fk, Fp = F0.clone(), F0.clone()
    before = hk.half_pass.launches
    sse_k = hk.half_pass(Fk, Ffix, tb, W, lrv, regv, mu, T, segments=seg,
                         **opts)
    torch.cuda.synchronize()
    assert hk.half_pass.launches == before + 1
    sse_p = hk.half_pass_ref(Fp, Ffix, tb, W, lrv, regv, mu, T, **opts)
    torch.testing.assert_close(Fk, Fp, **K1_TOL)
    assert abs(float(sse_k) - float(sse_p)) <= 1e-3 * float(sse_p)
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
