#!/usr/bin/env python3
'''
Smoke run of the PyTorch/CUDA port (``mfrec_tpu_torch``) on one GPU.

    python3 chip_smoke.py               # every phase, one card
    python3 chip_smoke.py --phases 12   # toolchain + kernel checks only
    python3 chip_smoke.py --phases 125  # ... and the ALS slice
    python3 chip_smoke.py --phases 1267 # ... and the SVD++ and FN slice
    python3 chip_smoke.py --phases 18   # ... the probe tools (P1, P2)

Phase 1  the toolchain: torch/CUDA/nvcc versions, the card, and the
         build of every kernel from ``mfrec_tpu_torch/csrc`` (one nvcc
         per source, started together), with ``-Xptxas -v``'s report.
Phase 2  each kernel against its plain PyTorch version on the card:
         K3 at the serving and retrieval-bench shapes plus edge shapes;
         K1 on real batches of the ML-10M-shape layouts (B=16384, W=128,
         k=66, T=128), on edge cases and on a whole half-pass at a
         reduced size; K4 at the JAX call's shape on real ML-10M-layout
         batches (B=16384, W=128, k=66), at the SVD++/FN item-step shape
         (W=512), on a whole W=512 layout (the phase aggregation) and on
         edge cases.  Median times of kernel and plain version.
Phase 3  the serving slice end to end at the ML-10M shape (69,878 users x
         10,677 items, rank 64): model -> checkpoint -> reload ->
         ``RecommenderServer`` ('xla' then 'fast' retrieval) answering
         concurrent HTTP requests, served lists checked against the plain
         version, and K3's launch count over that phase.
Phase 4  the training slice end to end at the same shape:
         ``GDRecommender.train(handle_bias=True)`` at the JAX bench's
         model parameters, a 1-epoch warm-up then 3 blocks of a 2- and a
         5-epoch run (the epoch time as the median of their difference
         quotients, as bench.py takes it), every epoch's train
         RMSE against the bias-only floor, K1's launch count, then a few
         ``recommend_batch`` calls from the trained model through K3.
Phase 5  the WRMF/ALS slice end to end at bench_als's shape (69,878 x
         10,677, 23M raw implicit draws, rank 64):
         ``WRMFRecommender.train()`` with solver 'cg' (6 PCG steps, 3
         after 2 epochs) through K2, timed as phase 4 is, K2's launch
         count, the held-out P@5 gate through K3 against the popularity
         floor, K2 on a real bucket against its plain version and the
         exact solver, the split of each half-sweep, and a CUDA model's
         CG epoch against a CPU model's.  Phase 2 also holds K2 to its
         plain version on edge cases.
Phase 6  the SVD++ tier end to end at the ML-10M shape:
         ``GDRecommender.feature_training_implicit()`` through K1 and K4
         (W=512, batch 16384, T=32, f32 fixed side), timed as phase 4
         is, every epoch's RMSE against the bias-only floor, K1's and
         K4's launch counts, one epoch split by phase (CUDA events) with
         the device busy share (torch.profiler), the epoch on the card
         against the same epoch on CPU tensors at 3,000 x 700, and the
         agg-only tier (K4 per batch and sweep) there too.
Phase 7  the FN tier the same way: ``FNRecommender.train()`` at
         bench.py's operating point (T=64), then retrieval through K3
         from the materialized profiles against the plain version, and
         one ``add_user`` fold-in.
Phase 8  the probe tools: P1 and P2 against their plain versions on the
         card (P1 on real ML-10M batches at T=8, on edge cases and on a
         whole reduced half-pass; every P2 variant on a chain at the
         probe's shape), then ``tools.ab_kernel``'s interleaved A/B of P1
         and K1 epochs at the JAX bench's data shape (10M raw draws),
         ``tools.kernel_probe``'s default, 'fix' and 'all2d' modes and
         'hiT' (K1), and the deletion variants over the first 16 ML-10M
         user batches (K1's throughput regime), with P1's, P2's and
         K1's launch counts over that run.

Any failure exits non-zero.  On success the line before the last is the
kernels' JSON summary and the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA device; imports no JAX.
'''
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
EXACT_ATOL = 1e-4          # f32 sums in another order than the twin
EXACT_TIE = 1e-5           # twin scores this close may swap places
FAST_RTOL = 2.0 ** -10     # one quantization step of the packed mode
FAST_ATOL = 1e-5
# K1 against its plain version: the bf16 tolerances of
# tests/test_pallas_half_pass.py.  Both round the window read and eff*ff
# to bf16 at the same places; FMA contraction and summation order can
# move a value by an f32 ulp, which can flip one bf16 rounding of the
# window read (2^-8 relative) for a sweep.
K1_ATOL = 5e-3
K1_RTOL = 5e-2
K1_SSE_RTOL = 1e-3         # the t=0 residuals summed in another order
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
ML10M = dict(U=69_878, I=10_677, nnz=10_000_000)
# K2 against its plain version: the tolerance of tests/test_als.py:303
# (the Pallas kernel against the XLA loop): f32 sums in another order
PCG_ATOL = 1e-4
PCG_RTOL = 1e-3
# bench.py bench_als's shape and settings (bench.py:271-297, 429): 23M
# raw draws of make_implicit_data at the ML-10M shape, rank 64, init
# N(0, 0.1), reg 0.015 (als_wrmf_train's default), CG 6 steps, 3 after 2
# epochs
ALS = dict(U=69_878, I=10_677, N=23_000_000)
ALS_PARAMS = {'nbr_features': 64, 'feature_init': 0.1,
              'regularization_model': 0.015, 'solver': 'cg', 'cg_steps': 6,
              'cg_warm_steps': 3, 'cg_warmup_epochs': 2}
# K4 against its plain version: counts exactly; sums over the same bf16
# rows, in f32 in another order
K4_ATOL = 1e-5
K4_RTOL = 1e-5
# phase 6: phase 4's model settings, the SVD++ tier's defaults otherwise
# (W=512, batch 16384, T=32, lr 0.15); phase 7: bench.py's FN operating
# point (bench.py:619, 633-646) at the model's defaults (W=512, T=64)
SVDPP_PARAMS = {'nbr_features': 64, 'feature_init': 0.05,
                'regularization_model': 0.02, 'min_improvement': -1.0}
FN_PARAMS = {'nbr_features': 64, 'feature_init': 0.05, 'learning_rate': 0.15,
             'learning_rate_users': 0.05, 'learning_rate_items': 0.05,
             'regularization_users': 0.02, 'regularization_items': 0.02,
             'regularization_bias': 0.02, 'min_improvement': -1.0}
REDUCED = (3000, 700, 60_000)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def compare(k_idx, k_s, t_idx, t_s, n, fast):
    '''Hold a kernel's top-n to its twin's top-(n+1): ids equal on every
    filled slot outside quasi-ties, scores within the mode's tolerance.
    Returns (ok, max_abs_err, swaps).'''
    from mfrec_tpu_torch.ops.topn_kernel import topn_agreement
    if fast:
        return topn_agreement(k_idx, k_s, t_idx, t_s, n, FAST_ATOL,
                              FAST_RTOL)
    return topn_agreement(k_idx, k_s, t_idx, t_s, n, EXACT_ATOL,
                          tie=EXACT_TIE)


def timed_ms(fn, iters):
    '''Median device time of one call, from CUDA events.'''
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase1():
    import torch
    from mfrec_tpu_torch.ops import _cuda_build, cg_kernel, \
        half_pass_kernel, half_pass_old_kernel, probe_kernel, topn_kernel, \
        window_agg_kernel
    log('phase 1: python %s, torch %s, CUDA %s' % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    nv = subprocess.run([_cuda_build.nvcc_path(), '--version'],
                        capture_output=True, text=True, check=True).stdout
    log('nvcc: %s' % nv.strip().splitlines()[-1])
    log('card: %s' % card_line())
    t0 = time.perf_counter()
    names = ('topn', 'half_pass', 'pcg', 'window_agg', 'half_pass_old',
             'probe')
    _cuda_build.build(names)
    for mod in (topn_kernel, half_pass_kernel, cg_kernel, window_agg_kernel,
                half_pass_old_kernel, probe_kernel):
        mod._library()
    log('built %s in %.1f s' % (', '.join('csrc/%s.cu' % x for x in names),
                                time.perf_counter() - t0))
    for name in names:
        log(_cuda_build.build_log(name) or '')


def _rated(rng, B, I, L):
    idx = np.zeros((B, L), np.int32)
    for b in range(B):
        idx[b] = np.sort(rng.choice(I, L, replace=False))
    return idx, np.full(B, L, np.int32)


def kernel_case(name, B, I, k, n, L=0, fast=False, q_bf16=False, mode='bias',
                seed=0, iters=0):
    '''One kernel-vs-twin check on the card; returns its record.'''
    import torch
    from mfrec_tpu_torch.ops.topn_kernel import (topn_scores_kernel,
                                                 topn_scores_ref)
    dev = torch.device('cuda')
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 0.3, (B, k)).astype(np.float32)
    Q = rng.normal(0, 0.3, (I, k)).astype(np.float32)
    bu = rng.normal(0, 0.1, B).astype(np.float32)
    bi = rng.normal(0, 0.1, I).astype(np.float32)
    mu = 3.5
    # the model layer's mapping of each predictor onto mu + bu + bi + dot
    if mode in ('dot', 'dot_plus_one'):
        bu[:], bi[:] = 0.0, 0.0
        mu = 1.0 if mode == 'dot_plus_one' else 0.0
    elif mode == 'logistic':
        mu = 0.0
    t = {x: torch.from_numpy(v).to(dev) for x, v in
         (('P', P), ('Q', Q), ('bu', bu), ('bi', bi))}
    Qd = t['Q'].to(torch.bfloat16) if q_bf16 else t['Q']
    ridx = rcnt = None
    if L:
        ri, rc = _rated(rng, B, I, L)
        ridx, rcnt = torch.from_numpy(ri).to(dev), torch.from_numpy(rc).to(dev)
    kw = dict(rated_idx=ridx, rated_cnt=rcnt, bf16_dot=fast, packed=fast)
    torch.backends.cuda.matmul.allow_tf32 = False
    k_idx, k_s = topn_scores_kernel(t['P'], Qd, t['bu'], t['bi'], mu, n, **kw)
    torch.cuda.synchronize()
    t_idx, t_s = topn_scores_ref(t['P'], Qd, t['bu'], t['bi'], mu,
                                 min(n + 1, I), **kw)
    ok, err, swaps = compare(k_idx.cpu(), k_s.cpu(), t_idx.cpu(), t_s.cpu(),
                             n, fast)
    rec = {'case': name, 'B': B, 'I': I, 'k': k, 'n': n, 'L': L,
           'fast': fast, 'mode': mode, 'ok': ok, 'max_abs_err': err,
           'swaps': swaps}
    if iters:
        rec['ms'] = timed_ms(lambda: topn_scores_kernel(
            t['P'], Qd, t['bu'], t['bi'], mu, n, **kw), iters)
        rec['plain_ms'] = timed_ms(lambda: topn_scores_ref(
            t['P'], Qd, t['bu'], t['bi'], mu, n, **kw), iters)
    rec['ids'] = k_idx.cpu().numpy()
    log('  %-28s ok=%s max_abs_err=%.3g swaps=%d%s' % (
        name, ok, err, swaps,
        ' kernel %.3f ms, plain %.3f ms' % (rec['ms'], rec['plain_ms'])
        if iters else ''))
    return rec


def phase2():
    return (phase2_topn(), phase2_half_pass(), phase2_pcg(),
            phase2_window_agg())


def phase2_topn():
    log('phase 2: K3 against its plain twin (tf32 off)')
    card = card_line()
    big = dict(B=1024, I=360_000, k=64, n=10)
    recs = [
        kernel_case('a exact', **big, iters=20),
        kernel_case('a exact rated64', **big, L=64, iters=20),
        kernel_case('b fast', **big, fast=True, q_bf16=True, iters=20),
        kernel_case('b fast rated64', **big, L=64, fast=True, q_bf16=True,
                    iters=20),
        kernel_case('c I=10001 k=128', B=37, I=10_001, k=128, n=10, L=16),
        kernel_case('c k=66 n=1', B=20, I=5_003, k=66, n=1, L=8),
        kernel_case('c n=1024', B=19, I=3_000, k=64, n=1024, L=100),
        kernel_case('c n=1024 fast', B=19, I=3_000, k=64, n=1024, L=100,
                    fast=True),
        kernel_case('c rated>n', B=33, I=4_000, k=64, n=10, L=2_048),
        kernel_case('c n=32', B=21, I=7_000, k=64, n=32, L=50),
        kernel_case('c n=33', B=21, I=7_000, k=64, n=33, L=50),
        kernel_case('c single chunk', B=5, I=300, k=16, n=7, L=10),
        kernel_case('c fast f32 Q k=66', B=40, I=9_999, k=66, n=12, L=40,
                    fast=True),
    ] + [kernel_case('c mode %s' % m, B=64, I=10_677, k=64, n=10, L=32,
                     mode=m) for m in ('bias', 'dot_plus_one', 'dot',
                                       'logistic')] + [
        # the serving batch at the ML-10M shape (pad_to=256)
        kernel_case('serving exact', B=256, I=10_677, k=64, n=10, L=256,
                    iters=50),
        kernel_case('serving fast', B=256, I=10_677, k=64, n=10, L=256,
                    fast=True, q_bf16=True, iters=50)]
    ex = recs[1]['ids']
    fa = recs[3]['ids']
    overlap = float(np.mean([len(set(ex[b]) & set(fa[b])) / ex.shape[1]
                             for b in range(ex.shape[0])]))
    log('  fast vs exact top-10 overlap at (b): %.4f' % overlap)
    for r in recs:
        if 'ms' in r:
            log('  time %-18s kernel %.3f ms, plain %.3f ms  [%s]'
                % (r['case'], r['ms'], r['plain_ms'], card))
    bad = [r['case'] for r in recs if not r['ok']]
    if bad or overlap < 0.99:
        raise SystemExit('phase 2 failed: %s, overlap %.4f' % (bad, overlap))
    return recs


@functools.lru_cache(maxsize=None)
def ml10m_stream():
    '''The ML-10M-shape rating stream of phases 2-4 (10M draws; the
    store keeps 8,346,084 unique pairs).'''
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    return synthetic_ratings(ML10M['U'], ML10M['I'],
                             nbr_ratings=ML10M['nnz'], rank=16, seed=0)


def ratings_stream(U, I, nnz):
    '''The ML-10M-shape stream at that shape (cached), else a fresh
    ``synthetic_ratings`` draw of the same law.'''
    if (U, I, nnz) == (ML10M['U'], ML10M['I'], ML10M['nnz']):
        return ml10m_stream()
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    return synthetic_ratings(U, I, nbr_ratings=nnz, rank=16, seed=0)


def _unique(u, i, v, U, I):
    from mfrec_tpu_torch.data.ratings import Ratings
    store = Ratings(U, I)
    store.set_many(u, i, v)
    return store.coo()


@functools.lru_cache(maxsize=None)
def unique_stream(U, I, nnz):
    '''``ratings_stream`` without duplicate pairs (the store's COO).'''
    return _unique(*ratings_stream(U, I, nnz), U, I)


@functools.lru_cache(maxsize=None)
def stream_layout(U, I, nnz, axis, W, B=16384):
    '''The ``sorted_pass_layout`` of ``unique_stream`` (cached: phase 2's
    kernels share them).'''
    from mfrec_tpu_torch.ops import sgd_mf
    u, i, v = unique_stream(U, I, nnz)
    return sgd_mf.sorted_pass_layout(u, i, v, B, axis=axis, max_window=W)


def _aug_factors(U, I, K, W, seed):
    '''Seeded augmented factors [P|bu|1], [Q|1|bi] with W spare rows,
    at the model's init scale (feature_init 0.05).'''
    from mfrec_tpu_torch.ops import sgd_mf
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 0.05, (U + W, K)).astype(np.float32)
    Q = rng.normal(0, 0.05, (I + W, K)).astype(np.float32)
    bu = rng.normal(0, 0.3, U + W).astype(np.float32)
    bi = rng.normal(0, 0.3, I + W).astype(np.float32)
    return sgd_mf.augment_factors(P, Q, bu, bi)


def roofline_ms(ops, nbytes):
    '''The least time for ``ops`` f32 operations and ``nbytes`` moved:
    the larger of the two over the card's peaks, in ms, and which one
    bounds it.'''
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def k1_bound(seg, k, T, flops=4.0):
    '''The least time the card could take for a K1 launch over
    ``seg``: the larger of its f32 operations (about ``flops``*k per
    rating and sweep; 4 for K1: dot, eff*ff, accumulate) over the FP32
    peak and the bytes it must move (the segment table, each fixed row
    once in bf16, each updated row read and written once) over the
    memory rate.'''
    import torch
    n = int(seg.ent_r.numel())
    nb = int(seg.blk_row.numel())
    ns = int(seg.seg_cnt.numel())
    nfix = int(torch.unique(seg.ent_fix).numel())
    ops = flops * k * T * n
    nbytes = (12.0 * n + 12.0 * nb + 8.0 * ns + 8.0 * k * nb + 2.0 * k * nfix
              + 8.0 * k)
    return roofline_ms(ops, nbytes)


def k1_case(name, F_upd, F_fix, layout, axis, batches=None, T=128, mu=3.5,
            lr=0.15, iters=0, plain_iters=1, zero_mask=False, device='cuda',
            **opts):
    '''K1 against its plain version on the card, in the working type
    (f32 factors, bf16 fixed side), over ``batches`` of a
    ``sorted_pass_layout`` (all of them by default).  Returns its
    record.'''
    import torch
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass, \
        half_pass_ref
    dev = torch.device(device)
    W = layout[-1]
    arrs = list(layout[:-1])
    if batches is not None:
        arrs = [a[np.asarray(batches)] for a in arrs]
    if zero_mask:
        arrs[3] = np.zeros_like(arrs[3])
    pl = sgd_mf.PassLayout(tuple(arrs) + (W,), axis, dev, segments=True)
    k = F_upd.shape[1]
    lrv, regv = (torch.from_numpy(a).to(dev) for a in sgd_mf.column_rates(
        k - 2, axis == 'user', lr, 0.02, 0.02, 0.15, 0.15, 0.01, 0.01))
    F0 = torch.from_numpy(F_upd).to(dev)
    Ffix = torch.from_numpy(F_fix).to(dev).to(torch.bfloat16)
    args = (Ffix, pl.batches(), W, lrv, regv, mu, T)
    Fk = F0.clone()
    sse_k = float(half_pass(Fk, *args, segments=pl.segments, **opts))
    Fp = F0.clone()
    sse_p = float(half_pass_ref(Fp, *args, **opts))
    diff = (Fk - Fp).abs()
    err = float(diff.max())
    ok_w = bool((diff <= K1_ATOL + K1_RTOL * Fp.abs()).all())
    sse_err = abs(sse_k - sse_p) / abs(sse_p) if sse_p else abs(sse_k)
    moved = float((Fk - F0).abs().max())
    finite = bool(torch.isfinite(Fk).all()) and np.isfinite(sse_k)
    ok = ok_w and finite and sse_err <= K1_SSE_RTOL and \
        ((moved == 0.0) if zero_mask else (moved > 0.0))
    seg = pl.segments
    rec = {'case': name, 'k': k, 'T': T, 'batches': pl.nbr_batches,
           'ratings': int(seg.ent_r.numel()), 'rows': int(seg.blk_row.numel()),
           'longest_row': seg.longest, 'ok': ok, 'max_abs_err': err,
           'sse_rel_err': sse_err}
    if iters:
        rec['ms'] = timed_ms(lambda: half_pass(
            Fk, *args, segments=pl.segments, **opts), iters)
        rec['plain_ms'] = timed_ms(lambda: half_pass_ref(Fp, *args, **opts),
                                   plain_iters)
        rec['bound_ms'], rec['bound_by'] = k1_bound(seg, k, T)
    log('  %-30s ok=%s max_abs_err=%.3g sse_rel_err=%.3g (%d ratings, %d '
        'rows)%s' % (name, ok, err, sse_err, rec['ratings'], rec['rows'],
                     ' kernel %.3f ms, plain %.3f ms, bound %.3f ms'
                     % (rec['ms'], rec['plain_ms'], rec['bound_ms'])
                     if iters else ''))
    return rec


def k1_kernel_ms(F_upd, F_fix, layout, axis, iters=3, only_row=None, T=128,
                 mu=3.5, device='cuda'):
    '''Device time of one K1 launch over a whole layout (or over
    ``only_row``'s ratings alone: that row's chain of segments).'''
    import torch
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    dev = torch.device(device)
    W = layout[-1]
    arrs = list(layout[:-1])
    if only_row is not None:
        key = arrs[0] if axis == 'user' else arrs[1]
        arrs[3] = arrs[3] * (key == only_row)
    pl = sgd_mf.PassLayout(tuple(arrs) + (W,), axis, dev, segments=True)
    k = F_upd.shape[1]
    lrv, regv = (torch.from_numpy(a).to(dev) for a in sgd_mf.column_rates(
        k - 2, axis == 'user', 0.15, 0.02, 0.02, 0.15, 0.15, 0.01, 0.01))
    F = torch.from_numpy(F_upd).to(dev)
    Ffix = torch.from_numpy(F_fix).to(dev).to(torch.bfloat16)
    ms = timed_ms(lambda: half_pass(F, Ffix, pl.batches(), W, lrv, regv, mu,
                                    T, segments=pl.segments), iters)
    bound, by = k1_bound(pl.segments, k, T)
    return ms, bound, by, pl.segments


def _longest_run_batch(layout):
    '''(batch, length) of the longest single-row run of a layout.'''
    kl, m = layout[4], layout[3]
    best = (0, 0)
    for b in range(kl.shape[0]):
        x = kl[b, :int(m[b].sum())]
        if x.size == 0:
            continue
        cuts = np.flatnonzero(np.diff(x)) + 1
        runs = np.diff(np.concatenate([[0], cuts, [x.size]]))
        if runs.max() > best[1]:
            best = (b, int(runs.max()))
    return best


def _boundary_pair(layout):
    '''The first batch b whose last row is batch b+1's first row.'''
    kl, m, lo = layout[4], layout[3], layout[5]
    for b in range(kl.shape[0] - 1):
        n = int(m[b].sum())
        if n and lo[b] + kl[b, n - 1] == lo[b + 1] + kl[b + 1, 0]:
            return b
    return None


def phase2_half_pass(U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz'], T=128,
                     device='cuda'):
    '''K1 against its plain version at the main-path shape and on edge
    cases; times at the main-path shape.'''
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    from mfrec_tpu_torch.ops import sgd_mf
    log('phase 2: K1 against its plain version (f32 factors, bf16 fixed '
        'side; window atol %g rtol %g, SSE rtol %g)'
        % (K1_ATOL, K1_RTOL, K1_SSE_RTOL))
    card = card_line()
    B, W, K = 16384, 128, 64
    kw = dict(T=T, device=device)
    t0 = time.perf_counter()
    _, i, v = unique_stream(U, I, nnz)
    lay = {a: stream_layout(U, I, nnz, a, W, B) for a in ('user', 'item')}
    Paug, Qaug = _aug_factors(U, I, K, W, seed=1)
    side = {'user': (Paug, Qaug), 'item': (Qaug, Paug)}
    log('  main-path layouts: %d ratings, %d user and %d item batches '
        '(%.1f s)' % (len(v), lay['user'][0].shape[0],
                      lay['item'][0].shape[0], time.perf_counter() - t0))
    recs = []
    for axis in ('user', 'item'):
        nb = min(16, lay[axis][0].shape[0])
        recs.append(k1_case('main first%d %s' % (nb, axis), *side[axis],
                            lay[axis], axis, batches=range(nb), iters=5,
                            plain_iters=2, **kw))
    runs = {a: _longest_run_batch(lay[a]) for a in lay}
    axis = max(runs, key=lambda a: runs[a][1])
    b, n = runs[axis]
    recs.append(k1_case('main longest segment (%s %d, %d)' % (axis, b, n),
                        *side[axis], lay[axis], axis, batches=[b], **kw))
    pairs = [(a, _boundary_pair(lay[a])) for a in ('user', 'item')]
    axis, b = next((a, b) for a, b in pairs + [(None, None)]
                   if a is None or b is not None)
    if axis is None:
        raise SystemExit('no batch pair shares a boundary row')
    recs.append(k1_case('main boundary pair (%s %d)' % (axis, b),
                        *side[axis], lay[axis], axis, batches=[b, b + 1],
                        **kw))
    # edge cases on a reduced stream
    su, si, sv = _unique(*synthetic_ratings(3000, 700, 60_000, rank=16,
                                            seed=1), 3000, 700)
    small = {a: sgd_mf.sorted_pass_layout(su, si, sv, B, axis=a,
                                          max_window=W)
             for a in ('user', 'item')}
    sP, sQ = _aug_factors(3000, 700, K, W, seed=2)
    wP, wQ = _aug_factors(3000, 700, 128, W, seed=3)
    edge = [('edge logistic', dict(link='logistic', clamp_pred=False,
                                   mu=0.0)),
            ('edge bias_none', dict(bias_none=True)),
            ('edge row_mean=False', dict(row_mean=False, lr=0.01)),
            ('edge clamp_pred=False', dict(clamp_pred=False)),
            ('edge all-masked batch', dict(zero_mask=True))]
    for name, opts in edge:
        recs.append(k1_case(name, sP, sQ, small['user'], 'user',
                            batches=[0, 1], **opts, **kw))
    recs.append(k1_case('edge k=130', wP, wQ, small['user'], 'user',
                        batches=[0, 1], **kw))
    recs.append(k1_case('reduced whole half-pass user', sP, sQ,
                        small['user'], 'user', **kw))
    recs.append(k1_case('reduced whole half-pass item', sQ, sP,
                        small['item'], 'item', **kw))
    # whole half-passes at the main-path shape, and the longest chain
    timing = {}
    for axis in ('user', 'item'):
        ms, bound, by, seg = k1_kernel_ms(*side[axis], lay[axis], axis,
                                          **kw)
        timing[axis] = dict(ms=ms, bound_ms=bound, bound_by=by,
                            longest=seg.longest,
                            longest_segments=seg.longest_segments)
        log('  time whole %s half-pass: kernel %.3f ms, bound %.3f ms (%s);'
            ' longest row %d ratings in %d segments  [%s]'
            % (axis, ms, bound, by, seg.longest, seg.longest_segments, card))
    hot = int(np.bincount(i).argmax())           # the most-rated item
    ms, bound, by, seg = k1_kernel_ms(*side['item'], lay['item'], 'item',
                                      only_row=hot, **kw)
    timing['chain'] = dict(ms=ms, bound_ms=bound, row=hot,
                           ratings=seg.longest,
                           segments=seg.longest_segments)
    log('  time longest chain (item %d, %d ratings, %d segments): kernel '
        '%.3f ms, %.1f %% of the item half-pass, bound %.3f ms  [%s]'
        % (hot, seg.longest, seg.longest_segments, ms,
           100.0 * ms / timing['item']['ms'], bound, card))
    for r in recs:
        if 'ms' in r:
            log('  time %-26s kernel %.3f ms, plain %.3f ms, bound %.3f ms '
                '(%s)  [%s]' % (r['case'], r['ms'], r['plain_ms'],
                                r['bound_ms'], r['bound_by'], card))
    bad = [r['case'] for r in recs if not r['ok']]
    if bad:
        raise SystemExit('phase 2 (K1) failed: %s' % bad)
    return recs, timing



def _http(port, path, payload=None):
    import urllib.request
    req = urllib.request.Request(
        'http://127.0.0.1:%d%s' % (port, path),
        data=None if payload is None else json.dumps(payload).encode(),
        method='GET' if payload is None else 'POST')
    with urllib.request.urlopen(req, timeout=120) as r:
        if r.status != 200:
            raise SystemExit('%s answered %d' % (path, r.status))
        return json.loads(r.read())


def _served_vs_twin(view, users, items, scores, fast):
    '''The served lists of ``users`` against the kernel's twin on the
    card, built from the same serving view.'''
    import torch
    from mfrec_tpu_torch.ops import topk
    from mfrec_tpu_torch.ops.topn_kernel import (kernel_rated_lists,
                                                 topn_scores_ref)
    m = view.model
    dev = m.device
    mode = m._predictor_mode(view.predictor)
    bu, bi, mu, _ = m._pallas_score_terms(mode)
    ridx, rmask = topk.pad_rated_lists(m.ratings, users,
                                       pad_to=view.rated_pad)
    ridx, rcnt = kernel_rated_lists(ridx, rmask)
    n = len(items[0])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    Q = t(np.asarray(m.Q, np.float32))
    if fast:
        Q = Q.to(torch.bfloat16)
    ref_idx, ref_s = topn_scores_ref(
        t(np.asarray(m.P[users], np.float32)), Q, t(bu[users]), t(bi), mu,
        n + 1, t(ridx), t(rcnt), bf16_dot=fast, packed=fast)
    return compare(np.asarray(items), np.asarray(scores), ref_idx.cpu(),
                   ref_s.cpu(), n, fast)


def phase3(U=69_878, I=10_677, nnz=10_000_000, device='cuda'):
    import tempfile
    import threading
    from mfrec_tpu_torch import interop
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    from mfrec_tpu_torch.serving import RecommenderServer

    K = 64
    t0 = time.perf_counter()
    u, i, v = ratings_stream(U, I, nnz)
    m = GDRecommender(U, I, {'nbr_features': K}, device=device)
    m.seed(0)
    m.set_ratings(u, i, v)
    m.init_feature_normal()
    m.compute_items_bias_bk()
    m.compute_users_bias_bk()
    log('phase 3: GDRecommender %d x %d, rank %d, nnz %d (duplicates '
        'removed), built in %.1f s' % (U, I, K, m.ratings.nnz,
                                       time.perf_counter() - t0))
    with tempfile.TemporaryDirectory() as d:
        m.save_state(os.path.join(d, 'gd'))
        model = interop.load_jax_state(os.path.join(d, 'gd'), device=device)
    for name in ('P', 'Q', 'users_bias', 'items_bias'):
        if not np.array_equal(getattr(m, name), getattr(model, name)):
            raise SystemExit('checkpoint round trip changed %s' % name)
    if model.ratings.nnz != m.ratings.nnz:
        raise SystemExit('checkpoint round trip changed the ratings')
    del m
    rng = np.random.default_rng(1)
    card = card_line()
    worst = 0.0
    topn_scores_kernel.launches = 0      # from here on: the main path only
    for retrieval in ('xla', 'fast'):
        fast = retrieval == 'fast'
        for predictor in ('predict', 'predict_rating_with_bias'):
            srv = RecommenderServer(model, pad_to=256, retrieval=retrieval,
                                    predictor=predictor)
            port = srv.start()
            try:
                health = _http(port, '/health')
                if health != {'ok': True, 'users': U, 'items': I}:
                    raise SystemExit('bad /health: %s' % health)
                users = rng.choice(U, 64, replace=False)
                got = {}

                def hit(uu):
                    got[uu] = _http(port, '/recommend?user=%d&n=10' % uu)

                launches0 = topn_scores_kernel.launches
                rounds, t1 = 4, time.perf_counter()
                for _ in range(rounds):
                    threads = [threading.Thread(target=hit, args=(int(x),))
                               for x in users]
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join(timeout=300)
                    if any(th.is_alive() for th in threads):
                        raise SystemExit('requests did not finish')
                rps = rounds * len(users) / (time.perf_counter() - t1)
                calls = topn_scores_kernel.launches - launches0
                items = [got[int(x)]['items'] for x in users]
                scores = [got[int(x)]['scores'] for x in users]
                if not np.isfinite(np.asarray(scores)).all():
                    raise SystemExit('non-finite served scores')
                ok, err, swaps = _served_vs_twin(srv.view, users, items,
                                                 scores, fast)
                worst = max(worst, err)
                log('  %-4s %-24s 64 concurrent x %d: %.1f requests/s in '
                    '%d K3 calls; vs twin ok=%s max_abs_err=%.3g swaps=%d'
                    '  [%s]' % (retrieval, predictor, rounds, rps, calls, ok,
                                err, swaps, card))
                if not ok:
                    raise SystemExit('served lists disagree with the twin')
                pred = _http(port, '/predict?user=%d&item=7' % users[0])
                want = model.predict(7, int(users[0]))
                if abs(pred['score'] - want) > 1e-5:
                    raise SystemExit('bad /predict: %s vs %s' % (pred, want))
                sim = _http(port, '/similar_items?item=7&n=5')
                if len(sim['items']) != 5 or 7 in sim['items']:
                    raise SystemExit('bad /similar_items: %s' % sim)
                # a rating on the user's best item takes it off the list
                x, best = int(users[0]), items[0][0]
                _http(port, '/rate', {'user': x, 'item': best, 'value': 5.0})
                srv.refresh()
                after = _http(port, '/recommend?user=%d&n=10' % x)
                if best in after['items']:
                    raise SystemExit('rated item %d still served' % best)
                ok, err, _ = _served_vs_twin(srv.view, np.array([x]),
                                             [after['items']],
                                             [after['scores']], fast)
                if not ok:
                    raise SystemExit('served list after /rate disagrees')
            finally:
                srv.stop()
    launches = topn_scores_kernel.launches
    log('  K3 launches during phase 3: %d' % launches)
    if launches == 0:
        raise SystemExit('the serving path never launched K3')
    return launches, worst


def bias_floor_rmse(users, items, vals, U, I):
    '''Training RMSE of the best mu + b_i + b_u predictor (the JAX
    bench's floor, ``mfrec_tpu_torch.tools.bench_data``'s copy), which a
    model that learns no structure cannot beat.'''
    from mfrec_tpu_torch.tools import bench_data
    return bench_data.bias_floor_rmse(users, items, vals, U, I)[0]


def retrieval_vs_plain(m, users, predictors):
    '''``recommend_batch(users, 10)`` from a trained model (K3 on a CUDA
    model) held to the plain top-n on the same device, per predictor.'''
    import torch
    from mfrec_tpu_torch.ops import topk
    from mfrec_tpu_torch.ops.topn_kernel import (kernel_rated_lists,
                                                 topn_agreement,
                                                 topn_scores_ref)
    dev = m.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for predictor in predictors:
        idx, scores = m.recommend_batch(users, 10, predictor=predictor)
        if not np.isfinite(scores).all():
            raise SystemExit('non-finite scores from the trained model')
        bu, bi, mu, _ = m._pallas_score_terms(m._predictor_mode(predictor))
        ridx, rmask = topk.pad_rated_lists(m.ratings, users)
        ridx, rcnt = kernel_rated_lists(ridx, rmask)
        ref = topn_scores_ref(t(m.P[users]), t(m.Q), t(bu[users]), t(bi), mu,
                              11, t(ridx), t(rcnt))
        ok, err, swaps = topn_agreement(idx, scores, ref[0].cpu(),
                                        ref[1].cpu(), 10, EXACT_ATOL,
                                        tie=EXACT_TIE)
        log('  recommend_batch(%d users, %s) from the trained model: ok=%s '
            'max_abs_err=%.3g swaps=%d' % (len(users), predictor, ok, err,
                                           swaps))
        if not ok:
            raise SystemExit('retrieval from the trained model disagrees')


def phase4(U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz'], device='cuda'):
    '''The training slice through the public path at the JAX bench's
    model parameters (bench.py bench_model): rank 64, feature_init 0.05,
    regularization 0.02, epochs pinned by min=max, everything else at
    the shipped defaults (engine auto, batch 16384, T=128, W=128,
    lr 0.15).'''
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    K = 64
    card = card_line()
    t0 = time.perf_counter()
    u, i, v = ratings_stream(U, I, nnz)
    m = GDRecommender(U, I, {'nbr_features': K, 'feature_init': 0.05,
                             'regularization_model': 0.02,
                             'min_improvement': -1.0}, device=device)
    m.seed(0)
    m.set_ratings(u, i, v)
    uu, ii, vv = m.ratings.coo()
    n = int(m.ratings.nnz)
    floor = bias_floor_rmse(uu, ii, vv, U, I)
    log('phase 4: GDRecommender(%d, %d, rank %d).train(handle_bias=True) on '
        '%s, %d ratings, engine %s, batch %d, T=%d; bias-only floor %.4f '
        '(%.1f s to build)' % (U, I, K, device, n, m.engine, m.batch_size,
                               m.inner_steps, floor,
                               time.perf_counter() - t0))

    def train(epochs):
        m.min_epochs = m.max_epochs = epochs
        m.train(handle_bias=True)

    res = epochs_timed(train, lambda: m.rmse_history, card, device)
    k1_launches = half_pass.launches
    epoch_s, marg, hist, h5 = (res['epoch_s'], res['epoch_s_blocks'],
                               res['hist'], res['rmse'])
    T = int(m.inner_steps)
    updates = n * K * T / epoch_s
    log('  warm-up 1 epoch %.2f s (rmse %.4f)' % (res['warmup_s'],
                                                  res['warmup_rmse']))
    log('  rmse per epoch (last 5-epoch run): %s' % ' '.join(
        '%.4f' % x for x in h5))
    log('  epoch %.4f s (median of 3), %.4g updates/s (nnz*K*T/epoch_s), '
        'K1 launches %d (3 x 7 epochs x 2 half-passes), final rmse %.4f vs '
        'floor %.4f  [%s]' % (epoch_s, updates, k1_launches, h5[-1], floor,
                              card))
    if not all(np.isfinite(hist)):
        raise SystemExit('non-finite training RMSE: %s' % hist)
    if not h5[-1] < floor:
        raise SystemExit('final RMSE %.4f does not beat the bias-only floor '
                         '%.4f' % (h5[-1], floor))
    if device == 'cuda' and k1_launches == 0:
        raise SystemExit('the training path never launched K1')
    # both paths meet: retrieval from the trained model, held to the plain
    # top-n on the same device
    users = np.random.default_rng(3).choice(U, 256, replace=False)
    retrieval_vs_plain(m, users, ('predict', 'predict_rating_with_bias'))
    k3_launches = topn_scores_kernel.launches
    log('  K1 launches %d, K3 launches %d during phase 4'
        % (k1_launches, k3_launches))
    if device == 'cuda' and k3_launches == 0:
        raise SystemExit('retrieval from the trained model never launched K3')
    return dict(k1_launches=k1_launches, k3_launches=k3_launches,
                epoch_s=epoch_s, epoch_s_blocks=marg, updates_per_s=updates,
                rmse=h5, floor=floor, warmup_s=res['warmup_s'])


def pcg_bound(R, k, steps):
    '''K2's least time on R systems: M, b and x0 read and x written once,
    4R(k^2 + 3k) bytes over the memory rate, against its 2Rk^2(steps + 1)
    f32 operations over the FP32 peak.'''
    return roofline_ms(2.0 * R * k * k * (steps + 1),
                       4.0 * R * (k * k + 3 * k))


def pcg_systems(R, k, kind, seed, device):
    '''Seeded ``(M, b, x0)`` on ``device`` for a K2 check.  ``kind``:
    'spd' (B B^T + 3I, as tests/test_als.py builds them; warm x0),
    'cold' (x0 = 0), 'b0' (b = 0), 'solved' (M = I and x0 = b: r = 0,
    so every step size takes its guard), 'identity' (M = I), 'asym'
    (the CG path's bf16 assembly ``ops.als.cg_system`` with alpha = 2:
    not symmetric).'''
    import torch
    from mfrec_tpu_torch.ops import als as als_ops
    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    if kind == 'asym':
        n, L = 3 * k + 50, 24
        F = t(rng.normal(0, 0.3, (n, k)))
        idx = torch.from_numpy(rng.integers(0, n, (R, L)).astype(np.int32))
        val = t(rng.uniform(1, 5, (R, L)))
        mask = t(rng.random((R, L)) > 0.2)
        out = t(rng.normal(0, 0.1, (R, k)))
        M, b, x0 = als_ops.cg_system(
            F.to(torch.bfloat16), out, als_ops._hh(F, 0.015),
            torch.arange(R, device=dev), idx.to(dev), val, mask, 1.0, 2.0)
        return M, b, x0
    if kind in ('solved', 'identity'):
        M = np.broadcast_to(np.eye(k, dtype=np.float32), (R, k, k))
    else:
        B = rng.normal(0, 1, (R, k, k)).astype(np.float32)
        M = np.einsum('rij,rkj->rik', B, B) + 3.0 * np.eye(k,
                                                            dtype=np.float32)
    b = np.zeros((R, k), np.float32) if kind == 'b0' else \
        rng.normal(0, 1, (R, k)).astype(np.float32)
    x0 = np.zeros((R, k), np.float32) if kind == 'cold' else \
        b if kind == 'solved' else \
        rng.normal(0, 0.1, (R, k)).astype(np.float32)
    return t(M), t(b), t(x0)


def pcg_case(name, M, b, x0, steps, iters=0, plain_iters=0, f64=False):
    '''K2 against its plain version on the same inputs; returns its
    record (with kernel and plain times when ``iters``).

    ``f64``: also run the iteration in float64 on the same inputs (the
    plain loop ``ops.als.pcg_solve``).  Mid-way through a warm-started
    solve of the real buckets, f32 CG trajectories that differ only in
    summation order drift apart faster than PCG_ATOL/PCG_RTOL allow (at 6
    steps the two plain torch versions differ from each other, and numpy's
    f32 iteration from the f64 one, by ~2e-4; they meet again once PCG
    converges).  There the kernel passes when it is as close to the
    float64 iteration as its plain version is, within a factor of 2.'''
    import torch
    from mfrec_tpu_torch.ops import als as als_ops
    from mfrec_tpu_torch.ops.cg_kernel import pcg_solve_kernel, \
        pcg_solve_ref
    xk = pcg_solve_kernel(M, b, x0, steps)
    if M.is_cuda:
        torch.cuda.synchronize()
    xp = pcg_solve_ref(M, b, x0, steps)
    diff = (xk - xp).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    within = bool((diff <= PCG_ATOL + PCG_RTOL * xp.abs()).all())
    ok = bool(torch.isfinite(xk).all()) and within
    R, k = b.shape
    rec = {'case': name, 'R': R, 'k': k, 'steps': steps, 'ok': ok,
           'max_abs_err': err, 'within_tolerance': within}
    if f64:
        x64 = als_ops.pcg_solve(M.double(), b.double(), x0.double(), steps)
        rec['kernel_err_f64'] = float((xk.double() - x64).abs().max())
        rec['plain_err_f64'] = float((xp.double() - x64).abs().max())
        rec['ok'] = bool(torch.isfinite(xk).all()) and (
            within or rec['kernel_err_f64'] <= 2.0 * rec['plain_err_f64'])
        ok = rec['ok']
        log('  %-34s against the float64 iteration: kernel %.3g, plain '
            'version %.3g' % (name, rec['kernel_err_f64'],
                              rec['plain_err_f64']))
    if iters:
        rec['ms'] = timed_ms(lambda: pcg_solve_kernel(M, b, x0, steps), iters)
        rec['plain_ms'] = timed_ms(lambda: pcg_solve_ref(M, b, x0, steps),
                                   plain_iters or iters)
        rec['bound_ms'], rec['bound_by'] = pcg_bound(R, k, steps)
    log('  %-34s ok=%s max_abs_err=%.3g%s%s' % (
        name, ok, err, '' if within else ' (outside atol %g rtol %g)'
        % (PCG_ATOL, PCG_RTOL), ' kernel %.3f ms, plain %.3f ms, bound '
        '%.3f ms' % (rec['ms'], rec['plain_ms'], rec['bound_ms'])
        if iters else ''))
    return rec


def phase2_pcg(device='cuda'):
    '''K2 against its plain version on edge cases: R of 1, 37 and 4,099
    (a ragged last block), k from 8 to 256 (the streamed-M layout at 256,
    odd and non-multiple-of-4 k), steps 0, the guards and the
    asymmetric assembly; then timed at R=48,547, k=64 (the ALS epoch's
    largest bucket) on random systems.'''
    from mfrec_tpu_torch.ops.cg_kernel import pcg_solve_kernel
    log('phase 2: K2 against its plain version (atol %g, rtol %g)'
        % (PCG_ATOL, PCG_RTOL))
    cases = [('R=1 k=8', 1, 8, 'spd', 5), ('R=37 k=8 cold', 37, 8, 'cold', 1),
             ('R=37 k=20', 37, 20, 'spd', 5),
             ('R=37 k=20 steps=0', 37, 20, 'spd', 0),
             ('R=37 k=37 (odd k)', 37, 37, 'spd', 5),
             ('R=37 k=64', 37, 64, 'spd', 5),
             ('R=37 k=130', 37, 130, 'spd', 5),
             ('R=37 k=130 steps=0', 37, 130, 'spd', 0),
             ('R=37 k=256 (M streamed)', 37, 256, 'spd', 5),
             ('R=1 k=256 steps=0', 1, 256, 'spd', 0),
             ('R=37 k=64 b=0', 37, 64, 'b0', 5),
             ('R=37 k=64 solved (r=0)', 37, 64, 'solved', 5),
             ('R=37 k=256 solved (r=0)', 37, 256, 'solved', 3),
             ('R=37 k=64 identity', 37, 64, 'identity', 5),
             ('R=37 k=20 asymmetric alpha=2', 37, 20, 'asym', 3),
             ('R=37 k=64 asymmetric alpha=2', 37, 64, 'asym', 6),
             ('R=37 k=130 asymmetric alpha=2', 37, 130, 'asym', 6),
             ('R=4099 k=64', 4099, 64, 'spd', 3)]
    recs = []
    for j, (name, R, k, kind, steps) in enumerate(cases):
        M, b, x0 = pcg_systems(R, k, kind, seed=j, device=device)
        if kind == 'asym' and not bool((M - M.transpose(1, 2)).abs().max()
                                       > 0):
            raise SystemExit('the asymmetric case came out symmetric')
        recs.append(pcg_case(name, M, b, x0, steps))
    # times at the ALS epoch's largest bucket shape, on random systems
    M, b, x0 = pcg_systems(48547, 64, 'spd', seed=1, device=device)
    for steps in (3, 6):
        recs.append(pcg_case('R=48547 k=64 steps=%d' % steps, M, b, x0,
                             steps, iters=10, plain_iters=3))
    M, b, x0 = pcg_systems(0, 64, 'spd', seed=0, device=device)
    before = pcg_solve_kernel.launches
    empty = pcg_solve_kernel(M, b, x0, 3)
    if tuple(empty.shape) != (0, 64) or pcg_solve_kernel.launches != before:
        raise SystemExit('R=0 must return [0, k] without a launch')
    bad = [r['case'] for r in recs if not r['ok']]
    if bad:
        raise SystemExit('phase 2 (K2) failed: %s' % bad)
    return recs


def k4_call_bound(n_in, B, k, W):
    '''K4's least time for one call: the masked-in rows of g read once,
    kl and mask read once, gsum and cnt written once, over the memory
    rate, against its n_in*k adds over the FP32 peak.'''
    return roofline_ms(float(n_in) * k,
                       4.0 * n_in * k + 8.0 * B + 4.0 * W * (k + 1))


def k4_scan_bound(seg, k):
    '''K4's least time for a whole phase: the rows read once, the
    segment table once, each touched target row read and written once.'''
    n = int(seg.ent_r.numel())
    nb = int(seg.blk_row.numel())
    ns = int(seg.seg_cnt.numel())
    return roofline_ms(float(n) * k,
                       4.0 * n * k + 4.0 * (ns + 1) + 12.0 * nb + 8.0 * k * nb)


def _k4_ok(got, want, exact):
    '''K4 against its plain version ``want``: every element within
    K4_ATOL + K4_RTOL*|want|, or -- where a long sum cancels, so that two
    f32 orders of the same bf16 rows land further apart than that -- at
    most twice as far from ``exact`` (the float64 sum of the same bf16
    rows) as the plain version is.  Returns (ok, max abs err vs the plain
    version, that of the kernel and of the plain version vs float64).'''
    import torch
    if not got.numel():
        return True, 0.0, 0.0, 0.0
    diff = (got - want).abs()
    err = float(diff.max())
    k64 = float((got.double() - exact).abs().max())
    p64 = float((want.double() - exact).abs().max())
    within = bool((diff <= K4_ATOL + K4_RTOL * want.abs()).all())
    ok = bool(torch.isfinite(got).all()) and (within or k64 <= 2.0 * p64)
    return ok, err, k64, p64


def k4_case(name, g, kl, m, W, iters=0, plain_iters=0):
    '''K4's per-call entry against its plain version on the same inputs
    (counts exactly, sums within K4_ATOL/K4_RTOL, a second launch
    bit-identical); with ``iters`` the kernel, the plain version, one
    ``index_add_`` of the pre-rounded rows (the library yardstick) and
    the bound.'''
    import torch
    from mfrec_tpu_torch.ops.window_agg_kernel import (window_aggregate,
                                                       window_aggregate_ref)
    gs, cnt = window_aggregate(g, kl, m, W)
    if g.is_cuda:
        torch.cuda.synchronize()
    rs, rc = window_aggregate_ref(g, kl, m, W)
    keep = m > 0
    exact = torch.zeros(gs.shape, dtype=torch.float64, device=g.device)
    exact.index_add_(0, kl[keep].long(),
                     g[keep].to(torch.bfloat16).double())
    ok, err, k64, p64 = _k4_ok(gs, rs, exact)
    again, _ = window_aggregate(g, kl, m, W, check_ids=False)
    ok = ok and torch.equal(cnt, rc) and torch.equal(again, gs)
    B, k = g.shape
    n_in = int(keep.sum())
    rec = {'case': name, 'B': B, 'W': W, 'k': k, 'rows_in': n_in, 'ok': ok,
           'max_abs_err': err, 'kernel_err_f64': k64, 'plain_err_f64': p64}
    if iters:
        rec['ms'] = timed_ms(lambda: window_aggregate(g, kl, m, W,
                                                      check_ids=False), iters)
        rec['plain_ms'] = timed_ms(
            lambda: window_aggregate_ref(g, kl, m, W), plain_iters or iters)
        idx, g16 = kl[keep].long(), g[keep].to(torch.bfloat16).float()
        out = torch.zeros((W, k), dtype=torch.float32, device=g.device)
        rec['library_ms'] = timed_ms(lambda: out.index_add_(0, idx, g16),
                                     iters)
        rec['bound_ms'], rec['bound_by'] = k4_call_bound(n_in, B, k, W)
    times = ' kernel %.4f ms, plain %.4f ms, index_add_ %.4f ms, bound %.4f ' \
        'ms' % (rec['ms'], rec['plain_ms'], rec['library_ms'],
                rec['bound_ms']) if iters else ''
    log('  %-44s ok=%s max_abs_err=%.3g (float64: kernel %.3g, plain %.3g;'
        ' %d of %d rows in)%s' % (name, ok, err, k64, p64, n_in, B, times))
    return rec


def k4_scan_case(name, seg, k, rows, seed, iters=0, plain_iters=0,
                 mean=False):
    '''K4's phase entry (``scan_aggregate``) over segment table ``seg``
    against its plain version, from a random target and random rows;
    with ``iters`` its times (``index_add_`` of the pre-rounded rows into
    their target rows is the library yardstick) and the bound.'''
    import torch
    from mfrec_tpu_torch.ops.window_agg_kernel import (scan_aggregate,
                                                       scan_aggregate_ref)
    dev = seg.ent_r.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = int(seg.ent_r.shape[0])
    vals = torch.randn((n, k), generator=gen, device=dev)
    t0 = torch.randn((rows, k), generator=gen, device=dev)
    got = scan_aggregate(t0.clone(), vals, seg, mean)
    if vals.is_cuda:
        torch.cuda.synchronize()
    want = scan_aggregate_ref(t0.clone(), vals, seg, mean)
    exact = scan_aggregate_ref(t0.double(), vals, seg, mean)
    ok, err, k64, p64 = _k4_ok(got, want, exact)
    rec = {'case': name, 'k': k, 'entries': n,
           'rows': int(seg.blk_row.numel()), 'longest_row': seg.longest,
           'ok': ok, 'max_abs_err': err, 'kernel_err_f64': k64,
           'plain_err_f64': p64}
    del got, want, exact
    if iters:
        tk = t0.clone()
        rec['ms'] = timed_ms(lambda: scan_aggregate(tk, vals, seg, mean),
                             iters)
        rec['plain_ms'] = timed_ms(
            lambda: scan_aggregate_ref(tk, vals, seg, mean),
            plain_iters or iters)
        idx, v16 = seg.ent_row.long(), vals.to(torch.bfloat16).float()
        rec['library_ms'] = timed_ms(lambda: tk.index_add_(0, idx, v16),
                                     iters)
        rec['bound_ms'], rec['bound_by'] = k4_scan_bound(seg, k)
        del idx, v16, tk
    log('  %-44s ok=%s max_abs_err=%.3g (float64: kernel %.3g, plain %.3g;'
        ' %d rows in %d target rows, longest %d)%s'
        % (name, ok, err, k64, p64, n, rec['rows'], seg.longest,
                   ' kernel %.3f ms, plain %.3f ms, index_add_ %.3f ms, bound '
                   '%.3f ms' % (rec['ms'], rec['plain_ms'], rec['library_ms'],
                                rec['bound_ms']) if iters else ''))
    return rec


def phase2_window_agg(U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz'],
                      device='cuda'):
    '''K4 against its plain version: the per-call entry at the JAX
    call's shape on real ML-10M-layout batches (B=16384, W=128, k=66: a
    user batch and the item batch with the longest run), at the SVD++ and
    FN item-step shapes (W=512, k=64 and the FN's two-in-one k=128), and
    on edge cases; the phase entry on the whole W=512 user layout (the
    SVD++/FN aggregation phases, k=64) and item layout (its hot rows).'''
    import torch
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    log('phase 2: K4 against its plain version (counts exact, sums atol %g '
        'rtol %g, or where a long sum cancels at most twice as far from the '
        'float64 sum as the plain version)' % (K4_ATOL, K4_RTOL))
    card = card_line()
    dev = torch.device(device)
    t0 = time.perf_counter()
    lay = {(a, W): stream_layout(U, I, nnz, a, W) for a in ('user', 'item')
           for W in (128, 512)}
    log('  ML-10M-shape layouts at W=128 and 512 (%.1f s)'
        % (time.perf_counter() - t0))
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def call(name, layout, b, k, W):
        g = rng.normal(0, 1, (layout[4].shape[1], k)).astype(np.float32)
        return k4_case(name, t(g), t(layout[4][b]), t(layout[3][b]), W,
                       iters=50, plain_iters=10)

    hb, hn = _longest_run_batch(lay['item', 128])
    recs = [call('JAX call: user batch 0 (W=128, k=66)', lay['user', 128],
                 0, 66, 128),
            call('JAX call: item batch %d, run %d (W=128, k=66)' % (hb, hn),
                 lay['item', 128], hb, 66, 128),
            call('Y step: item batch 0 (W=512, k=64)', lay['item', 512], 0,
                 64, 512),
            call('X/Y step: item batch 0 (W=512, k=128)', lay['item', 512],
                 0, 128, 512)]

    def edge(name, B, k, W, kind):
        g = rng.normal(0, 1, (B, k)).astype(np.float32)
        kl = np.sort(rng.integers(0, W, B)).astype(np.int32)
        m = np.ones(B, np.float32)
        if kind == 'masked':
            m[:] = 0.0
        elif kind == 'one id':
            kl[:] = W // 3
        elif kind == 'unsorted':
            rng.shuffle(kl)
            m = (rng.random(B) > 0.2).astype(np.float32)
        return k4_case(name, t(g), t(kl), t(m), W)

    recs += [edge('edge everything masked', 16384, 66, 128, 'masked'),
             edge('edge W=1', 5000, 66, 1, 'sorted'),
             edge('edge k=1', 16384, 1, 128, 'sorted'),
             edge('edge k=256', 8192, 256, 512, 'sorted'),
             edge('edge every row on one id', 16384, 66, 128, 'one id'),
             edge('edge unsorted ids, k=130', 3001, 130, 512, 'unsorted'),
             edge('edge B=0', 0, 64, 128, 'sorted')]
    scans = []
    for axis, iters in (('user', 10), ('item', 3)):
        L = lay[axis, 512]
        fix = L[1] if axis == 'user' else L[0]
        seg = hk.build_segments(fix, L[2], L[3], L[4], L[5], 512, dev)
        rows = (U if axis == 'user' else I) + 512
        scans.append(k4_scan_case('phase: whole %s layout (W=512, k=64)'
                                  % axis, seg, 64, rows, seed=len(scans),
                                  iters=iters, plain_iters=2))
        del seg
    L = stream_layout(*REDUCED, 'user', 512)
    seg = hk.build_segments(L[1], L[2], L[3], L[4], L[5], 512, dev)
    scans.append(k4_scan_case('phase mean=True: reduced user layout', seg,
                              66, REDUCED[0] + 512, seed=5, mean=True))
    for r in recs + scans:
        if 'ms' in r:
            log('  time %-44s kernel %.4f ms, plain %.4f ms, index_add_ '
                '%.4f ms, bound %.4f ms (%s)  [%s]'
                % (r['case'], r['ms'], r['plain_ms'], r['library_ms'],
                   r['bound_ms'], r['bound_by'], card))
    bad = [r['case'] for r in recs + scans if not r['ok']]
    if bad:
        raise SystemExit('phase 2 (K4) failed: %s' % bad)
    return {'recs': recs, 'scans': scans}


def make_implicit_data(U, I, N, seed=0, clusters=32, heldout_per_user=3):
    '''Copy of ``bench.py``'s ``make_implicit_data`` (bench.py:178-216):
    implicit interactions with planted cluster structure.  Users belong
    to taste clusters, each with its own popularity-skewed item
    propensity.  Returns (train_users, train_items, test_users,
    test_items): the last ``heldout_per_user`` interactions of each user
    with at least twice that many are held out.'''
    rng = np.random.default_rng(seed)
    cu = rng.integers(0, clusters, U)
    ranks = np.arange(1, I + 1, dtype=np.float64)
    pop = 1.0 / ranks ** 1.1
    aff = rng.gamma(0.3, 1.0, (clusters, I))
    probs = aff * pop[None, :]
    probs /= probs.sum(1, keepdims=True)
    users = rng.integers(0, U, N).astype(np.int32)
    items = np.empty(N, np.int32)
    ucl = cu[users]
    for c in range(clusters):
        sel = np.nonzero(ucl == c)[0]
        items[sel] = rng.choice(I, sel.size, p=probs[c]).astype(np.int32)
    order = np.argsort(users, kind='stable')
    su, si = users[order], items[order]
    starts = np.searchsorted(su, np.arange(U))
    ends = np.searchsorted(su, np.arange(U) + 1)
    counts = ends - starts
    test_mask = np.zeros(N, bool)
    eligible = counts >= 2 * heldout_per_user
    for h in range(1, heldout_per_user + 1):
        test_mask[ends[eligible] - h] = True
    return (su[~test_mask], si[~test_mask],
            su[test_mask], si[test_mask])


def _gate_users(test_u, max_users):
    '''The gate's users (the first ``max_users`` with held-out items) and
    each one's held-out segment of ``test_i`` in ``test_u`` order.'''
    eval_users = np.unique(test_u)[:max_users]
    order = np.argsort(test_u, kind='stable')
    starts = np.searchsorted(test_u[order], eval_users)
    ends = np.searchsorted(test_u[order], eval_users + 1)
    return eval_users, order, starts, ends


def _hits(top, test_i, order, starts, ends, s0):
    ti = test_i[order]
    return sum(len(set(ti[starts[s0 + j]:ends[s0 + j]].tolist())
                   & set(top[j].tolist())) for j in range(top.shape[0]))


def als_ranking_gate(P, Q, r_train, test_u, test_i, U, I, n=5,
                     max_users=4096, device='cuda', strict=False):
    '''Torch copy of ``bench.py``'s ``_als_ranking_gate``
    (bench.py:219-258): held-out P@n of the factors and of the
    popularity ranking on the first ``max_users`` users with held-out
    items, their train items masked.  Returns (p_model, p_popularity).

    The original masks by a scatter-set over the padded rated lists,
    whose padding slots repeat item 0 with mask 0; the JAX CPU backend
    applies a scatter's updates in order, so the last slot wins and item
    0 is left unmasked for every user whose list has padding.  This copy
    does the same (the same numbers), or masks every train item with
    ``strict=True``.'''
    import torch
    from mfrec_tpu_torch.ops.als import ieee_f32
    from mfrec_tpu_torch.ops.topk import pad_rated_lists
    dev = torch.device(device)
    eval_users, order, starts, ends = _gate_users(test_u, max_users)
    rated_idx, rated_mask = pad_rated_lists(r_train, eval_users)
    pop_row = torch.from_numpy(np.bincount(
        r_train.coo()[1], minlength=I).astype(np.float32)[None, :]).to(dev)
    Qd = torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(dev)
    hits_m = hits_p = 0
    chunk = 1024
    for s0 in range(0, eval_users.shape[0], chunk):
        us = eval_users[s0:s0 + chunk]
        ri = rated_idx[s0:s0 + chunk].astype(np.int64)
        rm = rated_mask[s0:s0 + chunk] > 0
        flat = (np.arange(us.shape[0])[:, None] * I + ri).ravel()
        if strict:
            neg = np.unique(flat[rm.ravel()])
        else:                  # the last slot of each position decides
            rev = flat[::-1]
            _, first = np.unique(rev, return_index=True)
            last = flat.size - 1 - first
            neg = flat[last][rm.ravel()[last]]
        neg = torch.from_numpy(neg).to(dev)

        def masked_topn(scores):
            s = scores.clone().reshape(-1)
            s[neg] = -3e38
            s = s.reshape(scores.shape)
            return torch.sort(s, dim=1, descending=True,
                              stable=True)[1][:, :n].cpu().numpy()

        with torch.no_grad():
            Pu = torch.from_numpy(np.ascontiguousarray(P[us],
                                                       np.float32)).to(dev)
            with ieee_f32():
                top_m = masked_topn(Pu @ Qd.T)
            top_p = masked_topn(pop_row.expand(us.shape[0], I))
        hits_m += _hits(top_m, test_i, order, starts, ends, s0)
        hits_p += _hits(top_p, test_i, order, starts, ends, s0)
    denom = max(eval_users.shape[0] * n, 1)
    return hits_m / denom, hits_p / denom


def k2_split(F_fix, F_upd, buckets, reg, steps):
    '''Device time of one CG half-sweep, by CUDA events, split into the
    gather + Gram assembly (``cg_system``), K2 and the rest (the fixed
    side's Gram and bf16 cast, the write-backs), replaying
    ``_bucket_cg_body``'s steps bucket by bucket.  Returns ms.'''
    import torch
    from mfrec_tpu_torch.ops import als as als_ops
    from mfrec_tpu_torch.ops.cg_kernel import pcg_solve_kernel

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    F_upd = F_upd.clone()
    torch.cuda.synchronize()
    t0 = ev()
    HHreg = als_ops._hh(F_fix, reg)
    Fb = F_fix.to(torch.bfloat16)
    gram = k2 = 0.0
    marks = []
    for rows, nidx, nval, mask in buckets:
        a = ev()
        M, b, x0 = als_ops.cg_system(Fb, F_upd, HHreg, rows, nidx, nval,
                                     mask, 1.0, 0.0)
        c = ev()
        x = pcg_solve_kernel(M, b, x0, steps)
        d = ev()
        F_upd[rows.long()] = x
        del M, b, x0, x
        marks.append((a, c, d))
    t1 = ev()
    t1.synchronize()
    for a, c, d in marks:
        gram += a.elapsed_time(c)
        k2 += c.elapsed_time(d)
    total = t0.elapsed_time(t1)
    return {'total_ms': total, 'gram_ms': gram, 'k2_ms': k2,
            'rest_ms': total - gram - k2}


def pcg_drift(M, b, x0, steps=(3, 6, 10, 20), sample=512):
    '''How far f32 PCG trajectories that differ only in summation order
    drift apart on these systems: per step count, the largest distance
    of K2, its plain version and the plain matmul loop from the float64
    iteration (the loop on the same inputs), and the plain versions'
    distance from each other; with the spectrum of the first ``sample``
    systems (eigenvalues, and the Jacobi-preconditioned condition
    number).  Logged only: the checks are in ``pcg_case``.'''
    import torch
    from mfrec_tpu_torch.ops import als as als_ops
    from mfrec_tpu_torch.ops.cg_kernel import pcg_solve_kernel, \
        pcg_solve_ref
    Ms = M[:sample].double()
    ev = torch.linalg.eigvalsh(Ms)
    dh = torch.diagonal(Ms, dim1=1, dim2=2).rsqrt()
    evp = torch.linalg.eigvalsh(Ms * dh[:, :, None] * dh[:, None, :])
    log('  the bucket\'s first %d systems: eigenvalues %.4g to %.4g, '
        'Jacobi-preconditioned condition median %.4g'
        % (Ms.shape[0], float(ev[:, 0].min()), float(ev[:, -1].max()),
           float((evp[:, -1] / evp[:, 0]).median())))
    M64, b64, x64_0 = M.double(), b.double(), x0.double()
    for n in steps:
        x64 = als_ops.pcg_solve(M64, b64, x64_0, n)
        xk = pcg_solve_kernel(M, b, x0, n)
        xp = pcg_solve_ref(M, b, x0, n)
        xl = als_ops.pcg_solve(M, b, x0, n)

        def dist(a, c):
            return float((a.double() - c.double()).abs().max())

        log('  steps %2d: from the float64 iteration K2 %.3g, plain version '
            '%.3g, plain matmul loop %.3g; plain version vs loop %.3g'
            % (n, dist(xk, x64), dist(xp, x64), dist(xl, x64),
               dist(xp, xl)))


def warm_epoch_device(m, ubd, ibd):
    '''One warm CG epoch (``cg_epoch`` at 3 steps) of model ``m``'s
    factors over the device buckets: its CUDA-event time (median of 5),
    its host-clock time, and the kernels' busy time in it by
    ``torch.profiler`` (idle share = 1 - busy / host time; None where the
    profiler reports no device time).'''
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mfrec_tpu_torch.ops import als as als_ops
    dev = m.device
    P = torch.from_numpy(m.P).to(dev)
    Q = torch.from_numpy(m.Q).to(dev)
    alive = [torch.from_numpy(als_ops._alive_mask(bk, n)).to(dev)
             for bk, n in ((ubd, m.nbr_users), (ibd, m.nbr_items))]

    def epoch():
        return als_ops.cg_epoch(P, Q, alive[0], alive[1], ubd, ibd, 1.0, 0.0,
                                float(m.K), 3, 'pallas')

    ev = timed_ms(epoch, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    busy = 0.0
    for e in prof.key_averages():
        if str(getattr(e, 'device_type', '')).endswith('CUDA'):
            busy += getattr(e, 'self_device_time_total',
                            getattr(e, 'self_cuda_time_total', 0.0)) / 1e3
    return {'epoch_event_ms': ev, 'epoch_wall_ms': wall, 'busy_ms': busy,
            'idle': (1.0 - busy / wall) if busy > 0 else None}


def phase5(U=ALS['U'], I=ALS['I'], N=ALS['N'], device='cuda',
           reduced=(3000, 700, 60_000)):
    '''The WRMF/ALS slice through the public path at bench_als's shape
    and settings: ``WRMFRecommender.train()`` (solver 'cg', 6 PCG steps,
    3 after 2 epochs), a 1-epoch warm-up then 3 blocks of a 2- and a
    5-epoch run (their difference: three pure warm epochs), K2's launch
    count, the held-out P@5 gate through ``recommend_batch`` (K3)
    against the popularity floor, the served lists against K3's plain
    twin, K2 on a real bucket against its plain version and the exact
    solver, the split of a half-sweep, and a CUDA model's CG epoch
    against a CPU model's at a reduced shape.'''
    import torch
    from mfrec_tpu_torch.data.movielens import ratings_from_arrays
    from mfrec_tpu_torch.models.wrmf import WRMFRecommender
    from mfrec_tpu_torch.ops import als as als_ops
    from mfrec_tpu_torch.ops.cg_kernel import pcg_solve_kernel
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    card = card_line()
    on_card = device == 'cuda'
    t0 = time.perf_counter()
    users, items, test_u, test_i = make_implicit_data(U, I, N, seed=0)
    m = WRMFRecommender(U, I, ALS_PARAMS, device=device)
    m.set_ratings(users, items, np.ones(users.shape[0], np.float32))
    ub = m.ratings.padded_rows(axis='user')
    ib = m.ratings.padded_rows(axis='item')
    per_epoch = len(ub) + len(ib)
    K = m.dimensionality
    log('phase 5: WRMFRecommender(%d, %d, rank %d, cg %d->%d after %d).'
        'train() on %s: %d training and %d held-out draws, nnz %d; user '
        'buckets (L, R) %s, item buckets %s: %d K2 launches per epoch '
        '(%.1f s to build)' % (
            U, I, K, m.cg_steps, m.cg_warm_steps, m.cg_warmup_epochs, device,
            users.shape[0], test_u.shape[0], m.ratings.nnz,
            [(b[1].shape[1], b[0].shape[0]) for b in ub],
            [(b[1].shape[1], b[0].shape[0]) for b in ib], per_epoch,
            time.perf_counter() - t0))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def train_timed(epochs):
        m.nbr_epochs = epochs
        sync()
        t = time.perf_counter()
        m.train()
        sync()
        return time.perf_counter() - t

    t_warm = train_timed(1)
    # one real bucket's systems, from the warmed-up factors: the user
    # bucket with the most rows
    big = max(range(len(ub)), key=lambda j: ub[j][0].shape[0])
    dev = m.device
    Pd = torch.from_numpy(m.P).to(dev)
    Qd = torch.from_numpy(m.Q).to(dev)
    bucket = tuple(torch.from_numpy(x).to(dev) for x in ub[big])
    HHreg = als_ops._hh(Qd, m.K)
    M, b, x0 = als_ops.cg_system(Qd.to(torch.bfloat16), Pd, HHreg,
                                 *bucket, 1.0, 0.0)
    del HHreg
    pcg_solve_kernel.launches = 0          # from here on: the main path
    topn_scores_kernel.launches = 0
    marg = []
    for _ in range(3):
        t2 = train_timed(2)
        t5 = train_timed(5)
        marg.append((t5 - t2) / 3.0)
        log('  2 epochs %.3f s, 5 epochs %.3f s: epoch %.4f s  [%s]'
            % (t2, t5, marg[-1], card))
    k2_launches = pcg_solve_kernel.launches
    epoch_s = float(np.median(marg))
    log('  warm-up 1 epoch %.2f s; epoch %.4f s (median of 3); K2 launches '
        '%d over 21 epochs (%.1f per epoch)  [%s]'
        % (t_warm, epoch_s, k2_launches, k2_launches / 21.0, card))
    if not (np.isfinite(m.P).all() and np.isfinite(m.Q).all()):
        raise SystemExit('non-finite factors from the ALS training')
    if on_card and k2_launches != 21 * per_epoch:
        raise SystemExit('K2 launched %d times, expected %d'
                         % (k2_launches, 21 * per_epoch))
    # the bench's quality gate, the model's lists through recommend_batch
    r_train = ratings_from_arrays(users, items, np.ones(users.shape[0],
                                                        np.float32), U, I)
    eval_users, order, starts, ends = _gate_users(test_u, 4096)
    top, _ = m.recommend_batch(eval_users, 5)
    p5 = _hits(top, test_i, order, starts, ends, 0) / (eval_users.size * 5)
    p5_copy, floor = als_ranking_gate(m.P, m.Q, r_train, test_u, test_i, U,
                                      I, device=device)
    p5_strict, floor_strict = als_ranking_gate(m.P, m.Q, r_train, test_u,
                                               test_i, U, I, device=device,
                                               strict=True)
    log('  held-out P@5 through recommend_batch %.4f (the gate copy: %.4f, '
        'every train item masked: %.4f); popularity floor %.4f (every '
        'train item masked: %.4f), %d users  [%s]'
        % (p5, p5_copy, p5_strict, floor, floor_strict, eval_users.size,
           card))
    # like against like: K3 masks every train item, the bench's gate
    # leaves item 0 unmasked (als_ranking_gate)
    if not (p5 > floor_strict and p5_copy > floor):
        raise SystemExit('held-out P@5 does not beat the popularity floor: '
                         '%.4f vs %.4f (every train item masked), %.4f vs '
                         '%.4f (the bench\'s gate)'
                         % (p5, floor_strict, p5_copy, floor))
    serve_users = np.random.default_rng(3).choice(U, 256, replace=False)
    retrieval_vs_plain(m, serve_users, ('predict',))
    k3_launches = topn_scores_kernel.launches
    if on_card and k3_launches == 0:
        raise SystemExit('retrieval from the trained WRMF never launched K3')
    # K2 on the real bucket against its plain version and the exact solver
    recs = [pcg_case('real bucket L=%d steps=%d' % (bucket[1].shape[1], s),
                     M, b, x0, s, iters=10, plain_iters=3, f64=True)
            for s in (6, 3)]
    pcg_drift(M, b, x0)
    exact_ms = timed_ms(lambda: torch.cholesky_solve(
        b[..., None], torch.linalg.cholesky(M)), 3)
    log('  exact solver (torch.linalg.cholesky + cholesky_solve) on the same '
        '%d systems: %.3f ms  [%s]' % (M.shape[0], exact_ms, card))
    del M, b, x0
    split = {}
    if on_card:
        ubd = als_ops.device_buckets(ub, dev)
        ibd = als_ops.device_buckets(ib, dev)
        Pd = torch.from_numpy(m.P).to(dev)
        Qd = torch.from_numpy(m.Q).to(dev)
        for side, args in (('user', (Qd, Pd, ubd)), ('item', (Pd, Qd, ibd))):
            k2_split(*args, m.K, 3)              # warm the allocator
            split[side] = k2_split(*args, m.K, 3)
            log('  %s half-sweep at 3 steps: %.3f ms on the card = gather + '
                'Gram %.3f + K2 %.3f + rest %.3f  [%s]'
                % (side, split[side]['total_ms'], split[side]['gram_ms'],
                   split[side]['k2_ms'], split[side]['rest_ms'], card))
        split['bound_ms_epoch'] = sum(
            pcg_bound(int(x[0].shape[0]), K, 3)[0] for x in ub + ib)
        split.update(warm_epoch_device(m, ubd, ibd))
        del ubd, ibd
        log('  one warm epoch (cg_epoch, 3 steps): %.3f ms by CUDA events '
            '(median of 5), %.3f ms on the host clock; kernels busy %.3f ms '
            'of it by torch.profiler: device idle %s  [%s]'
            % (split['epoch_event_ms'], split['epoch_wall_ms'],
               split['busy_ms'], 'not measured' if split['idle'] is None
               else '%.1f %%' % (100 * split['idle']), card))
        # a CUDA model's CG epoch against a CPU model's, same factors
        ru, ri, rn = reduced
        su, si, _, _ = make_implicit_data(ru, ri, rn, seed=1)
        preds = []
        for d in ('cuda', 'cpu'):
            mm = WRMFRecommender(ru, ri, dict(ALS_PARAMS, nbr_epochs=1),
                                 device=d)
            mm.seed(5)
            mm.set_ratings(su, si, np.ones(su.shape[0], np.float32))
            mm.train()
            preds.append(mm.P @ mm.Q.T)
        rms = float(np.sqrt(((preds[0] - preds[1]) ** 2).mean()))
        log('  one CG epoch at %d x %d: CUDA model vs CPU model prediction '
            'rms %.3g (limit 1e-3)' % (ru, ri, rms))
        if not rms < 1e-3:
            raise SystemExit('the CUDA model\'s CG epoch disagrees with the '
                             'CPU model\'s: rms %.3g' % rms)
    bad = [r['case'] for r in recs if not r['ok']]
    if bad:
        raise SystemExit('phase 5 (K2) failed: %s' % bad)
    return dict(k2_launches=k2_launches, k3_launches=k3_launches,
                epoch_s=epoch_s, epoch_s_blocks=marg, warmup_s=t_warm,
                p5=p5, p5_copy=p5_copy, floor=floor,
                floor_strict=floor_strict, recs=recs,
                exact_ms=exact_ms, split=split, per_epoch=per_epoch)


def k4_launches():
    from mfrec_tpu_torch.ops.window_agg_kernel import (scan_aggregate,
                                                       window_aggregate)
    return scan_aggregate.launches + window_aggregate.launches


def zero_launch_counts():
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    from mfrec_tpu_torch.ops.window_agg_kernel import (scan_aggregate,
                                                       window_aggregate)
    for fn in (half_pass, topn_scores_kernel, scan_aggregate,
               window_aggregate):
        fn.launches = 0


def epochs_timed(train, history, card, device):
    '''The timing of phases 4, 6 and 7 through the public
    ``train(epochs)``: a 1-epoch warm-up (layouts and segment tables),
    the launch counts set to 0,
    then 3 blocks of a 2- and a 5-epoch run; the epoch is the median of
    their difference quotients.'''
    import torch

    def timed(epochs):
        if device == 'cuda':
            torch.cuda.synchronize()
        t = time.perf_counter()
        train(epochs)
        if device == 'cuda':
            torch.cuda.synchronize()
        return time.perf_counter() - t, [float(x) for x in history()]

    t_warm, h1 = timed(1)
    zero_launch_counts()             # from here on: the main path only
    marg, hist = [], list(h1)
    for _ in range(3):
        t2, h2 = timed(2)
        t5, h5 = timed(5)
        marg.append((t5 - t2) / 3.0)
        hist += h2 + h5
        log('  2 epochs %.3f s, 5 epochs %.3f s: epoch %.4f s  [%s]'
            % (t2, t5, marg[-1], card))
    return dict(epoch_s=float(np.median(marg)), epoch_s_blocks=marg,
                hist=hist, rmse=h5, warmup_s=t_warm, warmup_rmse=h1[0])


def tier_split(epoch, state, args, device):
    '''One epoch of a tier on the card, split by phase: the CUDA-event
    time from one phase's end to the next's (the epoch's ``on_phase``
    hook marks them) beside the host time to enqueue it, then one more
    epoch under torch.profiler for the kernels' busy time by kernel (K1
    ``half_pass_rows``, K4 ``window_agg_kernel``/``scan_agg_kernel``,
    the rest) and the device idle share (1 - busy / host time).'''
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device != 'cuda':
        return {}
    state = tuple(x.clone() for x in state)
    epoch(*state, *args)                        # warm the allocator
    torch.cuda.synchronize()
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e, time.perf_counter()))

    mark('start')
    epoch(*state, *args, on_phase=mark)
    torch.cuda.synchronize()
    phases = {}
    for (_, e0, h0), (name, e1, h1) in zip(marks, marks[1:]):
        phases[name] = {'device_ms': e0.elapsed_time(e1),
                        'host_ms': 1e3 * (h1 - h0)}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        epoch(*state, *args)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    busy = {'k1': 0.0, 'k4': 0.0, 'other': 0.0}
    for e in prof.key_averages():
        if not str(getattr(e, 'device_type', '')).endswith('CUDA'):
            continue
        ms = getattr(e, 'self_device_time_total',
                     getattr(e, 'self_cuda_time_total', 0.0)) / 1e3
        key = 'k1' if 'half_pass_rows' in e.key else 'k4' if (
            'window_agg_kernel' in e.key or 'scan_agg_kernel' in e.key) \
            else 'other'
        busy[key] += ms
    total = sum(busy.values())
    return {'phases': phases,
            'epoch_event_ms': sum(p['device_ms'] for p in phases.values()),
            'epoch_wall_ms': wall, 'busy_ms': busy, 'busy_total_ms': total,
            'idle': (1.0 - total / wall) if total > 0 else None}


def log_split(split, card):
    if not split:
        return
    for name, p in split['phases'].items():
        log('  %-17s %9.3f ms on the card, %9.3f ms to enqueue  [%s]'
            % (name, p['device_ms'], p['host_ms'], card))
    b = split['busy_ms']
    log('  one epoch: %.3f ms by CUDA events, %.3f ms on the host clock; '
        'kernels busy %.3f ms (K1 %.3f, K4 %.3f, other %.3f) by '
        'torch.profiler: device idle %s  [%s]'
        % (split['epoch_event_ms'], split['epoch_wall_ms'],
           split['busy_total_ms'], b['k1'], b['k4'], b['other'],
           'not measured' if split['idle'] is None
           else '%.1f %%' % (100 * split['idle']), card))


def reduced_model(cls, params, device, reduced=REDUCED):
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    ru, ri, rn = reduced
    m = cls(ru, ri, params, device=device)
    m.seed(5)
    m.set_ratings(*synthetic_ratings(ru, ri, rn, rank=16, seed=1))
    return m


def tier_card_vs_cpu(kind, params, reduced=REDUCED):
    '''A CUDA model's tier epoch against the same epoch on CPU tensors
    (K1's and K4's plain versions), from the state a CPU model reaches in
    one public-path epoch at a reduced shape, within K1's tolerances;
    with the launches the CUDA epoch made.'''
    from mfrec_tpu_torch.models.fn import FNRecommender
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    cls = GDRecommender if kind == 'svdpp' else FNRecommender
    one = {'min_epochs': 1, 'max_epochs': 1} if kind == 'svdpp' \
        else {'nbr_epochs': 1}
    first = reduced_model(cls, dict(params, **one), 'cpu', reduced)
    if kind == 'svdpp':
        first.feature_training_implicit()
    else:
        first.train()
    out = {}
    for d in ('cuda', 'cpu'):
        m = reduced_model(cls, params, d, reduced)
        m.compute_overall_avg()
        for name in ('P', 'Q', 'Y', 'X', 'users_bias', 'items_bias'):
            setattr(m, name, getattr(first, name, None))
        if kind == 'svdpp':
            epoch, state, args = m._implicit_epoch(use_kernel=True)
        else:
            epoch, state, args = m._fn_epoch(m._init_or_resume(False),
                                             use_kernel=True)
        before = (half_pass.launches, k4_launches())
        *state, rmse = epoch(*state, *args)
        out[d] = ([x.cpu() for x in state], float(rmse),
                  (half_pass.launches - before[0],
                   k4_launches() - before[1]))
    errs = [float((a - b).abs().max()) for a, b in zip(out['cuda'][0],
                                                       out['cpu'][0])]
    ok = all(bool((a - b).abs().le(K1_ATOL + K1_RTOL * b.abs()).all())
             for a, b in zip(out['cuda'][0], out['cpu'][0]))
    ok = ok and abs(out['cuda'][1] - out['cpu'][1]) <= \
        1e-3 * abs(out['cpu'][1])
    log('  one %s epoch at %d x %d: card vs CPU tensors ok=%s, max abs '
        'err %s, rmse %.5f vs %.5f, K1 %d and K4 %d launches'
        % (kind, reduced[0], reduced[1], ok,
           ' '.join('%.3g' % e for e in errs), out['cuda'][1], out['cpu'][1],
           *out['cuda'][2]))
    if not ok:
        raise SystemExit('the %s epoch on the card disagrees with the same '
                         'epoch on CPU tensors' % kind)
    return {'ok': ok, 'max_abs_err': max(errs), 'launches': out['cuda'][2]}


def agg_tier_check(reduced=REDUCED, T=4):
    '''The agg-only tier (``use_agg_kernel``: the plain sweep with K4
    per batch and sweep) at a reduced shape: one epoch on the card
    against the same epoch on CPU tensors (K4's plain version), and K4's
    launches, which must be batches x T per half-pass.'''
    import torch
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops.window_agg_kernel import window_aggregate
    ru, ri, rn = reduced
    W = 128
    lay = {a: stream_layout(ru, ri, rn, a, W) for a in ('user', 'item')}
    Pa, Qa = _aug_factors(ru, ri, 64, W, seed=4)
    mu = float(np.mean(unique_stream(ru, ri, rn)[2]))
    out = {}
    for d in ('cuda', 'cpu'):
        pl_, ql_ = (sgd_mf.PassLayout(lay[a], a, d) for a in ('user', 'item'))
        ep = sgd_mf.make_alternating_epoch(
            W, W, 0.15, 0.02, lr_bu=0.15, lr_bi=0.15, K_bu=0.01, K_bi=0.01,
            bias_mode='learned', inner_steps=T, use_agg_kernel=True)
        window_aggregate.launches = 0
        P, Q, rmse = ep(torch.from_numpy(Pa.copy()).to(d),
                        torch.from_numpy(Qa.copy()).to(d), mu, pl_, ql_)
        out[d] = (P.cpu(), Q.cpu(), float(rmse), window_aggregate.launches,
                  T * (pl_.nbr_batches + ql_.nbr_batches))
    err = max(float((a - b).abs().max()) for a, b in zip(out['cuda'][:2],
                                                         out['cpu'][:2]))
    launches, want = out['cuda'][3:]
    ok = err <= EXACT_ATOL and launches == want and \
        abs(out['cuda'][2] - out['cpu'][2]) <= 1e-5 * out['cpu'][2]
    log('  agg-only tier at %d x %d, T=%d: card vs CPU tensors max abs err '
        '%.3g (limit %g), rmse %.6f vs %.6f, K4 launches %d (batches x T: '
        '%d)' % (ru, ri, T, err, EXACT_ATOL, out['cuda'][2], out['cpu'][2],
                 launches, want))
    if not ok:
        raise SystemExit('the agg-only tier on the card disagrees with the '
                         'plain epoch, or K4 launched %d times, not %d'
                         % (launches, want))
    return {'max_abs_err': err, 'launches': launches}


def phase6(U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz'], device='cuda',
           reduced=REDUCED):
    '''The SVD++ slice through the public path:
    ``GDRecommender.feature_training_implicit()`` at phase 4's model
    settings and the tier's defaults, timed as phase 4 is, its launch
    counts, an epoch split by phase, the card against CPU tensors at a
    reduced shape, and the agg-only tier.'''
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.window_agg_kernel import (scan_aggregate,
                                                       window_aggregate)
    card = card_line()
    t0 = time.perf_counter()
    m = GDRecommender(U, I, SVDPP_PARAMS, device=device)
    m.seed(0)
    m.set_ratings(*ratings_stream(U, I, nnz))
    floor = bias_floor_rmse(*m.ratings.coo(), U, I)
    log('phase 6: GDRecommender(%d, %d, rank %d).feature_training_implicit() '
        'on %s, %d ratings, batch %d, W=512, T=%d, f32 fixed side; bias-only '
        'floor %.4f (%.1f s to build)'
        % (U, I, m.dimensionality, device, m.ratings.nnz, m.batch_size,
           m.inner_steps_implicit, floor, time.perf_counter() - t0))

    def train(epochs):
        m.min_epochs = m.max_epochs = epochs
        m.feature_training_implicit()

    res = epochs_timed(train, lambda: m.rmse_history, card, device)
    res.update(k1_launches=half_pass.launches,
               k4_scan_launches=scan_aggregate.launches,
               k4_call_launches=window_aggregate.launches,
               k4_launches=k4_launches(), floor=floor)
    q_batches = m._alternating_layouts(512)[1].nbr_batches
    check_tier_run('phase 6', res, device, q_batches, card)
    epoch, state, args = m._implicit_epoch()
    res['split'] = tier_split(epoch, state, args, device)
    del epoch, state, args
    log_split(res['split'], card)
    if device == 'cuda':
        res['card_vs_cpu'] = tier_card_vs_cpu('svdpp', SVDPP_PARAMS, reduced)
        res['agg_tier'] = agg_tier_check(reduced)
    return res


def check_tier_run(name, res, device, q_batches, card):
    '''The gates of phases 6 and 7: every epoch's train RMSE finite, the
    last below the bias-only floor, and (on the card) K1 and K4 launched
    as the 21 timed epochs need: 2 K1 and 2 phase-K4 launches per epoch,
    one K4 call per item batch.'''
    hist = res['hist']
    log('  warm-up 1 epoch %.2f s (rmse %.4f); rmse per epoch (last 5-epoch '
        'run): %s' % (res['warmup_s'], res['warmup_rmse'],
                      ' '.join('%.4f' % x for x in res['rmse'])))
    log('  epoch %.4f s (median of 3), final rmse %.4f vs floor %.4f; K1 '
        'launches %d, K4 launches %d (%d whole-phase + %d per-batch; %d item '
        'batches per epoch) over 21 epochs  [%s]'
        % (res['epoch_s'], res['rmse'][-1], res['floor'], res['k1_launches'],
           res['k4_launches'], res['k4_scan_launches'],
           res['k4_call_launches'], q_batches, card))
    if not all(np.isfinite(hist)):
        raise SystemExit('%s: non-finite training RMSE: %s' % (name, hist))
    if not res['rmse'][-1] < res['floor']:
        raise SystemExit('%s: final RMSE %.4f does not beat the bias-only '
                         'floor %.4f' % (name, res['rmse'][-1], res['floor']))
    want = (42, 42, 21 * q_batches)
    got = (res['k1_launches'], res['k4_scan_launches'],
           res['k4_call_launches'])
    if device == 'cuda' and got != want:
        raise SystemExit('%s: K1/K4 launches %s, expected %s'
                         % (name, got, want))


def phase7(U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz'], device='cuda',
           reduced=REDUCED):
    '''The FN slice through the public path: ``FNRecommender.train()``
    at bench.py's operating point, timed and gated as phase 6, then
    retrieval from the materialized profiles through K3 and one fold-in.'''
    from mfrec_tpu_torch.models.fn import FNRecommender
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    from mfrec_tpu_torch.ops.window_agg_kernel import (scan_aggregate,
                                                       window_aggregate)
    card = card_line()
    t0 = time.perf_counter()
    m = FNRecommender(U, I, FN_PARAMS, device=device)
    m.seed(0)
    m.set_ratings(*ratings_stream(U, I, nnz))
    floor = bias_floor_rmse(*m.ratings.coo(), U, I)
    log('phase 7: FNRecommender(%d, %d, rank %d).train() on %s, %d ratings, '
        'batch %d, W=512, T=%d; bias-only floor %.4f (%.1f s to build)'
        % (U, I, m.dimensionality, device, m.ratings.nnz, m.batch_size,
           m.inner_steps, floor, time.perf_counter() - t0))

    def train(epochs):
        m.nbr_epochs = epochs
        m.train()

    res = epochs_timed(train, lambda: m.rmse_history, card, device)
    res.update(k1_launches=half_pass.launches,
               k4_scan_launches=scan_aggregate.launches,
               k4_call_launches=window_aggregate.launches,
               k4_launches=k4_launches(), floor=floor)
    q_batches = m._alternating_layouts(512)[1].nbr_batches
    check_tier_run('phase 7', res, device, q_batches, card)
    epoch, state, args = m._fn_epoch(m._init_or_resume(False))
    res['split'] = tier_split(epoch, state, args, device)
    del epoch, state, args
    log_split(res['split'], card)
    # serving from the materialized profiles, through K3
    users = np.random.default_rng(3).choice(U, 256, replace=False)
    retrieval_vs_plain(m, users, ('predict_rating_with_bias',))
    new_id = m.add_user('fold-in', [0, 7, 42], [5.0, 3.0, 4.0])
    idx, scores = m.recommend_batch([new_id], 10,
                                    predictor='predict_rating_with_bias')
    if not (np.isfinite(m.P[new_id]).all() and np.isfinite(scores).all()
            and not {0, 7, 42} & set(idx[0].tolist())):
        raise SystemExit('the folded-in user is not served right')
    res['k3_launches'] = topn_scores_kernel.launches
    log('  add_user fold-in: user %d served %s; K3 launches %d during the '
        'retrieval' % (new_id, idx[0].tolist(), res['k3_launches']))
    if device == 'cuda' and res['k3_launches'] == 0:
        raise SystemExit('retrieval from the FN model never launched K3')
    if device == 'cuda':
        res['card_vs_cpu'] = tier_card_vs_cpu('fn', FN_PARAMS, reduced)
    return res


# phase 8: the A/B tool's T, the operations P1 does per rating, sweep and
# column (dot 2; g = err*ff - (regv*fu)*m 3, regv*fu being the row's;
# accumulate 1), and the probe variants timed over real batches (each
# deletion with its baseline)
P1_T = 8
P1_FLOPS = 6.0
# P2 against its plain version, besides the window at K1's tolerances:
# each entry's change over the chain within 1 % of the largest change
# (the no_acc variants only shrink the window, by less than K1's atol)
P2_UPD_TOL = 1e-2
THROUGHPUT_VARIANTS = ('full', 'no_fu', 'no_acc', 'no_elem', 'bf16_chain',
                       'all2d', 'all2d_no_dot', 'all2d_no_prod',
                       'all2d_no_fu', 'all2d_no_acc', 'all2d_no_elem')


def _p1_check(name, F0, Ffix, batches, seg, W, lrv, regv, T=P1_T, mu=3.5,
              iters=0, plain_iters=1, zero_mask=False):
    """P1 (``half_pass_old``) against its plain version from ``F0``, in
    the working types (f32 factors, bf16 fixed side), K1's tolerances;
    a second launch must give the same bits.  Returns its record."""
    import torch
    from mfrec_tpu_torch.ops.half_pass_old_kernel import half_pass_old, \
        half_pass_old_ref
    args = (Ffix, batches, W, lrv, regv, mu, T)
    Fk = F0.clone()
    sse_k = float(half_pass_old(Fk, *args, segments=seg))
    again = F0.clone()
    half_pass_old(again, *args, segments=seg)
    torch.cuda.synchronize()
    Fp = F0.clone()
    sse_p = float(half_pass_old_ref(Fp, *args))
    diff = (Fk - Fp).abs()
    err = float(diff.max())
    sse_err = abs(sse_k - sse_p) / abs(sse_p) if sse_p else abs(sse_k)
    moved = float((Fk - F0).abs().max())
    ok = bool((diff <= K1_ATOL + K1_RTOL * Fp.abs()).all()) and \
        bool(torch.isfinite(Fk).all()) and sse_err <= K1_SSE_RTOL and \
        torch.equal(Fk, again) and \
        ((moved == 0.0) if zero_mask else (moved > 0.0))
    k = F0.shape[1]
    rec = {'case': name, 'k': k, 'T': T, 'ratings': int(seg.ent_r.numel()),
           'rows': int(seg.blk_row.numel()), 'ok': ok, 'max_abs_err': err,
           'sse_rel_err': sse_err}
    if iters:
        rec['ms'] = timed_ms(lambda: half_pass_old(Fk, *args, segments=seg),
                             iters)
        rec['plain_ms'] = timed_ms(lambda: half_pass_old_ref(Fp, *args),
                                   plain_iters)
        rec['bound_ms'], rec['bound_by'] = k1_bound(seg, k, T, P1_FLOPS)
    log('  %-34s ok=%s max_abs_err=%.3g sse_rel_err=%.3g (%d ratings, %d '
        'rows)%s' % (name, ok, err, sse_err, rec['ratings'], rec['rows'],
                     ' kernel %.3f ms, plain %.3f ms, bound %.3f ms'
                     % (rec['ms'], rec['plain_ms'], rec['bound_ms'])
                     if iters else ''))
    return rec


def p1_layout_case(name, F_upd, F_fix, layout, axis, batches=None,
                   **kw):
    """P1 over ``batches`` of a ``sorted_pass_layout`` (all by default) at
    the A/B tool's rates."""
    import torch
    from mfrec_tpu_torch.ops import sgd_mf
    dev = torch.device('cuda')
    W = layout[-1]
    arrs = list(layout[:-1])
    if batches is not None:
        arrs = [a[np.asarray(batches)] for a in arrs]
    pl = sgd_mf.PassLayout(tuple(arrs) + (W,), axis, dev, segments=True)
    lrv, regv = (torch.from_numpy(a).to(dev) for a in sgd_mf.column_rates(
        F_upd.shape[1] - 2, axis == 'user', 0.15, 0.02, 0.02))
    return _p1_check(name, torch.from_numpy(F_upd).to(dev),
                     torch.from_numpy(F_fix).to(dev).to(torch.bfloat16),
                     pl.batches(), pl.segments, W, lrv, regv, **kw)


def p1_random_case(name, k, W, nb=2, B=4096, zero_mask=False, seed=0):
    """P1 on ``nb`` random batches of B ratings (sorted window ids, 10 %
    masked, the last column frozen where k > 1) at width k and window
    W."""
    import torch
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    dev = torch.device('cuda')
    rng = np.random.default_rng(seed)
    n_upd, n_fix = 400 + W, 500
    lo = np.sort(rng.integers(0, 400, nb)).astype(np.int32)
    kl = np.sort(rng.integers(0, W, (nb, B)), axis=1).astype(np.int32)
    m = (rng.random((nb, B)) > 0.1).astype(np.float32)
    if zero_mask:
        m[:] = 0.0
    r = rng.uniform(1, 5, (nb, B)).astype(np.float32)
    fix = rng.integers(0, n_fix, (nb, B)).astype(np.int32)
    seg = hk.build_segments(fix, r, m, kl, lo, W, dev)
    F0 = torch.from_numpy(rng.normal(0, 0.1, (n_upd, k)).astype(
        np.float32)).to(dev)
    Ffix = torch.from_numpy(rng.normal(0, 0.1, (n_fix, k)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    lrv = torch.full((k,), 0.15, device=dev)
    if k > 1:
        lrv[-1] = 0.0
    regv = torch.full((k,), 0.02, device=dev)
    batches = tuple(torch.from_numpy(a).to(dev) for a in (fix, r, m, kl, lo))
    return _p1_check(name, F0, Ffix, batches, seg, W, lrv, regv,
                     zero_mask=zero_mask)


def p2_bound(B, W, k, T, n_chain=1):
    """P2's least time for ``n_chain`` calls of the full step: 4k f32
    operations per rating and sweep (dot, eff*ff, accumulate) over the
    FP32 peak against ff, r, m, kl read once and the window read and
    written once over the memory rate."""
    return roofline_ms(4.0 * k * T * B * n_chain,
                       4.0 * B * k + 12.0 * B + 8.0 * W * k + 8.0 * k)


def p2_case(name, data, variant, k, T=10, n_chain=3, iters=0,
            plain_iters=0, ff16=False):
    """A chain of ``n_chain`` calls of P2 variant ``variant`` at the
    probe's shape against its plain version (the window at K1's
    tolerances, each entry's change within P2_UPD_TOL of the largest
    change; a second launch bit-identical).  ``ff16``: the fixed rows in
    bf16.  With ``iters``, the times of one call at T."""
    import torch
    from mfrec_tpu_torch.ops import probe_kernel as p2
    from mfrec_tpu_torch.tools import kernel_probe as kp
    window, ff, r, m, kl, lrv, regv = data[k]
    if ff16:
        ff = ff.to(torch.bfloat16)
    tab = p2.probe_tables(kl, kp.W)
    args = (window, ff, r, m, kl, lrv, regv, variant, T)
    out, sse = p2.probe_chain(*args, n_chain, kp.CH, tables=tab)
    again, _ = p2.probe_chain(*args, n_chain, kp.CH, tables=tab)
    torch.cuda.synchronize()
    ref, sse_r = p2.probe_chain_ref(*args, n_chain, kp.CH)
    diff = (out - ref).abs()
    err = float(diff.max())
    moved = float((ref - window).abs().max())
    upd_err = float(((out - window) - (ref - window)).abs().max())
    sse_err = abs(float(sse) - float(sse_r)) / abs(float(sse_r))
    ok = bool((diff <= K1_ATOL + K1_RTOL * ref.abs()).all()) and \
        bool(torch.isfinite(out).all()) and sse_err <= K1_SSE_RTOL and \
        torch.equal(out, again) and moved > 0 and \
        upd_err <= P2_UPD_TOL * moved
    rec = {'case': name, 'variant': variant, 'k': k, 'T': T,
           'n_chain': n_chain, 'ok': ok, 'max_abs_err': err,
           'update_err': upd_err, 'largest_update': moved,
           'sse_rel_err': sse_err}
    if iters:
        rec['ms'] = timed_ms(lambda: p2.probe_chain(*args, 1, kp.CH,
                                                    tables=tab), iters)
        rec['plain_ms'] = timed_ms(lambda: p2.probe_chain_ref(*args, 1,
                                                              kp.CH),
                                   plain_iters or iters)
        rec['bound_ms'], rec['bound_by'] = p2_bound(ff.shape[0], kp.W, k, T)
    log('  %-30s ok=%s max_abs_err=%.3g update_err=%.3g of %.3g '
        'sse_rel_err=%.3g%s'
        % (name, ok, err, upd_err, moved, sse_err,
           ' one call: kernel %.4f ms, plain %.4f ms, bound %.4f ms'
           % (rec['ms'], rec['plain_ms'], rec['bound_ms']) if iters else ''))
    return rec


def p2_ff_dtype(data, card, reps=3):
    """'full' at the probe's shape (k=66) with the fixed rows in f32, as
    the probe passes them, and in bf16, K1's storage, interleaved over
    ``reps``: the median marginal sweep of each in us per batch."""
    import torch
    from mfrec_tpu_torch.tools import kernel_probe as kp
    d16 = {66: tuple(x.to(torch.bfloat16) if j == 1 else x
                     for j, x in enumerate(data[66]))}
    res = {'f32': [], 'bf16': []}
    for rep in range(reps):
        for key, d in (('f32', data), ('bf16', d16)):
            t2 = kp.time_case(d, 'full', 2, 66, 3)
            t10 = kp.time_case(d, 'full', 10, 66, 3)
            res[key].append(1e6 * (t10 - t2) / 8)
            log('  rep %d full, %-4s fixed rows: marginal %.2f us/batch  '
                '[%s]' % (rep, key, res[key][-1], card))
    out = {key: float(np.median(v)) for key, v in res.items()}
    log('  full at the probe\'s shape: f32 fixed rows %.2f, bf16 %.2f us per '
        'batch and sweep  [%s]' % (out['f32'], out['bf16'], card))
    return out


def p2_throughput(layout, F_upd, F_fix, card, nb=16):
    """The deletion variants over the first ``nb`` user batches of the
    ML-10M layout (each batch an independent problem: its window at lo,
    its fixed rows gathered in f32), one launch of nb x W blocks at T=2
    and T=10; and K1 over the same batches (its main path: bf16 fixed
    side, one launch).  Logs and returns the marginal sweep in us per
    batch."""
    import torch
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    from mfrec_tpu_torch.ops import probe_kernel as p2
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.tools import kernel_probe as kp
    dev = torch.device('cuda')
    ub, ib, rb, mb, kl, lo, W = layout
    k = F_upd.shape[1]

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    win = t(np.stack([F_upd[lo[b]:lo[b] + W] for b in range(nb)]))
    ff = t(F_fix[ib[:nb]])
    r, m, klt = t(rb[:nb]), t(mb[:nb]), t(kl[:nb], np.int32)
    lrv, regv = (t(a) for a in sgd_mf.column_rates(k - 2, True, 0.15, 0.02,
                                                   0.02))
    def ms(fn):
        return 1e3 * kp.timed_s(fn, dev, 3)

    out = {}
    tab = p2.probe_tables(klt, W)
    ff16 = ff.to(torch.bfloat16)
    for v in THROUGHPUT_VARIANTS + ('full_bf16ff',):
        name, f = (v, ff) if v != 'full_bf16ff' else ('full', ff16)
        ts = {T: ms(lambda: p2.probe_chain(
            win, f, r, m, klt, lrv, regv, name, T, 1, kp.CH, tables=tab))
            for T in (2, 10)}
        out[v] = 1e3 * (ts[10] - ts[2]) / 8 / nb
        log('  first %d user batches, %-14s T=2 %.3f ms, T=10 %.3f ms: '
            'marginal %.2f us/batch  [%s]' % (nb, v, ts[2], ts[10], out[v],
                                               card))
    arrs = [a[:nb] for a in layout[:-1]]
    pl = sgd_mf.PassLayout(tuple(arrs) + (W,), 'user', dev, segments=True)
    F = t(F_upd)
    Fb = t(F_fix).to(torch.bfloat16)
    ts = {T: ms(lambda: hk.half_pass(F, Fb, pl.batches(), W, lrv, regv, 3.5,
                                     T, segments=pl.segments))
          for T in (2, 10)}
    out['K1'] = 1e3 * (ts[10] - ts[2]) / 8 / nb
    log('  first %d user batches, K1 (bf16 fixed side) T=2 %.3f ms, T=10 '
        '%.3f ms: marginal %.2f us/batch  [%s]' % (nb, ts[2], ts[10],
                                                  out['K1'], card))
    return out


def phase8(U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz']):
    """The probe tools: P1 and P2 against their plain versions, then the
    tools' runs at full shape (the main path of this phase: the launch
    counts are set to 0 before it and read after)."""
    from mfrec_tpu_torch.ops import probe_kernel as p2
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.half_pass_old_kernel import half_pass_old
    from mfrec_tpu_torch.tools import ab_kernel, bench_data
    from mfrec_tpu_torch.tools import kernel_probe as kp
    card = card_line()
    log('phase 8: P1 against its plain version (T=%d, f32 factors, bf16 '
        'fixed side; K1\'s tolerances)' % P1_T)
    t0 = time.perf_counter()
    W = 128
    lay = {a: stream_layout(U, I, nnz, a, W) for a in ('user', 'item')}
    Paug, Qaug = _aug_factors(U, I, 64, W, seed=1)
    side = {'user': (Paug, Qaug), 'item': (Qaug, Paug)}
    hb, hn = _longest_run_batch(lay['item'])
    sl = {a: stream_layout(*REDUCED, a, W) for a in ('user', 'item')}
    sP, sQ = _aug_factors(REDUCED[0], REDUCED[1], 64, W, seed=2)
    p1 = [p1_layout_case('main first16 user', *side['user'], lay['user'],
                         'user', batches=range(16), iters=5, plain_iters=2),
          p1_layout_case('main hottest item batch (%d, run %d)' % (hb, hn),
                         *side['item'], lay['item'], 'item', batches=[hb]),
          p1_random_case('edge k=1', 1, W),
          p1_random_case('edge k=130 (f32 dot)', 130, W, seed=1),
          p1_random_case('edge k=256', 256, W, seed=2),
          p1_random_case('edge W=1', 66, 1, seed=3),
          p1_random_case('edge everything masked', 66, W, zero_mask=True),
          p1_layout_case('reduced whole half-pass user', sP, sQ, sl['user'],
                         'user'),
          p1_layout_case('reduced whole half-pass item', sQ, sP, sl['item'],
                         'item')]
    log('phase 8: P2 against its plain version (every variant, a chain of 3 '
        'calls at the probe\'s shape, T=10)')
    data = kp.probe_data('cuda')
    p2r = [p2_case('full k=66', data, 'full', 66, iters=20, plain_iters=5)]
    p2r += [p2_case('%s k=66' % v, data, v, 66) for v in sorted(p2.VARIANTS)
            if v != 'full']
    p2r += [p2_case('full k=%d' % k, data, 'full', k) for k in (64, 128)]
    p2r.append(p2_case('full k=66 bf16 fixed rows', data, 'full', 66,
                       ff16=True))
    bad = [r['case'] for r in p1 + p2r if not r['ok']]
    if bad:
        raise SystemExit('phase 8 failed: %s' % bad)
    log('  checks done in %.1f s' % (time.perf_counter() - t0))
    # the tools at full shape
    half_pass_old.launches = p2.probe_chain.launches = half_pass.launches = 0
    t0 = time.perf_counter()
    u, i, v = bench_data.make_data(U, I, nnz)
    log('phase 8: tools.ab_kernel at the JAX bench\'s data shape (%d x %d, '
        '%d raw draws), rank 64, batch 16384, W=128, T=%d (data %.1f s)'
        % (U, I, len(v), P1_T, time.perf_counter() - t0))
    ab = ab_kernel.run_ab(u, i, v, U, I, log=lambda x: log('  %s  [%s]'
                                                           % (x, card)))
    del u, i, v
    last = (ab['rmse_old'][-1], ab['rmse_new'][-1])
    log('  final rmse old %.4f, new %.4f against the bias-only floor %.4f'
        % (last[0], last[1], ab['floor']))
    if not (np.isfinite(ab['rmse_old'] + ab['rmse_new']).all()
            and max(last) < ab['floor']):
        raise SystemExit('the A/B epochs do not train below the bias-only '
                         'floor: %s vs %.4f' % (last, ab['floor']))
    probe = {}
    for mode in ('', 'fix', 'all2d'):
        log('phase 8: tools.kernel_probe mode %r (3 reps, us per batch)'
            % mode)
        probe[mode] = kp.probe_mode(data, mode, reps=3, iters=3,
                                    log=lambda x: log('  %s  [%s]'
                                                      % (x, card)))
    log('phase 8: tools.kernel_probe mode \'hiT\' (K1)')
    hit = kp.hit_mode(data, reps=2, iters=3,
                      log=lambda x: log('  %s  [%s]' % (x, card)))
    log('phase 8: full with f32 and with bf16 fixed rows (K1\'s reads)')
    ff16 = p2_ff_dtype(data, card)
    log('phase 8: the variants over real batches (K1\'s throughput regime)')
    thr = p2_throughput(lay['user'], Paug, Qaug, card)
    launches = {'p1': half_pass_old.launches, 'p2': p2.probe_chain.launches,
                'k1': half_pass.launches}
    log('  launches during the tools\' runs: P1 %d, P2 %d, K1 %d'
        % (launches['p1'], launches['p2'], launches['k1']))
    if min(launches.values()) == 0:
        raise SystemExit('a tool never launched its kernel: %s' % launches)
    return dict(p1=p1, p2=p2r, ab=ab, probe=probe, hit=hit, thr=thr,
                ff16=ff16, launches=launches)


def probe_entries(p8):
    """P1's and P2's entries of the kernels line."""
    if not p8:
        return []
    m1, f2 = p8['p1'][0], p8['p2'][0]
    ab = p8['ab']
    full = p8['probe'][''][('full', 66, 8192)]
    return [{
        'name': 'half_pass_old (P1, round-2 batch step for the A/B tool)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/half_pass_old.cu',
        'replaces': 'tools/ab_kernel.py:33',
        'launches': p8['launches']['p1'],
        'max_abs_err': max(r['max_abs_err'] for r in p8['p1']),
        'ms': m1['ms'], 'plain_ms': m1['plain_ms'],
        'bound_ms': m1['bound_ms'], 'bound_by': m1['bound_by'],
        'library_ms': None,
        'shape': 'first 16 batches of the ML-10M user half-pass: B=16384 '
                 'W=128 k=66 T=8',
        'ab_epoch_s_old': float(np.median(ab['old'])),
        'ab_epoch_s_new': float(np.median(ab['new'])),
        'ab_speedup_pct': ab['speedup']}, {
        'name': 'probe (P2, deletion-probe variants of the batch step)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/probe.cu',
        'replaces': 'tools/kernel_probe.py:89',
        'launches': p8['launches']['p2'],
        'max_abs_err': max(r['max_abs_err'] for r in p8['p2']),
        'ms': f2['ms'], 'plain_ms': f2['plain_ms'],
        'bound_ms': f2['bound_ms'], 'bound_by': f2['bound_by'],
        'library_ms': None,
        'shape': "one call of 'full' at the probe's shape: B=16384 W=128 "
                 'k=66 T=10',
        'marginal_sweep_us_full': 1e6 * full['marg'],
        'marginal_sweep_us_full_f32_vs_bf16_fixed_rows': p8['ff16'],
        'marginal_sweep_us_k1': 1e6 * p8['hit']['marg_8_32'],
        'marginal_sweep_us_real_batches': p8['thr']}]


def k3_bound(B, I, k):
    '''K3's least time at one shape: 2*B*I*k f32 FMA operations over the
    FP32 peak against P, Q, the biases and the result moved once.'''
    return roofline_ms(2.0 * B * I * k,
                       4.0 * (B * k + I * k + B + I) + 8.0 * B * 10)



def k2_entry(k2_recs, als):
    '''K2's entry of the kernels line: times on phase 5's real bucket at
    the warm step count (3), launches over phase 5's training.'''
    if not als:
        return []
    real = {r['steps']: r for r in als['recs']}
    split = als['split']
    return [{
        'name': 'pcg (K2, warm-started Jacobi-PCG on batched k x k systems)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/pcg.cu',
        'replaces': 'mfrec_tpu/ops/pallas_cg.py:26',
        'launches': als['k2_launches'],
        'max_abs_err': max(r['max_abs_err'] for r in k2_recs + als['recs']),
        'ms': real[3]['ms'], 'plain_ms': real[3]['plain_ms'],
        'bound_ms': real[3]['bound_ms'], 'bound_by': real[3]['bound_by'],
        'library_ms': None,
        'shape': 'the largest user bucket of the ALS epoch: R=%d k=64 '
                 'steps=3' % real[3]['R'],
        'ms_steps6': real[6]['ms'], 'plain_ms_steps6': real[6]['plain_ms'],
        'bound_ms_steps6': real[6]['bound_ms'],
        'exact_solver_ms': als['exact_ms'],
        'ms_per_epoch_k2': split['user']['k2_ms'] + split['item']['k2_ms'],
        'bound_ms_per_epoch': split['bound_ms_epoch'],
        'launches_per_epoch': als['per_epoch'],
        'epoch_s': als['epoch_s']}]


def k4_entry(k4, svdpp, fn):
    '''K4's entry of the kernels line: times at the JAX call's shape (a
    real user batch), at the SVD++ item step's and on a whole W=512 user
    layout; launches over phases 6 and 7's timed epochs.'''
    if not k4:
        return []
    call, ystep, xystep = k4['recs'][0], k4['recs'][2], k4['recs'][3]
    scan = k4['scans'][0]
    runs = [r for r in (svdpp, fn) if r]
    return [{
        'name': 'window_agg (K4, sorted-window aggregation)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/window_agg.cu',
        'replaces': 'mfrec_tpu/ops/pallas_window_agg.py:24',
        'launches': sum(r['k4_launches'] for r in runs) if runs else None,
        'max_abs_err': max(r['max_abs_err']
                           for r in k4['recs'] + k4['scans']),
        'ms': call['ms'], 'plain_ms': call['plain_ms'],
        'bound_ms': call['bound_ms'], 'bound_by': call['bound_by'],
        'library_ms': call['library_ms'],
        'shape': 'one call on ML-10M user batch 0: B=16384 W=128 k=66',
        'ms_y_step_call': ystep['ms'], 'bound_ms_y_step_call':
            ystep['bound_ms'], 'ms_xy_step_call': xystep['ms'],
        'ms_phase': scan['ms'], 'plain_ms_phase': scan['plain_ms'],
        'bound_ms_phase': scan['bound_ms'],
        'library_ms_phase': scan['library_ms'],
        'launches_svdpp': svdpp.get('k4_launches'),
        'launches_fn': fn.get('k4_launches'),
        'epoch_s_svdpp': svdpp.get('epoch_s'),
        'epoch_s_fn': fn.get('epoch_s')}]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[1])
    ap.add_argument('--phases', default='12345678',
                    help='which phases to run (default: all)')
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, 'mfrec_tpu_torch')):
        log('chip_smoke: mfrec_tpu_torch is not beside this script')
        return 2
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        log('chip_smoke: no CUDA device (torch.cuda.is_available() is '
            'False)')
        return 2
    if '1' in args.phases:
        phase1()
    k3_recs, (k1_recs, k1_time), k2_recs, k4 = phase2() \
        if '2' in args.phases else ([], ([], {}), [], {})
    launches, worst = phase3() if '3' in args.phases else (None, 0.0)
    train = phase4() if '4' in args.phases else {}
    als = phase5() if '5' in args.phases else {}
    svdpp = phase6() if '6' in args.phases else {}
    fn = phase7() if '7' in args.phases else {}
    p8 = phase8() if '8' in args.phases else {}
    if k3_recs:
        k3_ms, k3_by = k3_bound(1024, 360_000, 64)
        main1 = k1_recs[0]
        print(json.dumps({'kernels': [{
            'name': 'topn (K3, fused top-n retrieval)', 'route': 'cuda',
            'source': 'mfrec_tpu_torch/csrc/topn.cu',
            'replaces': 'mfrec_tpu/ops/pallas_topk.py:90',
            'launches': launches,
            'max_abs_err': max([worst] + [r['max_abs_err'] for r in k3_recs]),
            'ms': k3_recs[0]['ms'], 'plain_ms': k3_recs[0]['plain_ms'],
            'bound_ms': k3_ms, 'bound_by': k3_by, 'library_ms': None,
            'ms_fast': k3_recs[2]['ms'],
            'plain_ms_fast': k3_recs[2]['plain_ms'],
            'shape': 'B=1024 I=360000 k=64 n=10'}, {
            'name': 'half_pass (K1, fused sorted-window SGD batch step)',
            'route': 'cuda',
            'source': 'mfrec_tpu_torch/csrc/half_pass.cu',
            'replaces': 'mfrec_tpu/ops/pallas_half_pass.py:274',
            'launches': train.get('k1_launches'),
            'max_abs_err': max(r['max_abs_err'] for r in k1_recs),
            'ms': main1['ms'], 'plain_ms': main1['plain_ms'],
            'bound_ms': main1['bound_ms'], 'bound_by': main1['bound_by'],
            'library_ms': None,
            'shape': 'first 16 batches of the ML-10M user half-pass: '
                     'B=16384 W=128 k=66 T=128',
            'ms_half_pass_user': k1_time['user']['ms'],
            'ms_half_pass_item': k1_time['item']['ms'],
            'bound_ms_half_pass_user': k1_time['user']['bound_ms'],
            'bound_ms_half_pass_item': k1_time['item']['bound_ms'],
            'ms_longest_chain': k1_time['chain']['ms'],
            'epoch_s': train.get('epoch_s'),
            'launches_phase8': p8.get('launches', {}).get('k1')}]
            + k2_entry(k2_recs, als) + k4_entry(k4, svdpp, fn)
            + probe_entries(p8)}))
    log(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
