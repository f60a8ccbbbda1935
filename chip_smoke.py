#!/usr/bin/env python3
'''
Smoke run of the PyTorch/CUDA port (``mfrec_tpu_torch``) on one GPU.

    python3 chip_smoke.py               # every phase, one card
    python3 chip_smoke.py --phases 12   # toolchain + kernel checks only
    python3 chip_smoke.py --phases 125  # ... and the ALS slice
    python3 chip_smoke.py --phases 1267 # ... and the SVD++ and FN slice
    python3 chip_smoke.py --phases 18   # ... the probe tools (P1, P2)
    python3 chip_smoke.py --phases 19   # ... example 2's workflow
    python3 chip_smoke.py --phases 12k  # ... KMF's main path (S2, K1, K3)
    python3 chip_smoke.py --ab k1 A B B A   # K1 in checkouts A and B
    python3 chip_smoke.py --ab k1f A B B A  # FN's user half-pass: K1f or K1
    python3 chip_smoke.py --ab k4 A B B A   # K4's per call, the same way
    python3 chip_smoke.py --ab k1-rows B    # K1's cluster-row threshold
    python3 chip_smoke.py --ab als A B B A  # the ALS CG path, the same way
    python3 chip_smoke.py --ab k3 A B B A   # K3, bench and serving shapes
    python3 chip_smoke.py --ab s1 A B B A   # S1, its feature and fold-ins
    python3 chip_smoke.py --ab s2 A B B A   # S2, its epoch and fold-ins

Phase 1  the toolchain: torch/CUDA/nvcc versions, the card, and the
         build of every kernel from ``mfrec_tpu_torch/csrc`` (one nvcc
         per source, K1's four builds included, started together), with
         ``-Xptxas -v``'s report.
Phase 2  each kernel against its plain PyTorch version on the card:
         K3 at the serving and retrieval-bench shapes (CUDA events,
         device time, the wrapper's host time and the composed library
         yardstick) plus edge shapes (B off the user tile, I under a
         tile and one past a split, ties, rated ids on tile bounds, a
         user who rated all but n - 1 items, n and k around the limits);
         K1 on real batches of the ML-10M-shape layouts (B=16384, W=128,
         k=66) in each path's build (SGD bf16 T=128, SVD++ and FN f32),
         the most-rated item's whole chain (a cluster row), SVD++'s
         build at its width (k=102, f32, T=32: the first user batches
         and the hot item's chain, whose cluster blocks stage part of
         each slice and stream the rest), edge cases
         and a whole half-pass at a reduced size, then whole half-passes
         and the longest chain timed; K1f (FN's user half-pass, k=102,
         f32, T=32) on the first user batches, the heaviest user's chain
         and the whole user half-pass against K1's plain version, timed
         beside K1 with the same rates, and at phase 7's shape (k=66,
         T=64, W=512) on the first user batches and the heaviest user's
         chain; K2's M-given entry on edge cases
         and at the largest user bucket's shape, and the fused K2 on
         seeded buckets (k 8 to 256, L 8 to 16,384); K4's per-call sum at
         the JAX
         call's shape on real ML-10M-layout batches (B=16384, W=128,
         k=66; a user batch and the hottest item batch), at W=512, on a
         whole W=512 layout (the phase aggregation), the fused SVD++ /
         FN item step over the W=512 item layout against its plain
         version and the per-batch loop it replaces, and edge cases;
         B1, the BellKor bias refit, over the W=128 and 512 layouts'
         tables against its plain version and numpy's refit (one ulp).
         Median times of kernel and plain version.
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
         after 2 epochs) through the fused K2 (one launch per bucket:
         gather, tensor-core Gram, PCG, write-back), timed as phase 4 is
         but over a 2- and a 102-epoch run, with ``train()``'s fixed
         set-up, its launch count, the held-out P@5 gate through K3 against the
         popularity floor, the fused K2 on the largest user bucket and
         the hottest item bucket against its plain version (M and b
         against a float64 Gram) beside the parent's composition and the
         exact solver, K2's M-given entry on real systems, the split of
         each half-sweep, one warm epoch's kernels and idle share, and a
         CUDA model's CG epoch against a CPU model's.  Phase 2 also holds
         both K2 entries to their plain versions on edge cases.
Phase 6  the SVD++ tier end to end at the ML-10M shape:
         ``GDRecommender.feature_training_implicit()`` through K1 and K4
         (W=512, batch 16384, T=32, f32 fixed side), timed as phase 4
         is, every epoch's RMSE against the bias-only floor, K1's and
         K4's launch counts (3 K4 launches per epoch: two phase
         aggregations and the item step), one epoch split by phase
         (CUDA events; the item step's time on the card and to enqueue)
         with
         the device busy share (torch.profiler), the epoch on the card
         against the same epoch on CPU tensors at 3,000 x 700, and the
         agg-only tier (K4 per batch and sweep) there too.
Phase 7  the FN tier the same way: ``FNRecommender.train()`` at
         bench.py's operating point (T=64; the user half-pass through
         K1f, the item half-pass through K1: one launch each an epoch),
         then retrieval through K3
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
Phase 9  the reference's main workflow on the card at full width
         (``examples/example2_movielens_100k_sgd.py``, on the synthetic
         ML-100K u1 split of ``data/ml100k_like``, 16 features): (a)
         ``GDRecommender(engine='fused').train(handle_bias=True)``, the
         held-out RMSE (``test_predict_rating``) against the bias-only
         floor, P@10, ``add_user`` through S1 and the new user's top-5
         through K3, all against the same workflow on the CPU; (b) the
         same with 'funk_fused', 'alternating' (through K1) and 'funk'
         at a cut depth, S1's, K3's and K1's launches and the serial
         epochs counted over (a) and (b), S1 launched at most once a
         feature trained; (c) the fused and funk-fused tiers trained twice from
         one seed, bit for bit; (d) the fused tier at bench.py's
         operating point on phase 4's ML-10M shape (rank 64, B=16384,
         lr 0.002), its epoch by phase 4's difference quotient, launches
         an epoch and idle share; (e) ``add_user`` with 20 ratings on a
         rank-64 ML-10M-shape model, timed, its row held to the CPU plain
         path, one converged feature of it split (host, enqueue, device)
         beside the model's upload and download; (f)
         ``FNRecommender(engine='fused')`` and
         ``optimize_regularization_vmapped`` against the CPU.  Phase 2
         holds S1 to its plain version bit for bit (every bias mode and
         fold-in mask, the row table in shared and in device memory, one
         epoch a launch and converged: every epoch's rmse and the epoch
         count) and times the shuffled ML-100K-shape epoch with its
         bound, one rating's measured chain and the longest dependency
         chain.
Phase k  KMF's main path on the card: (a) ``KMFRecommender.train()``
         at phase 4's ML-10M shape, rank 64 (the JAX KMF bench's), the
         shipped defaults otherwise (engine 'auto': K1's logistic build
         with an f32 fixed side, T=64), timed as phase 4, every epoch's
         RMSE against the bias-only floor, then
         ``recommend_batch(predict_logistic)`` through K3 against the
         plain top-n; (b) ``add_user`` with 20 ratings on that model
         through S2 (the shipped 200 epochs in one launch), 3 calls
         timed, the new row against a CPU model's plain path; (c)
         ``engine='serial'`` on the ML-100K u1 train split at 40
         features, cut to 3 epochs, S2's epoch timed (one a launch and 3
         in one launch; rounds an epoch, ns a round and a rating) beside
         its bound (bytes, or the stream's longest dependency chain times
         one rating's chain as a probe apart from S2 measures it), its
         first epoch against the plain version on the CPU over the whole
         stream and, on the first 2,000 ratings, on the card, bit for
         bit; (d) ``engine='fused'`` twice from one
         seed, bit for bit; (e) ``tests/test_kmf.py``'s end-to-end
         workflow on the card against the CPU (the host scoring path for
         ``predict_linear_neg``, ``add_item``).  K1's, K3's and S2's
         launches over (a)-(c).  K1's logistic f32 build as (a) called
         it (the inputs of its first user and item half-passes,
         recorded) against its plain version on the first batch of each
         and the hot item's chain.  Phase 2 holds S2 to its plain version
         bit for bit (both links x the fold-in masks x k in 1, 8, 40, 64,
         66, 256; n = 1, 2, 3; one pair repeated; a fold-in stream;
         streams around its 32-rating chunks, n = 31 to 1,000; a hot
         item; rows far past shared memory; the converge entry's rmse
         list and count; a diverging stream).

``--ab`` times K1 (``kernel_probe``'s hiT, the ML-10M-shape half-passes,
the hot item's chain, the logistic link's item half-pass and chain),
FN's user half-pass at k 102, T 32 (``k1f``: through K1 with FN's rates,
and through K1f where the checkout has it, with its bound, its plain
version's time and its agreement with K1's plain version),
K3 (the bench shape exact and fast, with and without 64 rated ids, and
the serving batch: CUDA events, device time per kernel, the wrapper's
host time, the composed yardstick, the grid's split rule swept),
K4's per-call sum (CUDA events and device time beside ``index_add_``),
S1 (the ML-100K feature epoch by events and device time, one converged
feature through ``engine='funk'``, ``add_user`` at 16 features and at
rank 64 on a random ML-10M-shape model: ms, S1 launches and rmse reads a
call), S2 (the ML-100K epoch of phase k (c) by events and device time,
its 3-epoch launch, the rank-64 fold-in stream alone, ``add_user`` at
rank 64 on a random ML-10M-shape KMF model: ms, S2 launches and rmse
reads a call) or the ALS CG path (a warm epoch, each half-sweep, the largest user and
hottest item buckets, by CUDA events; the public ``train()`` at 0, 3
and 22 epochs on the host clock) in each checkout named, each in a
process of its own with its own modules and kernel builds, and prints
one ``AB <mode> {...}`` JSON line each.

Any failure exits non-zero.  On success the line before the last is the
kernels' JSON summary and the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA device; imports no JAX.
'''
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
EXACT_ATOL = 1e-4          # f32 sums in another order than the twin
EXACT_TIE = 1e-5           # twin scores this close may swap places
FAST_RTOL = 2.0 ** -10     # one quantization step of the packed mode
FAST_ATOL = 1e-5
NEG_SCORE = -3.0e38         # K3's score of a rated item
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
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_TF32_TENSOR_FLOPS = 495e12
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
# the item step (step_aggregate) against its plain version: within K4_ATOL
# plus 1 % of the largest change.  A row's first segment sums the same
# bf16 terms in another f32 order; the row then differs by an ulp, which
# can flip one bf16 rounding of a later segment's term (2^-9 of it)
STEP_UPD_TOL = 1e-2
# K4g's error mode against its plain version: K4's tolerance plus 2^-7 of
# the largest term, under 1 % of the elements beyond K4's tolerance.  The
# kernel's dot is a warp's fused multiply-adds where the plain version
# rounds each product, so an error may differ by an f32 ulp and round one
# term err * q to the neighbouring bf16 value (tests/test_torch_gpu.py)
AGG_FLIP = 2.0 ** -7
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


def device_ms(fn, n=20):
    '''Device time of one call: the CUDA kernels' own time over ``n``
    calls under torch.profiler, per call (no host time: for calls of a
    few microseconds, whose host side CUDA events would measure).'''
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(b - a for _, a, b in trace_device_ops(prof)) / 1e3 / n


def kernel_device_ms(fn, name, n=10):
    '''Mean device time of one kernel whose name holds ``name`` over ``n``
    calls of ``fn`` under torch.profiler, and how many of its launches
    the profiler recorded (the mean is over those).'''
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    durs = []
    for _ in range(3):           # the tracer may drop a session's events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        durs = [b - a for x, a, b in trace_device_ops(prof) if name in x]
        if durs:
            break
    return (sum(durs) / len(durs) / 1e3 if durs else None), len(durs)


def ms_or_not(x, spec='%.4f ms'):
    '''``spec % x``, or "not measured" where the tracer recorded none.'''
    return 'not measured' if x is None else spec % x


def phase1():
    import torch
    from mfrec_tpu_torch.ops import _cuda_build, bias_refit_kernel, \
        cg_kernel, frozen_half_pass_kernel, half_pass_kernel, \
        half_pass_old_kernel, kmf_serial_kernel, probe_kernel, \
        serial_kernel, topn_kernel, window_agg_kernel
    log('phase 1: python %s, torch %s, CUDA %s' % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    nv = subprocess.run([_cuda_build.nvcc_path(), '--version'],
                        capture_output=True, text=True, check=True).stdout
    log('nvcc: %s' % nv.strip().splitlines()[-1])
    log('card: %s' % card_line())
    t0 = time.perf_counter()
    k1 = tuple(half_pass_kernel.LIBRARIES.values())
    names = ('topn',) + k1 + ('frozen_half_pass', 'pcg', 'cg_bucket',
                              'window_agg', 'half_pass_old', 'probe',
                              'serial_funk', 'kmf_serial', 'bias_refit')
    _cuda_build.build(names)
    for mod in (topn_kernel, frozen_half_pass_kernel, cg_kernel,
                window_agg_kernel, half_pass_old_kernel, probe_kernel,
                serial_kernel, kmf_serial_kernel, bias_refit_kernel):
        mod._library()
    cg_kernel._bucket_library()
    for name in k1:
        half_pass_kernel._library(name)
    log('built %s in %.1f s' % (', '.join('csrc/%s.cu' % x for x in names),
                                time.perf_counter() - t0))
    for name in names:
        log(_cuda_build.build_log(name) or '')


def _rated(rng, B, I, L):
    idx = np.zeros((B, L), np.int32)
    for b in range(B):
        idx[b] = np.sort(rng.choice(I, L, replace=False))
    return idx, np.full(B, L, np.int32)


def k3_inputs(B, I, k, n, L=0, fast=False, q_bf16=False, mode='bias',
              seed=0, edge=None):
    '''Seeded K3 inputs on the card: ``{'args': (P, Q, bu, bi, mu, n),
    'kw': {rated_idx, rated_cnt, bf16_dot, packed}}``.  ``edge``: 'ties'
    (every other Q row and item bias a copy of the one before, so scores
    tie exactly and order by id), 'bounds' (each user's rated ids include
    the first and last item of every item tile, hence of every split,
    and those items score best unmasked), 'all_but' (user 0 rated all
    but n - 1 items, so NEG fills the tail of its list).'''
    import torch
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
    if edge == 'ties':
        Q[1::2], bi[1::2] = Q[0:I - 1:2], bi[0:I - 1:2]
    ri = rc = None
    if L:
        ri, rc = _rated(rng, B, I, L)
    if edge == 'bounds':
        from mfrec_tpu_torch.ops.topn_kernel import ITEM_TILE
        starts = np.arange(0, I, ITEM_TILE)
        marks = np.unique(np.concatenate(
            [starts, np.minimum(starts + ITEM_TILE, I) - 1])).astype(np.int32)
        ri = np.tile(marks, (B, 1))
        rc = np.full(B, marks.size, np.int32)
        bi[marks] += 50.0      # the marks would lead every list unmasked
    elif edge == 'all_but':
        keep = rng.choice(I, n - 1, replace=False)
        rest = np.setdiff1d(np.arange(I, dtype=np.int32), keep)
        ri = np.zeros((B, rest.size), np.int32)
        ri[0] = rest
        for b in range(1, B):
            ri[b, :L] = np.sort(rng.choice(I, L, replace=False))
        rc = np.full(B, L, np.int32)
        rc[0] = rest.size
    t = {x: torch.from_numpy(v).to(dev) for x, v in
         (('P', P), ('Q', Q), ('bu', bu), ('bi', bi))}
    Qd = t['Q'].to(torch.bfloat16) if q_bf16 else t['Q']
    kw = dict(rated_idx=None, rated_cnt=None, bf16_dot=fast, packed=fast)
    if ri is not None:
        kw.update(rated_idx=torch.from_numpy(ri).to(dev),
                  rated_cnt=torch.from_numpy(rc).to(dev))
    return {'args': (t['P'], Qd, t['bu'], t['bi'], mu, n), 'kw': kw}


def k3_composed(args, kw):
    '''The composed library yardstick for K3 (timed, never called by the
    port): ``torch.matmul`` (TF32 off; bf16 operands in the fast mode,
    f32 out where ``torch.mm`` takes ``out_dtype``), the bias adds, NEG at
    the rated ids by one ``index_fill_``, ``torch.topk``.'''
    import torch
    P, Q, bu, bi, mu, n = args
    fast = kw['bf16_dot']
    if fast:
        P, Q = P.to(torch.bfloat16), Q.to(torch.bfloat16)
    else:
        Q = Q.float()
    QT = Q.T
    flat = None
    if kw['rated_idx'] is not None:
        ri, rc = kw['rated_idx'], kw['rated_cnt']
        L = ri.shape[1]
        valid = torch.arange(L, device=ri.device)[None, :] < rc[:, None]
        rows = torch.arange(ri.shape[0], device=ri.device)[:, None]
        flat = (rows * Q.shape[0] + ri.long())[valid]
    mm = torch.mm
    if fast:
        try:
            torch.mm(P[:1], QT[:, :8], out_dtype=torch.float32)
            mm = functools.partial(torch.mm, out_dtype=torch.float32)
        except (TypeError, RuntimeError, NotImplementedError):
            pass        # bf16 out, then .float()
    f32_out = mm is not torch.mm or not fast

    def call():
        s = mm(P, QT).float()
        s = ((s + mu) + bu[:, None]) + bi[None, :]
        if flat is not None:
            s.view(-1).index_fill_(0, flat, NEG_SCORE)
        return torch.topk(s, n, dim=1)
    call.f32_out = f32_out
    return call


def kernel_case(name, B, I, k, n, L=0, fast=False, q_bf16=False, mode='bias',
                seed=0, iters=0, edge=None, composed=False, min_tiles=None):
    '''One kernel-vs-twin check on the card; returns its record.  With
    ``iters``: CUDA-event and device times of the kernel and its plain
    version, and with ``composed`` the composed library yardstick's.
    ``min_tiles``: the plan's least tiles a split for this case.'''
    import torch
    from mfrec_tpu_torch.ops import topn_kernel as tk
    from mfrec_tpu_torch.ops.topn_kernel import (topn_scores_kernel,
                                                 topn_scores_ref)
    t = k3_inputs(B, I, k, n, L, fast, q_bf16, mode, seed, edge)
    args, kw = t['args'], t['kw']
    torch.backends.cuda.matmul.allow_tf32 = False
    default = tk.MIN_TILES_PER_SPLIT
    tk.MIN_TILES_PER_SPLIT = min_tiles or default
    try:
        k_idx, k_s = topn_scores_kernel(*args, **kw)
        torch.cuda.synchronize()
    finally:
        tk.MIN_TILES_PER_SPLIT = default
    t_idx, t_s = topn_scores_ref(*args[:5], min(n + 1, I), **kw)
    ok, err, swaps = compare(k_idx.cpu(), k_s.cpu(), t_idx.cpu(), t_s.cpu(),
                             n, fast)
    rec = {'case': name, 'B': B, 'I': I, 'k': k, 'n': n, 'L': L,
           'fast': fast, 'mode': mode, 'edge': edge, 'ok': ok,
           'max_abs_err': err, 'swaps': swaps}
    if iters:
        kern = functools.partial(topn_scores_kernel, *args, **kw)
        rec['ms'] = timed_ms(kern, iters)
        rec['device_ms'] = device_ms(kern)
        rec['plain_ms'] = timed_ms(functools.partial(
            topn_scores_ref, *args, **kw), iters)
        if B <= 256:
            rec['host_us'] = k3_host_us(kern)
        if composed:
            comp = k3_composed(args, kw)
            rec['composed_ms'] = timed_ms(comp, iters)
            rec['composed_device_ms'] = device_ms(comp)
    rec['ids'] = k_idx.cpu().numpy()
    log('  %-28s ok=%s max_abs_err=%.3g swaps=%d%s' % (
        name, ok, err, swaps,
        ' kernel %.3f ms (device %.4f), plain %.3f ms%s' % (
            rec['ms'], rec['device_ms'], rec['plain_ms'],
            ', composed %.3f ms (device %.4f)' % (
                rec['composed_ms'], rec['composed_device_ms'])
            if composed else '') if iters else ''))
    return rec


def phase2():
    return (phase2_topn(), phase2_half_pass(),
            {'pcg': phase2_pcg(), 'bucket': phase2_cg_bucket()},
            phase2_window_agg(), phase2_serial(), phase2_kmf_serial())


def one_past_split(B, n, slots, lo=2000, min_tiles=1):
    '''The first I >= lo whose last split in K3's plan (at ``min_tiles``
    tiles a split or more) is one tile that holds one item (I one past
    the split boundary before it).'''
    from mfrec_tpu_torch.ops.topn_kernel import (ITEM_TILE, split_tiles,
                                                 topn_plan)
    for I in range(lo + (1 - lo) % ITEM_TILE, lo + 200_000, ITEM_TILE):
        p = topn_plan(B, I, n, slots, min_tiles)
        last = split_tiles(p['tiles'], p['splits'], p['splits'] - 1)
        if p['splits'] > 1 and last[0] == p['tiles'] - 1:
            return I
    raise SystemExit('no I with one item past a split')


K3_EDGE_MODES = (('exact', {}), ('fast', dict(fast=True, q_bf16=True)),
                 ('fast f32 Q', dict(fast=True)))


def k3_edge_cases():
    '''The redesigned K3's edges, in each mode: B off the 64-user tile,
    I under one item tile and one item past a split, exact ties (ids
    ascending), rated ids on every tile's first and last item, a user
    who rated all but n - 1 items, n either side of the running list's
    limit, k off the 128-byte chunk.'''
    import torch
    from mfrec_tpu_torch.ops import topn_kernel as tk
    recs = []
    for mname, kw in K3_EDGE_MODES:
        fast = kw.get('fast', False)
        slots = tk._slots(tk._library(), torch.device('cuda', 0),
                          int(kw.get('q_bf16', False)), 64, 10, fast)
        for name, shape in (
                ('B=1', dict(B=1, I=5000, k=64, n=10, L=20)),
                ('B=65', dict(B=65, I=5000, k=64, n=10, L=20)),
                ('B=129', dict(B=129, I=3001, k=64, n=10, L=20)),
                ('B=1025', dict(B=1025, I=2000, k=64, n=10, L=20)),
                ('I<tile', dict(B=9, I=100, k=64, n=10, L=5)),
                ('I one past split', dict(B=70, I=one_past_split(70, 10,
                                                                 slots),
                                          k=64, n=10, L=20, min_tiles=1)),
                ('ties n=7', dict(B=70, I=3001, k=64, n=7, edge='ties')),
                ('ties n=40', dict(B=70, I=3001, k=64, n=40, edge='ties')),
                ('rated bounds n=10', dict(B=66, I=5000, k=64, n=10,
                                           edge='bounds')),
                ('rated bounds n=33', dict(B=66, I=5000, k=64, n=33,
                                           edge='bounds')),
                ('all but n-1 n=5', dict(B=9, I=3000, k=64, n=5, L=30,
                                         edge='all_but')),
                ('all but n-1 n=40', dict(B=9, I=3000, k=64, n=40, L=30,
                                          edge='all_but')),
                ('n=1', dict(B=17, I=4000, k=64, n=1, L=30)),
                ('n=32', dict(B=17, I=4000, k=64, n=32, L=30)),
                ('n=33', dict(B=17, I=4000, k=64, n=33, L=30)),
                ('n=1024', dict(B=7, I=3000, k=64, n=1024, L=30)),
                ('k=1', dict(B=40, I=3000, k=1, n=10, L=10)),
                ('k=3', dict(B=40, I=3000, k=3, n=10, L=10)),
                ('k=66', dict(B=40, I=3000, k=66, n=10, L=10)),
                ('k=256', dict(B=40, I=3000, k=256, n=10, L=10)),
                ('k=256 n=40', dict(B=40, I=3000, k=256, n=40, L=10))):
            recs.append(kernel_case('d %s %s' % (mname, name), **shape,
                                    **kw))
    return recs


def phase2_topn():
    log('phase 2: K3 against its plain twin (tf32 off)')
    card = card_line()
    big = dict(B=1024, I=360_000, k=64, n=10)
    recs = [
        kernel_case('a exact', **big, iters=20, composed=True),
        kernel_case('a exact rated64', **big, L=64, iters=20, composed=True),
        kernel_case('b fast', **big, fast=True, q_bf16=True, iters=20,
                    composed=True),
        kernel_case('b fast rated64', **big, L=64, fast=True, q_bf16=True,
                    iters=20, composed=True),
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
                    iters=50, composed=True),
        kernel_case('serving fast', B=256, I=10_677, k=64, n=10, L=256,
                    fast=True, q_bf16=True, iters=50, composed=True)
    ] + k3_edge_cases()
    ex = recs[1]['ids']
    fa = recs[3]['ids']
    overlap = float(np.mean([len(set(ex[b]) & set(fa[b])) / ex.shape[1]
                             for b in range(ex.shape[0])]))
    log('  fast vs exact top-10 overlap at (b): %.4f' % overlap)
    for r in recs:
        if 'ms' in r:
            log('  time %-18s kernel %.3f ms (device %.4f), plain %.3f ms, '
                'composed %.3f ms (device %.4f)%s  [%s]'
                % (r['case'], r['ms'], r['device_ms'], r['plain_ms'],
                   r['composed_ms'], r['composed_device_ms'],
                   ', host %.1f us a call' % r['host_us']
                   if 'host_us' in r else '', card))
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


def k1_bound(seg, k, T, flops=4.0, fix_bytes=2):
    '''The least time the card could take for a K1 launch over
    ``seg``: the larger of its f32 operations (about ``flops``*k per
    rating and sweep; 4 for K1: dot, eff*ff, accumulate) over the FP32
    peak and the bytes it must move (the segment table, each fixed row
    once in bf16 -- ``fix_bytes`` 4 for f32 --, each updated row read and
    written once) over the memory rate.'''
    import torch
    n = int(seg.ent_r.numel())
    nb = int(seg.blk_row.numel())
    ns = int(seg.seg_cnt.numel())
    nfix = int(torch.unique(seg.ent_fix).numel())
    ops = flops * k * T * n
    nbytes = (12.0 * n + 12.0 * nb + 8.0 * ns + 8.0 * k * nb
              + fix_bytes * k * nfix + 8.0 * k)
    return roofline_ms(ops, nbytes)


# the fixed side's type and the column rates of each path's K1 launches:
# SGD (bf16 fixed rows, biases fixed), SVD++ (f32), FN (f32, learned
# biases, the user half-pass's factor columns frozen)
# the logistic link's options (KMF's half-passes: no clamp, no mu)
LOGISTIC = dict(link='logistic', clamp_pred=False, mu=0.0)
K1_PATHS = {'sgd': dict(ff32=False, learned=False, T=128),
            'svdpp': dict(ff32=True, learned=False, T=32),
            'fn': dict(ff32=True, learned=True, T=64)}


def k1_case(name, F_upd, F_fix, layout, axis, batches=None, T=128, mu=3.5,
            lr=0.15, iters=0, plain_iters=1, zero_mask=False, device='cuda',
            ff32=False, learned=False, **opts):
    '''K1 against its plain version on the card, in the working type
    (f32 factors, bf16 fixed side, or f32 with ``ff32``), over
    ``batches`` of a ``sorted_pass_layout`` (all of them by default), a
    second launch from the same factors bit-identical.  ``learned``: the
    FN path's rates (learned biases; on the user side the factor columns
    frozen).  Returns its record.'''
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
        k - 2, axis == 'user', lr, 0.02, 0.02, 0.15, 0.15, 0.01, 0.01,
        learned, freeze_user_factors=learned))
    F0 = torch.from_numpy(F_upd).to(dev)
    Ffix = torch.from_numpy(F_fix).to(dev)
    if not ff32:
        Ffix = Ffix.to(torch.bfloat16)
    args = (Ffix, pl.batches(), W, lrv, regv, mu, T)
    Fk = F0.clone()
    sse_k = float(half_pass(Fk, *args, segments=pl.segments, **opts))
    again = F0.clone()
    sse_a = float(half_pass(again, *args, segments=pl.segments, **opts))
    Fp = F0.clone()
    sse_p = float(half_pass_ref(Fp, *args, **opts))
    diff = (Fk - Fp).abs()
    err = float(diff.max())
    ok_w = bool((diff <= K1_ATOL + K1_RTOL * Fp.abs()).all())
    sse_err = abs(sse_k - sse_p) / abs(sse_p) if sse_p else abs(sse_k)
    moved = float((Fk - F0).abs().max())
    finite = bool(torch.isfinite(Fk).all()) and np.isfinite(sse_k)
    ok = ok_w and finite and sse_err <= K1_SSE_RTOL and \
        ((moved == 0.0) if zero_mask else (moved > 0.0)) and \
        bool(torch.equal(again, Fk)) and sse_a == sse_k
    del again
    seg = pl.segments
    rec = {'case': name, 'k': k, 'T': T, 'batches': pl.nbr_batches,
           'ratings': int(seg.ent_r.numel()), 'rows': int(seg.blk_row.numel()),
           'longest_row': seg.longest, 'ok': ok, 'max_abs_err': err,
           'sse_rel_err': sse_err, 'fixed_side': 'f32' if ff32 else 'bf16'}
    if iters:
        rec['ms'] = timed_ms(lambda: half_pass(
            Fk, *args, segments=pl.segments, **opts), iters)
        rec['plain_ms'] = timed_ms(lambda: half_pass_ref(Fp, *args, **opts),
                                   plain_iters)
        rec['bound_ms'], rec['bound_by'] = k1_bound(
            seg, k, T, fix_bytes=4 if ff32 else 2)
    log('  %-30s ok=%s max_abs_err=%.3g sse_rel_err=%.3g (%d ratings, %d '
        'rows)%s' % (name, ok, err, sse_err, rec['ratings'], rec['rows'],
                     ' kernel %.3f ms, plain %.3f ms, bound %.3f ms'
                     % (rec['ms'], rec['plain_ms'], rec['bound_ms'])
                     if iters else ''))
    return rec


def k1f_bound(seg, k, T):
    '''The least time the card could take for a K1f launch over ``seg``
    (f32 fixed rows): the larger of its f32 operations (each rating's
    frozen dot once, 2 k, then about 9 a sweep: b_u's term, the base, the
    clamp, the residual, eff * ff_col and its sum) over the FP32 peak and
    the bytes it must move (the segment table, each fixed row once, each
    updated row read once and b_u written) over the memory rate.  The
    dots' gathers of fixed rows from L2 (4 k bytes a rating) count in
    neither.'''
    import torch
    n = int(seg.ent_r.numel())
    nb = int(seg.blk_row.numel())
    ns = int(seg.seg_cnt.numel())
    nfix = int(torch.unique(seg.ent_fix).numel())
    ops = (2.0 * k + 9.0 * T) * n
    nbytes = (12.0 * n + 12.0 * nb + 8.0 * ns + (4.0 * k + 4.0) * nb
              + 4.0 * k * nfix + 8.0 * k)
    return roofline_ms(ops, nbytes)


def k1f_case(name, F_upd, F_fix, layout, batches=None, only_row=None, T=32,
             mu=3.5, iters=0, plain_iters=1, device='cuda'):
    '''K1f (FN's user half-pass: f32 fixed rows, every rate but b_u's
    zero) against K1's plain version with the same rates over
    ``batches`` of a user ``sorted_pass_layout`` (all by default; with
    ``only_row``, that row's ratings alone), K1's tolerances, a second
    launch bit-identical and every column but b_u's untouched.  With
    ``iters``: K1f's time, K1's on the same inputs and rates (the
    parent's path), K1f's plain version's (unless ``plain_iters`` is 0)
    and K1f's bound.'''
    import torch
    from mfrec_tpu_torch.ops import frozen_half_pass_kernel as fk
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass, \
        half_pass_ref
    dev = torch.device(device)
    W = layout[-1]
    arrs = list(layout[:-1])
    if batches is not None:
        arrs = [a[np.asarray(batches)] for a in arrs]
    if only_row is not None:
        arrs[3] = arrs[3] * (arrs[0] == only_row)
    pl = sgd_mf.PassLayout(tuple(arrs) + (W,), 'user', dev, segments=True)
    k = F_upd.shape[1]
    lrv, regv = (torch.from_numpy(a).to(dev) for a in sgd_mf.column_rates(
        k - 2, True, 0.15, 0.02, 0.02, 0.15, 0.15, 0.01, 0.01, True,
        freeze_user_factors=True))
    F0 = torch.from_numpy(F_upd).to(dev)
    Ffix = torch.from_numpy(F_fix).to(dev)
    args = (Ffix, pl.batches(), W, lrv, regv, mu)
    seg = pl.segments
    Fk, again, Fp = F0.clone(), F0.clone(), F0.clone()
    sse_k = float(fk.frozen_half_pass(Fk, *args, k - 2, T, segments=seg))
    sse_a = float(fk.frozen_half_pass(again, *args, k - 2, T, segments=seg))
    sse_p = float(half_pass_ref(Fp, *args, T))
    diff = (Fk - Fp).abs()
    err = float(diff.max())
    sse_err = abs(sse_k - sse_p) / abs(sse_p) if sse_p else abs(sse_k)
    moving = torch.zeros(k, dtype=torch.bool, device=dev)
    moving[k - 2] = True
    ok = bool((diff <= K1_ATOL + K1_RTOL * Fp.abs()).all()) and \
        sse_err <= K1_SSE_RTOL and bool(torch.isfinite(Fk).all()) and \
        bool(torch.equal(again, Fk)) and sse_a == sse_k and \
        bool(torch.equal(Fk[:, ~moving], F0[:, ~moving])) and \
        float((Fk - F0).abs().max()) > 0
    del again, Fp
    n_long, _, n_ovf = fk.long_rows(seg, *fk.geometry(k)[:2]) \
        if dev.type == 'cuda' else (None, None, None)
    rec = {'case': name, 'k': k, 'T': T, 'W': W,
           'batches': pl.nbr_batches, 'ratings': int(seg.ent_r.numel()),
           'rows': int(seg.blk_row.numel()), 'long_rows': n_long,
           'records_past_shared_memory': n_ovf, 'longest_row': seg.longest,
           'ok': ok, 'max_abs_err': err, 'sse_rel_err': sse_err}
    if iters:
        rec['ms'] = timed_ms(lambda: fk.frozen_half_pass(
            Fk, *args, k - 2, T, segments=seg), iters)
        rec['k1_ms'] = timed_ms(lambda: half_pass(
            Fk, *args, T, segments=seg), iters)
        Ft = F0.clone()
        rec['plain_ms'] = timed_ms(lambda: fk.frozen_half_pass_ref(
            Ft, *args, k - 2, T), plain_iters) if plain_iters else None
        rec['bound_ms'], rec['bound_by'] = k1f_bound(seg, k, T)
    log('  %-34s ok=%s max_abs_err=%.3g sse_rel_err=%.3g (%d ratings, %d '
        'rows, %s of them a block, %s records past shared memory)%s'
        % (name, ok, err, sse_err, rec['ratings'], rec['rows'], n_long,
           n_ovf, ' K1f %.3f ms, K1 with the same rates %.3f ms, plain '
           '%s, bound %.3f ms (%s)' % (
               rec['ms'], rec['k1_ms'], ms_or_not(rec['plain_ms'], '%.3f ms'),
               rec['bound_ms'], rec['bound_by']) if iters else ''))
    return rec


# the fields of each K1f record that the kernels line keeps
K1F_CASE_KEYS = ('case', 'k', 'T', 'W', 'batches', 'ratings', 'rows',
                 'long_rows', 'records_past_shared_memory', 'ok',
                 'max_abs_err', 'sse_rel_err', 'ms', 'k1_ms')


def k1f_entry(k1_time, fn):
    '''The kernels line's K1f entry from phase 2's K1f records (at k 102,
    T 32 over the W=128 layout: the first 16 user batches, the heaviest
    user, the whole half-pass; at phase 7's k 66, T 64 over the W=512
    layout: the first 16 user batches, the heaviest user) and phase 7's
    launches.'''
    recs = k1_time.get('k1f', [])
    if not recs:
        return []
    first, whole = recs[0], recs[2]
    return [{
        'name': 'frozen_half_pass (K1f, FN\'s user half-pass: the frozen '
                'dot once, b_u swept)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/frozen_half_pass.cu',
        'replaces': 'mfrec_tpu/ops/fn.py:141-252 (user half-pass through '
                    'mfrec_tpu/ops/pallas_half_pass.py:274)',
        'launches': fn.get('k1f_launches'),
        'max_abs_err': max(r['max_abs_err'] for r in recs),
        'ms': first['ms'], 'plain_ms': first['plain_ms'],
        'bound_ms': first['bound_ms'], 'bound_by': first['bound_by'],
        'library_ms': None,
        'shape': 'first 16 batches of the ML-10M user half-pass: B=16384 '
                 'W=128 k=102 T=32, f32 fixed rows',
        'ms_half_pass_user': whole['ms'],
        'k1_ms_half_pass_user': whole['k1_ms'],
        'bound_ms_half_pass_user': whole['bound_ms'],
        'cases': [{x: r.get(x) for x in K1F_CASE_KEYS} for r in recs]}]


def k1_kernel_ms(F_upd, F_fix, layout, axis, iters=3, only_row=None, T=128,
                 mu=3.5, device='cuda', ff32=False, **opts):
    '''Device time of one K1 launch over a whole layout (or over
    ``only_row``'s ratings alone: that row's chain of segments), bf16
    fixed rows (f32 with ``ff32``); ``opts`` go to ``half_pass`` (the
    link).'''
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
    Ffix = torch.from_numpy(F_fix).to(dev)
    if not ff32:
        Ffix = Ffix.to(torch.bfloat16)
    ms = timed_ms(lambda: half_pass(F, Ffix, pl.batches(), W, lrv, regv, mu,
                                    T, segments=pl.segments, **opts), iters)
    bound, by = k1_bound(pl.segments, k, T, fix_bytes=4 if ff32 else 2)
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
    # the other paths' builds: SVD++ and FN run K1 on f32 fixed rows
    for path in ('svdpp', 'fn'):
        opt = dict(K1_PATHS[path], device=device)
        nb = min(16, lay['user'][0].shape[0])
        recs.append(k1_case('%s path first%d user (f32 fixed, T=%d)'
                            % (path, nb, opt['T']), *side['user'],
                            lay['user'], 'user', batches=range(nb),
                            iters=5, plain_iters=2, **opt))
    runs = {a: _longest_run_batch(lay[a]) for a in lay}
    axis = max(runs, key=lambda a: runs[a][1])
    b, n = runs[axis]
    recs.append(k1_case('main longest segment (%s %d, %d)' % (axis, b, n),
                        *side[axis], lay[axis], axis, batches=[b], **kw))
    # the most-rated item's whole chain (a cluster row) against the plain
    # version: every batch it has ratings in
    hot = int(np.bincount(i).argmax())
    hot_b = np.flatnonzero(((lay['item'][1] == hot)
                            & (lay['item'][3] > 0)).any(1))
    recs.append(k1_case('main hot item %d chain (%d batches, cluster)'
                        % (hot, hot_b.size), *side['item'], lay['item'],
                        'item', batches=hot_b, **kw))
    recs.append(k1_case('logistic hot item %d chain (cluster)' % hot,
                        *side['item'], lay['item'], 'item', batches=hot_b,
                        **LOGISTIC, **kw))
    # SVD++'s build at its width (f = 100: k = 102, f32 fixed, T = 32), as
    # its cell runs it: the first user batches, and the hot item's chain,
    # whose cluster blocks stage part of each slice and stream the rest
    Pw, Qw = _aug_factors(U, I, 100, W, seed=4)
    k102 = dict(K1_PATHS['svdpp'], device=device)
    nb = min(16, lay['user'][0].shape[0])
    recs.append(k1_case('svdpp k=102 first%d user (f32 fixed, T=%d)'
                        % (nb, k102['T']), Pw, Qw, lay['user'], 'user',
                        batches=range(nb), iters=5, plain_iters=2, **k102))
    recs.append(k1_case('svdpp k=102 hot item %d chain (cluster, T=%d)'
                        % (hot, k102['T']), Qw, Pw, lay['item'], 'item',
                        batches=hot_b, **k102))
    # K1f, FN's user half-pass at its width (k = 102, f32 fixed, T = 32):
    # the first user batches, the heaviest user's chain (a block, records
    # past shared memory) and the whole half-pass against K1's plain
    # version, timed beside K1 with the same rates
    def heaviest(L):
        ub, mb = L[0], L[3]
        row = int(np.bincount(ub[mb > 0]).argmax())
        return row, np.flatnonzero(((ub == row) & (mb > 0)).any(1))

    heavy, heavy_b = heaviest(lay['user'])
    k1f_recs = [
        k1f_case('k1f k=102 first%d user (T=32)' % nb, Pw, Qw, lay['user'],
                 batches=range(nb), iters=5, plain_iters=2, device=device),
        k1f_case('k1f k=102 heaviest user %d (T=32)' % heavy, Pw, Qw,
                 lay['user'], batches=heavy_b, only_row=heavy,
                 device=device),
        k1f_case('k1f k=102 whole user half-pass (T=32)', Pw, Qw,
                 lay['user'], iters=5, plain_iters=0, device=device)]
    # and at phase 7's shape (rank 64: k = 66, KJ = 3; T = 64; the W=512
    # user layout FN trains on): the first user batches, timed beside K1,
    # and the heaviest user's chain
    lay512 = stream_layout(U, I, nnz, 'user', 512, B)
    P66, Q66 = _aug_factors(U, I, 64, 512, seed=5)
    heavy, heavy_b = heaviest(lay512)
    nb512 = min(16, lay512[0].shape[0])
    k1f_recs += [
        k1f_case('k1f k=66 W=512 first%d user (T=64)' % nb512, P66, Q66,
                 lay512, batches=range(nb512), T=64, iters=5,
                 plain_iters=0, device=device),
        k1f_case('k1f k=66 W=512 heaviest user %d (T=64)' % heavy, P66,
                 Q66, lay512, batches=heavy_b, only_row=heavy, T=64,
                 device=device)]
    del P66, Q66
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
    edge = [('edge logistic', LOGISTIC),
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
    ms, bound, by, seg = k1_kernel_ms(*side['item'], lay['item'], 'item',
                                      only_row=hot, **kw)
    timing['chain'] = dict(ms=ms, bound_ms=bound, row=hot,
                           ratings=seg.longest,
                           segments=seg.longest_segments)
    log('  time longest chain (item %d, %d ratings, %d segments): kernel '
        '%.3f ms, %.1f %% of the item half-pass, bound %.3f ms  [%s]'
        % (hot, seg.longest, seg.longest_segments, ms,
           100.0 * ms / timing['item']['ms'], bound, card))
    # the logistic link's build (KMF's half-passes): the item half-pass and
    # the hot item's chain, whose cluster rows it runs too
    lg = {n: k1_kernel_ms(*side['item'], lay['item'], 'item', only_row=row,
                          **LOGISTIC, **kw)[0]
          for n, row in (('item', None), ('chain', hot))}
    timing['logistic'] = lg
    log('  time logistic link: whole item half-pass %.3f ms, longest chain '
        '%.3f ms  [%s]' % (lg['item'], lg['chain'], card))
    for r in recs:
        if 'ms' in r:
            log('  time %-26s kernel %.3f ms, plain %.3f ms, bound %.3f ms '
                '(%s)  [%s]' % (r['case'], r['ms'], r['plain_ms'],
                                r['bound_ms'], r['bound_by'], card))
    timing['k1f'] = k1f_recs
    bad = [r['case'] for r in recs + k1f_recs if not r['ok']]
    if bad:
        raise SystemExit('phase 2 (K1, K1f) failed: %s' % bad)
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
        bu, bi, mu, post = m._pallas_score_terms(
            m._predictor_mode(predictor))
        ridx, rmask = topk.pad_rated_lists(m.ratings, users)
        ridx, rcnt = kernel_rated_lists(ridx, rmask)
        ref = topn_scores_ref(t(m.P[users]), t(m.Q), t(bu[users]), t(bi), mu,
                              11, t(ridx), t(rcnt))
        ref_s = ref[1].cpu().numpy()
        if post is not None:            # the monotone link, as the model
            ref_s = post(ref_s)
        ok, err, swaps = topn_agreement(idx, scores, ref[0].cpu(), ref_s, 10,
                                        EXACT_ATOL, tie=EXACT_TIE)
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
    from mfrec_tpu_torch.ops.bias_refit_kernel import bias_refit
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
    b1_launches = bias_refit.launches
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
    # the bias refit on the card: two B1 launches a call, 6 calls
    log('  B1 launches %d (6 calls x 2 passes)' % b1_launches)
    if device == 'cuda' and b1_launches != 12:
        raise SystemExit('B1 launched %d times, not 12' % b1_launches)
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
                b1_launches=b1_launches, epoch_s=epoch_s, epoch_s_blocks=marg, updates_per_s=updates,
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


# the fused K2's M and b against a float64 Gram of the same bf16
# operands: within (ceil(count / 32) + 72) u of the absolute sum of the
# terms, u = 2^-24, plus u |HHreg| for M's last add (b: ceil(count / 32)
# + 36).  A chunk's 32 products are exact and summed by the tensor cores
# in two mma steps, which need not round to nearest: if each step aligns
# its 16 products and the accumulator to the largest exponent and
# truncates (the behaviour measured on earlier NVIDIA tensor cores), each
# of the 17 addends and the normalised sum lose less than 2u of the
# chunk's absolute sum, 36 u a step, 72 u a chunk; the chunks' sums are
# IEEE f32 adds, one rounding each (in a cluster row, a rank's chunks and
# then the ranks' partials, fewer adds on any path than the row has
# chunks): the recursive-summation bound
# (Higham, Accuracy and Stability of Numerical Algorithms, 4.2).  b: 32
# FMAs a chunk, then the adds of the chunks and of at most 4 parts.  A
# Gram rounded to bf16 (2^-9 = 32,768 u) misses it by far at every count
# the ALS epoch has (at most 1,961 chunks).
GRAM_U = 2.0 ** -24
GRAM_CHUNK = 32


def bucket_counts(mask):
    '''Each row's count as the fused K2 finds it: one past its last slot
    with mask != 0.'''
    import torch
    pos = torch.arange(1, mask.shape[1] + 1, device=mask.device)
    return ((mask != 0) * pos).amax(1) if mask.shape[1] else \
        torch.zeros(mask.shape[0], dtype=torch.int64, device=mask.device)


def cg_bucket_f64(Fb, HHreg, nbr_idx, nbr_val, mask, c_pos, alpha, k,
                  chunk=2048):
    '''One bucket's M and b in float64 from the operands the fused K2 and
    the JAX body round to (Ab = Fb[idx] in bf16, cm1 and (1 + cm1) mask
    in f32, Awb = bf16(Ab * bf16(cm1))), and the absolute sums of their
    terms: (M64, b64, SM, Sb), [R, k, k] and [R, k].  ``chunk`` systems
    at a time.'''
    import torch
    R = nbr_idx.shape[0]
    dev = Fb.device
    f64 = dict(dtype=torch.float64, device=dev)
    M64, SM = torch.empty((R, k, k), **f64), torch.empty((R, k, k), **f64)
    b64, Sb = torch.empty((R, k), **f64), torch.empty((R, k), **f64)
    H = HHreg.double()[None]
    for s0 in range(0, R, chunk):
        sl = slice(s0, s0 + chunk)
        Ab = Fb[:, :k][nbr_idx[sl].long()]
        c = float(alpha) * nbr_val[sl] if float(alpha) > 0 else \
            torch.full_like(nbr_val[sl], float(c_pos))
        cm1 = c * mask[sl]
        Awb = (Ab.float() * cm1.to(torch.bfloat16).float()[..., None]).to(
            torch.bfloat16)
        A64, W64 = Ab.double(), Awb.double()
        coef = ((1.0 + cm1) * mask[sl]).double()[:, None, :]
        M64[sl] = H + torch.bmm(W64.transpose(1, 2), A64)
        SM[sl] = torch.bmm(W64.abs().transpose(1, 2), A64.abs())
        b64[sl] = torch.bmm(coef, A64)[:, 0]
        Sb[sl] = torch.bmm(coef.abs(), A64.abs())[:, 0]
    return M64, b64, SM, Sb


def gram_within(M, b, M64, b64, SM, Sb, HHreg, counts):
    '''M and b against the float64 Gram within GRAM_U's bound (above).
    Returns (ok, max |M - M64|, max |b - b64|, the largest error over its
    bound).'''
    nch = ((counts + GRAM_CHUNK - 1) // GRAM_CHUNK).double()
    tolM = (nch + 72)[:, None, None] * GRAM_U * SM + \
        GRAM_U * HHreg.double().abs()[None]
    tolb = (nch + 36)[:, None] * GRAM_U * Sb
    eM, eb = (M.double() - M64).abs(), (b.double() - b64).abs()
    ok = bool((eM <= tolM).all()) and bool((eb <= tolb).all())
    ratio = max(float((eM / tolM.clamp(min=1e-300)).max()) if eM.numel()
                else 0.0,
                float((eb / tolb.clamp(min=1e-300)).max()) if eb.numel()
                else 0.0)
    return (ok, float(eM.max()) if eM.numel() else 0.0,
            float(eb.max()) if eb.numel() else 0.0, ratio)


def cg_bucket_bound(idx, mask, k, steps, c_pos, alpha):
    '''The fused K2's least time on one bucket (``idx``, ``mask`` [R, L]
    tensors), counted from what these inputs ask for, in ms, and what
    sets it.  Bytes: the mask read whole; the ids of the real entries
    (mask != 0) and, where alpha > 0, their values; the distinct fixed
    rows they name, k bf16 each; HHreg, the row ids, x0 and x.
    Operations: the Gram over the real entries on the bf16 tensor cores,
    k (k + 1) each where alpha = 0 and bf16(c_pos) is a power of two (then
    Awb = 2^e Ab exactly and the correction is symmetric), 2 k^2 each
    otherwise; b on the f32 cores (k adds each at alpha = 0, 2 k
    otherwise) and the PCG (2 k^2 (steps + 1) per system).  The tensor
    cores and the f32 cores run side by side, so the bound is the largest
    of the three times.'''
    import torch
    R, L = idx.shape
    real = mask != 0
    nnz = int(real.sum())
    n_fix = int(torch.unique(idx[real]).numel())
    w = float(torch.tensor(c_pos, dtype=torch.bfloat16))
    symmetric = alpha == 0 and math.frexp(w)[0] == 0.5
    nbytes = 4.0 * R * L + (4.0 if alpha == 0 else 8.0) * nnz + \
        2.0 * n_fix * k + 4.0 * k * k + 4.0 * R + 8.0 * R * k
    t_tensor = (k * (k + 1.0) if symmetric else 2.0 * k * k) * nnz \
        / PEAK_BF16_TENSOR_FLOPS
    t_f32 = ((k if alpha == 0 else 2.0 * k) * nnz
             + 2.0 * R * k * k * (steps + 1)) / PEAK_F32_FLOPS
    t_ops, t_bytes = max(t_tensor, t_f32), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def cg_bucket_data(R, L, k, seed, device, hot=False, holes=False,
                   empty_row=False):
    '''A seeded bucket for the fused K2: F [3k + 50, k] ~ N(0, 0.3) (its
    bf16 copy as ``cg_epoch`` makes it and HHreg = F^T F + 0.015 I), out
    [R + 23, k] ~ N(0, 0.1), R distinct rows, each row's count uniform in
    1..L with its real entries first and zero padding after (as
    ``padded_rows`` lays them out), values in 1..5.  ``hot``: the first
    row full; ``holes``: 30 % of the real slots masked out (a mask the
    kernel must not read as a prefix); ``empty_row``: the second row has
    no entry.'''
    import torch
    from mfrec_tpu_torch.ops import als as als_ops
    rng = np.random.default_rng(seed)
    n, n_upd = 3 * k + 50, R + 23
    F = rng.normal(0, 0.3, (n, k)).astype(np.float32)
    out = rng.normal(0, 0.1, (n_upd, k)).astype(np.float32)
    rows = rng.permutation(n_upd)[:R].astype(np.int32)
    counts = rng.integers(1, L + 1, R)
    if hot and R:
        counts[0] = L
    if empty_row and R > 1:
        counts[1] = 0
    slots = np.arange(L)[None, :] < counts[:, None]
    mask = slots.astype(np.float32)
    if holes:
        mask *= (rng.random((R, L)) > 0.3)
    idx = np.where(slots, rng.integers(0, n, (R, L)), 0).astype(np.int32)
    val = np.where(slots, rng.uniform(1, 5, (R, L)), 0).astype(np.float32)
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    Ff = t(F)
    return dict(Fb=als_ops._fixed_bf16(Ff), out=t(out),
                HH=als_ops._hh(Ff, 0.015), rows=t(rows), idx=t(idx),
                val=t(val), mask=t(mask))


def cg_bucket_case(name, d, steps, c_pos=1.0, alpha=0.0, iters=0,
                   plain_iters=0, yardsticks=False):
    '''The fused K2 against its plain version (``cg_bucket_ref``) on one
    bucket ``d`` (``cg_bucket_data``'s keys): M and b against the
    float64 Gram (``gram_within``), x against the plain version within
    PCG_ATOL/PCG_RTOL or, where f32 PCG trajectories drift apart mid-solve
    (``pcg_case``), as close to the float64 iteration on the float64
    Gram as the plain version is within a factor of 2; rows outside
    ``rows`` untouched, ``steps=0`` returns x0 exactly, one launch on a
    card.  With ``iters``: kernel, plain version and bound; with
    ``yardsticks`` also the parent's composition (``cg_system`` +
    ``pcg_solve_kernel`` + write-back, ``composed_ms``) and the exact
    solver on the same systems.'''
    import torch
    from mfrec_tpu_torch.ops import als as als_ops
    from mfrec_tpu_torch.ops.cg_kernel import cg_bucket_kernel, \
        cg_bucket_ref, pcg_solve_kernel
    out0, rows, Fb = d['out'], d['rows'], d['Fb']
    R, L = d['idx'].shape
    k = out0.shape[1]
    on_card = out0.is_cuda
    args = (d['HH'], rows, d['idx'], d['val'], d['mask'], c_pos, alpha,
            steps)
    before = cg_bucket_kernel.launches
    outk, Mk, bk = cg_bucket_kernel(Fb, out0.clone(), *args,
                                    return_system=True)
    if on_card:
        torch.cuda.synchronize()
    launched = cg_bucket_kernel.launches - before
    outp, Mp, bp = cg_bucket_ref(Fb, out0.clone(), *args, return_system=True)
    counts = bucket_counts(d['mask'])
    M64, b64, SM, Sb = cg_bucket_f64(Fb, d['HH'], d['idx'], d['val'],
                                     d['mask'], c_pos, alpha, k)
    gram_ok, errM, errb, ratio = gram_within(Mk, bk, M64, b64, SM, Sb,
                                             d['HH'], counts)
    plain_errM = float((Mp.double() - M64).abs().max()) if R else 0.0
    # the largest error of M in units of u times the absolute sum of its
    # terms, HHreg's included
    units = float(((Mk.double() - M64).abs() / (GRAM_U * (
        SM + d['HH'].double().abs()[None])).clamp(min=1e-300)).max()) \
        if R else 0.0
    rl = rows.long()
    xk, xp, x0 = outk[rl], outp[rl], out0[rl]
    diff = (xk - xp).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    within = bool((diff <= PCG_ATOL + PCG_RTOL * xp.abs()).all())
    x64 = als_ops.pcg_solve(M64, b64, x0.double(), steps)
    kerr64 = float((xk.double() - x64).abs().max()) if R else 0.0
    perr64 = float((xp.double() - x64).abs().max()) if R else 0.0
    x_ok = bool(torch.isfinite(xk).all()) and (within or kerr64 <= 2 * perr64)
    others = torch.ones(out0.shape[0], dtype=torch.bool, device=out0.device)
    others[rl] = False
    untouched = torch.equal(outk[others], out0[others])
    zero_ok = steps != 0 or torch.equal(xk, x0)
    launch_ok = launched == (1 if on_card and R else 0)
    ok = gram_ok and x_ok and untouched and zero_ok and launch_ok
    nnz = int((d['mask'] != 0).sum())
    rec = {'case': name, 'R': R, 'L': L, 'k': k, 'steps': steps,
           'alpha': alpha, 'c_pos': c_pos, 'nnz': nnz,
           'max_count': int(counts.max()) if R else 0, 'ok': ok,
           'max_abs_err': err, 'within_tolerance': within,
           'kernel_err_f64': kerr64, 'plain_err_f64': perr64,
           'gram_ok': gram_ok, 'M_err_f64': errM, 'b_err_f64': errb,
           'plain_M_err_f64': plain_errM, 'gram_err_over_bound': ratio,
           'M_err_u_abs_sum': units,
           'untouched': untouched, 'launches': launched}
    if iters:
        outt = out0.clone()
        rec['ms'] = timed_ms(lambda: cg_bucket_kernel(Fb, outt, *args), iters)
        rec['plain_ms'] = timed_ms(lambda: cg_bucket_ref(Fb, outt, *args),
                                   plain_iters or iters)
        rec['bound_ms'], rec['bound_by'] = cg_bucket_bound(
            d['idx'], d['mask'], k, steps, c_pos, alpha)
        if yardsticks:
            def composed():
                M, b, x0_ = als_ops.cg_system(Fb, outt, *args[:-1])
                outt[rl] = pcg_solve_kernel(M, b, x0_, steps)

            rec['composed_ms'] = timed_ms(composed, plain_iters or iters)
            rec['exact_ms'] = timed_ms(lambda: torch.cholesky_solve(
                bp[..., None], torch.linalg.cholesky(Mp)), plain_iters or iters)
    log('  %-40s ok=%s x err %.3g%s (f64: kernel %.3g, plain %.3g); M err '
        '%.3g (plain %.3g; %.1f u of its terms), b err %.3g, %.2f of the '
        'bound%s' % (
            name, ok, err, '' if within else ' (outside atol %g rtol %g)'
            % (PCG_ATOL, PCG_RTOL), kerr64, perr64, errM, plain_errM, units,
            errb, ratio, ' kernel %.3f ms, plain %.3f ms, bound %.3f ms (%s)%s'
            % (rec['ms'], rec['plain_ms'], rec['bound_ms'], rec['bound_by'],
               ', composed %.3f ms, exact solver %.3f ms'
               % (rec['composed_ms'], rec['exact_ms']) if yardsticks else '')
            if iters else ''))
    return rec


def phase2_cg_bucket(device='cuda'):
    '''The fused K2 against its plain version on seeded buckets: k from 8
    to 256 (odd k padded to 16-byte rows; k = 256 streams M), L from 8 to
    16,384 (one full hot row), masks with holes and an empty row, alpha 0
    and 2 with c_pos 1.7, steps 0, 3 and 6, and R = 4,099 (two systems a
    block); R = 0 launches nothing.'''
    from mfrec_tpu_torch.ops.cg_kernel import cg_bucket_kernel
    log('phase 2: the fused K2 (gather, Gram, PCG, write-back) against its '
        'plain version (M, b: the float64 bound; x: atol %g, rtol %g)'
        % (PCG_ATOL, PCG_RTOL))
    cases = [('R=1 k=8 L=8', 1, 8, 8, 3, 0.0, {}),
             ('R=37 k=20 L=64 alpha=2', 37, 64, 20, 6, 2.0, {}),
             ('R=37 k=37 L=64 (odd k)', 37, 64, 37, 3, 0.0, {}),
             ('R=37 k=64 L=64 steps=0', 37, 64, 64, 0, 2.0, {}),
             ('R=37 k=64 L=256 holes, empty row', 37, 256, 64, 6, 2.0,
              dict(holes=True, empty_row=True)),
             ('R=37 k=130 L=64 alpha=2', 37, 64, 130, 3, 2.0, {}),
             ('R=9 k=256 L=64 (M streamed)', 9, 64, 256, 3, 2.0, {}),
             ('R=3 k=64 L=16384 hot row', 3, 16384, 64, 6, 0.0,
              dict(hot=True)),
             ('R=4099 k=64 L=256 (2 a block)', 4099, 256, 64, 3, 2.0, {})]
    recs = []
    for j, (name, R, L, k, steps, alpha, kw) in enumerate(cases):
        d = cg_bucket_data(R, L, k, seed=100 + j, device=device, **kw)
        recs.append(cg_bucket_case(name, d, steps, c_pos=1.7, alpha=alpha))
    d = cg_bucket_data(0, 8, 64, seed=0, device=device)
    before = cg_bucket_kernel.launches
    out0 = d['out'].clone()
    cg_bucket_kernel(d['Fb'], d['out'], d['HH'], d['rows'], d['idx'],
                     d['val'], d['mask'], 1.0, 0.0, 3)
    if cg_bucket_kernel.launches != before or not bool(
            (d['out'] == out0).all()):
        raise SystemExit('R=0 must launch nothing and change nothing')
    bad = [r['case'] for r in recs if not r['ok']]
    if bad:
        raise SystemExit('phase 2 (fused K2) failed: %s' % bad)
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
    the bound, the kernel and ``index_add_`` both by CUDA events around a
    call (host included) and by their device time (``device_ms``).'''
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
        if g.is_cuda:
            rec['device_ms'] = device_ms(lambda: window_aggregate(
                g, kl, m, W, check_ids=False))
            rec['library_device_ms'] = device_ms(
                lambda: out.index_add_(0, idx, g16))
        rec['bound_ms'], rec['bound_by'] = k4_call_bound(n_in, B, k, W)
    times = ' kernel %.4f ms, plain %.4f ms, index_add_ %.4f ms, bound %.4f ' \
        'ms; device time kernel %.4f ms, index_add_ %.4f ms' % (
            rec['ms'], rec['plain_ms'], rec['library_ms'], rec['bound_ms'],
            rec.get('device_ms', -1.0), rec.get('library_device_ms', -1.0)) \
        if iters else ''
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


def k4_gather_bound(seg, k, mode):
    '''K4g's least time over segment table ``seg``, k the gathered rows'
    width: the benchmark's byte and operation counts of the SVD++
    aggregation phases (``bench_torch/lib/svdpp_bound``; the error mode's
    rows are k = factors + 2 wide) on this script's peaks.'''
    import torch
    bench = os.path.join(REPO, 'bench_torch')
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from lib import fn_bound, svdpp_bound
    work = {'gather': svdpp_bound.gather_agg_work,
            'error': svdpp_bound.error_agg_work,
            'profile': fn_bound.profile_agg_work}[mode]
    return roofline_ms(*work(
        int(seg.ent_r.numel()), int(seg.blk_row.numel()),
        int(seg.seg_cnt.numel()), int(torch.unique(seg.ent_fix).numel()),
        k - 2 if mode == 'error' else k))


def _profile_rows(seg, X, Y, bu, bi, mu):
    '''The FN profile mode's rows ``res_e * X[fix_e] + Y[fix_e]``.'''
    import torch
    f = seg.ent_fix.long()
    res = seg.ent_r - (torch.as_tensor(mu, dtype=torch.float32)
                       + bu[seg.ent_row.long()] + bi[f])
    return res[:, None] * X[f] + Y[f]


def k4_gather_case(name, seg, mode, k, rows, fix_rows, seed, iters=0,
                   plain_iters=0, rounded=True):
    '''K4g -- ``gather_aggregate`` (``mode`` 'gather', SVD++'s Y sums),
    ``error_aggregate`` ('error', the error-weighted Q sums of SVD++ and
    FN) or ``profile_aggregate`` ('profile', FN's profile sums) -- over
    segment table ``seg`` against its plain version, from a random
    target, random gathered rows ``[fix_rows, k]`` and, in the error
    mode, random effective rows, the target k - 2 wide and ratings
    clamped to [1, 5]; in the profile mode X the gathered rows, a random
    Y and random biases, its rows rounded to bf16 or, with ``rounded``
    False (the served profiles' instantiation), summed in full f32.  The sum and profile modes (whose rows kernel
    and plain version make alike) as ``scan_aggregate`` (``_k4_ok``);
    the error mode within K4_ATOL/K4_RTOL plus AGG_FLIP of the largest
    term, under 1 % of the elements beyond K4's tolerance; a second
    launch bit-identical.  With ``iters`` the kernel's time (CUDA events
    around a call, host included, and its device time), the plain
    version's and the bound.'''
    import torch
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    dev = seg.ent_r.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randn((fix_rows, k), generator=gen, device=dev)
    if mode == 'gather':
        kt = k
        run, ref, args = wak.gather_aggregate, wak.gather_aggregate_ref, \
            (src, seg)
    elif mode == 'profile':
        kt = k
        src = 0.05 * src
        Y = 0.05 * torch.randn((fix_rows, k), generator=gen, device=dev)
        bu = 0.3 * torch.randn(rows, generator=gen, device=dev)
        bi = 0.3 * torch.randn(fix_rows, generator=gen, device=dev)
        run, ref, args = (wak.profile_aggregate, wak.profile_aggregate_ref,
                          (src, Y, bu, bi, seg, 3.6, rounded))
    else:
        kt = k - 2
        prow = 0.3 * torch.randn((rows, k), generator=gen, device=dev)
        run, ref, args = wak.error_aggregate, wak.error_aggregate_ref, \
            (prow, src, seg, 3.6, 1.0, 5.0)
    t0 = torch.randn((rows, kt), generator=gen, device=dev)
    got = run(t0.clone(), *args)
    again = run(t0.clone(), *args)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    want = ref(t0.clone(), *args)
    same = bool(torch.equal(got, again))
    del again
    if mode in ('gather', 'profile'):
        rows_of = src[seg.ent_fix.long()] if mode == 'gather' else \
            _profile_rows(seg, *args[:4], 3.6)
        exact = wak.scan_aggregate_ref(t0.double(), rows_of, seg,
                                       rounded=rounded)
        del rows_of
        ok, err, k64, p64 = _k4_ok(got, want, exact)
        del exact
        extra = {'kernel_err_f64': k64, 'plain_err_f64': p64}
        what = 'float64: kernel %.3g, plain %.3g' % (k64, p64)
    else:
        # the largest term err * q, in blocks of entries
        tmax = 0.0
        for a in range(0, int(seg.ent_r.numel()), 1 << 22):
            f = seg.ent_fix[a:a + (1 << 22)].long()
            q = src[f]
            d = (prow[seg.ent_row[a:a + (1 << 22)].long()] * q).sum(-1) + 3.6
            e = (seg.ent_r[a:a + (1 << 22)] - d.clamp(1.0, 5.0)) * \
                seg.ent_m[a:a + (1 << 22)]
            tmax = max(tmax, float((e[:, None] * q[:, :kt]).abs().max()))
            del f, q, d, e
        diff = (got - want).abs()
        tol = K4_ATOL + K4_RTOL * want.abs()
        err = float(diff.max())
        share = float((diff > tol).float().mean())
        ok = bool(torch.isfinite(got).all()) and bool(
            (diff <= tol + AGG_FLIP * tmax).all()) and share < 1e-2
        del diff, tol
        extra = {'largest_term': tmax, 'share_over_k4_tol': share}
        what = 'largest term %.3g, %.2g of the elements past K4\'s ' \
            'tolerance' % (tmax, share)
    ok = ok and same and float((want - t0).abs().max()) > 0
    rec = {'case': name, 'mode': mode, 'k': k, 'rounded': rounded,
           'entries':
           int(seg.ent_r.numel()), 'rows': int(seg.blk_row.numel()),
           'longest_row': seg.longest, 'ok': ok, 'max_abs_err': err,
           **extra}
    del got, want
    if iters:
        tk = t0.clone()
        rec['ms'] = timed_ms(lambda: run(tk, *args), iters)
        rec['plain_ms'] = timed_ms(lambda: ref(tk, *args),
                                   plain_iters or iters)
        if dev.type == 'cuda':
            rec['device_ms'] = device_ms(lambda: run(tk, *args))
        rec['bound_ms'], rec['bound_by'] = k4_gather_bound(seg, k, mode)
        del tk
    log('  %-44s ok=%s max_abs_err=%.3g (%s; %d entries in %d rows, '
        'longest %d)%s'
        % (name, ok, err, what, rec['entries'], rec['rows'], seg.longest,
           ' kernel %.3f ms (device %.3f ms), plain %.3f ms, bound %.3f ms'
           % (rec['ms'], rec.get('device_ms', -1.0), rec['plain_ms'],
              rec['bound_ms']) if iters else ''))
    return rec


def b1_bound(p_seg, q_seg, n_items):
    '''B1's least time for both passes: the bytes they must move (the
    item table's ent_r and the user table's ent_r and ent_fix once, 24
    bytes a row for the row list, its offsets and the output, the item
    biases once) over the memory rate; its operations (a subtraction and
    an add an entry, one more in the user pass) are far below the FP32
    peak.'''
    n_i, n_u = int(q_seg.ent_r.numel()), int(p_seg.ent_r.numel())
    rows = int(q_seg.blk_row.numel()) + int(p_seg.blk_row.numel())
    return roofline_ms(2.0 * n_i + 3.0 * n_u,
                       4.0 * n_i + 8.0 * n_u + 24.0 * rows + 4.0 * n_items)


def b1_case(name, lay_user, lay_item, W, U, I, nnz, iters=0,
            device='cuda'):
    '''B1 (``bias_refit``: the item pass, then the user pass over the
    item biases) over the segment tables of the sorted-pass layouts
    ``lay_user``, ``lay_item`` at window W, against its plain version on
    the card and the numpy refit of a CPU model over the same store
    (``unique_stream``): within one f32 ulp an element (counted: the
    elements that differ at all), a second launch bit-identical.  With
    ``iters`` the two passes' time by CUDA events (host included), the
    kernel's device time (torch.profiler), the plain version's and the
    numpy refit's (host clock), and the bound.'''
    import torch
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops import bias_refit_kernel as b1
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    dev = torch.device(device)
    p_seg = hk.build_segments(lay_user[1], lay_user[2], lay_user[3],
                              lay_user[4], lay_user[5], W, dev)
    q_seg = hk.build_segments(lay_item[0], lay_item[2], lay_item[3],
                              lay_item[4], lay_item[5], W, dev)
    m = GDRecommender(U, I, device='cpu')
    m.set_ratings(*unique_stream(U, I, nnz))
    m.compute_overall_avg()
    t0 = time.perf_counter()
    m.compute_items_bias_bk()
    m.compute_users_bias_bk()
    numpy_ms = 1e3 * (time.perf_counter() - t0)
    mu, K2, K3 = m.overall_bias, m.K2, m.K3

    def run():
        bi = b1.bias_refit(q_seg, I, mu, K3)
        return bi, b1.bias_refit(p_seg, U, mu, K2, bi=bi)

    def plain():
        bi = b1.bias_refit_ref(q_seg, I, mu, K3)
        return bi, b1.bias_refit_ref(p_seg, U, mu, K2, bi=bi)

    got = [t.cpu().numpy() for t in run()]
    again = [t.cpu().numpy() for t in run()]
    want = [t.cpu().numpy() for t in plain()]
    host = [m.items_bias, m.users_bias]
    same = all(np.array_equal(a, b) for a, b in zip(got, again))

    def ulps(a, b):
        return int(np.abs(a.view(np.int32).astype(np.int64)
                          - b.view(np.int32).astype(np.int64)).max())

    ulp_plain = max(ulps(a, b) for a, b in zip(got, want))
    ulp_numpy = max(ulps(a, b) for a, b in zip(got, host))
    differ = sum(int((a != b).sum()) for a, b in zip(got, host))
    ok = same and ulp_plain <= 1 and ulp_numpy <= 1 and \
        all(np.isfinite(a).all() for a in got)
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, host))
    rec = {'case': name, 'W': W, 'entries': int(q_seg.ent_r.numel()),
           'rows': int(q_seg.blk_row.numel() + p_seg.blk_row.numel()),
           'longest_row': q_seg.longest, 'ok': ok, 'max_abs_err': err,
           'max_ulp_plain': ulp_plain, 'max_ulp_numpy': ulp_numpy,
           'elements_off_numpy': differ, 'numpy_ms': numpy_ms}
    if iters:
        rec['ms'] = timed_ms(run, iters)
        rec['plain_ms'] = timed_ms(plain, max(2, iters // 5))
        rec['device_ms'] = kernel_device_ms(run, 'bias_refit_kernel')[0] \
            if dev.type == 'cuda' else None
        if rec['device_ms'] is not None:
            rec['device_ms'] *= 2          # two launches a call
        rec['bound_ms'], rec['bound_by'] = b1_bound(p_seg, q_seg, I)
    del p_seg, q_seg
    log('  %-44s ok=%s max_abs_err=%.3g (ulps from the plain version %d, '
        'from numpy %d, %d elements off numpy; %d entries, longest row %d)%s'
        % (name, ok, err, ulp_plain, ulp_numpy, differ, rec['entries'],
           rec['longest_row'],
           ' kernel %.4f ms (device %s), plain %.3f ms, numpy %.1f ms, '
           'bound %.4f ms' % (rec['ms'], ms_or_not(rec['device_ms']),
                              rec['plain_ms'], numpy_ms, rec['bound_ms'])
           if iters else ''))
    return rec


def step_bound(seg, k, nt, weighted):
    '''The item step's least time: the bytes its inputs need (the
    table's ent_fix and ent_m, the per-entry weights when ``weighted``,
    the G rows it gathers read once, the segment offsets and rows, the
    ``nt`` targets' rows read and written once) over the memory rate,
    against its 4 operations per entry, column and target (weight, decay,
    mask, add) over the FP32 peak.'''
    import torch
    n = int(seg.ent_r.numel())
    nb = int(seg.blk_row.numel())
    ns = int(seg.seg_cnt.numel())
    nfix = int(torch.unique(seg.ent_fix).numel())
    nbytes = ((12.0 if weighted else 8.0) * n + 4.0 * k * nfix
              + 4.0 * (ns + 1) + 12.0 * nb + 8.0 * k * nb * nt)
    return roofline_ms(4.0 * n * k * nt, nbytes)


def step_case(name, kind, seg, q_layout, k, seed, iters=0, plain_iters=0):
    '''The fused item step (``step_aggregate``) over an item layout's
    segment table against its plain version, from random targets and G
    (SVD++'s Y, or FN's residual-weighted X and Y): within K4_ATOL plus
    STEP_UPD_TOL of the largest change, a second launch bit-identical.
    With ``iters`` its times beside the plain version's, the parent's
    per-batch loop over ``q_layout`` (one K4 call per item batch) and the
    bound; no one PyTorch call computes the chain.'''
    import torch
    from mfrec_tpu_torch.ops import fn as fn_ops
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops.window_agg_kernel import (step_aggregate,
                                                       step_aggregate_ref)
    dev = seg.ent_r.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    U1 = int(seg.max_fix) + 1 + q_layout.W
    I1 = int(seg.max_row) + 1 + q_layout.W
    G = 0.01 * torch.randn((U1, k), generator=gen, device=dev)
    T0 = [0.05 * torch.randn((I1, k), generator=gen, device=dev)
          for _ in range(2 if kind == 'fn' else 1)]
    mu = torch.tensor(3.5)
    bu = 0.3 * torch.randn(U1, generator=gen, device=dev)
    bi = 0.3 * torch.randn(I1, generator=gen, device=dev)
    step, decay = 0.15, (0.02, 0.02)[:len(T0)]
    coef = (seg.ent_r - (mu + bu[seg.ent_fix.long()] + bi[seg.ent_row.long()]),
            None) if kind == 'fn' else (None,)
    kw = dict(coef=coef, decay=decay, step=step, row_mean=True)
    got = step_aggregate([t.clone() for t in T0], G, seg, **kw)
    again = step_aggregate([t.clone() for t in T0], G, seg, **kw)
    if G.is_cuda:
        torch.cuda.synchronize()
    want = step_aggregate_ref([t.clone() for t in T0], G, seg, **kw)
    moved = max(float((w - t).abs().max()) for w, t in zip(want, T0))
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    ok = moved > 0 and err <= K4_ATOL + STEP_UPD_TOL * moved and all(
        bool(torch.equal(a, b)) and bool(torch.isfinite(a).all())
        for a, b in zip(got, again))
    rec = {'case': name, 'k': k, 'targets': len(T0),
           'entries': int(seg.ent_r.numel()), 'rows': int(seg.blk_row.numel()),
           'longest_row': seg.longest, 'ok': ok, 'max_abs_err': err,
           'moved': moved}
    del got, again, want
    if iters:
        tk = [t.clone() for t in T0]
        rec['ms'] = timed_ms(lambda: step_aggregate(tk, G, seg, **kw), iters)
        rec['plain_ms'] = timed_ms(
            lambda: step_aggregate_ref(tk, G, seg, **kw), plain_iters or iters)
        if kind == 'fn':
            loop = lambda: fn_ops.xy_step_batches(  # noqa: E731
                tk[0], tk[1], G, q_layout, mu, bu, bi, *decay, step, True)
        else:
            loop = lambda: sgd_mf.y_step_batches(  # noqa: E731
                tk[0], G, q_layout, decay[0], step, True)
        rec['loop_ms'] = timed_ms(loop, plain_iters or iters)
        rec['library_ms'] = None
        rec['bound_ms'], rec['bound_by'] = step_bound(seg, k, len(T0),
                                                      kind == 'fn')
        del tk
    log('  %-44s ok=%s max_abs_err=%.3g (largest change %.3g; %d entries in '
        '%d rows, longest %d)%s'
        % (name, ok, err, moved, rec['entries'], rec['rows'], seg.longest,
           ' kernel %.4f ms, plain %.3f ms, per-batch loop %.3f ms, bound '
           '%.4f ms' % (rec['ms'], rec['plain_ms'], rec['loop_ms'],
                        rec['bound_ms']) if iters else ''))
    return rec


def phase2_window_agg(U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz'],
                      device='cuda'):
    '''K4 against its plain version: the per-call entry at the JAX
    call's shape on real ML-10M-layout batches (B=16384, W=128, k=66: a
    user batch and the item batch with the longest run), at the SVD++ and
    FN item-step shapes (W=512, k=64 and the FN's two-in-one k=128), and
    on edge cases; the phase entry on the whole W=512 user layout (FN's
    aggregation phases, k=64) and item layout (its hot rows); K4g, the
    gathered phases of SVD++ (the Y sums and the error-weighted Q sums),
    on the whole W=512 user layout at rank 64 and 100 and on a user of
    about 17,700 ratings; and B1, the bias refit, over the W=128 and
    W=512 layouts' tables.'''
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
    from mfrec_tpu_torch.ops import sgd_mf
    # K4g, SVD++'s gathered phases, over the W=512 user layout phase 6
    # drives: k 64 and 66 its rank-64 widths, 100 and 102 the Netflix
    # cell's
    L = lay['user', 512]
    seg = hk.build_segments(L[1], L[2], L[3], L[4], L[5], 512, dev)
    gathers = [k4_gather_case('K4g %s: whole user layout (W=512, k=%d)'
                              % (mode, k), seg, mode, k, U + 512, I + 512,
                              seed=20 + j, iters=10, plain_iters=2)
               for j, (mode, k) in enumerate((('gather', 64), ('error', 66),
                                              ('gather', 100),
                                              ('error', 102),
                                              ('profile', 100)))]
    # FN's other profile instantiations: the served profiles' unrounded
    # sums (k 100 the Netflix cell's, timed) and phase 7's rank 64 (KJ=2),
    # rounded and unrounded
    gathers += [k4_gather_case('K4g profile%s: whole user layout (W=512, '
                               'k=%d)' % ('' if r else ' unrounded', k),
                               seg, 'profile', k, U + 512, I + 512,
                               seed=25 + j, iters=10 if k == 100 else 0,
                               plain_iters=2, rounded=r)
                for j, (k, r) in enumerate(((100, False), (64, True),
                                            (64, False)))]
    # and on a user of about the Netflix cap's 17,653 ratings over two
    # batches (K4g's 16-warp blocks, which no ML-10M user reaches), beside
    # users of one rating
    from mfrec_tpu_torch.ops import window_agg_kernel as wak
    Uh, Ih, Nh = 20_000, 17_770, 2_000_000
    u = rng.integers(0, Uh - 100, Nh).astype(np.int32)
    u[:17_653] = 3
    u[17_653:17_693] = np.arange(Uh - 100, Uh - 60)
    i = rng.integers(0, Ih, Nh).astype(np.int32)
    v = rng.uniform(1, 5, Nh).astype(np.float32)
    L = sgd_mf.sorted_pass_layout(u, i, v, 16384, axis='user',
                                  max_window=512)
    seg = hk.build_segments(L[1], L[2], L[3], L[4], L[5], 512, dev)
    if int(seg.blk_len.max()) < wak.AGG_BLOCK_ROW:
        raise SystemExit('phase 2 (K4g): no row reaches the block path')
    gathers += [k4_gather_case('K4g %s%s: a heavy user, 2 batches (k=%d)'
                               % (mode, '' if r else ' unrounded', k), seg,
                               mode, k, Uh + 512, Ih + 512, seed=30 + j,
                               rounded=r)
                for j, (mode, k, r) in enumerate((('gather', 100, True),
                                                  ('error', 102, True),
                                                  ('profile', 100, True),
                                                  ('profile', 100, False),
                                                  ('profile', 64, True),
                                                  ('profile', 64, False)))]
    del seg
    # the SVD++ / FN item step over the W=512 item layout, one launch
    L = lay['item', 512]
    seg = hk.build_segments(L[0], L[2], L[3], L[4], L[5], 512, dev)
    ql = sgd_mf.PassLayout(L, 'item', dev)
    steps = [step_case('item step: SVD++ Y (W=512, k=64)', 'svdpp', seg, ql,
                       64, seed=6, iters=10, plain_iters=2),
             step_case('item step: FN X and Y (W=512, k=64 x 2)', 'fn', seg,
                       ql, 64, seed=7, iters=10, plain_iters=2)]
    del seg, ql
    L = stream_layout(*REDUCED, 'item', 64)
    seg = hk.build_segments(L[0], L[2], L[3], L[4], L[5], 64, dev)
    steps.append(step_case('item step: reduced FN, k=128 x 2', 'fn', seg,
                           sgd_mf.PassLayout(L, 'item', dev), 128, seed=8))
    # B1, the BellKor refit, over both W's tables (gd's and svdpp's)
    refits = [b1_case('B1 bias refit: W=%d layouts' % W, lay['user', W],
                      lay['item', W], W, U, I, nnz, iters=20 if W == 512
                      else 0, device=device) for W in (128, 512)]
    for r in recs + scans:
        if 'ms' in r:
            log('  time %-44s kernel %.4f ms, plain %.4f ms, index_add_ '
                '%.4f ms, bound %.4f ms (%s)%s  [%s]'
                % (r['case'], r['ms'], r['plain_ms'], r['library_ms'],
                   r['bound_ms'], r['bound_by'],
                   '; device time kernel %.4f ms, index_add_ %.4f ms'
                   % (r['device_ms'], r['library_device_ms'])
                   if 'device_ms' in r else '', card))
    for r in steps:
        if 'ms' in r:
            log('  time %-44s kernel %.4f ms, plain %.3f ms, per-batch loop '
                '%.3f ms, bound %.4f ms (%s)  [%s]'
                % (r['case'], r['ms'], r['plain_ms'], r['loop_ms'],
                   r['bound_ms'], r['bound_by'], card))
    for r in (r for r in gathers if 'ms' in r):
        log('  time %-44s kernel %.4f ms (device %.4f ms), plain %.3f ms, '
            'bound %.4f ms (%s)  [%s]'
            % (r['case'], r['ms'], r.get('device_ms', -1.0), r['plain_ms'],
               r['bound_ms'], r['bound_by'], card))
    bad = [r['case'] for r in recs + scans + steps + gathers + refits
           if not r['ok']]
    if bad:
        raise SystemExit('phase 2 (K4, B1) failed: %s' % bad)
    return {'recs': recs, 'scans': scans, 'steps': steps,
            'gathers': gathers, 'refits': refits}


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


def k2_split(F_fix, F_upd, buckets, alive, reg, steps):
    '''Device time of one CG half-sweep, by CUDA events, split into the
    fused K2 (one launch per bucket) and the rest (the fixed side's Gram
    ``_hh``, its bf16 cast, the alive mask), replaying ``cg_epoch``'s
    half-sweep bucket by bucket.  Returns ms.'''
    import torch
    from mfrec_tpu_torch.ops import als as als_ops

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    F_upd = F_upd.clone()
    torch.cuda.synchronize()
    t0 = ev()
    HHreg = als_ops._hh(F_fix, reg)
    Fb = als_ops._fixed_bf16(F_fix)
    marks = []
    for rows, nidx, nval, mask in buckets:
        a = ev()
        als_ops._bucket_cg_body(Fb, F_upd, HHreg, rows, nidx, nval, mask,
                                1.0, 0.0, reg, steps, 'pallas')
        marks.append((a, ev()))
    F_upd.mul_(alive)
    t1 = ev()
    t1.synchronize()
    per = [a.elapsed_time(c) for a, c in marks]
    total = t0.elapsed_time(t1)
    return {'total_ms': total, 'kernel_ms': sum(per), 'bucket_ms': per,
            'rest_ms': total - sum(per)}


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


def device_busy_ms(prof):
    '''The device's busy time in a torch.profiler run, in ms: the union of
    its operations' intervals (``trace_device_ops``), so that work
    overlapping on two streams counts once (a sum of kernel times can
    exceed the wall time).'''
    return union_ms([(a, b) for _, a, b in trace_device_ops(prof)])


def trace_device_ops(prof):
    '''(name, start us, end us) of every kernel, copy and memset of a
    torch.profiler run, read from its chrome trace as
    ``bench_torch/lib/trace.py`` reads it: every device time this script
    reports comes from here, since the profiler's events (``events()``,
    ``key_averages()``) leave out the kernels launched through ctypes
    (K1's, K1f's).'''
    import tempfile
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.unlink(path)
    return [(e.get('name', ''), float(e['ts']),
             float(e['ts']) + float(e.get('dur', 0.0))) for e in events
            if e.get('ph') == 'X'
            and e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]


def union_ms(intervals):
    '''The length of the union of (start, end) intervals in us, in ms.'''
    iv = sorted(intervals)
    busy, end = 0.0, None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def idle_share(busy_ms, epoch_ms):
    '''The device's idle share of an epoch: 1 - busy / epoch, busy the
    union of kernel intervals under torch.profiler and the epoch its
    CUDA-event time without the profiler (the gaps the host leaves
    between kernels count as idle; the profiler's own host cost does
    not).  None where the profiler saw no device time.'''
    return (1.0 - busy_ms / epoch_ms) if busy_ms > 0 else None


def device_kernels(prof):
    '''Per device operation name in a torch.profiler run
    (``trace_device_ops``): (launches, ms), longest first.'''
    out = {}
    for name, a, b in trace_device_ops(prof):
        n, t = out.get(name, (0, 0.0))
        out[name] = (n + 1, t + (b - a) / 1e3)
    return dict(sorted(out.items(), key=lambda x: -x[1][1]))


def warm_epoch_device(m, ubd, ibd):
    '''One warm CG epoch (``cg_epoch`` at 3 steps) of model ``m``'s
    factors over the device buckets: its CUDA-event time (median of 5),
    the host's time to enqueue it, its host-clock time and the device's
    busy time in it by ``torch.profiler`` tracing the device alone (the
    union of kernel intervals), the idle share (``idle_share``) and its
    kernels by name.  Fails if the epoch gathers the buckets with
    ``index_select``, runs a matrix product other than ``_hh``'s two F^T F
    or launches K2's M-given entry.'''
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
    t = time.perf_counter()
    epoch()
    enqueue = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    busy = device_busy_ms(prof)
    kernels = device_kernels(prof)
    for name, (n, ms) in kernels.items():
        log('    %9.3f ms  %4d x  %s' % (ms, n, name[:110]))
    low = {x.lower(): n for x, (n, _) in kernels.items()}
    gathers = sum(n for x, n in low.items()
                  if 'index_select' in x or 'indexselect' in x)
    products = sum(n for x, n in low.items() if 'gemm' in x or 'bmm' in x)
    pcg = sum(n for x, n in low.items() if 'pcg_kernel' in x)
    if gathers or products > 2 or pcg:
        raise SystemExit('the warm CG epoch runs %d index_select gathers, %d '
                         'matrix-product kernels (2 expected: _hh) and %d '
                         'standalone PCG launches' % (gathers, products, pcg))
    return {'epoch_event_ms': ev, 'epoch_wall_ms': wall,
            'epoch_enqueue_ms': enqueue, 'busy_ms': busy,
            'idle': idle_share(busy, ev),
            'idle_host_clock': idle_share(busy, wall),
            'kernels': {x: list(v) for x, v in kernels.items()}}


def phase5(U=ALS['U'], I=ALS['I'], N=ALS['N'], device='cuda',
           reduced=(3000, 700, 60_000)):
    '''The WRMF/ALS slice through the public path at bench_als's shape
    and settings: ``WRMFRecommender.train()`` (solver 'cg', 6 PCG steps,
    3 after 2 epochs), a 1-epoch warm-up, three 0-epoch runs
    (``train()``'s fixed set-up), 3 blocks of a 2- and a 102-epoch run
    (their difference: a hundred pure warm epochs; the 2-epoch run less
    two of them: the set-up again), a 5-epoch run whose model the gates
    read, the fused K2's launch count (one per bucket, none of the M-given entry), the
    held-out P@5 gate through ``recommend_batch`` (K3) against the
    popularity floor, the served lists against K3's plain twin, the fused
    K2 on the largest user bucket and the hottest item bucket against its
    plain version (3 and 6 steps; timed beside the parent's composition
    and the exact solver), K2's M-given entry on the user bucket's
    systems, the split of each half-sweep, one warm epoch by CUDA events
    with its kernels and the device's idle share, and a CUDA model's CG
    epoch against a CPU model's at a reduced shape.'''
    import torch
    from mfrec_tpu_torch.data.movielens import ratings_from_arrays
    from mfrec_tpu_torch.models.wrmf import WRMFRecommender
    from mfrec_tpu_torch.ops import als as als_ops
    from mfrec_tpu_torch.ops.cg_kernel import cg_bucket_kernel, \
        pcg_solve_kernel
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
        'buckets (L, R) %s, item buckets %s: %d fused K2 launches per epoch '
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
    # two real buckets from the warmed-up factors: the user bucket with
    # the most rows and the item bucket with the longest rows
    big = max(range(len(ub)), key=lambda j: ub[j][0].shape[0])
    hot = max(range(len(ib)), key=lambda j: ib[j][1].shape[1])
    dev = m.device
    Pd = torch.from_numpy(m.P).to(dev)
    Qd = torch.from_numpy(m.Q).to(dev)
    real = {}
    for name, F, out, bk in (('user', Qd, Pd, ub[big]),
                             ('item', Pd, Qd, ib[hot])):
        bk = [torch.from_numpy(x).to(dev) for x in bk]
        real[name] = dict(Fb=als_ops._fixed_bf16(F), out=out,
                          HH=als_ops._hh(F, m.K), rows=bk[0], idx=bk[1],
                          val=bk[2], mask=bk[3])
    pcg_solve_kernel.launches = 0          # from here on: the main path
    cg_bucket_kernel.launches = 0
    topn_scores_kernel.launches = 0
    setup_0 = [train_timed(0) for _ in range(3)]
    # a 2- and a 102-epoch run: at a few ms an epoch, fewer epochs leave
    # the quotient inside the spread of train()'s fixed set-up (tens of
    # ms); then the 5-epoch model the quality gate reads
    marg, setup = [], []
    for _ in range(3):
        t2 = train_timed(2)
        t102 = train_timed(102)
        marg.append((t102 - t2) / 100.0)
        setup.append(t2 - 2 * marg[-1])
        log('  2 epochs %.3f s, 102 epochs %.3f s: epoch %.5f s, set-up '
            '%.3f s  [%s]' % (t2, t102, marg[-1], setup[-1], card))
    t5 = train_timed(5)
    k2_launches = cg_bucket_kernel.launches
    pcg_launches = pcg_solve_kernel.launches
    n_epochs = 3 * (2 + 102) + 5
    epoch_s = float(np.median(marg))
    setup_s = float(np.median(setup))
    log('  5 epochs %.3f s (the model the gate reads)  [%s]' % (t5, card))
    log('  warm-up 1 epoch %.2f s; epoch %.5f s (median of 3); train()\'s '
        'fixed set-up %.3f s (median of 3; a 0-epoch train() %s s); fused '
        'K2 launches %d over %d epochs (%.1f per epoch), M-given K2 '
        'launches %d  [%s]' % (
            t_warm, epoch_s, setup_s, ', '.join('%.3f' % x for x in setup_0),
            k2_launches, n_epochs, k2_launches / n_epochs, pcg_launches,
            card))
    if not (np.isfinite(m.P).all() and np.isfinite(m.Q).all()):
        raise SystemExit('non-finite factors from the ALS training')
    if on_card and (k2_launches != n_epochs * per_epoch or pcg_launches):
        raise SystemExit('the fused K2 launched %d times, expected %d; the '
                         'M-given entry %d times, expected 0'
                         % (k2_launches, n_epochs * per_epoch, pcg_launches))
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
    # the fused K2 on the two real buckets against its plain version,
    # timed beside the parent's composition and the exact solver
    frecs = []
    for name in ('user', 'item'):
        d = real[name]
        for s in (6, 3):
            frecs.append(cg_bucket_case(
                '%s bucket R=%d L=%d steps=%d' % (
                    name, d['idx'].shape[0], d['idx'].shape[1], s),
                d, s, iters=10, plain_iters=3, yardsticks=name == 'user'))
    # K2's M-given entry on the user bucket's systems (pcg_launch)
    d = real['user']
    M, b, x0 = als_ops.cg_system(d['Fb'], d['out'], d['HH'], d['rows'],
                                 d['idx'], d['val'], d['mask'], 1.0, 0.0)
    recs = [pcg_case('real bucket L=%d steps=%d' % (d['idx'].shape[1], s),
                     M, b, x0, s, iters=10, plain_iters=3, f64=True)
            for s in (6, 3)]
    pcg_drift(M, b, x0)
    exact_ms = timed_ms(lambda: torch.cholesky_solve(
        b[..., None], torch.linalg.cholesky(M)), 3)
    log('  exact solver (torch.linalg.cholesky + cholesky_solve) on the same '
        '%d systems: %.3f ms  [%s]' % (M.shape[0], exact_ms, card))
    del M, b, x0, real, d
    split = {}
    if on_card:
        sync()
        t = time.perf_counter()
        ubd = als_ops.device_buckets(ub, dev)
        ibd = als_ops.device_buckets(ib, dev)
        sync()
        split['upload_s'] = time.perf_counter() - t
        log('  the buckets\' upload, as train() makes it once a call: %.3f s '
            '(%.1f MB)  [%s]' % (split['upload_s'], sum(
                x.numel() * x.element_size() for bk in ubd + ibd
                for x in bk) / 1e6, card))
        Pd = torch.from_numpy(m.P).to(dev)
        Qd = torch.from_numpy(m.Q).to(dev)
        alive = [torch.from_numpy(als_ops._alive_mask(bk, n)).to(dev)
                 for bk, n in ((ub, U), (ib, I))]
        for side, args in (('user', (Qd, Pd, ubd, alive[0])),
                           ('item', (Pd, Qd, ibd, alive[1]))):
            k2_split(*args, m.K, 3)              # warm the allocator
            split[side] = k2_split(*args, m.K, 3)
            log('  %s half-sweep at 3 steps: %.3f ms on the card = fused K2 '
                '%.3f (per bucket %s) + rest %.3f  [%s]'
                % (side, split[side]['total_ms'], split[side]['kernel_ms'],
                   ', '.join('%.3f' % x for x in split[side]['bucket_ms']),
                   split[side]['rest_ms'], card))
        split['bound_ms_epoch'] = sum(
            cg_bucket_bound(x[1], x[3], K, 3, m.c_pos, m.alpha)[0]
            for x in ubd + ibd)
        log('  the fused K2\'s bound over the warm epoch\'s %d buckets: %.3f '
            'ms' % (per_epoch, split['bound_ms_epoch']))
        split.update(warm_epoch_device(m, ubd, ibd))
        del ubd, ibd
        log('  one warm epoch (cg_epoch, 3 steps): %.3f ms by CUDA events '
            '(median of 5), %.3f ms to enqueue, %.3f ms on the host clock '
            'under the profiler; device busy %.3f ms by torch.profiler (the '
            'union of kernel intervals): device idle %s of the event time '
            '(%s of the host clock)  [%s]'
            % (split['epoch_event_ms'], split['epoch_enqueue_ms'],
               split['epoch_wall_ms'], split['busy_ms'],
               'not measured' if split['idle'] is None
               else '%.1f %%' % (100 * split['idle']),
               'not measured' if split['idle_host_clock'] is None
               else '%.1f %%' % (100 * split['idle_host_clock']), card))
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
    bad = [r['case'] for r in recs + frecs if not r['ok']]
    if bad:
        raise SystemExit('phase 5 (K2) failed: %s' % bad)
    return dict(k2_launches=k2_launches, pcg_launches=pcg_launches,
                k3_launches=k3_launches, epoch_s=epoch_s,
                epoch_s_blocks=marg, setup_s=setup_s,
                setup_s_blocks=setup, setup_s_zero_epochs=setup_0,
                n_epochs=n_epochs, warmup_s=t_warm, p5=p5,
                p5_copy=p5_copy, floor=floor, floor_strict=floor_strict,
                recs=recs, frecs=frecs, exact_ms=exact_ms, split=split,
                per_epoch=per_epoch)


def k4g_launches():
    '''K4g's launches: the gathered phases of SVD++ (``gather_aggregate``
    and ``error_aggregate``) and FN (``profile_aggregate`` and
    ``error_aggregate``; ``profile_aggregate`` also sums FN's served
    profiles, once a call).'''
    from mfrec_tpu_torch.ops.window_agg_kernel import (error_aggregate,
                                                       gather_aggregate,
                                                       profile_aggregate)
    return gather_aggregate.launches + error_aggregate.launches + \
        profile_aggregate.launches


def k4_launches():
    '''K4's launches by every entry point (the per-call sum, the phase
    aggregation, K4g's gathered phases and the item step).'''
    from mfrec_tpu_torch.ops.window_agg_kernel import (scan_aggregate,
                                                       step_aggregate,
                                                       window_aggregate)
    return scan_aggregate.launches + k4g_launches() + \
        window_aggregate.launches + step_aggregate.launches


def zero_launch_counts():
    from mfrec_tpu_torch.ops.bias_refit_kernel import bias_refit
    from mfrec_tpu_torch.ops.frozen_half_pass_kernel import \
        frozen_half_pass
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.kmf_serial_kernel import kmf_serial_converge
    from mfrec_tpu_torch.ops.serial_kernel import serial_converge
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    from mfrec_tpu_torch.ops.window_agg_kernel import (error_aggregate,
                                                       gather_aggregate,
                                                       profile_aggregate,
                                                       scan_aggregate,
                                                       step_aggregate,
                                                       window_aggregate)
    for fn in (half_pass, frozen_half_pass, topn_scores_kernel,
               scan_aggregate,
               gather_aggregate, error_aggregate, profile_aggregate,
               window_aggregate, step_aggregate, serial_converge,
               kmf_serial_converge, bias_refit):
        fn.launches = 0
    serial_converge.epochs = kmf_serial_converge.epochs = 0


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


K4_KERNELS = ('window_index_kernel', 'window_sum_kernel', 'scan_agg_kernel',
              'gather_agg_kernel', 'step_agg_kernel')


def kernel_group(name):
    '''Which of K1f, K1 and K4 a device kernel's name belongs to, or
    'other'.'''
    if 'frozen_half_pass_rows' in name:
        return 'k1f'
    if 'half_pass_rows' in name or 'half_pass_cluster_rows' in name:
        return 'k1'
    return 'k4' if any(n in name for n in K4_KERNELS) else 'other'


def tier_split(epoch, state, args, device):
    '''One epoch of a tier on the card, split by phase: the CUDA-event
    time from one phase's end to the next's (the epoch's ``on_phase``
    hook marks them) beside the host time to enqueue it, then one more
    epoch under torch.profiler for the kernels' busy time by kernel, read
    from its chrome trace (``trace_device_ops``; ``kernel_group``: K1f
    ``frozen_half_pass_rows``, K1
    ``half_pass_rows``/``half_pass_cluster_rows``, K4's
    ``window_index_kernel``/``window_sum_kernel``/``scan_agg_kernel``/
    ``gather_agg_kernel``/``step_agg_kernel``, the rest) and the device
    idle share (``idle_share``: busy the union of kernel intervals, as
    K1's cluster kernel runs on a side stream beside its other blocks,
    over the epoch's CUDA-event time).'''
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
    busy = {'k1': 0.0, 'k1f': 0.0, 'k4': 0.0, 'other': 0.0}
    names = {}
    ops = trace_device_ops(prof)
    for name, a, b in ops:
        ms = (b - a) / 1e3
        busy[kernel_group(name)] += ms
        names[name] = names.get(name, 0.0) + ms
    total = union_ms([(a, b) for _, a, b in ops])
    return {'phases': phases, 'kernels_ms': dict(sorted(
        names.items(), key=lambda x: -x[1])[:8]),
            'epoch_event_ms': sum(p['device_ms'] for p in phases.values()),
            'epoch_wall_ms': wall, 'busy_ms': busy, 'busy_total_ms': total,
            'busy_sum_ms': sum(busy.values()),
            'idle': idle_share(total, sum(p['device_ms']
                                          for p in phases.values())),
            'idle_host_clock': idle_share(total, wall)}


def log_split(split, card):
    if not split:
        return
    for name, p in split['phases'].items():
        log('  %-17s %9.3f ms on the card, %9.3f ms to enqueue  [%s]'
            % (name, p['device_ms'], p['host_ms'], card))
    b = split['busy_ms']
    log('  one epoch: %.3f ms by CUDA events, %.3f ms on the host clock; '
        'device busy %.3f ms (the union of kernel intervals; kernel time '
        'K1 %.3f, K1f %.3f, K4 %.3f, other %.3f, sum %.3f) by '
        'torch.profiler: device idle %s of the event time (%s of the host '
        'clock)  [%s]'
        % (split['epoch_event_ms'], split['epoch_wall_ms'],
           split['busy_total_ms'], b['k1'], b['k1f'], b['k4'], b['other'],
           split['busy_sum_ms'],
           'not measured' if split['idle'] is None
           else '%.1f %%' % (100 * split['idle']),
           'not measured' if split['idle_host_clock'] is None
           else '%.1f %%' % (100 * split['idle_host_clock']), card))
    log('  the epoch\'s longest kernels: %s' % '; '.join(
        '%s %.3f ms' % (n[:60], ms) for n, ms in split['kernels_ms'].items()))


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
    from mfrec_tpu_torch.ops.frozen_half_pass_kernel import \
        frozen_half_pass
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
            epoch, state, args = m._fn_epoch(
                m._upload(m._init_or_resume(False)), use_kernel=True)
        before = (half_pass.launches, frozen_half_pass.launches,
                  k4_launches())
        *state, rmse = epoch(*state, *args)
        out[d] = ([x.cpu() for x in state], float(rmse),
                  (half_pass.launches - before[0],
                   frozen_half_pass.launches - before[1],
                   k4_launches() - before[2]))
    errs = [float((a - b).abs().max()) for a, b in zip(out['cuda'][0],
                                                       out['cpu'][0])]
    ok = all(bool((a - b).abs().le(K1_ATOL + K1_RTOL * b.abs()).all())
             for a, b in zip(out['cuda'][0], out['cpu'][0]))
    ok = ok and abs(out['cuda'][1] - out['cpu'][1]) <= \
        1e-3 * abs(out['cpu'][1])
    log('  one %s epoch at %d x %d: card vs CPU tensors ok=%s, max abs '
        'err %s, rmse %.5f vs %.5f, K1 %d, K1f %d and K4 %d launches'
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
    from mfrec_tpu_torch.ops.frozen_half_pass_kernel import \
        frozen_half_pass
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.window_agg_kernel import (scan_aggregate,
                                                       step_aggregate,
                                                       window_aggregate)
    from mfrec_tpu_torch.ops.bias_refit_kernel import bias_refit
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
               k1f_launches=frozen_half_pass.launches,
               b1_launches=bias_refit.launches,
               k4_scan_launches=scan_aggregate.launches,
               k4g_launches=k4g_launches(),
               k4_call_launches=window_aggregate.launches,
               k4_step_launches=step_aggregate.launches,
               k4_launches=k4_launches(), floor=floor)
    q_batches = m._alternating_layouts(512)[1].nbr_batches
    check_tier_run('phase 6', res, device, q_batches, card, 'svdpp')
    log('  B1 launches %d (6 calls x 2 passes)' % res['b1_launches'])
    if device == 'cuda' and res['b1_launches'] != 12:
        raise SystemExit('phase 6: B1 launched %d times, not 12'
                         % res['b1_launches'])
    epoch, state, args = m._implicit_epoch()
    res['split'] = tier_split(epoch, state, args, device)
    del epoch, state, args
    log_split(res['split'], card)
    if device == 'cuda':
        res['card_vs_cpu'] = tier_card_vs_cpu('svdpp', SVDPP_PARAMS, reduced)
        res['agg_tier'] = agg_tier_check(reduced)
    return res


def check_tier_run(name, res, device, q_batches, card, tier):
    '''The gates of phases 6 and 7: every epoch's train RMSE finite, the
    last below the bias-only floor, and (on the card) K1 and K4 launched
    as the 21 timed epochs in 6 calls need: 2 K1 launches per epoch (FN:
    one of K1 and one of K1f, its user half-pass), and 3
    of K4 -- 2 whole-phase aggregations through K4g's gathered entries
    (``tier`` 'svdpp': the sum and error modes; 'fn': the profile and
    error modes, and one profile launch a call for the served profiles)
    and one item step, no ``scan_aggregate`` and no call per item
    batch.'''
    hist = res['hist']
    log('  warm-up 1 epoch %.2f s (rmse %.4f); rmse per epoch (last 5-epoch '
        'run): %s' % (res['warmup_s'], res['warmup_rmse'],
                      ' '.join('%.4f' % x for x in res['rmse'])))
    log('  epoch %.4f s (median of 3), final rmse %.4f vs floor %.4f; K1 '
        'launches %d, K1f launches %d, K4 launches %d (%d whole-phase + %d '
        'gathered-phase + %d item-step + %d per-batch; %d item batches per '
        'epoch): %.2f per epoch over 21 epochs  [%s]'
        % (res['epoch_s'], res['rmse'][-1], res['floor'], res['k1_launches'],
           res['k1f_launches'], res['k4_launches'], res['k4_scan_launches'],
           res['k4g_launches'],
           res['k4_step_launches'], res['k4_call_launches'], q_batches,
           res['k4_launches'] / 21.0, card))
    if not all(np.isfinite(hist)):
        raise SystemExit('%s: non-finite training RMSE: %s' % (name, hist))
    if not res['rmse'][-1] < res['floor']:
        raise SystemExit('%s: final RMSE %.4f does not beat the bias-only '
                         'floor %.4f' % (name, res['rmse'][-1], res['floor']))
    want = (42, 0, 0, 42, 21, 0) if tier == 'svdpp' else \
        (21, 21, 0, 48, 21, 0)
    got = (res['k1_launches'], res['k1f_launches'], res['k4_scan_launches'],
           res['k4g_launches'], res['k4_step_launches'],
           res['k4_call_launches'])
    if device == 'cuda' and got != want:
        raise SystemExit('%s: K1/K1f/K4 launches %s, expected %s'
                         % (name, got, want))


def phase7(U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz'], device='cuda',
           reduced=REDUCED):
    '''The FN slice through the public path: ``FNRecommender.train()``
    at bench.py's operating point, timed and gated as phase 6, then
    retrieval from the materialized profiles through K3 and one fold-in.'''
    from mfrec_tpu_torch.models.fn import FNRecommender
    from mfrec_tpu_torch.ops.frozen_half_pass_kernel import \
        frozen_half_pass
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    from mfrec_tpu_torch.ops.window_agg_kernel import (scan_aggregate,
                                                       step_aggregate,
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
               k1f_launches=frozen_half_pass.launches,
               k4_scan_launches=scan_aggregate.launches,
               k4g_launches=k4g_launches(),
               k4_call_launches=window_aggregate.launches,
               k4_step_launches=step_aggregate.launches,
               k4_launches=k4_launches(), floor=floor)
    q_batches = m._alternating_layouts(512)[1].nbr_batches
    check_tier_run('phase 7', res, device, q_batches, card, 'fn')
    epoch, state, args = m._fn_epoch(m._upload(m._init_or_resume(False)))
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


def k3_bound(B, I, k, n, L=0, route='tf32x3'):
    '''K3's least time at one shape, in ms, and what bounds it: the larger
    of the 2*B*I*k multiply-add operations over the route's peak and the
    bytes each input is read and each output written once (P f32, Q f32
    or, for 'bf16', bf16, the biases, L rated ids a user and their
    counts, n ids and scores a user).  Routes: 'f32' the CUDA cores at
    67 TFLOP/s; 'tf32x3' three products on the TF32 tensor cores at 495
    TFLOP/s (split TF32, what meets the exact mode's tolerance on the
    tensor cores); 'bf16' the bf16 tensor cores at 989 TFLOP/s.'''
    peak = {'f32': PEAK_F32_FLOPS, 'tf32x3': PEAK_TF32_TENSOR_FLOPS / 3.0,
            'bf16': PEAK_BF16_TENSOR_FLOPS}[route]
    nbytes = (4.0 * B * k + (2.0 if route == 'bf16' else 4.0) * I * k
              + 4.0 * (B + I) + 4.0 * B * (L + 1) + 8.0 * B * n)
    t_ops, t_bytes = 2.0 * B * I * k / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def k3_entry(k3_recs, launches, worst):
    '''The kernels line's K3 entry.  ``ms``, ``plain_ms`` and ``bound_ms``
    keep their meaning (the exact mode at the bench shape: CUDA events,
    and the f32 CUDA-core bound); beside them the split-TF32 bound of the
    route the kernel takes (``bound_ms_split_tf32``), the fast mode's
    bf16 one, device times, the wrapper's host time and the composed
    yardstick; ``share_of_bound*`` is a bound over the device time.'''
    by = {r['case']: r for r in k3_recs}
    ex, fa = by['a exact'], by['b fast']
    se, sf = by['serving exact'], by['serving fast']
    b_ex, b_by = k3_bound(1024, 360_000, 64, 10, route='f32')
    b_tf, _ = k3_bound(1024, 360_000, 64, 10, route='tf32x3')
    b_fast, b_fast_by = k3_bound(1024, 360_000, 64, 10, route='bf16')
    b_se, _ = k3_bound(256, 10_677, 64, 10, L=256, route='tf32x3')
    b_sf, _ = k3_bound(256, 10_677, 64, 10, L=256, route='bf16')
    return [{
        'name': 'topn (K3, fused top-n retrieval)', 'route': 'cuda',
        'source': 'mfrec_tpu_torch/csrc/topn.cu',
        'replaces': 'mfrec_tpu/ops/pallas_topk.py:90',
        'launches': launches,
        'max_abs_err': max([worst] + [r['max_abs_err'] for r in k3_recs]),
        'ms': ex['ms'], 'plain_ms': ex['plain_ms'],
        'bound_ms': b_ex, 'bound_by': b_by, 'library_ms': None,
        'shape': 'B=1024 I=360000 k=64 n=10',
        'exact_route': 'split tf32 on the tensor cores',
        'bound_ms_split_tf32': b_tf,
        'device_ms': ex['device_ms'],
        'composed_ms': ex['composed_ms'],
        'composed_device_ms': ex['composed_device_ms'],
        'share_of_bound': b_ex / ex['device_ms'],
        'share_of_bound_split_tf32': b_tf / ex['device_ms'],
        'ms_rated64': by['a exact rated64']['ms'],
        'device_ms_rated64': by['a exact rated64']['device_ms'],
        'ms_fast': fa['ms'], 'plain_ms_fast': fa['plain_ms'],
        'device_ms_fast': fa['device_ms'],
        'composed_ms_fast': fa['composed_ms'],
        'composed_device_ms_fast': fa['composed_device_ms'],
        'bound_ms_fast': b_fast, 'bound_by_fast': b_fast_by,
        'share_of_bound_fast': b_fast / fa['device_ms'],
        'ms_fast_rated64': by['b fast rated64']['ms'],
        'device_ms_fast_rated64': by['b fast rated64']['device_ms'],
        'serving_shape': 'B=256 I=10677 k=64 n=10 L=256',
        'ms_serving': se['ms'], 'device_ms_serving': se['device_ms'],
        'host_us_serving': se['host_us'],
        'plain_ms_serving': se['plain_ms'],
        'composed_ms_serving': se['composed_ms'],
        'composed_device_ms_serving': se['composed_device_ms'],
        'bound_ms_serving': b_se,
        'ms_serving_fast': sf['ms'], 'device_ms_serving_fast': sf['device_ms'],
        'host_us_serving_fast': sf['host_us'],
        'composed_device_ms_serving_fast': sf['composed_device_ms'],
        'bound_ms_serving_fast': b_sf}]


def k2_entry(k2_recs, als):
    '''K2's entries of the kernels line.  The fused bucket kernel (the
    ALS path's): times on phase 5's largest user bucket at the warm step
    count (3) beside its plain version, the parent's composition and the
    exact solver, the hottest item bucket, the fused kernel's time over a
    warm epoch's buckets, launches over phase 5's training.  The M-given
    entry ``pcg_launch``: times on the user bucket's systems; it is on no
    training path since the fused kernel (0 launches there).'''
    if not als:
        return []
    real = {r['steps']: r for r in als['recs']}
    fused = {(r['case'].split()[0], r['steps']): r for r in als['frecs']}
    user, item = fused[('user', 3)], fused[('item', 3)]
    split = als['split']
    return [{
        'name': 'cg_bucket (K2 fused: an ALS bucket\'s gather, bf16 '
                'tensor-core Gram, warm-started PCG and write-back)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/cg_bucket.cu',
        'replaces': 'mfrec_tpu/ops/als.py:99-106 and '
                    'mfrec_tpu/ops/pallas_cg.py:26',
        'launches': als['k2_launches'],
        'max_abs_err': max(r['max_abs_err']
                           for r in k2_recs['bucket'] + als['frecs']),
        'ms': user['ms'], 'plain_ms': user['plain_ms'],
        'bound_ms': user['bound_ms'], 'bound_by': user['bound_by'],
        'library_ms': None,
        'shape': 'the largest user bucket of the ALS epoch: R=%d L=%d k=64 '
                 'steps=3, %d entries' % (user['R'], user['L'], user['nnz']),
        'composed_ms': user['composed_ms'],
        'exact_solver_ms': user['exact_ms'],
        'ms_steps6': fused[('user', 6)]['ms'],
        'plain_ms_steps6': fused[('user', 6)]['plain_ms'],
        'composed_ms_steps6': fused[('user', 6)]['composed_ms'],
        'ms_hot_item_bucket': item['ms'],
        'plain_ms_hot_item_bucket': item['plain_ms'],
        'bound_ms_hot_item_bucket': item['bound_ms'],
        'shape_hot_item_bucket': 'R=%d L=%d, longest row %d' % (
            item['R'], item['L'], item['max_count']),
        'gram_err_over_bound': max(r['gram_err_over_bound']
                                   for r in k2_recs['bucket'] + als['frecs']),
        'ms_per_epoch': split['user']['kernel_ms'] + split['item']['kernel_ms'],
        'bound_ms_per_epoch': split['bound_ms_epoch'],
        'launches_per_epoch': als['per_epoch'],
        'epoch_event_ms': split['epoch_event_ms'],
        'epoch_idle': split['idle'],
        'epoch_s': als['epoch_s'],
        'train_setup_s': als['setup_s'],
        'train_upload_s': split['upload_s']}, {
        'name': 'pcg (K2, warm-started Jacobi-PCG on batched k x k systems, '
                'M given)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/pcg.cu',
        'replaces': 'mfrec_tpu/ops/pallas_cg.py:26',
        'launches': als['pcg_launches'],
        'max_abs_err': max(r['max_abs_err']
                           for r in k2_recs['pcg'] + als['recs']),
        'ms': real[3]['ms'], 'plain_ms': real[3]['plain_ms'],
        'bound_ms': real[3]['bound_ms'], 'bound_by': real[3]['bound_by'],
        'library_ms': None,
        'shape': 'the largest user bucket\'s systems: R=%d k=64 steps=3; on '
                 'no training path (the fused kernel runs the ALS epoch)'
                 % real[3]['R'],
        'ms_steps6': real[6]['ms'], 'plain_ms_steps6': real[6]['plain_ms'],
        'bound_ms_steps6': real[6]['bound_ms'],
        'exact_solver_ms': als['exact_ms']}]


def k4_entry(k4, svdpp, fn):
    '''K4's entries of the kernels line: the per-call sum and the phase
    aggregation (times at the JAX call's shape, a real user batch, on
    the hottest item batch, at the old item-step call's and on a whole
    W=512 user layout), K4g's gathered phases (a whole W=512 user
    layout) and the item step (a whole W=512 item layout); launches over
    phases 6 and 7's timed epochs.'''
    if not k4:
        return []
    call, hotb = k4['recs'][0], k4['recs'][1]
    ystep, xystep = k4['recs'][2], k4['recs'][3]
    scan = k4['scans'][0]
    y, xy = k4['steps'][0], k4['steps'][1]
    g64, e66, g100, e102, p100 = k4['gathers'][:5]
    runs = [r for r in (svdpp, fn) if r]

    def split(r, name):
        return r.get('split', {}).get('phases', {}).get(name, {})

    return [{
        'name': 'window_agg (K4, sorted-window aggregation)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/window_agg.cu',
        'replaces': 'mfrec_tpu/ops/pallas_window_agg.py:24',
        'launches': sum(r['k4_scan_launches'] + r['k4_call_launches']
                        for r in runs) if runs else None,
        'max_abs_err': max(r['max_abs_err']
                           for r in k4['recs'] + k4['scans']),
        'ms': call['ms'], 'plain_ms': call['plain_ms'],
        'bound_ms': call['bound_ms'], 'bound_by': call['bound_by'],
        'library_ms': call['library_ms'],
        'shape': 'one call on ML-10M user batch 0: B=16384 W=128 k=66; ms, '
                 'plain_ms and library_ms CUDA events around one call (host '
                 'included), *device_ms the kernels\' own time '
                 '(torch.profiler)',
        'device_ms': call['device_ms'],
        'library_device_ms': call['library_device_ms'],
        'ms_hot_batch': hotb['ms'],
        'library_ms_hot_batch': hotb['library_ms'],
        'device_ms_hot_batch': hotb['device_ms'],
        'library_device_ms_hot_batch': hotb['library_device_ms'],
        'bound_ms_hot_batch': hotb['bound_ms'],
        'ms_y_step_call': ystep['ms'], 'bound_ms_y_step_call':
            ystep['bound_ms'], 'ms_xy_step_call': xystep['ms'],
        'ms_phase': scan['ms'], 'plain_ms_phase': scan['plain_ms'],
        'bound_ms_phase': scan['bound_ms'],
        'library_ms_phase': scan['library_ms'],
        'launches_per_epoch_all_entries_svdpp':
            svdpp['k4_launches'] / 21.0 if svdpp else None,
        'launches_per_epoch_all_entries_fn':
            fn['k4_launches'] / 21.0 if fn else None,
        'epoch_s_svdpp': svdpp.get('epoch_s'),
        'epoch_s_fn': fn.get('epoch_s')}, {
        'name': 'gather_agg (K4g, SVD++ aggregation phases gathering their '
                'rows)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/window_agg.cu',
        'replaces': 'mfrec_tpu/ops/sgd_mf.py:971-989 over '
                    'mfrec_tpu/ops/pallas_window_agg.py:24',
        'launches': sum(r['k4g_launches'] for r in runs) if runs else None,
        'max_abs_err': max(r['max_abs_err'] for r in k4['gathers']),
        'ms': g64['ms'], 'plain_ms': g64['plain_ms'],
        'bound_ms': g64['bound_ms'], 'bound_by': g64['bound_by'],
        'library_ms': None,
        'shape': 'the Y sums (gather_aggregate) over the ML-10M W=512 user '
                 'layout: %d entries, k=64; ms and plain_ms CUDA events '
                 'around one call (host included), device_ms the kernel\'s '
                 'own time (torch.profiler)' % g64['entries'],
        'device_ms': g64.get('device_ms'),
        'ms_error': e66['ms'], 'plain_ms_error': e66['plain_ms'],
        'device_ms_error': e66.get('device_ms'),
        'bound_ms_error': e66['bound_ms'],
        'ms_k100': g100['ms'], 'plain_ms_k100': g100['plain_ms'],
        'device_ms_k100': g100.get('device_ms'),
        'bound_ms_k100': g100['bound_ms'],
        'ms_error_k102': e102['ms'], 'plain_ms_error_k102': e102['plain_ms'],
        'device_ms_error_k102': e102.get('device_ms'),
        'bound_ms_error_k102': e102['bound_ms'],
        'largest_term_error': max(e66['largest_term'],
                                  e102['largest_term']),
        'ms_profile_k100': p100['ms'], 'plain_ms_profile_k100':
            p100['plain_ms'], 'device_ms_profile_k100': p100.get('device_ms'),
        'bound_ms_profile_k100': p100['bound_ms'],
        'phase_ms_svdpp': [split(svdpp, p).get('device_ms') for p in
                           ('aggregate Y', 'aggregate errors')]}, {
        'name': 'step_aggregate (K4 item step, SVD++ Y / FN X and Y)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/window_agg.cu',
        'replaces': 'mfrec_tpu/ops/sgd_mf.py:993-1000 and '
                    'mfrec_tpu/ops/fn.py:232-249 over '
                    'mfrec_tpu/ops/pallas_window_agg.py:24',
        'launches': sum(r['k4_step_launches'] for r in runs)
        if runs else None,
        'max_abs_err': max(r['max_abs_err'] for r in k4['steps']),
        'ms': y['ms'], 'plain_ms': y['plain_ms'], 'bound_ms': y['bound_ms'],
        'bound_by': y['bound_by'], 'library_ms': None,
        'shape': 'SVD++ Y over the ML-10M W=512 item layout: 8346084 '
                 'entries, k=64',
        'per_batch_loop_ms': y['loop_ms'],
        'ms_fn': xy['ms'], 'plain_ms_fn': xy['plain_ms'],
        'per_batch_loop_ms_fn': xy['loop_ms'], 'bound_ms_fn': xy['bound_ms'],
        'step_device_ms_svdpp': split(svdpp, 'Y step').get('device_ms'),
        'step_enqueue_ms_svdpp': split(svdpp, 'Y step').get('host_ms'),
        'step_device_ms_fn': split(fn, 'X/Y step').get('device_ms'),
        'step_enqueue_ms_fn': split(fn, 'X/Y step').get('host_ms')}]


def b1_entry(k4, train, svdpp):
    '''B1's entry of the kernels line: the bias refit over the ML-10M W=512
    layouts' tables (both passes), launches over phases 4 and 6's timed
    calls.'''
    if not k4 or not k4.get('refits'):
        return []
    r = next(x for x in k4['refits'] if 'ms' in x)
    runs = [x for x in (train, svdpp) if x]
    return [{
        'name': 'bias_refit (B1, BellKor bias refit over the segment tables)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/bias_refit.cu',
        'replaces': 'numpy on the host: mfrec_tpu/models/mf.py '
                    'compute_items_bias_bk, compute_users_bias_bk',
        'launches': sum(x['b1_launches'] for x in runs) if runs else None,
        'max_abs_err': max(x['max_abs_err'] for x in k4['refits']),
        'max_ulp_numpy': max(x['max_ulp_numpy'] for x in k4['refits']),
        'ms': r['ms'], 'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': None,
        'device_ms': r['device_ms'], 'numpy_ms': r['numpy_ms'],
        'shape': 'item then user pass over the ML-10M W=512 layouts\' '
                 'tables: %d ratings; ms and plain_ms CUDA events around one '
                 'call (host included), device_ms the kernel\'s own time '
                 '(torch.profiler), numpy_ms the host refit it replaces'
                 % r['entries']}]


# S1 against its plain version on the card: bit for bit; its converge
# entry under a rule that stops between 3 and 40 epochs; the ML-100K
# feature timed over S1_EPOCHS epochs in one launch (example 2's least)
S1_CASE = dict(U=300, I=200, n=5000, k=16)
S1_CONVERGE_CASE = dict(U=300, I=200, n=1000, k=16)
S1_RULE = dict(min_epochs=3, max_epochs=40, min_improvement=3e-3)
S1_EPOCHS = 30
# phase 9: examples/example2_movielens_100k_sgd.py:30-37 (16 features,
# 30-120 epochs, min_improvement 1e-4, feature_init 0.1, K 0.02; lr 0.2
# on 'alternating', 0.01 otherwise)
EX2_PARAMS = {'min_epochs': 30, 'max_epochs': 120, 'min_improvement': 1e-4,
              'feature_init': 0.1, 'regularization_model': 0.02,
              'nbr_features': 16}
# the funk engine's cut depth: min = max epochs per feature.  At 2 (16 x 2
# serial epochs) the held-out RMSE stays above the bias-only floor (the
# JAX package on the CPU: 0.9561 against 0.9528); 10 is the least of
# those tried that passes it (0.9426)
FUNK_CUT = 10
# the card against the same workflow on the CPU (tests/test_torch_foldin.py
# states the same): held-out RMSE within 1e-3, P@10 within 0.002 (20
# hits of 9,430), the folded-in user's top-5 the same ids, scores within
# 1e-3 -- f32 sums in another order, run for up to 120 epochs
EX2_RMSE_TOL = 1e-3
EX2_P10_TOL = 2e-3
EX2_SCORE_TOL = 1e-3
# bench.py's fused operating point (bench.py:764-773): rank 64, B=16384,
# lr 0.002, K 0.02, fixed biases, init N(0, 0.1)
FUSED_BENCH = dict(k=64, B=16384, lr=0.002, K=0.02, init=0.1)
# FN's per-batch tier at the ML-100K shape: the model's defaults but 16
# features, batch 1024 (tests/test_fn.py's), 3 epochs
FN_FUSED_PARAMS = {'nbr_features': 16, 'batch_size': 1024,
                   'engine': 'fused', 'nbr_epochs': 3,
                   'min_improvement': -1.0}
FN_FUSED_TOL = 1e-4


def s1_inputs(U, I, n, k, seed, device):
    '''A seeded stream and columns for S1: ids with repeats, ratings in
    [1, 5], half the cache filled.'''
    import torch
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(
        uidx=t(rng.integers(0, U, n).astype(np.int32)),
        iidx=t(rng.integers(0, I, n).astype(np.int32)),
        r=t(rng.integers(1, 6, n).astype(np.float32)),
        cache=t(np.where(rng.random(n) < 0.5, rng.uniform(1, 5, n),
                         0).astype(np.float32)),
        P=t(rng.normal(0.1, 0.05, (U, k)).astype(np.float32)),
        Q=t(rng.normal(0.1, 0.05, (I, k)).astype(np.float32)),
        bu=t(rng.normal(0, 0.1, U).astype(np.float32)),
        bi=t(rng.normal(0, 0.1, I).astype(np.float32)))


def s1_call(fn, d, f, mode, upd_u, upd_i, **kw):
    '''One S1 epoch (``fn``: the wrapper or the plain version) on copies of
    ``d``'s columns, at example 2's rates; returns (pf, qf, bu, bi,
    rmse).'''
    P, Q = d['P'], d['Q']
    k = int(P.shape[1])
    return fn(P[:, f].contiguous(), Q[:, f].contiguous(), d['cache'],
              d['uidx'], d['iidx'], d['r'], f, k, 0.1, 0.01, 0.02, 3.53,
              d['bu'].clone(), d['bi'].clone(), 0.005, 0.006, 0.012, 0.004,
              bias_mode=mode, update_users=upd_u, update_items=upd_i, P=P,
              Q=Q, **kw)


def s1_bound_ms(n, U, I, mode):
    '''S1's least time for one epoch by the usual rule: the stream read
    once (uidx, iidx, r, cache: 16 bytes a rating), the columns read and
    written once, the biases read once (learned: and written; the learned
    dot reads the P and Q rows once more), against ~12 f32 operations a
    rating (2k more for the learned dot) at 67 TFLOP/s.'''
    nbytes = 16.0 * n + 8.0 * (U + I) + 4.0 * (U + I) * (
        2 if mode == 'learned' else 1)
    return roofline_ms(12.0 * n, nbytes)      # (ms, what bounds it)


def s1_converge_call(fn, d, f, mode, upd_u, upd_i, **kw):
    '''One converged feature (``fn``: the converge entry or its plain
    version) on copies of ``d``'s columns, under S1_RULE.'''
    return s1_call(fn, d, f, mode, upd_u, upd_i, **dict(S1_RULE, **kw))


def ml100k_stream(device):
    '''The ML-100K shape's 100,000 ratings shuffled as ``_run_funk``
    shuffles a model's (seed 0), with phase 2's columns and fixed biases;
    and the stream as ``ml100k_like.generate`` orders it (by user).'''
    import torch
    from mfrec_tpu_torch.data import ml100k_like
    u, i, v = ml100k_like.generate(seed=0)
    U, I, n = ml100k_like.N_USERS, ml100k_like.N_ITEMS, int(u.shape[0])
    perm = np.random.default_rng(0).permutation(n)
    rng = np.random.default_rng(2)
    cols = dict(cache=torch.zeros(n, device=device),
                P=torch.full((U, 16), 0.1, device=device),
                Q=torch.full((I, 16), 0.1, device=device),
                bu=torch.from_numpy(rng.normal(0, 0.3, U).astype(
                    np.float32)).to(device),
                bi=torch.from_numpy(rng.normal(0, 0.3, I).astype(
                    np.float32)).to(device))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    shuffled = dict(cols, uidx=t(u[perm]), iidx=t(i[perm]), r=t(v[perm]))
    by_user = dict(cols, uidx=t(u), iidx=t(i), r=t(v))
    return shuffled, by_user, (U, I, n)


def s1_times(sk, d, plan, epochs):
    '''S1 on ``d``'s stream: one epoch a launch (CUDA events, device
    time, host time with the rmse read), and ``epochs`` epochs in one
    converge launch (CUDA events; ms an epoch).'''
    cols = (d['P'][:, 0].contiguous(), d['Q'][:, 0].contiguous())
    bu, bi = d['bu'].clone(), d['bi'].clone()
    args = (cols[0], cols[1], d['cache'], d['uidx'], d['iidx'], d['r'], 0,
            16, 0.1, 0.01, 0.02, 3.53, bu, bi, 0.005, 0.006, 0.012, 0.004)

    def one():
        return sk.serial_epoch(*args, bias_mode='fixed', plan=plan)

    def many():
        sk.serial_converge(*args, bias_mode='fixed', plan=plan,
                           min_epochs=epochs, max_epochs=epochs)

    ms = timed_ms(one, 10)
    dev_ms, dev_n = kernel_device_ms(one, 'serial_funk', 10)
    conv_ms = timed_ms(many, 3)
    conv_dev, conv_n = kernel_device_ms(many, 'serial_funk', 2)
    return dict(ms=ms, device_ms=dev_ms, device_n=dev_n,
                converged_ms=conv_ms, converged_device_ms=conv_dev,
                converged_device_n=conv_n, epochs=epochs,
                epoch_ms_converged=conv_ms / epochs,
                rounds=plan.rounds, table=plan.table)


def phase2_serial(device='cuda'):
    '''S1 (``csrc/serial_funk.cu``) against its plain version on the card:
    every bias mode and fold-in mask on a 5,000-rating stream at k=16, the
    row table in shared memory and the columns in device memory, bit for
    bit, one epoch a launch and converged (every epoch's rmse, the epoch
    count); then the ML-100K shape (100,000 ratings shuffled, 943 x 1,682,
    'fixed' as example 2 trains): a 3-epoch converge launch against three
    one-epoch launches bit for bit, one epoch a launch and S1_EPOCHS in
    one launch timed beside the bound, the plain version, one rating's
    chain (measured) and the stream's longest dependency chain.'''
    import torch
    from mfrec_tpu_torch.ops import serial_kernel as sk
    card = card_line()
    c = S1_CASE
    d = s1_inputs(c['U'], c['I'], c['n'], c['k'], 1, device)
    log('phase 2: S1 against its plain version on the card (%d ratings, '
        '%d x %d, k=%d, one epoch; %d ratings converged; bit for bit)'
        % (c['n'], c['U'], c['I'], c['k'], S1_CONVERGE_CASE['n']))
    cc = S1_CONVERGE_CASE
    dc = s1_inputs(cc['U'], cc['I'], cc['n'], cc['k'], 2, device)
    masks = ((True, True), (True, False), (False, True))
    worst = 0.0
    for entry in ('epoch', 'converge'):
        for mode in sk.BIAS_MODES:
            for uu, ui in masks:
                if entry == 'epoch':
                    want = s1_call(sk.serial_feature_epoch_ref, d, 3, mode,
                                   uu, ui)
                else:
                    want = s1_converge_call(sk.serial_converge_ref, dc, 3,
                                            mode, uu, ui)
                for smem in (None, False):
                    if entry == 'epoch':
                        got = s1_call(sk.serial_epoch, d, 3, mode, uu, ui,
                                      smem=smem)
                        hist = (float(got[4]), float(want[4]))
                    else:
                        got = s1_converge_call(sk.serial_converge, dc, 3,
                                               mode, uu, ui, smem=smem)
                        hist = (got[4], want[4])
                    torch.cuda.synchronize()
                    same = hist[0] == hist[1] and all(
                        torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
                    err = max(float((a - b).abs().max())
                              for a, b in zip(got[:4], want[:4]))
                    worst = max(worst, err)
                    log('  %-8s %-7s users=%d items=%d %s: bit-identical=%s '
                        '(max abs err %.3g; %s)'
                        % (entry, mode, uu, ui, 'device memory'
                           if smem is False else 'shared-memory table', same,
                           err, 'rmse %.6f' % hist[0] if entry == 'epoch'
                           else '%d epochs, last rmse %.6f'
                           % (len(hist[0]), hist[0][-1])))
                    if not same:
                        raise SystemExit('S1 differs from its plain version')
    shuffled, by_user, (U, I, n) = ml100k_stream(device)
    plan = sk.serial_plan(shuffled['uidx'], shuffled['iidx'], False, device)
    got = s1_call(sk.serial_epoch, shuffled, 0, 'fixed', True, True,
                  plan=plan)
    t0 = time.perf_counter()
    want = s1_call(sk.serial_feature_epoch_ref, shuffled, 0, 'fixed', True,
                   True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    # three epochs in one converge launch against three one-epoch launches
    three = s1_call(sk.serial_converge, shuffled, 0, 'fixed', True, True,
                    plan=plan, min_epochs=3, max_epochs=3)
    cols = (shuffled['P'][:, 0].contiguous(),
            shuffled['Q'][:, 0].contiguous(), shuffled['bu'].clone(),
            shuffled['bi'].clone())
    rm = []
    for _ in range(3):
        rm.append(float(sk.serial_epoch(
            cols[0], cols[1], shuffled['cache'], shuffled['uidx'],
            shuffled['iidx'], shuffled['r'], 0, 16, 0.1, 0.01, 0.02, 3.53,
            cols[2], cols[3], 0.005, 0.006, 0.012, 0.004, bias_mode='fixed',
            plan=plan)[4]))
    same3 = three[4] == rm and all(torch.equal(a, b)
                                   for a, b in zip(three[:4], cols))
    tm = s1_times(sk, shuffled, plan, S1_EPOCHS)
    sorted_plan = sk.serial_plan(by_user['uidx'], by_user['iidx'], False,
                                 device)
    tm_sorted = s1_times(sk, by_user, sorted_plan, 3)
    lat_ns = sk.chain_latency_ns(device)
    depth = sk.longest_chain(shuffled['uidx'].cpu().numpy(),
                             shuffled['iidx'].cpu().numpy())
    bound, bound_by = s1_bound_ms(n, U, I, 'fixed')
    log('  ML-100K shape, shuffled (%d ratings, %d x %d, fixed): one epoch '
        'bit-identical=%s, 3 epochs in one launch against 3 launches '
        'bit-identical=%s; one epoch a launch %.4f ms (events), %s device '
        '(%d launches recorded), %.1f ns a rating; %d epochs in one launch '
        '%.4f ms, %.4f ms an epoch (%s device a launch); plain version '
        '%.1f ms; bound %.5f ms (%s); %d rounds an epoch (%d chunks); one '
        'rating\'s chain %.2f ns (measured), longest dependency chain %d '
        'ratings: critical path %.4f ms  [%s]'
        % (n, U, I, same, same3, tm['ms'], ms_or_not(tm['device_ms']),
           tm['device_n'], tm['ms'] * 1e6 / n, S1_EPOCHS, tm['converged_ms'],
           tm['epoch_ms_converged'], ms_or_not(tm['converged_device_ms']),
           plain_ms, bound, bound_by, plan.rounds, -(-n // sk.CHUNK), lat_ns,
           depth, depth * lat_ns / 1e6, card))
    log('  the same stream ordered by user (one user\'s ratings in a row): '
        '%d rounds an epoch; one epoch a launch %.4f ms, %.4f ms an epoch '
        'in a 3-epoch launch  [%s]' % (sorted_plan.rounds, tm_sorted['ms'],
                                       tm_sorted['epoch_ms_converged'], card))
    if not (same and same3):
        raise SystemExit('S1 differs from its plain version at the ML-100K '
                         'shape')
    return dict(tm, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                chain_ns=lat_ns, longest_chain=depth,
                critical_ms=depth * lat_ns / 1e6, max_abs_err=worst, n=n,
                by_user=tm_sorted)


def heldout_floor_rmse(train, test, U, I):
    '''Held-out RMSE of the bias-only predictor fitted on the training
    split (``tests/test_acceptance_ml100k.py``'s floor): what a model
    that learns no structure reaches on the test split.'''
    from mfrec_tpu_torch.tools import bench_data
    users, items, vals = train
    _, bu, bi = bench_data.bias_floor_rmse(users, items, vals, U, I)
    pred = np.clip(vals.mean() + bi[test[:, 1].astype(int)]
                   + bu[test[:, 0].astype(int)], 1.0, 5.0)
    return float(np.sqrt(((test[:, 2] - pred) ** 2).mean()))


def example2(engine, device, data, cut=None):
    '''``examples/example2_movielens_100k_sgd.py:44-61`` through the port's
    public API on ``device``: train (handle_bias=True), the held-out RMSE
    over the whole test split, P@10, then ``add_user('new-user', items
    0-9, 5.0)`` and the new user's top-5.  ``cut``: min = max epochs.'''
    import torch
    from mfrec_tpu_torch.eval.metrics import precision_recall, \
        test_predict_rating
    from mfrec_tpu_torch.models.gd import GDRecommender
    (users, items, values), u_test = data
    U, I = int(users.max()) + 1, int(items.max()) + 1
    params = dict(EX2_PARAMS, engine=engine,
                  learning_rate=0.2 if engine == 'alternating' else 0.01)
    if cut is not None:
        params.update(min_epochs=cut, max_epochs=cut)
    m = GDRecommender(U, I, params, device=device)
    m.seed(0)
    m.set_ratings(users, items, values)

    def sync():
        if device == 'cuda':
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    m.train(handle_bias=True)
    sync()
    train_s = time.perf_counter() - t0
    hist = [float(x) for x in m.rmse_history]
    rmse = test_predict_rating(m, u_test, nbr_samples=len(u_test),
                               predictor='predict_rating_with_bias',
                               quiet=True)[0]
    p10 = precision_recall(m, u_test, nbr_recommendations=10,
                           predictor='predict_rating_with_bias')[0]
    t0 = time.perf_counter()
    new_id = m.add_user('new-user', np.arange(10, dtype=np.int32),
                        np.full(10, 5.0, np.float32))
    sync()
    add_ms = (time.perf_counter() - t0) * 1e3
    ids, scores = m.find_recommended_items(
        user_index=new_id, nbr_recommendations=5,
        predictor='predict_rating_with_bias')
    return dict(train_s=train_s, epochs=len(hist), hist=hist, rmse=rmse,
                p10=p10, add_ms=add_ms, new_id=new_id, ids=ids,
                scores=scores, model=m, fold_epochs=len(m.rmse_history))


def fused_bench(device='cuda', U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz']):
    '''The fused tier at bench.py's operating point on the ML-10M shape of
    phase 4: the epoch by phase 4's difference quotient (3 blocks of a 2-
    and a 5-epoch run after a 1-epoch warm-up), every RMSE against the
    bias-only floor, one epoch's device launches and idle share
    (torch.profiler against the CUDA-event epoch).'''
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.tools import bench_data
    card = card_line()
    fb = FUSED_BENCH
    t0 = time.perf_counter()
    users, items, vals = unique_stream(U, I, nnz)
    floor, bu, bi = bench_data.bias_floor_rmse(users, items, vals, U, I)
    ub, ib, rb, mb = sgd_mf.batch_ratings(users, items, vals, fb['B'],
                                          seed=0)
    plan = sgd_mf.fused_plan(ub, ib, device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ub, ib, rb, mb = t(ub), t(ib), t(rb), t(mb)
    rng = np.random.default_rng(0)
    st = sgd_mf.MFState(
        P=t(rng.normal(0, fb['init'], (U, fb['k'])).astype(np.float32)),
        Q=t(rng.normal(0, fb['init'], (I, fb['k'])).astype(np.float32)),
        bu=t(bu), bi=t(bi), mu=torch.tensor(float(vals.mean())))
    epoch = sgd_mf.make_fused_epoch(fb['B'], lr=fb['lr'], K=fb['K'],
                                    bias_mode='fixed')
    log('phase 9(d): the fused tier at bench.py\'s operating point: %d x '
        '%d, %d ratings, %d batches of %d, rank %d, lr %g, K %g, fixed '
        'biases; bias-only floor %.4f (%.1f s to build the data and the '
        'scatter plans)' % (U, I, vals.shape[0], ub.shape[0], fb['B'],
                            fb['k'], fb['lr'], fb['K'], floor,
                            time.perf_counter() - t0))
    hist = []

    def run(epochs):
        for _ in range(epochs):
            _, rmse = epoch(st, ub, ib, rb, mb, plan=plan)
            hist.append(float(rmse))

    res = epochs_timed(run, lambda: hist[-5:], card, device)
    epoch_ms, launches, idle = None, None, None
    if device == 'cuda':
        # one epoch: CUDA events, then under the profiler for its launches
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        run(1)
        b.record()
        b.synchronize()
        epoch_ms = a.elapsed_time(b)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(1)
            torch.cuda.synchronize()
        launches = sum(n for n, _ in device_kernels(prof).values())
        idle = idle_share(device_busy_ms(prof), epoch_ms)
    log('  epoch %.4f s (median of 3), %s ms by events; %s device '
        'launches an epoch (%s a batch), idle share %s; last rmse %.4f vs '
        'floor %.4f  [%s]' % (res['epoch_s'], epoch_ms, launches,
                              None if launches is None
                              else launches / float(ub.shape[0]),
                              'not measured' if idle is None
                              else '%.3f' % idle, hist[-1], floor, card))
    if not all(np.isfinite(hist)):
        raise SystemExit('non-finite fused-tier RMSE: %s' % hist)
    if not hist[-1] < floor:
        raise SystemExit('the fused tier does not beat the bias-only floor')
    return dict(epoch_s=res['epoch_s'], epoch_s_blocks=res['epoch_s_blocks'],
                epoch_ms_events=epoch_ms, launches_per_epoch=launches,
                idle_share=idle, rmse=hist[-1], floor=floor,
                state=st, data=(users, items, vals))


def foldin_full_width(fb, devices=('cuda', 'cpu')):
    '''``add_user`` with 20 ratings on a rank-64 ML-10M-shape model (the
    fused tier's from (d), handed over by ``interop.from_numpy``), timed
    a call, the new row held to the same fold-in on a CPU model from the
    same state (the plain version: bit for bit).'''
    import torch
    from mfrec_tpu_torch import interop
    from mfrec_tpu_torch.ops import serial_kernel as sk
    card = card_line()
    st = fb['state']
    users, items, vals = fb['data']
    P, Q = st.P.cpu().numpy(), st.Q.cpu().numpy()
    bu, bi = st.bu.cpu().numpy(), st.bi.cpu().numpy()
    params = dict(EX2_PARAMS, nbr_features=P.shape[1], learning_rate=0.01)
    rng = np.random.default_rng(4)
    new_items = [rng.choice(Q.shape[0], 20, replace=False).astype(np.int32)
                 for _ in range(3)]
    new_vals = [rng.integers(1, 6, 20).astype(np.float32) for _ in range(3)]
    rows, times, epochs, launches = {}, [], [], []
    on, off = devices
    for d in devices:
        m = interop.from_numpy(P, Q, bu, bi, float(vals.mean()),
                               (users, items, vals), device=d,
                               parameters=params)
        m.seed(7)
        rows[d] = []
        for j in range(3 if d == on else 1):
            if d == 'cuda':
                torch.cuda.synchronize()
            before = sk.serial_converge.launches
            t0 = time.perf_counter()
            new_id = m.add_user('fold-%d' % j, new_items[j], new_vals[j])
            if d == 'cuda':
                torch.cuda.synchronize()
            if d == on:
                times.append((time.perf_counter() - t0) * 1e3)
                epochs.append(len(m.rmse_history))
                launches.append(sk.serial_converge.launches - before)
            rows[d].append(m.P[new_id].copy())
        if d == 'cuda':
            split = s1_feature_cost(m, new_id, new_items[0], new_vals[0])
            split.update(state_transfer_ms(m))
    same = np.array_equal(rows[on][0], rows[off][0])
    err = float(np.abs(rows[on][0] - rows[off][0]).max())
    log('phase 9(e): add_user with 20 ratings on the rank-%d ML-10M-shape '
        'model: %s ms a call (3 calls; %s serial epochs, %s S1 launches and '
        'as many rmse reads each), the new row against the CPU plain path '
        'from the same state bit-identical=%s (max abs err %.3g)  [%s]'
        % (P.shape[1], ' '.join('%.1f' % x for x in times),
           ' '.join(str(e) for e in epochs),
           ' '.join(str(x) for x in launches), same, err, card))
    if on == 'cuda':
        log('  one converged feature of that fold-in (%d epochs): %.1f us '
            'on the host clock with its rmse read (%.1f us to enqueue the '
            'launch alone), %s of device time; the whole model\'s P, Q '
            'and biases to the card %.2f ms (%.1f MB), P and Q back %.2f ms '
            '(not moved by a fold-in)  [%s]' % (split['epochs'], split['feature_us'],
                      split['enqueue_us'], ms_or_not(split['device_ms']),
                      split['upload_ms'], split['mb'], split['download_ms'],
                      card))
    if not same or not np.isfinite(rows[on][0]).all():
        raise SystemExit('the fold-in on the card differs from the CPU '
                         'plain path')
    return dict(add_ms=float(np.median(times)), add_ms_all=times,
                epochs=epochs, launches=launches,
                **({'split': split} if on == 'cuda' else {}))


def state_transfer_ms(m, reps=5):
    '''The whole model's P, Q and biases to the card (``_state``) and P
    and Q back (``_host``), ms each on the host clock (median of
    ``reps``), and the MB moved up: what a fold-in would move if
    ``_run_funk`` did not move only the stream's rows.'''
    import torch
    from mfrec_tpu_torch.models.mf import _host
    up, down = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = m._state(with_bias=True)
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        _host(st.P, m.nbr_users), _host(st.Q, m.nbr_items)
        down.append((time.perf_counter() - t0) * 1e3)
    mb = sum(x.numel() * 4 for x in (st.P, st.Q, st.bu, st.bi)) / 1e6
    return dict(upload_ms=float(np.median(up)),
                download_ms=float(np.median(down)), mb=mb)


def s1_feature_cost(m, user, items, vals, calls=50):
    '''What one converged feature of a fold-in costs on the card: ``calls``
    features (feature 0 of the fold-in's stream, example 2's rule)
    through ``serial_converge`` on the host clock, each with its one read
    of the rmse; the same launches without the read (the enqueue); the
    launch's device time; and the epochs a feature ran.'''
    import torch
    from mfrec_tpu_torch.ops import serial_kernel as sk
    dev = m.device
    k = m.dimensionality

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    uidx = t(np.full(len(items), user), np.int32)
    iidx, r = t(items, np.int32), t(vals, np.float32)
    cache = torch.zeros(len(items), device=dev)
    pf = t(m.P[:, 0], np.float32)
    qf = t(m.Q[:, 0], np.float32)
    bu, bi = t(m.users_bias, np.float32), t(m.items_bias, np.float32)
    plan = sk.serial_plan(uidx, iidx, False, dev)
    args = (cache, uidx, iidx, r, 0, k, 0.1, 0.01, 0.02, 3.5, bu, bi, 0.0,
            0.0, 0.0, 0.0)
    rule = dict(min_epochs=m.min_epochs, max_epochs=m.max_epochs,
                min_improvement=m.min_improvement)

    def feature():                 # the rmse read once, as _run_funk does
        return sk.serial_converge(pf.clone(), qf, *args, bias_mode='fixed',
                                  update_items=False, plan=plan, **rule)[4]

    scal = sk.epoch_scalars(0, k, 0.1, 0.01, 0.02, 3.5, 0.0, 0.0, 0.0, 0.0,
                            1.0, 5.0)

    def enqueue():                 # the launch alone, nothing read
        return sk._launch(pf.clone(), qf, cache, uidx, iidx, r, 0, scal, bu,
                          bi, 'fixed', True, False, None, None, plan,
                          (0, 2.0, 2.0, rule['min_epochs'], rule['max_epochs'],
                           rule['min_improvement']), rule['max_epochs'])

    epochs = len(feature())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        feature()
    feature_us = (time.perf_counter() - t0) * 1e6 / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        enqueue()
    enqueue_us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return dict(feature_us=feature_us, enqueue_us=enqueue_us,
                epochs=epochs,
                device_ms=kernel_device_ms(feature, 'serial_funk', 20)[0])


def fn_and_sweep(data, devices=('cuda', 'cpu')):
    '''``FNRecommender(engine='fused')`` at the ML-100K shape and
    ``optimize_regularization_vmapped`` over three K, each on the card
    against the same call on the CPU.'''
    from mfrec_tpu_torch.eval.sweep import optimize_regularization_vmapped
    from mfrec_tpu_torch.models.fn import FNRecommender
    card = card_line()
    (users, items, values), u_test = data
    U, I = int(users.max()) + 1, int(items.max()) + 1
    on, off = devices
    out = {}
    for d in devices:
        t0 = time.perf_counter()
        m = FNRecommender(U, I, FN_FUSED_PARAMS, device=d)
        m.seed(0)
        m.set_ratings(users, items, values)
        m.train()
        out[d] = (np.asarray(m.rmse_history), m.P.copy(),
                  time.perf_counter() - t0)
    herr = float(np.abs(out[on][0] - out[off][0]).max())
    perr = float(np.abs(out[on][1] - out[off][1]).max())
    log('phase 9(f): FNRecommender(engine=\'fused\') at %d x %d, %d '
        'features, batch %d, %d epochs: rmse %s on the card (%.2f s) vs %s '
        'on the CPU (%.2f s); max diff rmse %.3g, profiles %.3g  [%s]'
        % (U, I, FN_FUSED_PARAMS['nbr_features'],
           FN_FUSED_PARAMS['batch_size'], FN_FUSED_PARAMS['nbr_epochs'],
           ' '.join('%.5f' % x for x in out[on][0]), out[on][2],
           ' '.join('%.5f' % x for x in out[off][0]), out[off][2], herr,
           perr, card))
    if not (np.isfinite(out[on][0]).all() and herr <= FN_FUSED_TOL
            and perr <= FN_FUSED_TOL):
        raise SystemExit('the FN fused tier on the card disagrees with the '
                         'CPU')
    regs = [0.005, 0.02, 0.1]
    sw = {}
    for d in devices:
        t0 = time.perf_counter()
        sw[d] = (optimize_regularization_vmapped(
            users, items, values, u_test, regs, rank=16, epochs=10,
            device=d)[1], time.perf_counter() - t0)
    serr = float(np.abs(sw[on][0] - sw[off][0]).max())
    log('  optimize_regularization_vmapped(K=%s, rank 16, 10 epochs): '
        'held-out rmse %s on the card (%.2f s) vs %s on the CPU (%.2f s), '
        'max diff %.3g  [%s]' % (regs, ' '.join(
            '%.5f' % x for x in sw[on][0]), sw[on][1], ' '.join(
            '%.5f' % x for x in sw[off][0]), sw[off][1], serr, card))
    if not (np.isfinite(sw[on][0]).all() and serr <= FN_FUSED_TOL):
        raise SystemExit('the regularization sweep on the card disagrees '
                         'with the CPU')
    return dict(fn_rmse=out[on][0].tolist(), sweep=sw[on][0].tolist())


def phase9(device='cuda', reduced=None):
    '''The reference's main workflow on the card at full width
    (``examples/example2_movielens_100k_sgd.py``): (a) example 2 as
    written (engine 'fused') against the same workflow on the CPU; (b)
    'funk_fused', 'alternating' and (cut) 'funk'; (c) the fused and
    funk-fused tiers repeated bit for bit; (d) the fused tier at
    bench.py's ML-10M operating point; (e) fold-in on a rank-64
    ML-10M-shape model; (f) FN's fused tier and the regularization
    sweep against the CPU.  The launch counts are set to 0 before (a)
    and (b), the workflow this phase drives, and read after them.'''
    from mfrec_tpu_torch.data import ml100k_like
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.serial_kernel import serial_converge
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    card = card_line()
    t_phase = time.perf_counter()
    data = ml100k_like.u1_split(seed=0)
    (users, items, values), u_test = data
    U, I = int(users.max()) + 1, int(items.max()) + 1
    floor = heldout_floor_rmse(data[0], u_test, U, I)
    log('phase 9: example 2\'s workflow on the card: the synthetic ML-100K '
        'u1 split (%d x %d, %d train / %d test), 16 features; held-out '
        'bias-only floor %.4f' % (U, I, users.shape[0], u_test.shape[0],
                                  floor))
    zero_launch_counts()
    runs = {}
    for engine, cut in (('fused', None), ('funk_fused', None),
                        ('alternating', None), ('funk', FUNK_CUT)):
        r = example2(engine, device, data, cut=cut)
        runs[engine] = r
        log('  (%s) %-11s trained %d epochs%s in %.2f s (train rmse %.4f), '
            'held-out rmse %.4f, P@10 %.4f; add_user %.1f ms (%d serial '
            'epochs), top-5 %s  [%s]'
            % ('a' if engine == 'fused' else 'b', engine, r['epochs'],
               '' if cut is None else ' (cut: min = max = %d a feature)'
               % cut, r['train_s'], r['hist'][-1], r['rmse'], r['p10'],
               r['add_ms'], r['fold_epochs'], r['ids'], card))
        if not (np.isfinite(r['hist']).all() and np.isfinite(r['rmse'])):
            raise SystemExit('non-finite RMSE from engine %r' % engine)
        if not r['rmse'] < floor:
            raise SystemExit('engine %r: held-out rmse %.4f does not beat '
                             'the bias-only floor %.4f'
                             % (engine, r['rmse'], floor))
    launches = {'s1': serial_converge.launches,
                'k3': topn_scores_kernel.launches, 'k1': half_pass.launches}
    # features _run_funk trained: 'funk''s 16, and each add_user's 16
    features = sum(r['model'].dimensionality * (1 + (e == 'funk'))
                   for e, r in runs.items())
    serial_epochs = serial_converge.epochs
    log('  launches over (a) and (b): S1 %d (%d features trained through '
        'S1, %d serial epochs), K3 %d, K1 %d'
        % (launches['s1'], features, serial_epochs, launches['k3'],
           launches['k1']))
    if device == 'cuda' and min(launches.values()) == 0:
        raise SystemExit('the workflow never launched a kernel of its path: '
                         '%s' % launches)
    if device == 'cuda' and launches['s1'] > features:
        raise SystemExit('_run_funk launched S1 %d times for %d features'
                         % (launches['s1'], features))
    a = runs['fused']
    cpu = example2('fused', 'cpu', data)
    sdiff = max(abs(x - y) for x, y in zip(a['scores'], cpu['scores']))
    log('  (a) the same workflow on the CPU: %d epochs, held-out rmse %.4f, '
        'P@10 %.4f, top-5 %s; card - CPU: rmse %.3g, P@10 %.3g, scores %.3g'
        % (cpu['epochs'], cpu['rmse'], cpu['p10'], cpu['ids'],
           a['rmse'] - cpu['rmse'], a['p10'] - cpu['p10'], sdiff))
    if not (abs(a['rmse'] - cpu['rmse']) <= EX2_RMSE_TOL
            and abs(a['p10'] - cpu['p10']) <= EX2_P10_TOL
            and sorted(a['ids']) == sorted(cpu['ids'])
            and sdiff <= EX2_SCORE_TOL):
        raise SystemExit('example 2 on the card disagrees with the CPU')
    # (c) determinism: two runs from one seed, bit for bit
    for engine in ('fused', 'funk_fused'):
        m1 = example2(engine, device, data, cut=5)['model']
        m2 = example2(engine, device, data, cut=5)['model']
        same = np.array_equal(m1.P, m2.P) and np.array_equal(m1.Q, m2.Q)
        log('  (c) %s trained twice from one seed (5 epochs%s): P and Q '
            'bit-identical=%s' % (engine, ' a feature' if engine ==
                                  'funk_fused' else '', same))
        if not same:
            raise SystemExit('the %s tier does not repeat on the card'
                             % engine)
    devices = (device, 'cpu')
    fb = fused_bench(device, *(reduced or (ML10M['U'], ML10M['I'],
                                           ML10M['nnz'])))
    fold = foldin_full_width(fb, devices)
    fns = fn_and_sweep(data, devices)
    log('  phase 9 in %.1f s  [%s]' % (time.perf_counter() - t_phase, card))
    return dict(runs={e: {k: v for k, v in r.items() if k != 'model'}
                      for e, r in runs.items()},
                launches=launches, features=features,
                serial_epochs=serial_epochs, floor=floor, fused=dict(
                    (k, v) for k, v in fb.items()
                    if k not in ('state', 'data')), fold=fold, fn=fns)


def serial_entry(s1, p9):
    '''S1's entry of the kernels line: the ML-100K-shape feature epoch of
    phase 2 (one a launch; and S1_EPOCHS in one launch), the launches of
    phase 9's workflow.'''
    if not s1:
        return []
    fold = p9.get('fold', {})
    return [{
        'name': 'serial_funk (S1, a feature\'s serial Funk epochs and its '
                'convergence rule; no TPU counterpart)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/serial_funk.cu',
        'replaces': 'mfrec_tpu/ops/sgd_mf.py:109 (serial_feature_epoch, a '
                    'lax.fori_loop outside any Pallas kernel; the loop '
                    'around it, mfrec_tpu/models/gd.py:910)',
        'launches': p9.get('launches', {}).get('s1'),
        'max_abs_err': s1['max_abs_err'],
        'ms': s1['ms'], 'plain_ms': s1['plain_ms'],
        'bound_ms': s1['bound_ms'], 'bound_by': s1['bound_by'],
        'library_ms': None,
        'shape': 'one feature epoch at the ML-100K shape: 100000 ratings '
                 'shuffled, 943 x 1682, fixed biases',
        'device_ms': s1['device_ms'],
        'epoch_ms_converged': s1['epoch_ms_converged'],
        'converged_epochs': s1['epochs'],
        'rounds_an_epoch': s1['rounds'],
        'chain_ns': s1['chain_ns'], 'longest_chain': s1['longest_chain'],
        'critical_path_ms': s1['critical_ms'],
        'ms_by_user_order': s1['by_user']['ms'],
        'features_phase9': p9.get('features'),
        'serial_epochs_phase9': p9.get('serial_epochs'),
        'add_user_ms_example2': p9.get('runs', {}).get('fused', {}).get(
            'add_ms'),
        'add_user_ms_rank64': fold.get('add_ms'),
        'foldin_feature_us_rank64': fold.get('split', {}).get('feature_us')}]


# ------------------------------------------------------------------- S2
S2_KS = (1, 8, 40, 64, 66, 256)
S2_MASKS = ((True, True), (True, False), (False, True))
S2_RULES = ((12, 12, 0.0), (1, 60, 0.01))      # min_improvement None, float
S2_CHUNK_EDGES = (31, 32, 33, 64, 65)          # around S2's 32-rating chunks
# KMF's phase: the JAX KMF bench's rank (bench.py:655-693) at the shipped
# defaults otherwise; ML-100K at the shipped 40 features
KMF_PARAMS = {'nbr_features': 64}
KMF_SERIAL_EPOCHS = 3          # (c): engine='serial' cut to 3 epochs
KMF_REDUCED = 2000             # (c): the first ratings, against the plain
# version on the card (~1 ms a rating there); the whole stream's first
# epoch is held to the plain version on the CPU (~0.2 ms a rating)
# the fold-in's new row on the card against the CPU plain path: the same
# f32 steps; the card's expf and the CPU's exp may differ by an ulp,
# which 200 epochs may carry to a few ulps of the row
KMF_FOLD_TOL = 1e-5
# the end-to-end workflow of tests/test_kmf.py on the card against the
# CPU: K1's f32 build against the CPU's XLA branch, 200 epochs; the
# held-out RMSEs differ by 8.2e-5 on an H100 80GB HBM3 (700 W), about 3x
# under this
KMF_E2E_RMSE_TOL = 2.5e-4


def s2_inputs(U, I, n, k, seed, device):
    '''A seeded stream and state for S2: ids with repeats, ratings in [1,
    5].'''
    import torch
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(P=t(rng.normal(0, 0.1, (U, k)).astype(np.float32)),
                Q=t(rng.normal(0, 0.1, (I, k)).astype(np.float32)),
                bu=t(rng.normal(0, 0.1, U).astype(np.float32)),
                bi=t(rng.normal(0, 0.1, I).astype(np.float32)),
                uidx=t(rng.integers(0, U, n).astype(np.int32)),
                iidx=t(rng.integers(0, I, n).astype(np.int32)),
                r=t(rng.integers(1, 6, n).astype(np.float32)))


def s2_call(fn, d, kernel, masks, lr=0.01, **kw):
    '''``fn`` (an S2 entry or its plain version) on copies of ``d``'s
    state at KMF's default rates; returns (P, Q, bu, bi, rmse or
    history).'''
    st = [d[x].clone() for x in ('P', 'Q', 'bu', 'bi')]
    return fn(*st, d['uidx'], d['iidx'], d['r'], lr, 0.1, 0.1, 0.007,
              kernel, 1.0, 5.0, *masks, **kw)


def s2_compare(got, want):
    '''(bit-identical, max abs err) of two S2 results.'''
    import torch
    if got[0].is_cuda:
        torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], want[:4]))
    if isinstance(got[4], list):
        same = same and np.array_equal(got[4], want[4], equal_nan=True)
    else:
        same = same and torch.equal(got[4], want[4])
        err = max(err, float((got[4] - want[4]).abs()))
    return same, err


def s2_bound_ms(u, i, k, chain_ns):
    '''S2's least time for an epoch of the stream (u, i): the larger of
    its bytes over the card's rate (the ids and ratings, 12 bytes a
    rating, read once; each distinct P and Q row and bias read and
    written once) and its critical path (the stream's longest dependency
    chain, ``serial_kernel.longest_chain``, times ``chain_ns``, one
    rating's chain as ``kmf_serial_kernel.chain_latency_ns`` measures it
    apart from S2).  Returns (ms, 'bytes' or 'operations', chain
    ratings).'''
    from mfrec_tpu_torch.ops import serial_kernel
    nbytes = 12.0 * len(u) + 8.0 * (k + 1) * (len(np.unique(u))
                                              + len(np.unique(i)))
    depth = serial_kernel.longest_chain(u, i)
    t_bytes, t_chain = nbytes / PEAK_BYTES * 1e3, depth * chain_ns / 1e6
    return max(t_bytes, t_chain), \
        'operations' if t_chain >= t_bytes else 'bytes', depth


def phase2_kmf_serial(device='cuda'):
    '''S2 (``csrc/kmf_serial.cu``) against its plain version on the card,
    bit for bit: every link x fold-in mask x k in S2_KS over a 200-rating
    stream (one epoch a launch); n = 1, 2, 3, a stream repeating one (u,
    i), a fold-in stream of one user with a duplicated pair, streams
    around the 32-rating chunks (n = 31, 32, 33, 64, 65, 1,000), a hot
    item, rows far past shared memory; the converge entry's rmse list
    and epoch count under min_improvement None and a float; a stream
    that diverges to a non-finite rmse.'''
    import torch
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    card = card_line()
    log('phase 2: S2 against its plain version on the card (bit for bit)')
    worst, failed = 0.0, []

    def check(name, got, want):
        nonlocal worst
        same, err = s2_compare(got, want)
        worst = max(worst, err)
        if not same:
            failed.append(name)
        return same, err

    for k in S2_KS:
        d = s2_inputs(30, 20, 200, k, k, device)
        res = []
        for kernel in ('logistic', 'linear'):
            for masks in S2_MASKS:
                res.append(check('k=%d %s %s' % (k, kernel, masks),
                                 s2_call(sk.kmf_serial_epoch, d, kernel,
                                         masks),
                                 s2_call(sk.kmf_serial_epoch_ref, d, kernel,
                                         masks)))
        log('  k=%-3d 2 links x 3 masks, 200 ratings, one epoch: '
            'bit-identical %d/6 (max abs err %.3g)'
            % (k, sum(s for s, _ in res), max(e for _, e in res)))
    streams = []
    for n in (1, 2, 3):
        streams.append(('n=%d' % n, s2_inputs(12, 40, n, 66, n, device)))
    d = s2_inputs(12, 40, 33, 66, 5, device)
    streams.append(('one (u, i) repeated', dict(
        d, uidx=torch.full_like(d['uidx'], 3),
        iidx=torch.full_like(d['iidx'], 5))))
    fold = torch.randperm(40, device=device)[:20].int()
    fold[19] = fold[4]
    streams.append(('one user\'s fold-in, a pair twice', dict(
        s2_inputs(12, 40, 20, 64, 6, device),
        uidx=torch.full((20,), 7, dtype=torch.int32, device=device),
        iidx=fold)))
    for n in S2_CHUNK_EDGES:                # S2 runs chunks of 32 ratings
        streams.append(('n=%d' % n, s2_inputs(40, 60, n, 40, 100 + n,
                                              device)))
    for name, s in streams:
        res = []
        for kernel in ('logistic', 'linear'):
            for masks in S2_MASKS:
                kw = dict(min_epochs=3, max_epochs=3)
                res.append(check(name, s2_call(sk.kmf_serial_converge, s,
                                               kernel, masks, **kw),
                                 s2_call(sk.kmf_serial_converge_ref, s,
                                         kernel, masks, **kw)))
        log('  %s, 3 epochs in one launch, 2 links x 3 masks: '
            'bit-identical %d/6' % (name, sum(x for x, _ in res)))
    d = s2_inputs(40, 60, 1000, 40, 1100, device)
    kw = dict(min_epochs=2, max_epochs=2)
    same, _ = check('n=1000', s2_call(sk.kmf_serial_converge, d, 'logistic',
                                      (True, True), **kw),
                    s2_call(sk.kmf_serial_converge_ref, d, 'logistic',
                            (True, True), **kw))
    log('  n=1000, 2 epochs in one launch, logistic: bit-identical=%s'
        % same)
    hot = s2_inputs(30, 25, 300, 40, 11, device)
    rng = np.random.default_rng(11)
    hot['iidx'] = torch.from_numpy(np.where(
        rng.random(300) < 0.5, 0, rng.integers(1, 25, 300)).astype(
            np.int32)).to(device)
    big = s2_inputs(3000, 2000, 1500, 64, 12, device)
    for name, d, fn, ref, kernel, kw in (
            ('a hot item (half the stream), 2 epochs', hot,
             sk.kmf_serial_converge, sk.kmf_serial_converge_ref, 'logistic',
             dict(min_epochs=2, max_epochs=2)),
            ('3,000 users x 2,000 items at k=64 (rows far past shared '
             'memory), one epoch', big, sk.kmf_serial_epoch,
             sk.kmf_serial_epoch_ref, 'linear', {})):
        res = [check(name, s2_call(fn, d, kernel, masks, **kw),
                     s2_call(ref, d, kernel, masks, **kw))
               for masks in S2_MASKS]
        log('  %s, %s x 3 masks: bit-identical %d/3'
            % (name, kernel, sum(x for x, _ in res)))
    d = s2_inputs(25, 18, 150, 8, 7, device)
    for rule in S2_RULES:
        for kernel in ('logistic', 'linear'):
            kw = dict(min_epochs=rule[0], max_epochs=rule[1],
                      min_improvement=rule[2])
            got = s2_call(sk.kmf_serial_converge, d, kernel, (True, True),
                          **kw)
            same, _ = check('converge %s %s' % (rule, kernel), got,
                            s2_call(sk.kmf_serial_converge_ref, d, kernel,
                                    (True, True), **kw))
            log('  converge entry, rule %s, %s: %d epochs in one launch, '
                'rmse list and count bit-identical=%s' % (rule, kernel,
                                                          len(got[4]), same))
    kw = dict(min_epochs=30, max_epochs=30)        # linear, lr 0.3: inf
    got = s2_call(sk.kmf_serial_converge, d, 'linear', (True, True), lr=0.3,
                  **kw)
    want = s2_call(sk.kmf_serial_converge_ref, d, 'linear', (True, True),
                   lr=0.3, **kw)
    same = len(got[4]) == len(want[4]) < 30 and \
        not math.isfinite(got[4][-1]) and \
        np.array_equal(got[4], want[4], equal_nan=True)
    log('  a diverging stream: stopped after %d epochs on rmse %r (plain: '
        '%d, %r), same=%s  [%s]' % (len(got[4]), got[4][-1], len(want[4]),
                                    want[4][-1], same, card))
    if not same:
        failed.append('divergence')
    if failed:
        raise SystemExit('S2 differs from its plain version: %s' % failed)
    return dict(max_abs_err=worst)


def kmf_model(params, device, U, I, data):
    '''A seeded ``KMFRecommender`` on ``device`` holding ``data``.'''
    from mfrec_tpu_torch.models.kmf import KMFRecommender
    m = KMFRecommender(U, I, dict(params), device=device)
    m.seed(0)
    m.set_ratings(*data)
    return m


def kmf_foldin(m, device):
    '''(b): ``add_user`` with 20 ratings on the trained rank-64 model at
    the shipped 200 epochs, 3 calls timed (S2 launches and rmse reads a
    call); the first call's new row against a CPU model's plain path
    from the same state.'''
    import torch
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    card = card_line()
    state = tuple(np.array(getattr(m, x)) for x in
                  ('P', 'Q', 'users_bias', 'items_bias'))
    rng = np.random.default_rng(4)
    items = [rng.choice(m.nbr_items, 20, replace=False).astype(np.int32)
             for _ in range(3)]
    vals = [rng.integers(1, 6, 20).astype(np.float32) for _ in range(3)]
    m.nbr_epochs = 200
    times, launches, epochs, rows = [], [], [], []
    for j in range(3):
        m.seed(7 + j)
        if device == 'cuda':
            torch.cuda.synchronize()
        before = sk.kmf_serial_converge.launches
        t0 = time.perf_counter()
        new = m.add_user('fold-%d' % j, items[j], vals[j])
        if device == 'cuda':
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(sk.kmf_serial_converge.launches - before)
        epochs.append(len(m.rmse_history))
        rows.append(m.P[new].copy())
    return dict(times=times, launches=launches, epochs=epochs, rows=rows,
                state=state, items=items, vals=vals, card=card)


def kmf_foldin_vs_cpu(m, fold):
    '''(b), the check: the first fold-in again on a CPU model built from
    the trained state (``interop.from_numpy``), its plain path.'''
    from mfrec_tpu_torch import interop
    from mfrec_tpu_torch.models.kmf import KMFRecommender
    P, Q, bu, bi = fold['state']
    c = interop.from_numpy(P, Q, bu, bi, m.overall_bias, m.ratings.coo(),
                           device='cpu', model_class=KMFRecommender,
                           parameters={'nbr_epochs': 200})
    c.seed(7)
    t0 = time.perf_counter()
    new = c.add_user('fold-0', fold['items'][0], fold['vals'][0])
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(c.P[new] - fold['rows'][0]).max())
    same = np.array_equal(c.P[new], fold['rows'][0])
    return err, same, cpu_ms


class K1Recorder:
    """While open, the alternating epoch's K1 calls go through a wrapper
    that keeps the inputs of the first ``count`` (the factors it updates
    and the fixed side, cloned before the launch, and the other
    arguments) and then launches K1 as before.  The epoch reaches K1 as
    ``sgd_mf.half_pass_kernel.half_pass``; that name is swapped for the
    time the recorder is open."""

    def __init__(self, count=2):
        self.count, self.calls = count, []

    def __enter__(self):
        from mfrec_tpu_torch.ops import half_pass_kernel, sgd_mf
        calls, count = self.calls, self.count
        real = half_pass_kernel.half_pass

        class Module:
            def __getattr__(self, name):
                return getattr(half_pass_kernel, name)

            @staticmethod
            def half_pass(F_upd, F_fix, *args, **kw):
                if len(calls) < count:
                    calls.append((F_upd.clone(), F_fix.clone(), args, kw))
                return real(F_upd, F_fix, *args, **kw)

        sgd_mf.half_pass_kernel = Module()
        return self

    def __exit__(self, *exc):
        from mfrec_tpu_torch.ops import half_pass_kernel, sgd_mf
        sgd_mf.half_pass_kernel = half_pass_kernel
        return False


def k1_kmf_cases(calls, hot, device='cuda'):
    """K1 as KMF's ``train()`` called it (phase k (a)): the recorded inputs
    of an epoch's user and item half-passes (the logistic link, f32 fixed
    side), on the first batch of each layout and on every batch holding
    the most-rated item ``hot`` (its chain), the kernel against
    ``half_pass_ref`` on the card at K1's window and SSE tolerances, a
    second launch bit-identical.  Returns the records."""
    import torch
    from mfrec_tpu_torch.ops.half_pass_kernel import build_segments, \
        half_pass, half_pass_ref
    if len(calls) != 2:
        raise SystemExit('KMF\'s train() made %d K1 calls, not an epoch\'s '
                         'two' % len(calls))
    dev = torch.device(device)
    (Pu, Pfix, uargs, ukw), (Qi, Qfix, iargs, ikw) = calls
    fix, r, m, kl, lo = iargs[0]
    rows = lo[:, None].long() + kl.long()
    hot_b = torch.nonzero(((rows == hot) & (m > 0)).any(1)).flatten()
    cases = [('user batch 0', Pu, Pfix, uargs, ukw, torch.tensor([0])),
             ('item batch 0', Qi, Qfix, iargs, ikw, torch.tensor([0])),
             ('hot item %d chain (%d batches)' % (hot, hot_b.numel()), Qi,
              Qfix, iargs, ikw, hot_b.cpu())]
    recs = []
    for name, F0, Ffix, args, kw, idx in cases:
        batches, W, rest = args[0], args[1], args[2:]
        link = rest[-1]
        sub = tuple(t[idx.to(t.device)] for t in batches)
        seg = build_segments(*(t.cpu().numpy() for t in sub), W, dev)
        kw = dict(kw, segments=seg)
        Fk = F0.clone()
        sse_k = float(half_pass(Fk, Ffix, sub, W, *rest, **kw))
        again = F0.clone()
        sse_a = float(half_pass(again, Ffix, sub, W, *rest, **kw))
        Fp = F0.clone()
        sse_p = float(half_pass_ref(Fp, Ffix, sub, W, *rest))
        diff = (Fk - Fp).abs()
        err = float(diff.max())
        sse_err = abs(sse_k - sse_p) / abs(sse_p) if sse_p else abs(sse_k)
        ok = bool((diff <= K1_ATOL + K1_RTOL * Fp.abs()).all()) and \
            bool(torch.isfinite(Fk).all()) and np.isfinite(sse_k) and \
            sse_err <= K1_SSE_RTOL and float((Fk - F0).abs().max()) > 0 \
            and bool(torch.equal(again, Fk)) and sse_a == sse_k and \
            link == 'logistic' and Ffix.dtype == torch.float32
        recs.append({'case': 'KMF ' + name, 'k': int(F0.shape[1]),
                     'T': int(rest[3]), 'ratings': int(seg.ent_r.numel()),
                     'link': link, 'fixed_side': str(Ffix.dtype),
                     'ok': ok, 'max_abs_err': err, 'sse_rel_err': sse_err})
        log('  K1 as train() called it, %-32s link %s, fixed side %s, k=%d, '
            'T=%d, %d ratings: ok=%s max_abs_err=%.3g sse_rel_err=%.3g'
            % (name, link, Ffix.dtype, F0.shape[1], rest[3],
               seg.ent_r.numel(), ok, err, sse_err))
        del Fk, again, Fp, diff
    bad = [r['case'] for r in recs if not r['ok']]
    if bad:
        raise SystemExit('K1 at KMF\'s layouts differs from its plain '
                         'version: %s' % bad)
    return recs


def phasek(device='cuda', U=ML10M['U'], I=ML10M['I'], nnz=ML10M['nnz']):
    '''KMF's main path on the card: (a) ``KMFRecommender.train()`` at the
    ML-10M shape, rank 64, engine 'auto' (K1's logistic build, f32 fixed
    side), timed as phase 4, then ``recommend_batch(predict_logistic)``
    through K3 against the plain top-n; (b) ``add_user`` with 20 ratings
    on that model through S2 (200 epochs, one launch), against a CPU
    model's plain path; (c) ``engine='serial'`` at the ML-100K shape (u1
    train split, 40 features, cut to KMF_SERIAL_EPOCHS), S2's epoch timed
    beside its bound and the plain version (on the first KMF_REDUCED
    ratings); (d) ``engine='fused'`` twice from one seed, bit for bit;
    (e) the workflow of ``tests/test_kmf.py::test_kmf_model_end_to_end``
    on the card against the CPU.  The launch counts are set to 0 before
    (a) and read after (c)'s training, the path this phase drives.'''
    import torch
    from mfrec_tpu_torch.data import ml100k_like
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    card = card_line()
    t_phase = time.perf_counter()
    u, i, v = ratings_stream(U, I, nnz)
    m = kmf_model(KMF_PARAMS, device, U, I, (u, i, v))
    uu, ii, vv = m.ratings.coo()
    floor = bias_floor_rmse(uu, ii, vv, U, I)
    log('phase k: KMFRecommender(%d, %d, rank %d).train() on %s, %d '
        'ratings, engine %s, batch %d, T=%d, K_users %g, K_items %g, lr '
        '%s (row-mean default); bias-only floor %.4f (%.1f s to build)'
        % (U, I, m.dimensionality, device, m.ratings.nnz, m.engine,
           m.batch_size, m.inner_steps, m.K_users, m.K_items, m._alt_lr(),
           floor, time.perf_counter() - t_phase))

    def train(epochs):
        m.nbr_epochs = epochs
        m.train()

    zero_launch_counts()
    with K1Recorder() as k1_calls:
        res = epochs_timed(train, lambda: m.rmse_history, card, device)
    hist, h5 = res['hist'], res['rmse']
    log('  (a) rmse per epoch (last 5-epoch run): %s; epoch %.4f s (median '
        'of 3), final rmse %.4f vs floor %.4f  [%s]'
        % (' '.join('%.4f' % x for x in h5), res['epoch_s'], h5[-1], floor,
           card))
    if not all(np.isfinite(hist)):
        raise SystemExit('non-finite KMF training RMSE: %s' % hist)
    if not h5[-1] < floor:
        raise SystemExit('KMF: final RMSE %.4f does not beat the bias-only '
                         'floor %.4f' % (h5[-1], floor))
    users = np.random.default_rng(3).choice(U, 256, replace=False)
    retrieval_vs_plain(m, users, ('predict_logistic',))
    fold = kmf_foldin(m, device)
    (tu, ti, tv), u_test = ml100k_like.u1_split(seed=0)
    U1, I1 = ml100k_like.N_USERS, ml100k_like.N_ITEMS
    ms = kmf_model({'engine': 'serial', 'nbr_epochs': KMF_SERIAL_EPOCHS},
                   device, U1, I1, (tu, ti, tv))
    t0 = time.perf_counter()
    ms.train()
    if device == 'cuda':
        torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    launches = {'k1': half_pass.launches, 'k3': topn_scores_kernel.launches,
                's2': sk.kmf_serial_converge.launches}
    s2_epochs = sk.kmf_serial_converge.epochs
    log('  (b) add_user with 20 ratings on the rank-%d model: %s ms a call '
        '(%s epochs, %s S2 launches and as many rmse reads)  [%s]'
        % (m.dimensionality, ' '.join('%.2f' % x for x in fold['times']),
           ' '.join(str(x) for x in fold['epochs']),
           ' '.join(str(x) for x in fold['launches']), card))
    log('  (c) engine=\'serial\' on the ML-100K u1 train split (%d x %d, %d '
        'ratings, %d features, cut to %d epochs): %.3f s, rmse %s'
        % (U1, I1, len(tv), ms.dimensionality, KMF_SERIAL_EPOCHS, serial_s,
           ' '.join('%.4f' % x for x in ms.rmse_history)))
    log('  launches over (a)-(c): K1 %d, K3 %d, S2 %d (%d serial epochs)'
        % (launches['k1'], launches['k3'], launches['s2'], s2_epochs))
    if device == 'cuda' and min(launches.values()) == 0:
        raise SystemExit('KMF\'s path never launched a kernel of its path: '
                         '%s' % launches)
    if device == 'cuda' and launches['s2'] != 4:
        raise SystemExit('S2 launched %d times for 3 fold-ins and one '
                         'serial train() (one a call)' % launches['s2'])
    if not (np.isfinite(ms.rmse_history).all()
            and len(ms.rmse_history) == KMF_SERIAL_EPOCHS):
        raise SystemExit('engine=\'serial\': %s' % ms.rmse_history)
    err, same, cpu_ms = kmf_foldin_vs_cpu(m, fold)
    log('  (b) the new row against a CPU model\'s plain path from the same '
        'state: bit-identical=%s, max abs err %.3g (tolerance %g); the CPU '
        'fold-in %.1f ms' % (same, err, KMF_FOLD_TOL, cpu_ms))
    if not err <= KMF_FOLD_TOL:
        raise SystemExit('the KMF fold-in on the card differs from the CPU '
                         'plain path')
    hot = int(np.bincount(ii, minlength=I).argmax())
    k1 = k1_kmf_cases(k1_calls.calls, hot, device)
    s2 = kmf_serial_timing(device)
    fused = kmf_fused_twice((tu, ti, tv), U1, I1, device)
    e2e = kmf_workflow(device)
    log('  phase k in %.1f s  [%s]' % (time.perf_counter() - t_phase, card))
    return dict(launches=launches, s2_epochs=s2_epochs,
                epoch_s=res['epoch_s'], epoch_s_blocks=res['epoch_s_blocks'],
                rmse=h5, floor=floor, add_ms=float(np.median(fold['times'])),
                add_ms_all=fold['times'], fold_err=err, serial_s=serial_s,
                s2=s2, fused=fused, e2e=e2e, k1=k1)


def kmf_ml100k(device):
    '''The stream ``engine='serial'`` walks at the ML-100K shape (the u1
    train split shuffled by a serial ``KMFRecommender``'s first draw from
    seed 0) and the state it starts from (the model's init draw at 40
    features, zero biases): (base, (u, i, r)).'''
    import torch
    from mfrec_tpu_torch.data import ml100k_like
    from mfrec_tpu_torch.models.kmf import KMFRecommender
    (tu, ti, tv), _ = ml100k_like.u1_split(seed=0)
    U, I = ml100k_like.N_USERS, ml100k_like.N_ITEMS
    m = KMFRecommender(U, I, {'engine': 'serial'}, device='cpu')
    m.seed(0)
    m.set_ratings(tu, ti, tv)
    m.init_feature_normal(0.0, 0.1)
    u, i, r = m.ratings.shuffled(int(m.rng.integers(2 ** 31)))

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    base = dict(P=t(m.P), Q=t(m.Q), bu=t(np.zeros(U, np.float32)),
                bi=t(np.zeros(I, np.float32)), uidx=t(u, np.int32),
                iidx=t(i, np.int32), r=t(r, np.float32))
    return base, (u, i, r)


def kmf_serial_timing(device):
    '''(c), the measurement: S2 on the stream ``engine='serial'`` walks
    (``kmf_ml100k``) by its plan: one epoch a launch and
    KMF_SERIAL_EPOCHS in one launch (CUDA events; device time), ns a
    rating and a round, beside the bound; the first epoch's state against
    the plain version on the CPU over the whole stream (within
    KMF_FOLD_TOL: the card's expf and the CPU's exp may differ by an ulp)
    and on the card over the first KMF_REDUCED ratings (bit for bit),
    both timed.'''
    import torch
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    card = card_line()
    base, (u, i, r) = kmf_ml100k(device)
    U, I = base['P'].shape[0], base['Q'].shape[0]
    k = int(base['P'].shape[1])
    n = len(r)
    plan = sk.kmf_plan(base['uidx'], base['iidx'], base['r'], device)
    kw = dict(min_epochs=KMF_SERIAL_EPOCHS, max_epochs=KMF_SERIAL_EPOCHS)

    def one():
        return s2_call(sk.kmf_serial_epoch, base, 'logistic', (True, True),
                       plan=plan)

    def many():
        return s2_call(sk.kmf_serial_converge, base, 'logistic',
                       (True, True), plan=plan, **kw)

    epoch_ms = timed_ms(one, 5)
    dev_ms, dev_n = kernel_device_ms(one, 'kmf_serial', 3)
    conv_ms = timed_ms(many, 3)
    chain = sk.chain_latency_ns(k, 'logistic', device)
    bound, bound_by, depth = s2_bound_ms(u, i, k, chain)
    full = [x.cpu() for x in one()]
    cpu = {x: v.cpu() for x, v in base.items()}
    t0 = time.perf_counter()
    want_full = s2_call(sk.kmf_serial_epoch_ref, cpu, 'logistic',
                        (True, True))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    full_same, full_err = s2_compare(full, want_full)
    red = dict(base, uidx=base['uidx'][:KMF_REDUCED],
               iidx=base['iidx'][:KMF_REDUCED], r=base['r'][:KMF_REDUCED])
    red_plan = sk.kmf_plan(red['uidx'], red['iidx'], red['r'], device)
    got = s2_call(sk.kmf_serial_epoch, red, 'logistic', (True, True),
                  plan=red_plan)
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    sync()
    t0 = time.perf_counter()
    want = s2_call(sk.kmf_serial_epoch_ref, red, 'logistic', (True, True))
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same, err = s2_compare(got, want)
    red_ms = timed_ms(lambda: s2_call(sk.kmf_serial_epoch, red, 'logistic',
                                      (True, True), plan=red_plan), 5)
    ru, ri = u[:KMF_REDUCED], i[:KMF_REDUCED]
    red_bound, red_by, red_depth = s2_bound_ms(ru, ri, k, chain)
    ns_round = (dev_ms if dev_ms is not None else epoch_ms) * 1e6 \
        / plan.rounds
    log('  (c) S2 at the ML-100K shape (%d ratings shuffled, %d x %d, k=%d, '
        'logistic): one epoch a launch %.4f ms (events), %s device (%d '
        'launches recorded), %.1f ns a rating; %d rounds an epoch (chunks '
        'of %d), %.1f ns a round (device); %d epochs in one launch %.4f '
        'ms, %.4f an epoch; bound %.4f ms (%s: longest dependency chain %d '
        'ratings x one rating\'s chain %.1f ns, the probe)  [%s]'
        % (n, U, I, k, epoch_ms, ms_or_not(dev_ms), dev_n,
           epoch_ms * 1e6 / n, plan.rounds, sk.CHUNK, ns_round,
           KMF_SERIAL_EPOCHS, conv_ms, conv_ms / KMF_SERIAL_EPOCHS, bound,
           bound_by, depth, chain, card))
    log('  (c) the whole stream\'s first epoch against the plain version on '
        'the CPU (%.0f ms there): bit-identical=%s, max abs err %.3g '
        '(tolerance %g)' % (cpu_ms, full_same, full_err, KMF_FOLD_TOL))
    if not full_err <= KMF_FOLD_TOL:
        raise SystemExit('S2 differs from its plain version on the CPU over '
                         'the ML-100K epoch')
    log('  (c) the first %d ratings of that stream, the first epoch from '
        'the model\'s init: S2 against its plain version on the card '
        'bit-identical=%s (max abs err %.3g); S2 %.4f ms, plain %.1f ms, '
        'bound %.5f ms (%s, chain %d)  [%s]'
        % (KMF_REDUCED, same, err, red_ms, plain_ms, red_bound, red_by,
           red_depth, card))
    if not same:
        raise SystemExit('S2 differs from its plain version on the ML-100K '
                         'stream')
    return dict(epoch_ms=epoch_ms, device_ms=dev_ms, converged_ms=conv_ms,
                ns_a_rating=epoch_ms * 1e6 / n, rounds=plan.rounds,
                ns_a_round=ns_round, bound_ms=bound,
                bound_by=bound_by, longest_chain=depth, chain_ns=chain,
                n=n, k=k, reduced_ms=red_ms, reduced_plain_ms=plain_ms,
                reduced_bound_ms=red_bound, reduced_bound_by=red_by,
                max_abs_err=err, full_cpu_err=full_err,
                full_cpu_same=full_same, full_cpu_plain_ms=cpu_ms)


def kmf_fused_twice(data, U, I, device):
    '''(d): ``engine='fused'`` on the ML-100K split twice from one seed (3
    epochs, the shipped defaults otherwise), P, Q and biases bit for
    bit.'''
    runs = []
    t0 = time.perf_counter()
    for _ in range(2):
        m = kmf_model({'engine': 'fused', 'nbr_epochs': 3}, device, U, I,
                      data)
        m.train()
        runs.append(m)
    same = all(np.array_equal(getattr(runs[0], x), getattr(runs[1], x))
               for x in ('P', 'Q', 'users_bias', 'items_bias')) and \
        runs[0].rmse_history == runs[1].rmse_history
    log('  (d) engine=\'fused\' trained twice from one seed (3 epochs, %.2f '
        's): rmse %s, P, Q and biases bit-identical=%s'
        % (time.perf_counter() - t0, ' '.join(
            '%.4f' % x for x in runs[0].rmse_history), same))
    if not (same and np.isfinite(runs[0].rmse_history).all()):
        raise SystemExit('the KMF fused tier does not repeat on the card')
    return dict(rmse=runs[0].rmse_history, same=same)


def kmf_workflow(device):
    '''(e): ``tests/test_kmf.py::test_kmf_model_end_to_end`` on the card
    and on the CPU (train, ``test_predict_rating(predict_logistic)``,
    ``find_recommended_items(predict_linear_neg)`` through the host
    scoring path, ``add_item``): the held-out RMSEs within
    KMF_E2E_RMSE_TOL, both under the constant-mean baseline; the host
    path's lists and ``add_item`` from the card model's state on the CPU
    model, equal.'''
    from mfrec_tpu_torch.data.movielens import synthetic_ratings, \
        train_test_split
    from mfrec_tpu_torch.eval.metrics import test_predict_rating
    (u, i, v), test = train_test_split(*synthetic_ratings(
        nbr_users=300, nbr_items=200, nbr_ratings=6000, rank=6, seed=1),
        test_fraction=0.2, seed=2)
    U, I = int(u.max()) + 1, int(i.max()) + 1
    params = {'nbr_epochs': 200, 'nbr_features': 8, 'learning_rate': 0.02,
              'regularization_users': 0.05, 'regularization_items': 0.05,
              'inner_steps': 8}
    out = {}
    for dev in (device, 'cpu'):
        m = kmf_model(params, dev, U, I, (u, i, v))
        t0 = time.perf_counter()
        m.train()
        train_s = time.perf_counter() - t0
        rmse = test_predict_rating(m, test, nbr_samples=len(test),
                                   predictor='predict_logistic',
                                   quiet=True)[0]
        out[dev] = (m, rmse, train_s)
    (c, rc, tc), (p, rp, tp) = out[device], out['cpu']
    base = float(np.sqrt(((test[:, 2] - v.mean()) ** 2).mean()))
    for name in ('P', 'Q', 'users_bias', 'items_bias'):
        setattr(p, name, np.array(getattr(c, name)))
    lists = [m.find_recommended_items(7, nbr_recommendations=10,
                                      predictor='predict_linear_neg')
             for m in (c, p)]
    rows = []
    for m in (c, p):
        m.seed(2)
        new = m.add_item('new-item', np.arange(6, dtype=np.int32),
                         np.full(6, 4.0, np.float32))
        rows.append(m.Q[new].copy())
    err = float(np.abs(rows[0] - rows[1]).max())
    log('  (e) tests/test_kmf.py\'s workflow: held-out rmse %.7f on the card '
        '(train %.2f s), %.7f on the CPU (%.2f s), card - CPU %.3g '
        '(tolerance %g), baseline %.4f; predict_linear_neg top-10 from the '
        'host path %s, the same on the CPU=%s; add_item\'s row card - CPU '
        '%.3g' % (rc, tc, rp, tp, rc - rp, KMF_E2E_RMSE_TOL, base,
                  lists[0][0], lists[0] == lists[1], err))
    if not (rc < base and rp < base and abs(rc - rp) <= KMF_E2E_RMSE_TOL
            and lists[0] == lists[1] and len(lists[0][0]) == 10
            and err <= KMF_FOLD_TOL):
        raise SystemExit('KMF\'s workflow on the card disagrees with the CPU')
    return dict(rmse=rc, rmse_cpu=rp, baseline=base, add_item_err=err)


def kmf_entry(s2, pk):
    '''S2's entry of the kernels line: the kernel and its plain version on
    the first KMF_REDUCED ratings of the ML-100K stream (phase k (c)),
    the full epoch beside them, the launches of phase k's path.'''
    if not pk:
        return []
    t = pk['s2']
    return [{
        'name': 'kmf_serial (S2, a call\'s serial kernel-MF epochs and '
                'their convergence rule; no TPU counterpart; redesigned: '
                'each 32-rating chunk run side by side on 16 warps from a '
                'host plan, rows handed over in shared memory)',
        'route': 'cuda', 'source': 'mfrec_tpu_torch/csrc/kmf_serial.cu',
        'replaces': 'mfrec_tpu/ops/kmf.py:34 (kmf_serial_epoch, a '
                    'lax.fori_loop outside any Pallas kernel; the driver '
                    'loop around it, mfrec_tpu/models/kmf.py:333)',
        'launches': pk['launches']['s2'],
        'max_abs_err': max(s2.get('max_abs_err', 0.0), t['max_abs_err'],
                           pk['fold_err'], t['full_cpu_err']),
        'ms': t['reduced_ms'], 'plain_ms': t['reduced_plain_ms'],
        'bound_ms': t['reduced_bound_ms'], 'bound_by': t['reduced_bound_by'],
        'library_ms': None,
        'shape': 'one epoch over the first %d ratings of the ML-100K u1 '
                 'train split shuffled, k=40, logistic' % KMF_REDUCED,
        'epoch_ms_ml100k': t['epoch_ms'], 'device_ms_ml100k': t['device_ms'],
        'ns_a_rating': t['ns_a_rating'], 'rounds_ml100k': t['rounds'],
        'ns_a_round': t['ns_a_round'], 'bound_ms_ml100k': t['bound_ms'],
        'chain_ns': t['chain_ns'], 'longest_chain': t['longest_chain'],
        'max_abs_err_ml100k_vs_cpu': t['full_cpu_err'],
        'plain_ms_ml100k_cpu': t['full_cpu_plain_ms'],
        'add_user_ms_rank64': pk['add_ms'],
        'serial_epochs_phase_k': pk['s2_epochs']}]


def ab_layouts(path):
    '''The W=128 ML-10M user and item layouts and the most-rated item,
    built once by the process that starts the A/B and loaded by each
    checkout's process from ``path`` (an .npz).'''
    if os.path.exists(path):
        z = np.load(path)
        lay = {a: tuple(z['%s%d' % (a, j)] for j in range(6)) + (128,)
               for a in ('user', 'item')}
        return lay, int(z['hot'])
    U, I, nnz = ML10M['U'], ML10M['I'], ML10M['nnz']
    lay = {a: stream_layout(U, I, nnz, a, 128) for a in ('user', 'item')}
    hot = int(np.bincount(unique_stream(U, I, nnz)[1]).argmax())
    np.savez(path, hot=hot, **{'%s%d' % (a, j): lay[a][j]
                               for a in lay for j in range(6)})
    return lay, hot


def ab_k1(lay, hot):
    '''K1 in this process's checkout: ``kernel_probe``'s hiT (us per
    batch and sweep), the ML-10M-shape user and item half-passes, the
    most-rated item's chain and the first 16 user batches, the item
    half-pass and chain through the logistic link's build, and each
    half-pass through the f32 builds at their models' widths and sweeps:
    SVD++'s (identity, k=102, T=32) and KMF's (logistic, k=66, T=64) (ms,
    CUDA events).'''
    from mfrec_tpu_torch.tools import kernel_probe as kp
    Paug, Qaug = _aug_factors(ML10M['U'], ML10M['I'], 64, 128, seed=1)
    Pw, Qw = _aug_factors(ML10M['U'], ML10M['I'], 100, 128, seed=1)
    hit = kp.hit_mode(kp.probe_data('cuda'), reps=3, iters=3,
                      log=lambda x: None)
    out = {'hit_us': 1e6 * hit['marg_8_32']}
    svdpp = dict(ff32=True, T=32)
    kmf = dict(LOGISTIC, ff32=True, T=64)
    for name, F, G, axis, row, opts in (
            ('user_ms', Paug, Qaug, 'user', None, {}),
            ('item_ms', Qaug, Paug, 'item', None, {}),
            ('chain_ms', Qaug, Paug, 'item', hot, {}),
            ('item_ms_logistic', Qaug, Paug, 'item', None, LOGISTIC),
            ('chain_ms_logistic', Qaug, Paug, 'item', hot, LOGISTIC),
            ('user_ms_f32_k102', Pw, Qw, 'user', None, svdpp),
            ('item_ms_f32_k102', Qw, Pw, 'item', None, svdpp),
            ('user_ms_logistic_f32', Paug, Qaug, 'user', None, kmf),
            ('item_ms_logistic_f32', Qaug, Paug, 'item', None, kmf)):
        out[name] = k1_kernel_ms(F, G, lay[axis], axis, iters=3,
                                 only_row=row, **opts)[0]
    out['first16_user_ms'] = k1_kernel_ms(
        Paug, Qaug, tuple(a[:16] for a in lay['user'][:-1]) + (128,), 'user',
        iters=5)[0]
    return out


def ab_k1f(lay):
    '''FN's user half-pass at its width (k = 102, f32 fixed rows, T = 32,
    every rate but b_u's zero) over the W=128 ML-10M user layout in this
    process's checkout: through K1 (the parent's path; ms, CUDA events)
    and, where the checkout has K1f, through K1f: its time and bound on
    the whole half-pass and on the first 16 batches, its plain version's
    time there, and its agreement with K1's plain version (``k1f_case``).'''
    import importlib.util
    import torch
    from mfrec_tpu_torch.ops import sgd_mf
    from mfrec_tpu_torch.ops.half_pass_kernel import half_pass
    Pw, Qw = _aug_factors(ML10M['U'], ML10M['I'], 100, 128, seed=1)
    dev = torch.device('cuda')
    pl = sgd_mf.PassLayout(lay['user'], 'user', dev, segments=True)
    lrv, regv = (torch.from_numpy(a).to(dev) for a in sgd_mf.column_rates(
        100, True, 0.15, 0.02, 0.02, 0.15, 0.15, 0.01, 0.01, True,
        freeze_user_factors=True))
    F = torch.from_numpy(Pw).to(dev)
    G = torch.from_numpy(Qw).to(dev)
    out = {'k1_ms': timed_ms(lambda: half_pass(
        F, G, pl.batches(), 128, lrv, regv, 3.5, 32, segments=pl.segments),
        5)}
    del F, G, pl
    if importlib.util.find_spec(
            'mfrec_tpu_torch.ops.frozen_half_pass_kernel') is None:
        return out
    first = k1f_case('ab k1f first 16 user batches', Pw, Qw, lay['user'],
                     batches=range(16), iters=5, plain_iters=2)
    whole = k1f_case('ab k1f whole user half-pass', Pw, Qw, lay['user'],
                     iters=5, plain_iters=0)
    out.update(k1f_ms=whole['ms'], k1_ms_same_process=whole['k1_ms'],
               bound_ms=whole['bound_ms'], bound_by=whole['bound_by'],
               k1f_ms_first16=first['ms'], plain_ms_first16=first['plain_ms'],
               bound_ms_first16=first['bound_ms'],
               ok=first['ok'] and whole['ok'],
               max_abs_err=max(first['max_abs_err'], whole['max_abs_err']))
    return out


def ab_k1_rows(lay, hot):
    '''The item half-pass and the hot chain (ms) with K1's cluster rows
    at ``CLUSTER_ROW`` 4,096, 16,384 and none.'''
    from mfrec_tpu_torch.ops import half_pass_kernel as hk
    Paug, Qaug = _aug_factors(ML10M['U'], ML10M['I'], 64, 128, seed=1)
    out = {}
    for row in (4096, 16384, 10 ** 9):
        hk.CLUSTER_ROW = row
        item = k1_kernel_ms(Qaug, Paug, lay['item'], 'item', iters=3)
        chain = k1_kernel_ms(Qaug, Paug, lay['item'], 'item', iters=3,
                             only_row=hot)[0]
        out['cluster_row_%d' % row] = dict(item_ms=item[0], chain_ms=chain,
                                           cluster_rows=item[3].n_cluster)
    return out


def ab_k4(lay):
    '''One per-call ``window_aggregate`` at the JAX shape (user batch 0,
    W=128, k=66) and on the hottest item batch, beside ``index_add_`` of
    the same pre-rounded rows: CUDA events around one call (host
    included) and device time (``device_ms``).'''
    import torch
    from mfrec_tpu_torch.ops.window_agg_kernel import window_aggregate
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    hb, _ = _longest_run_batch(lay['item'])
    out = {}
    for name, L, b in (('jax_shape', lay['user'], 0),
                       ('hot_batch', lay['item'], hb)):
        g = torch.from_numpy(rng.normal(0, 1, (L[4].shape[1], 66)).astype(
            np.float32)).to(dev)
        kl = torch.from_numpy(np.ascontiguousarray(L[4][b])).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(L[3][b])).to(dev)
        keep = m > 0
        idx, g16 = kl[keep].long(), g[keep].to(torch.bfloat16).float()
        acc = torch.zeros((128, 66), device=dev)
        for what, fn in (
                ('kernel', lambda: window_aggregate(g, kl, m, 128,
                                                    check_ids=False)),
                ('index_add_', lambda: acc.index_add_(0, idx, g16))):
            out['%s_%s' % (name, what)] = dict(event_ms=timed_ms(fn, 50),
                                               device_ms=device_ms(fn))
    return out


K3_AB_CASES = (
    ('bench_exact', dict(B=1024, I=360_000, k=64, n=10, L=0, fast=False)),
    ('bench_exact_rated64', dict(B=1024, I=360_000, k=64, n=10, L=64,
                                 fast=False)),
    ('bench_fast', dict(B=1024, I=360_000, k=64, n=10, L=0, fast=True)),
    ('bench_fast_rated64', dict(B=1024, I=360_000, k=64, n=10, L=64,
                                fast=True)),
    ('serving_exact', dict(B=256, I=10_677, k=64, n=10, L=256, fast=False)),
    ('serving_fast', dict(B=256, I=10_677, k=64, n=10, L=256, fast=True)))


def k3_split(fn, n=20):
    '''Device time per call of each kernel ``fn`` launches (torch.profiler,
    ms, by the kernel's name without its arguments and namespace).'''
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, (count, ms) in device_kernels(prof).items():
        m = re.search(r'(\w+)\s*[<(]',
                      name.replace('(anonymous namespace)::', ''))
        short = m.group(1) if m else name[:40]
        c, t = out.get(short, (0, 0.0))
        out[short] = (c + count, t + ms)
    return {x: dict(launches_per_call=c / n, ms=t / n)
            for x, (c, t) in out.items()}


def k3_host_us(fn, calls=200):
    '''Host microseconds per wrapper call: the enqueue of ``calls``
    back-to-back calls on the host clock, before the device is waited
    for (the device's work per call is shorter, so the queue never
    fills).'''
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * host / calls


def ab_k3():
    '''K3 in this process's checkout at the bench shape (exact, exact with
    64 rated ids, fast, fast rated) and the serving batch (exact, fast),
    on ``k3_inputs``' seeded inputs: CUDA events around one call, the
    device time of each kernel it launches, and at the serving batch the
    host microseconds per wrapper call; and the device time under other
    split rules (resident blocks x tiles, ``topn_plan``'s arguments).'''
    from mfrec_tpu_torch.ops import topn_kernel as tk
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    out = {}
    for name, c in K3_AB_CASES:
        t = k3_inputs(**c, q_bf16=c['fast'])
        call = functools.partial(topn_scores_kernel, *t['args'],
                                 **t['kw'])
        rec = {'event_ms': timed_ms(call, 20 if c['B'] > 256 else 50),
               'device_ms': device_ms(call), 'kernels': k3_split(call)}
        if c['B'] <= 256:
            rec['host_us'] = k3_host_us(call)
        comp = k3_composed(t['args'], t['kw'])
        rec['composed_event_ms'] = timed_ms(comp, 10)
        rec['composed_device_ms'] = device_ms(comp, 10)
        rec['composed_f32_out'] = comp.f32_out
        out[name] = rec
        del comp
        if hasattr(tk, 'MIN_TILES_PER_SPLIT'):
            plan = tk.topn_plan
            try:       # the grid's split rule: resident blocks x tiles
                for slots, mt in ((132, 1), (198, 1), (264, 1), (264, 2)):
                    tk.topn_plan = (lambda B, I, n, _s, min_tiles=None,
                                    S=slots, M=mt: plan(B, I, n, S, M))
                    rec['device_ms_slots_%d_min_tiles_%d' % (slots, mt)] = \
                        device_ms(call)
            finally:
                tk.topn_plan = plan
    return out


def ab_als_data(path):
    '''bench_als's data and buckets (69,878 x 10,677, 23M raw implicit
    draws), built once by the process that starts the A/B and loaded by
    each checkout's process from ``path`` (an .npz): (user buckets, item
    buckets).'''
    if os.path.exists(path):
        z = np.load(path)
        return tuple([tuple(z['%s%d_%d' % (a, j, t)] for t in range(4))
                      for j in range(int(z['n_' + a]))]
                     for a in ('user', 'item')) + (z['users'], z['items'])
    from mfrec_tpu_torch.data.movielens import ratings_from_arrays
    users, items, _, _ = make_implicit_data(ALS['U'], ALS['I'], ALS['N'],
                                            seed=0)
    r = ratings_from_arrays(users, items, np.ones(users.shape[0],
                                                  np.float32),
                            ALS['U'], ALS['I'])
    bks = {a: r.padded_rows(axis=a) for a in ('user', 'item')}
    arrays = {'n_' + a: len(bks[a]) for a in bks}
    arrays.update(users=users, items=items)
    arrays.update({'%s%d_%d' % (a, j, t): x for a in bks
                   for j, bk in enumerate(bks[a]) for t, x in enumerate(bk)})
    np.savez(path, **arrays)
    return bks['user'], bks['item'], users, items


def ab_als(ub, ib, users, items):
    '''The CG path in this process's checkout, at bench_als's shape,
    from factors N(0, 0.1) (seed 0) after one 6-step epoch: one warm
    epoch (``cg_epoch``, 3 steps) and each half-sweep
    (``als_half_sweep_cg``) by CUDA events (median of 5),
    ``_bucket_cg_body`` on the largest user bucket and the hottest item
    bucket at 3 steps (median of 10), and the public
    ``WRMFRecommender.train()`` (phase 5's parameters) on the host clock
    at 0 epochs (its fixed set-up), 3 (bench_als's ``epochs``) and 22,
    the median of 3 each after one warm-up call.'''
    import torch
    from mfrec_tpu_torch.ops import als as als_ops
    dev = torch.device('cuda')
    U, I, K, reg = ALS['U'], ALS['I'], 64, 0.015
    rng = np.random.default_rng(0)
    P = torch.from_numpy(rng.normal(0, 0.1, (U, K)).astype(np.float32)).to(dev)
    Q = torch.from_numpy(rng.normal(0, 0.1, (I, K)).astype(np.float32)).to(dev)
    ubd = als_ops.device_buckets(ub, dev)
    ibd = als_ops.device_buckets(ib, dev)
    alive = [torch.from_numpy(als_ops._alive_mask(bk, n)).to(dev)
             for bk, n in ((ub, U), (ib, I))]
    P, Q = als_ops.cg_epoch(P, Q, alive[0], alive[1], ubd, ibd, 1.0, 0.0,
                            reg, 6, 'pallas')
    out = {'epoch_ms': timed_ms(lambda: als_ops.cg_epoch(
        P, Q, alive[0], alive[1], ubd, ibd, 1.0, 0.0, reg, 3, 'pallas'), 5)}
    out['user_half_sweep_ms'] = timed_ms(lambda: als_ops.als_half_sweep_cg(
        Q, P, ubd, 1.0, 0.0, reg, 3), 5)
    out['item_half_sweep_ms'] = timed_ms(lambda: als_ops.als_half_sweep_cg(
        P, Q, ibd, 1.0, 0.0, reg, 3), 5)
    big = max(range(len(ubd)), key=lambda j: ubd[j][0].shape[0])
    hot = max(range(len(ibd)), key=lambda j: ibd[j][1].shape[1])
    for name, F, upd, bk in (('user_bucket_ms', Q, P, ubd[big]),
                             ('item_bucket_ms', P, Q, ibd[hot])):
        HHreg, Fb, upd = als_ops._hh(F, reg), F.to(torch.bfloat16), upd.clone()
        out[name] = timed_ms(lambda: als_ops._bucket_cg_body(
            Fb, upd, HHreg, *bk, 1.0, 0.0, reg, 3, 'pallas'), 10)
        out[name.replace('_ms', '_shape')] = list(bk[1].shape)
    del ubd, ibd, P, Q
    from mfrec_tpu_torch.models.wrmf import WRMFRecommender
    m = WRMFRecommender(U, I, ALS_PARAMS, device='cuda')
    m.set_ratings(users, items, np.ones(users.shape[0], np.float32))

    def train_s(epochs):
        m.nbr_epochs = epochs
        torch.cuda.synchronize()
        t = time.perf_counter()
        m.train()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    train_s(1)
    for n in (0, 3, 22):
        out['train_s_%d_epochs' % n] = float(np.median(
            [train_s(n) for _ in range(3)]))
    return out


def _s1_count(sk):
    '''S1's launch counter in either design: ``serial_converge``'s, or
    the one-epoch-a-launch ``serial_epoch``'s.'''
    return getattr(sk, 'serial_converge', sk.serial_epoch)


def ab_s1(reps=3):
    '''S1 in this process's checkout: the ML-100K feature epoch (the
    shuffled stream, 'fixed'; CUDA events and device time, ns a rating);
    one converged feature through the public API (``engine='funk'``, one
    feature, example 2's settings, the u1 train split; host clock); and
    ``add_user`` (20 ratings at rank 64 on a random ML-10M-shape model;
    example 2's items 0-9 at 16 features on its fused-trained model), ms
    a call, S1 launches a call and host reads of an rmse a call (one a
    launch in both designs).  Medians of ``reps``.'''
    import torch
    from mfrec_tpu_torch import interop
    from mfrec_tpu_torch.data import ml100k_like
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops import serial_kernel as sk
    dev = 'cuda'
    count = _s1_count(sk)
    out = {}
    shuffled, _, (U, I, n) = ml100k_stream(dev)
    kw = {}
    if hasattr(sk, 'serial_plan'):
        kw['plan'] = sk.serial_plan(shuffled['uidx'], shuffled['iidx'],
                                    False, dev)
    pf = shuffled['P'][:, 0].contiguous()
    qf = shuffled['Q'][:, 0].contiguous()
    bu, bi = shuffled['bu'].clone(), shuffled['bi'].clone()

    def epoch():
        sk.serial_epoch(pf, qf, shuffled['cache'], shuffled['uidx'],
                        shuffled['iidx'], shuffled['r'], 0, 16, 0.1, 0.01,
                        0.02, 3.53, bu, bi, 0.005, 0.006, 0.012, 0.004,
                        bias_mode='fixed', **kw)

    out['epoch_ms'] = timed_ms(epoch, 10)
    out['epoch_device_ms'], out['epoch_device_n'] = kernel_device_ms(
        epoch, 'serial_funk', 10)
    out['epoch_ns_a_rating'] = out['epoch_ms'] * 1e6 / n
    data = ml100k_like.u1_split(seed=0)
    (users, items, values), _ = data
    Uu, Ii = int(users.max()) + 1, int(items.max()) + 1

    def sync():
        torch.cuda.synchronize()

    feat = []
    for _ in range(reps):
        m = GDRecommender(Uu, Ii, dict(EX2_PARAMS, nbr_features=1,
                                       engine='funk', learning_rate=0.01),
                          device=dev)
        m.seed(0)
        m.set_ratings(users, items, values)
        before = count.launches
        sync()
        t0 = time.perf_counter()
        m.train(handle_bias=True)
        sync()
        feat.append(((time.perf_counter() - t0) * 1e3,
                     count.launches - before, len(m.rmse_history)))
    out['feature_ms'] = float(np.median([x[0] for x in feat]))
    out['feature_ms_all'] = [x[0] for x in feat]
    out['feature_launches'], out['feature_epochs'] = feat[0][1:]
    out['feature_reads'] = feat[0][1]

    def adds(m, calls):
        rec = []
        for j, (its, vals) in enumerate(calls):
            before = count.launches
            sync()
            t0 = time.perf_counter()
            m.add_user('ab-%d' % j, its, vals)
            sync()
            rec.append(((time.perf_counter() - t0) * 1e3,
                        count.launches - before))
        return ([x[0] for x in rec], [x[1] for x in rec])

    m = GDRecommender(Uu, Ii, dict(EX2_PARAMS, engine='fused',
                                   learning_rate=0.01), device=dev)
    m.seed(0)
    m.set_ratings(users, items, values)
    m.train(handle_bias=True)
    ms, la = adds(m, [(np.arange(10, dtype=np.int32),
                       np.full(10, 5.0, np.float32))] * reps)
    out.update(add_user_ms_16=float(np.median(ms)), add_user_ms_16_all=ms,
               add_user_launches_16=la[0], add_user_reads_16=la[0])
    rng = np.random.default_rng(4)
    Um, Im, k = ML10M['U'], ML10M['I'], 64
    P = rng.normal(0, 0.1, (Um, k)).astype(np.float32)
    Q = rng.normal(0, 0.1, (Im, k)).astype(np.float32)
    bu0 = rng.normal(0, 0.3, Um).astype(np.float32)
    bi0 = rng.normal(0, 0.3, Im).astype(np.float32)
    ru = rng.integers(0, Um, 100_000).astype(np.int32)
    ri = rng.integers(0, Im, 100_000).astype(np.int32)
    rv = rng.integers(1, 6, 100_000).astype(np.float32)
    m = interop.from_numpy(P, Q, bu0, bi0, 3.5, (ru, ri, rv), device=dev,
                           parameters=dict(EX2_PARAMS, nbr_features=k,
                                           learning_rate=0.01))
    m.seed(7)
    ms, la = adds(m, [(rng.choice(Im, 20, replace=False).astype(np.int32),
                       rng.integers(1, 6, 20).astype(np.float32))
                      for _ in range(reps)])
    out.update(add_user_ms_64=float(np.median(ms)), add_user_ms_64_all=ms,
               add_user_launches_64=la, add_user_reads_64=la,
               add_user_epochs_64=len(m.rmse_history))
    return out


def ab_s2(reps=3):
    '''S2 in this process's checkout: the ML-100K epoch of phase k (c)
    (``kmf_ml100k``; one epoch a launch, CUDA events and device time, ns
    a rating), its 3-epoch launch, the rank-64 fold-in stream alone (one
    user, 20 items fixed, 200 epochs in one launch; events and device
    time), and ``add_user`` with 20 ratings on a random ML-10M-shape
    rank-64 KMF model (the shipped 200 epochs; ms, S2 launches and rmse
    reads a call).  A stream's plan, where the checkout has one, is built
    once and not timed.  Medians of ``reps`` (the add_user calls) or of
    the timed runs.'''
    import torch
    from mfrec_tpu_torch import interop
    from mfrec_tpu_torch.models.kmf import KMFRecommender
    from mfrec_tpu_torch.ops import kmf_serial_kernel as sk
    dev = 'cuda'
    out = {}

    def planned(d):
        if not hasattr(sk, 'kmf_plan'):
            return {}
        plan = sk.kmf_plan(d['uidx'], d['iidx'], d['r'], dev)
        out.setdefault('rounds', plan.rounds)
        return {'plan': plan}

    base, (u, i, r) = kmf_ml100k(dev)
    kw = planned(base)

    def epoch():
        return s2_call(sk.kmf_serial_epoch, base, 'logistic', (True, True),
                       **kw)

    def three():
        return s2_call(sk.kmf_serial_converge, base, 'logistic',
                       (True, True), min_epochs=3, max_epochs=3, **kw)

    out['epoch_ms'] = timed_ms(epoch, 10)
    out['epoch_device_ms'], out['epoch_device_n'] = kernel_device_ms(
        epoch, 'kmf_serial', 10)
    out['epoch_ns_a_rating'] = out['epoch_ms'] * 1e6 / len(r)
    out['three_epochs_ms'] = timed_ms(three, 5)
    rng = np.random.default_rng(4)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fd = dict(P=t(rng.normal(0, 0.1, (1, 64)).astype(np.float32)),
              Q=t(rng.normal(0, 0.1, (20, 64)).astype(np.float32)),
              bu=t(np.zeros(1, np.float32)),
              bi=t(rng.normal(0, 0.3, 20).astype(np.float32)),
              uidx=t(np.zeros(20, np.int32)),
              iidx=t(np.arange(20, dtype=np.int32)),
              r=t(rng.integers(1, 6, 20).astype(np.float32)))
    fkw = planned(fd)

    def fold():
        return s2_call(sk.kmf_serial_converge, fd, 'logistic',
                       (True, False), min_epochs=200, max_epochs=200, **fkw)

    out['foldin_stream_ms'] = timed_ms(fold, 10)
    out['foldin_stream_device_ms'], _ = kernel_device_ms(fold, 'kmf_serial',
                                                          10)
    Um, Im, k = ML10M['U'], ML10M['I'], 64
    P = rng.normal(0, 0.1, (Um, k)).astype(np.float32)
    Q = rng.normal(0, 0.1, (Im, k)).astype(np.float32)
    bu0 = rng.normal(0, 0.3, Um).astype(np.float32)
    bi0 = rng.normal(0, 0.3, Im).astype(np.float32)
    ru = rng.integers(0, Um, 100_000).astype(np.int32)
    ri = rng.integers(0, Im, 100_000).astype(np.int32)
    rv = rng.integers(1, 6, 100_000).astype(np.float32)
    m = interop.from_numpy(P, Q, bu0, bi0, 3.5, (ru, ri, rv), device=dev,
                           model_class=KMFRecommender,
                           parameters={'nbr_features': k, 'nbr_epochs': 200})
    m.seed(7)
    rec = []
    for j in range(reps):
        items = rng.choice(Im, 20, replace=False).astype(np.int32)
        vals = rng.integers(1, 6, 20).astype(np.float32)
        before = sk.kmf_serial_converge.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.add_user('ab-%d' % j, items, vals)
        torch.cuda.synchronize()
        rec.append(((time.perf_counter() - t0) * 1e3,
                    sk.kmf_serial_converge.launches - before,
                    len(m.rmse_history)))
    out.update(add_user_ms_64=float(np.median([x[0] for x in rec])),
               add_user_ms_64_all=[x[0] for x in rec],
               add_user_launches_64=[x[1] for x in rec],
               add_user_reads_64=[x[1] for x in rec],
               add_user_epochs_64=rec[0][2])
    return out


AB_MODES = ('k1', 'k1f', 'k4', 'k1-rows', 'als', 'k3', 's1', 's2')


def ab_main(mode, checkouts, child):
    '''``--ab``: each checkout measured in a process of its own (its own
    ``mfrec_tpu_torch`` and kernel builds, this script's measurement), in
    the order given; one ``AB <mode> {...}`` JSON line per checkout.'''
    als = mode == 'als'
    cache = os.path.join(REPO, 'mfrec_tpu_torch', '_build',
                         'ab_als.npz' if als else 'ab_layouts.npz')
    if child:
        checkout = os.path.abspath(checkouts[0])
        os.chdir(checkout)
        sys.path.insert(0, checkout)
        from mfrec_tpu_torch.ops import _cuda_build
        from mfrec_tpu_torch.ops import half_pass_kernel as hk
        if mode == 'k3':
            _cuda_build.build(['topn'])
            out = ab_k3()
        elif mode == 's1':
            _cuda_build.build(['serial_funk'])
            out = ab_s1()
        elif mode == 's2':
            _cuda_build.build(['kmf_serial'])
            out = ab_s2()
        elif als:
            _cuda_build.build([x for x in ('pcg', 'cg_bucket') if os.path.exists(
                os.path.join(checkout, 'mfrec_tpu_torch', 'csrc', x + '.cu'))])
            out = ab_als(*ab_als_data(cache))
        else:
            _cuda_build.build(tuple(getattr(hk, 'LIBRARIES',
                                            {0: 'half_pass'}).values())
                              + ('window_agg',) + tuple(
                x for x in ('frozen_half_pass',) if os.path.exists(
                    os.path.join(checkout, 'mfrec_tpu_torch', 'csrc',
                                 x + '.cu'))))
            lay, hot = ab_layouts(cache)
            out = {'k1': lambda: ab_k1(lay, hot),
                   'k1f': lambda: ab_k1f(lay),
                   'k1-rows': lambda: ab_k1_rows(lay, hot),
                   'k4': lambda: ab_k4(lay)}[mode]()
        out.update(checkout=checkout, card=card_line())
        print('AB %s %s' % (mode, json.dumps(out)), flush=True)
        return 0
    if mode in ('k3', 's1', 's2'):   # seeded inputs made in each process
        return max(subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--ab', mode,
             '--ab-child', d]).returncode for d in checkouts)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        os.remove(cache)
    if als:
        ab_als_data(cache)
    else:
        ab_layouts(cache)
    rc = 0
    try:
        for d in checkouts:
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                                  '--ab', mode, '--ab-child', d]).returncode
    finally:
        os.remove(cache)
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[1])
    ap.add_argument('--phases', default='123456789k',
                    help='which phases to run (default: all)')
    ap.add_argument('--ab', choices=AB_MODES,
                    help='instead of the phases, time K1, K3, K4, S1, S2 or '
                         'the ALS CG path in each checkout given, in the '
                         'order given')
    ap.add_argument('--ab-child', action='store_true', help=argparse.SUPPRESS)
    ap.add_argument('checkouts', nargs='*', help='checkouts for --ab')
    args = ap.parse_args(argv)
    if args.checkouts and not args.ab:
        ap.error('checkouts are for --ab')
    if not os.path.isdir(os.path.join(REPO, 'mfrec_tpu_torch')):
        log('chip_smoke: mfrec_tpu_torch is not beside this script')
        return 2
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        log('chip_smoke: no CUDA device (torch.cuda.is_available() is '
            'False)')
        return 2
    if args.ab:
        return ab_main(args.ab, args.checkouts, args.ab_child)
    if '1' in args.phases:
        phase1()
    k3_recs, (k1_recs, k1_time), k2_recs, k4, s1, s2 = phase2() \
        if '2' in args.phases else ([], ([], {}), {'pcg': [], 'bucket': []},
                                    {}, {}, {})
    launches, worst = phase3() if '3' in args.phases else (None, 0.0)
    train = phase4() if '4' in args.phases else {}
    als = phase5() if '5' in args.phases else {}
    svdpp = phase6() if '6' in args.phases else {}
    fn = phase7() if '7' in args.phases else {}
    p8 = phase8() if '8' in args.phases else {}
    p9 = phase9() if '9' in args.phases else {}
    pk = phasek() if 'k' in args.phases else {}
    if k3_recs:
        main1 = k1_recs[0]
        print(json.dumps({'kernels': k3_entry(k3_recs, launches, worst) + [{
            'name': 'half_pass (K1, fused sorted-window SGD batch step)',
            'route': 'cuda',
            'source': 'mfrec_tpu_torch/csrc/half_pass.cuh',
            'replaces': 'mfrec_tpu/ops/pallas_half_pass.py:274',
            'launches': train.get('k1_launches'),
            'max_abs_err': max(r['max_abs_err']
                               for r in k1_recs + pk.get('k1', [])),
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
            'ms_half_pass_item_logistic': k1_time['logistic']['item'],
            'ms_longest_chain_logistic': k1_time['logistic']['chain'],
            'epoch_s': train.get('epoch_s'),
            'launches_phase8': p8.get('launches', {}).get('k1'),
            'launches_kmf': pk.get('launches', {}).get('k1'),
            'max_abs_err_kmf': max((r['max_abs_err'] for r in
                                    pk.get('k1', [])), default=None),
            'epoch_s_kmf': pk.get('epoch_s')}] + k1f_entry(k1_time, fn)
            + k2_entry(k2_recs, als) + k4_entry(k4, svdpp, fn)
            + b1_entry(k4, train, svdpp)
            + probe_entries(p8) + serial_entry(s1, p9)
            + kmf_entry(s2, pk)}))
    log(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
