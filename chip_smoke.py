#!/usr/bin/env python3
'''
Smoke run of the PyTorch/CUDA port (``mfrec_tpu_torch``) on one GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --phases 12  # toolchain + kernel checks only

Phase 1  the toolchain: torch/CUDA/nvcc versions, the card, and the
         build of every kernel from ``mfrec_tpu_torch/csrc``.
Phase 2  each kernel against its plain PyTorch twin on the card, at the
         shapes the serving path and the retrieval bench give it, plus
         edge shapes; median times of kernel and twin.
Phase 3  the serving slice end to end at the ML-10M shape (69,878 users x
         10,677 items, rank 64): model -> checkpoint -> reload ->
         ``RecommenderServer`` ('xla' then 'fast' retrieval) answering
         concurrent HTTP requests, served lists checked against the twin,
         and the kernels' launch counts over that phase.

Any failure exits non-zero.  On success the line before the last is the
kernels' JSON summary and the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA device; imports no JAX.
'''
from __future__ import annotations

import argparse
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
    from mfrec_tpu_torch.ops import _cuda_build, topn_kernel
    log('phase 1: python %s, torch %s, CUDA %s' % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))
    nv = subprocess.run([_cuda_build.nvcc_path(), '--version'],
                        capture_output=True, text=True, check=True).stdout
    log('nvcc: %s' % nv.strip().splitlines()[-1])
    log('card: %s' % card_line())
    t0 = time.perf_counter()
    topn_kernel._library()
    log('built csrc/topn.cu in %.1f s' % (time.perf_counter() - t0))
    log(_cuda_build.build_log('topn') or '')


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
    from mfrec_tpu_torch.data.movielens import synthetic_ratings
    from mfrec_tpu_torch.models.gd import GDRecommender
    from mfrec_tpu_torch.ops.topn_kernel import topn_scores_kernel
    from mfrec_tpu_torch.serving import RecommenderServer

    K = 64
    t0 = time.perf_counter()
    u, i, v = synthetic_ratings(U, I, nbr_ratings=nnz, rank=16, seed=0)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[1])
    ap.add_argument('--phases', default='123',
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
    recs = phase2() if '2' in args.phases else []
    launches, worst = phase3() if '3' in args.phases else (None, 0.0)
    if recs:
        print(json.dumps({'kernels': [{
            'name': 'topn (K3, fused top-n retrieval)', 'route': 'cuda',
            'source': 'mfrec_tpu_torch/csrc/topn.cu',
            'replaces': 'mfrec_tpu/ops/pallas_topk.py:90',
            'launches': launches,
            'max_abs_err': max([worst] + [r['max_abs_err'] for r in recs]),
            'ms': recs[0]['ms'], 'plain_ms': recs[0]['plain_ms'],
            'ms_fast': recs[2]['ms'], 'plain_ms_fast': recs[2]['plain_ms'],
            'shape': 'B=1024 I=360000 k=64 n=10'}]}))
    log(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
