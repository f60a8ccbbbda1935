'''
Deletion profiling of the sorted-window batch step's marginal sweep on
the card.

Port of ``tools/kernel_probe.py``.  The probe times kernel variants (P2,
``ops/probe_kernel.py``) that each delete or re-round one part of K1's
sweep, at T=2 and T=10 sweeps per call, so that

    marginal_sweep = (t(T=10) - t(T=2)) / (8 * N_BATCH)

is the per-sweep cost with the variant's part deleted (compile-time
constants and the per-call fixed cost cancel).  Each timed run chains
N_BATCH calls on one batch (each call's window feeds the next: one
launch over N_BATCH copies) and is timed by CUDA events around that
launch.  The probe's shape: one batch of B=16,384 ratings with sorted
window ids in a W=128 window, f32 fixed rows, k=66 (64 and 128 in the
lane-alignment cases), 128 rows on 132 SMs: a sweep is one block's
latency.  The variants' names and the functions they compute are in
``ops/probe_kernel.py``; since P2 runs K1's design, each variant's
difference from ``full`` is a deletion from K1's own code.

Modes (the JAX tool's case lists, unchanged): '' (the default:
full, no_fu, no_acc, no_elem, and full at k=64 and 128), 'fix', 'dot',
'ohT', 'all2d', and

  hiT  K1 itself (``ops.half_pass_kernel.half_pass``, bf16 fixed side)
       chained at T=8, 32 and 64, the marginal sweep from adjacent rungs
       (K1 has no chunk: the JAX tool's ch axis has no counterpart);
  grp  K1 over G in {8, 32} batches at random window starts into a
       factor array of 70,136 or 512 rows ([rows, 66]; the batch's fixed
       rows pre-gathered, passed as F_fix with fix = arange(B)).

    python -m mfrec_tpu_torch.tools.kernel_probe [mode] [--reps N]
'''
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from mfrec_tpu_torch.models.base import resolve_device
from mfrec_tpu_torch.ops import half_pass_kernel as hk
from mfrec_tpu_torch.ops import probe_kernel

B, W, CH = 1 << 14, 128, 8192
REPS = 5
N_BATCH = 200
MODES = ('', 'fix', 'dot', 'ohT', 'all2d', 'hiT', 'grp')


def probe_data(device='cuda', ks=(64, 66, 128), lrv=0.1, seed=0,
               batch=B):
    '''The probe's inputs per k, drawn as the JAX tool draws them (the
    same numpy stream): window [W, k], ff [batch, k] f32, r, m (ones),
    sorted kl [batch], lrv and regv [k], on ``device``.'''
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = {}
    for k in ks:
        data[k] = tuple(torch.from_numpy(x).to(dev) for x in (
            rng.normal(0, 0.3, (W, k)).astype(np.float32),
            rng.normal(0, 0.3, (batch, k)).astype(np.float32),
            rng.uniform(1, 5, batch).astype(np.float32),
            np.ones(batch, np.float32),
            np.sort(rng.integers(0, W, batch)).astype(np.int32),
            np.full(k, lrv, np.float32),
            np.full(k, 0.02, np.float32)))
    return data


def run_one(window, ff, r, m, kl, lrv, regv, variant, T, k, ch=CH):
    '''One call of ``variant`` (P2), the JAX signature: as there, the 1D
    variants ignore ``ch`` and take the module's ``CH``.'''
    ch = ch if variant.startswith('all2d') else CH
    return probe_kernel.probe_chain(window, ff, r, m, kl, lrv, regv,
                                    variant, T, 1, ch)


def run_chain(window, ff, r, m, kl, lrv, regv, variant, T, k, ch,
              n_batch=N_BATCH, tables=None):
    '''``n_batch`` chained calls at chunk ``ch`` (the window of each feeds
    the next), one launch on the card.  Returns (window, summed sse).'''
    return probe_kernel.probe_chain(window, ff, r, m, kl, lrv, regv,
                                    variant, T, n_batch, ch, tables=tables)


def timed_s(fn, device, iters):
    '''The least of ``iters`` timed calls of ``fn`` after one warm call,
    in seconds: CUDA events on a card, the host clock on the CPU.'''
    fn()
    best = []
    for _ in range(iters):
        if device.type == 'cuda':
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best.append(time.perf_counter() - t0)
    return min(best)


def time_case(data, variant, T, k, iters=5, ch=CH, n_batch=N_BATCH):
    '''Seconds per call of ``variant`` at T sweeps, in a chain of
    ``n_batch`` calls (the launch alone: the tables are built first).'''
    window, ff, r, m, kl, lrv, regv = data[k]
    dev = window.device
    tab = probe_kernel.probe_tables(kl, W) if dev.type == 'cuda' else None
    return timed_s(lambda: run_chain(window, ff, r, m, kl, lrv, regv,
                                     variant, T, k, ch, n_batch, tab),
                   dev, iters) / n_batch


def _k1_chain(F, F_fix, data, lo):
    '''K1 over the batches at window starts ``lo`` (the probe batch each
    time, its fixed rows pre-gathered: fix = arange(B)) with the segment
    table built once.  Returns ``run(T)``, one launch at T sweeps.'''
    window, ff, r, m, kl, lrv, regv = data
    dev = F.device
    nb = len(lo)
    Bn = ff.shape[0]
    host = [np.broadcast_to(x.cpu().numpy(), (nb, Bn)) for x in (r, m, kl)]
    fix = np.broadcast_to(np.arange(Bn, dtype=np.int32), (nb, Bn))
    lo = np.asarray(lo, np.int32)
    seg = hk.build_segments(fix, *host, lo, W, dev) \
        if dev.type == 'cuda' else None
    batches = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (fix, *host, lo))

    def run(T):
        return hk.half_pass(F, F_fix, batches, W, lrv, regv, 3.5, T,
                            segments=seg)
    return run


def hit_mode(data, reps=3, n_batch=N_BATCH, iters=5, log=print):
    '''K1 (the production kernel) chained over ``n_batch`` copies of the
    k=66 probe batch at T=8, 32 and 64; the marginal sweep from
    adjacent rungs, in seconds per batch.'''
    window, ff = data[66][:2]
    dev = window.device
    ffb = ff.to(torch.bfloat16)
    F = window.clone()
    run = _k1_chain(F, ffb, data[66], [0] * n_batch)
    res = []
    for rep in range(reps):
        ts = {}
        for T in (8, 32, 64):
            F.copy_(window)
            ts[T] = timed_s(lambda: run(T), dev, iters) / n_batch
        m8_32 = (ts[32] - ts[8]) / 24
        m32_64 = (ts[64] - ts[32]) / 32
        res.append((ts, m8_32, m32_64))
        log('rep %d K1 t8 %7.1f t32 %7.1f t64 %7.1f us  marg(8-32) %5.2f  '
            'marg(32-64) %5.2f us/batch'
            % (rep, ts[8] * 1e6, ts[32] * 1e6, ts[64] * 1e6, m8_32 * 1e6,
               m32_64 * 1e6))
    out = {'marg_8_32': statistics.median(x[1] for x in res),
           'marg_32_64': statistics.median(x[2] for x in res),
           't8': statistics.median(x[0][8] for x in res)}
    log('K1 median marg(8-32) %5.2f  marg(32-64) %5.2f us/batch'
        % (out['marg_8_32'] * 1e6, out['marg_32_64'] * 1e6))
    return out


def time_group(F, data66, T, G, lo_mod, iters=5, nsteps=None,
               n_batch=N_BATCH):
    '''K1 over ``nsteps`` groups of G batches (each group's window starts
    drawn once in [0, lo_mod)), one launch; seconds per batch.'''
    nsteps = nsteps or max(1, n_batch // G)
    rng = np.random.default_rng(1)
    lo = np.tile(rng.integers(0, lo_mod, G), nsteps)
    run = _k1_chain(F, data66[1], data66, lo)
    return timed_s(lambda: run(T), F.device, iters) / (nsteps * G)


def grp_mode(device='cuda', reps=REPS, iters=5, n_batch=N_BATCH, batch=B,
             log=print):
    '''K1 over G batches at random window starts: vary G and the size of
    the factor array.'''
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    data66 = tuple(torch.from_numpy(x).to(dev) for x in (
        rng.normal(0, 0.3, (W, 66)).astype(np.float32),
        rng.normal(0, 0.3, (batch, 66)).astype(np.float32),
        rng.uniform(1, 5, batch).astype(np.float32),
        np.ones(batch, np.float32),
        np.sort(rng.integers(0, W, batch)).astype(np.int32),
        np.full(66, 1e-4, np.float32),
        np.full(66, 0.02, np.float32)))
    big = rng.normal(0, 0.3, (70136, 128)).astype(np.float32)[:, :66]
    small = rng.normal(0, 0.3, (512, 128)).astype(np.float32)[:, :66]
    Fbig, Fsmall = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (big, small))
    cases = [('G8_bigF', Fbig, 8, 70000), ('G32_bigF', Fbig, 32, 70000),
             ('G8_smallF', Fsmall, 8, 384), ('G32_smallF', Fsmall, 32, 384)]
    res = {c[0]: [] for c in cases}
    for rep in range(reps):
        for name, F, G, lo_mod in cases:
            t2 = time_group(F, data66, 2, G, lo_mod, iters, None, n_batch)
            t10 = time_group(F, data66, 10, G, lo_mod, iters, None,
                             n_batch)
            marg = (t10 - t2) / 8
            res[name].append(marg)
            log('rep %d %-10s marginal %6.2f us/batch  t2_abs %6.1f'
                % (rep, name, marg * 1e6, t2 * 1e6))
    out = {}
    for name, _, _, _ in cases:
        out[name] = statistics.median(res[name])
        log('%-10s median marginal %6.2f us/batch' % (name, out[name] * 1e6))
    return out


def cases_of(mode, batch=B, ch=CH):
    '''The JAX tool's (variant, k, ch) cases of a timing mode (its B and
    CH replaced by ``batch`` and ``ch``, its 4096 by ch/2).'''
    B, CH = batch, ch
    if mode == 'fix':
        return [('full', 66, CH), ('dot_mxu_b16', 66, CH),
                ('bf16_chain', 66, CH), ('all2d', 66, CH),
                ('all2d_bf16', 66, CH), ('no_elem', 66, CH)]
    if mode == 'dot':
        return [('all2d', 66, CH), ('all2d_sumk', 66, CH)]
    if mode == 'ohT':
        return [('all2d_sumk', 66, CH), ('all2d_sumk_ohT', 66, CH),
                ('all2d_ohT', 66, CH), ('all2d_sumk', 64, CH),
                ('all2d_sumk_ohT', 64, CH)]
    if mode == 'all2d':
        return [('all2d', 66, CH), ('all2d_no_dot', 66, CH),
                ('all2d_no_prod', 66, CH), ('all2d_no_fu', 66, CH),
                ('all2d_no_acc', 66, CH), ('all2d_no_elem', 66, CH),
                ('all2d', 66, B), ('all2d', 66, CH // 2)]
    if mode == '':
        return [('full', 66, CH), ('no_fu', 66, CH), ('no_acc', 66, CH),
                ('no_elem', 66, CH), ('full', 64, CH), ('full', 128, CH)]
    raise ValueError('unknown mode %r (one of %s)' % (mode, MODES))


def probe_mode(data, mode='', reps=REPS, n_batch=N_BATCH, iters=5, ch=CH,
               log=print):
    '''Time a mode's cases at T=2 and 10, interleaved over ``reps``;
    log each rep and the marginal-sweep report.  Returns {case: {'marg':
    median s/batch, 't2': median s/batch}}.'''
    cases = cases_of(mode, data[66][1].shape[0], ch)
    res = {c: [] for c in cases}
    abs2 = {c: [] for c in cases}
    for rep in range(reps):
        for c in cases:
            v, k, ch = c
            t2 = time_case(data, v, 2, k, iters, ch, n_batch)
            t10 = time_case(data, v, 10, k, iters, ch, n_batch)
            marg = (t10 - t2) / 8
            res[c].append(marg)
            abs2[c].append(t2)
            log('rep %d %-14s k=%-3d ch=%-5d marginal %6.2f us/batch'
                '  t2_abs %6.1f us' % (rep, v, k, ch, marg * 1e6, t2 * 1e6))
    base = statistics.median(res[cases[0]])
    out = {}
    for c in cases:
        med = statistics.median(res[c])
        t2m = statistics.median(abs2[c])
        out[c] = {'marg': med, 't2': t2m}
        log('%-14s k=%-3d ch=%-5d median %6.2f us/batch (delta vs %s'
            ' %.2f us)  t2_abs %6.1f (fixed ~%.1f)'
            % (c[0], c[1], c[2], med * 1e6, cases[0][0],
               (base - med) * 1e6, t2m * 1e6, (t2m - 2 * med) * 1e6))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description='Deletion profiling of the '
                                 'batch step\'s marginal sweep.')
    ap.add_argument('mode', nargs='?', default='', choices=MODES)
    ap.add_argument('--reps', type=int, default=REPS)
    ap.add_argument('--n-batch', type=int, default=N_BATCH)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--batch', type=int, default=B)
    ap.add_argument('--chunk', type=int, default=CH)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    if a.mode == 'grp':
        return grp_mode(a.device, a.reps, a.iters, a.n_batch, a.batch)
    data = probe_data(a.device, batch=a.batch)
    if a.mode == 'hiT':
        return hit_mode(data, min(a.reps, 3), a.n_batch, a.iters)
    return probe_mode(data, a.mode, a.reps, a.n_batch, a.iters, a.chunk)


if __name__ == '__main__':
    main()
