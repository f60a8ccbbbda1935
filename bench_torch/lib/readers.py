'''
What the per-layer readers share: the least time of the window's
training work, counted from the cell's own shapes by the yardstick, and
the device's idle share.  Each ``metrics/<metric>.py`` is a small reader
over these; a reader that finds nothing to read returns None.
'''
from __future__ import annotations

from lib import yardstick as ys


def _steps(params, epoch):
    return params['cg_steps'] if epoch < params['cg_warmup_epochs'] \
        else params['cg_warm_steps']


def sgd_epoch(work):
    '''One epoch's (operations-only time, roofline time) in seconds.'''
    k, T = work['k'], work['T']
    ops = sum(ys.k1_ops(h['n'], k, T) for h in work['half_passes'])
    bound = sum(ys.k1_bound(h['n'], h['rows'], h['segments'],
                            h['fixed_rows'], k, T)[0]
                for h in work['half_passes']) / 1e3
    return ops / ys.PEAK_F32_FLOPS, bound


def als_epoch(work, steps):
    '''One ALS epoch at ``steps`` PCG steps: (operations-only time, the
    buckets' roofline time) in seconds.  Operations: each bucket's Gram
    on the bf16 tensor cores beside b and the PCG on the f32 cores (the
    larger), and each half-sweep's Q^T Q on the f32 cores.'''
    k, p = work['k'], work['params']
    ops_t, bound = 0.0, 0.0
    for side, rows in (('user_buckets', work['items']),
                       ('item_buckets', work['users'])):
        ops_t += 2.0 * rows * k * k / ys.PEAK_F32_FLOPS
        for b in work[side]:
            t_tensor, t_f32, _ = ys.cg_bucket_parts(
                b['R'], b['L'], b['nnz'], b['n_fix'], k, steps,
                p['c_pos'], p['alpha'])
            ops_t += max(t_tensor, t_f32)
            bound += ys.cg_bucket_bound(b['R'], b['L'], b['nnz'],
                                        b['n_fix'], k, steps, p['c_pos'],
                                        p['alpha'])[0] / 1e3
    return ops_t, bound


def train_window(ctx):
    '''The traced window's training work: (operations-only time, roofline
    time) in seconds, over every call it ran.'''
    c = ctx['counters']
    work = ctx['work']()
    calls, epochs = c['calls'], c['epochs_a_call']
    if 'half_passes' in work:
        ops, bound = sgd_epoch(work)
        return calls * epochs * ops, calls * epochs * bound
    ops, bound = 0.0, 0.0
    for e in range(epochs):
        o, b = als_epoch(work, _steps(work['params'], e))
        ops += o
        bound += b
    return calls * ops, calls * bound


def idle_share(ctx):
    tr = ctx['trace']
    busy = tr.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / tr.window_s)


def roofline_in(ctx, span, least_s):
    '''``least_s`` over the device time of the work launched inside the
    ``span`` spans, in %.'''
    busy = ctx['trace'].busy_in_s(span)
    if not busy:
        return None
    return 100.0 * least_s / busy
