'''
The least time of the SVD++ epoch's aggregation phases, and the model
operations of its epoch, counted from the cell's own shapes (the counts
``reference/svdpp_window.work`` returns), on the yardstick's H100 peaks.

Phase 1 (the Y sums) and phase 4 (the error-weighted Q sums) each pass
once over the user side's entries, gathering one row an entry by its
fixed id: k-wide Y rows in phase 1, (k+2)-wide Qaug rows in phase 4.
The gathered rows stay in L2 and count once; what must come from memory
is the work list (an entry's fixed id; with its rating and mask in phase
4), the segments' offsets, the rows' (row, first, last segment), the
target rows read and written, each gathered row once and, in phase 4,
each user's effective row.  Operations: k adds an entry in phase 1;
phase 4's dot (2 (k+2)), the prediction, residual and mask (3) and the
weighted sum (2 k): 4 k + 7 an entry.  The Y step (phase 5) does 3 k an
entry ((G - decay y) * m, summed).
'''
from __future__ import annotations

from lib import yardstick as ys


def gather_agg_work(n, rows, segments, fixed_rows, k):
    '''Phase 1: (f32 operations, bytes).'''
    ops = float(k) * n
    nbytes = (4.0 * n + 4.0 * (segments + 1) + 12.0 * rows
              + 8.0 * k * rows + 4.0 * k * fixed_rows)
    return ops, nbytes


def error_agg_work(n, rows, segments, fixed_rows, k):
    '''Phase 4 at k factors (rows k + 2 wide): (f32 operations, bytes).'''
    ops = (4.0 * k + 7.0) * n
    nbytes = (12.0 * n + 4.0 * (segments + 1) + 12.0 * rows
              + 8.0 * k * rows + 4.0 * (k + 2) * rows
              + 4.0 * (k + 2) * fixed_rows)
    return ops, nbytes


def agg_bound_s(work):
    '''One epoch's two aggregation phases at their least time, seconds
    (each the larger of its operations at the FP32 peak and its bytes at
    the memory rate).'''
    h = work['half_passes'][0]
    k = work['k_factors']
    args = (h['n'], h['rows'], h['segments'], h['fixed_rows'], k)
    return sum(ys.roofline_ms(*f(*args))[0]
               for f in (gather_agg_work, error_agg_work)) / 1e3


def half_pass_bound_s(work):
    '''One epoch's two half-passes at K1's least time, the fixed side in
    f32 (4 bytes a column), seconds.'''
    k, T = work['k'], work['T']
    return sum(ys.k1_bound(h['n'], h['rows'], h['segments'],
                           h['fixed_rows'], k, T, fix_bytes=4)[0]
               for h in work['half_passes']) / 1e3


def epoch_ops(work):
    '''One epoch's model operations: 4 k T a rating and sweep of each
    half-pass (k the augmented width), the two aggregations' and the Y
    step's per entry.'''
    k, T, kf = work['k'], work['T'], work['k_factors']
    user, item = work['half_passes']
    ops = sum(ys.k1_ops(h['n'], k, T) for h in work['half_passes'])
    args = (user['n'], user['rows'], user['segments'], user['fixed_rows'],
            kf)
    ops += gather_agg_work(*args)[0] + error_agg_work(*args)[0]
    return ops + 3.0 * kf * item['n']


def window_epochs(ctx):
    '''The traced window's epochs: its calls times the epochs a call.'''
    c = ctx['counters']
    return c['calls'] * c['epochs_a_call']
