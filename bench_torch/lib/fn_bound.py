'''
The least time of the FN (Asymmetric-SVD) epoch's gathered phases and
its X/Y step, and the model operations of its epoch, counted from the
cell's own shapes (the counts ``reference/fn_window.work`` returns), on
the yardstick's H100 peaks.

Phase 1 (the profiles) passes once over the user side's entries: an
entry's fixed id and rating (the table holds masked-in entries only, so
no mask is read), its residual r - ((mu + b_u) + b_j) (3 operations) and
the row res x_j + y_j summed (3 k: a multiply, an add and the sum); a
row's segment offsets and (row, first, last segment), its target read
and written and its b_u; a gathered item's X and Y rows and b_j, each
once (they stay in L2).  Phase 4 is K4g's error mode over the same
entries, as in SVD++ (``svdpp_bound.error_agg_work``: 4 k + 7 an entry).
The X/Y step (phase 5) passes over the item side's entries: the user id,
rating and mask, the residual (3), X's term (res G - decay x) * m summed
(4 k) and Y's (G - decay y) * m summed (3 k), the decays once a segment;
an item's X and Y rows read and written and its b_i; a gathered user's
G row and b_u, each once.  The two half-passes: the item side at K1's
least time with the fixed side in f32; the frozen user side moves K1's
bytes but needs only its dot and b_u's term (``user_half_pass_ops``).
'''
from __future__ import annotations

from lib import svdpp_bound
from lib import yardstick as ys


def profile_agg_work(n, rows, segments, fixed_rows, k):
    '''Phase 1 at k factors: (f32 operations, bytes).'''
    ops = (3.0 + 3.0 * k) * n
    nbytes = (8.0 * n + 4.0 * (segments + 1) + 12.0 * rows
              + 8.0 * k * rows + 4.0 * rows + (8.0 * k + 4.0) * fixed_rows)
    return ops, nbytes


def xy_step_work(n, rows, segments, fixed_rows, k):
    '''Phase 5 at k factors over the item side: (f32 operations, bytes).'''
    ops = (7.0 * k + 3.0) * n
    nbytes = (12.0 * n + 4.0 * (segments + 1) + 12.0 * rows
              + 16.0 * k * rows + 4.0 * rows + (4.0 * k + 4.0) * fixed_rows)
    return ops, nbytes


def _side(work, which):
    h = work['half_passes'][which]
    return (h['n'], h['rows'], h['segments'], h['fixed_rows'],
            work['k_factors'])


def agg_bound_s(work):
    '''One epoch's two gathered phases at their least time, seconds (each
    the larger of its operations at the FP32 peak and its bytes at the
    memory rate).'''
    args = _side(work, 0)
    return sum(ys.roofline_ms(*f(*args))[0] for f in (
        profile_agg_work, svdpp_bound.error_agg_work)) / 1e3


def xy_step_bound_s(work):
    '''One epoch's X/Y step at its least time, seconds.'''
    return ys.roofline_ms(*xy_step_work(*_side(work, 1)))[0] / 1e3


def user_half_pass_ops(n, k, T):
    '''The frozen user half-pass: a rating and sweep's dot over the
    augmented width k (2 k) and b_u's error and gradient term (2).'''
    return (2.0 * k + 2.0) * T * n


def half_pass_bound_s(work):
    '''One epoch's two half-passes at their least time, seconds: the item
    side at K1's (4 k T a rating and sweep), the frozen user side at its
    own operations; each with K1's bytes, the fixed side in f32.'''
    k, T = work['k'], work['T']
    user, item = work['half_passes']
    t = ys.k1_bound(item['n'], item['rows'], item['segments'],
                    item['fixed_rows'], k, T, fix_bytes=4)[0]
    t += ys.k1_bound(user['n'], user['rows'], user['segments'],
                     user['fixed_rows'], k, T, fix_bytes=4,
                     flops=(2.0 * k + 2.0) / k)[0]
    return t / 1e3


def epoch_ops(work):
    '''One epoch's model operations: the item half-pass at K1's 4 k T a
    rating and sweep (k the augmented width), the frozen user half-pass
    at what it needs, the two gathered phases' and the X/Y step's per
    entry.'''
    k, T = work['k'], work['T']
    user, item = work['half_passes']
    ops = ys.k1_ops(item['n'], k, T) + user_half_pass_ops(user['n'], k, T)
    args = _side(work, 0)
    ops += profile_agg_work(*args)[0] + svdpp_bound.error_agg_work(*args)[0]
    return ops + xy_step_work(*_side(work, 1))[0]
