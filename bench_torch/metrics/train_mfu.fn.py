'''The FN training window's model operations (the item half-pass at 4 k
T f32 operations a rating and sweep, k the augmented width; the frozen
user half-pass at its dot and b_u's term; the two gathered phases' and
the X/Y step's operations an entry; ``lib/fn_bound.py``) at the FP32
peak, over the window's wall time, in %.'''
from lib import fn_bound, svdpp_bound, yardstick


def read(ctx):
    work = ctx['work']()
    if 'fn' not in work:
        return None
    ops = svdpp_bound.window_epochs(ctx) * fn_bound.epoch_ops(work)
    return 100.0 * ops / yardstick.PEAK_F32_FLOPS / ctx['trace'].window_s
