'''The SVD++ training window's model operations (4 k T f32 operations a
rating and sweep of each half-pass, k the augmented width, plus the two
aggregations' and the Y step's operations an entry) at the FP32 peak,
over the window's wall time, in %.'''
from lib import svdpp_bound, yardstick


def read(ctx):
    work = ctx['work']()
    if 'svdpp' not in work:
        return None
    ops = svdpp_bound.window_epochs(ctx) * svdpp_bound.epoch_ops(work)
    return 100.0 * ops / yardstick.PEAK_F32_FLOPS / ctx['trace'].window_s
