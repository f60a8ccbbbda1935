'''The FN half-passes' least time (the item side at ``k1_bound``, the
frozen user side at its dot and b_u's term, both with K1's bytes and the
fixed side in f32; ``lib/fn_bound.py``) in every epoch of the window over
the device time of the work launched inside the program's
``fn.half_passes`` spans, in %.  None where the program records no such
span.'''
from lib import fn_bound, svdpp_bound
from lib.readers import roofline_in


def read(ctx):
    work = ctx['work']()
    if 'fn' not in work:
        return None
    return roofline_in(ctx, 'fn.half_passes', svdpp_bound.window_epochs(ctx)
                       * fn_bound.half_pass_bound_s(work))
