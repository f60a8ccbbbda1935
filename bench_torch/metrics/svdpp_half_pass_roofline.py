'''The SVD++ half-passes' least time (``k1_bound`` of every half-pass in
the window, the fixed side in f32) over the device time of the work
launched inside the program's ``svdpp.half_passes`` spans, in %.  None
where the program records no such span.'''
from lib import svdpp_bound
from lib.readers import roofline_in


def read(ctx):
    work = ctx['work']()
    if 'svdpp' not in work:
        return None
    return roofline_in(ctx, 'svdpp.half_passes',
                       svdpp_bound.window_epochs(ctx)
                       * svdpp_bound.half_pass_bound_s(work))
