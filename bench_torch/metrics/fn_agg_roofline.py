'''The FN gathered phases' least time (K4g's profile and error modes in
every epoch of the window, from the cell's shapes) over the device time
of the work launched inside the program's ``fn.aggregate`` spans, in %.
None where the program records no such span.'''
from lib import fn_bound, svdpp_bound
from lib.readers import roofline_in


def read(ctx):
    work = ctx['work']()
    if 'fn' not in work:
        return None
    return roofline_in(ctx, 'fn.aggregate', svdpp_bound.window_epochs(ctx)
                       * fn_bound.agg_bound_s(work))
