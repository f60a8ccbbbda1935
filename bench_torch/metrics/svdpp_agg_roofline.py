'''The SVD++ aggregation phases' least time (both K4 gathered phases of
every epoch in the window, from the cell's shapes) over the device time
of the work launched inside the program's ``svdpp.aggregate`` spans, in
%.  None where the program records no such span.'''
from lib import svdpp_bound
from lib.readers import roofline_in


def read(ctx):
    work = ctx['work']()
    if 'svdpp' not in work:
        return None
    return roofline_in(ctx, 'svdpp.aggregate', svdpp_bound.window_epochs(ctx)
                       * svdpp_bound.agg_bound_s(work))
