'''The FN X/Y step's least time (K4s's two-target step in every epoch of
the window, from the cell's shapes) over the device time of the work
launched inside the program's ``fn.xy_step`` spans, in %.  None where the
program records no such span.'''
from lib import fn_bound, svdpp_bound
from lib.readers import roofline_in


def read(ctx):
    work = ctx['work']()
    if 'fn' not in work:
        return None
    return roofline_in(ctx, 'fn.xy_step', svdpp_bound.window_epochs(ctx)
                       * fn_bound.xy_step_bound_s(work))
