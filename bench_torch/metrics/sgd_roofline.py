'''The SGD half-passes' least time (the K1 bound of every half-pass in the
window) over the device time of the work launched inside the ``train``
spans, in %.'''
from lib.readers import roofline_in, train_window


def read(ctx):
    if 'half_passes' not in ctx['work']():
        return None
    return roofline_in(ctx, 'train', train_window(ctx)[1])
