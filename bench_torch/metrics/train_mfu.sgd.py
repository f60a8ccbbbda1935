'''The SGD training window's model operations (4 k T f32 operations a
rating and sweep of every half-pass) at the FP32 peak, over the window's
wall time, in %.'''
from lib.readers import train_window


def read(ctx):
    if 'half_passes' not in ctx['work']():
        return None
    return 100.0 * train_window(ctx)[0] / ctx['trace'].window_s
