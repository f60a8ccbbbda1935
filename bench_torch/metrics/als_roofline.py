'''The ALS buckets' least time (the K2 bound of every bucket and epoch in
the window) over the device time of the work launched inside the
``train`` spans, in %.'''
from lib.readers import roofline_in, train_window


def read(ctx):
    if 'user_buckets' not in ctx['work']():
        return None
    return roofline_in(ctx, 'train', train_window(ctx)[1])
