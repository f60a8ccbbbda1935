'''The ALS training window's model operations, each kind at its pipe's
published peak (each bucket's Gram on the bf16 tensor cores beside b and
the PCG on the f32 cores, each half-sweep's Q^T Q on the f32 cores), over
the window's wall time, in %.'''
from lib.readers import train_window


def read(ctx):
    if 'user_buckets' not in ctx['work']():
        return None
    return 100.0 * train_window(ctx)[0] / ctx['trace'].window_s
