'''The device's idle share over the traced window: 1 - busy / wall, busy
the union of its kernels' and copies' intervals, in %.'''
from lib.readers import idle_share


def read(ctx):
    return idle_share(ctx)
