'''Math helpers (reference ``mfrec/lib/math_.py``), copied from
``mfrec_tpu/utils/math_.py``.'''
from __future__ import annotations

import numpy as np


def sigmoid(x, p1=1.0, scale_range=4.0, y0=1.0, x0=0.0):
    '''Scaled/shifted logistic (reference math_.py:14-16): maps R onto
    (y0, y0 + scale_range) — with the defaults, the [1, 5] rating scale.'''
    return scale_range / (1.0 + np.exp(-p1 * (np.asarray(x) - x0))) + y0
