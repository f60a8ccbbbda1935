'''
The yardstick: the H100's published peaks, the least time of a piece of
work, the bounds of the kernels' work counted from the cell's own
shapes, and the union of busy intervals.

Copied from ``chip_smoke.py`` (the peaks, ``roofline_ms``, ``k1_bound``
and ``cg_bucket_bound``), with each bound taking counts in
place of the program's own tables, so that a later change to the
program's layouts cannot change what it is measured against.
'''
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_TF32_TENSOR_FLOPS = 495e12
PEAK_BYTES = 3.35e12


def roofline_ms(ops, nbytes, peak=PEAK_F32_FLOPS):
    '''The least time for ``ops`` operations at ``peak`` and ``nbytes``
    moved at the memory rate: the larger of the two, in ms, and which one
    bounds it.'''
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def k1_ops(n, k, T, flops=4.0):
    '''f32 operations of one SGD half-pass: ``flops`` * k per rating and
    sweep (the dot, eff*ff, the accumulation), k the augmented width.'''
    return flops * k * T * n


def k1_bound(n, rows, segments, fixed_rows, k, T, flops=4.0, fix_bytes=2):
    '''The least time of one sorted-window SGD half-pass over ``n``
    ratings, ``rows`` updated rows in ``segments`` (row, batch) segments,
    ``fixed_rows`` distinct fixed rows: the larger of its f32 operations
    over the FP32 peak and the bytes it must move (the work list, each
    fixed row once in bf16, each updated row read and written once) over
    the memory rate.  ms, and what bounds it.'''
    ops = k1_ops(n, k, T, flops)
    nbytes = (12.0 * n + 12.0 * rows + 8.0 * segments + 8.0 * k * rows
              + fix_bytes * k * fixed_rows + 8.0 * k)
    return roofline_ms(ops, nbytes)


def cg_bucket_parts(R, L, nnz, n_fix, k, steps, c_pos=1.0, alpha=0.0):
    '''One ALS bucket's least time by part, in seconds: (tensor cores,
    f32 cores, bytes).  ``R`` systems padded to ``L``, ``nnz`` real
    entries naming ``n_fix`` distinct fixed rows.  The Gram on the bf16
    tensor cores, k (k + 1) an entry where alpha = 0 and bf16(c_pos) is a
    power of two (a symmetric correction), 2 k^2 otherwise; b (k adds an
    entry at alpha = 0, 2 k otherwise) and the PCG (2 k^2 (steps + 1) a
    system) on the f32 cores; bytes: the mask whole, the real ids (and
    values where alpha > 0), the fixed rows in bf16, HHreg, the row ids,
    x0 and x.'''
    w = _bf16_value(c_pos)
    symmetric = alpha == 0 and math.frexp(w)[0] == 0.5
    nbytes = 4.0 * R * L + (4.0 if alpha == 0 else 8.0) * nnz + \
        2.0 * n_fix * k + 4.0 * k * k + 4.0 * R + 8.0 * R * k
    t_tensor = (k * (k + 1.0) if symmetric else 2.0 * k * k) * nnz \
        / PEAK_BF16_TENSOR_FLOPS
    t_f32 = ((k if alpha == 0 else 2.0 * k) * nnz
             + 2.0 * R * k * k * (steps + 1)) / PEAK_F32_FLOPS
    return t_tensor, t_f32, nbytes / PEAK_BYTES


def cg_bucket_bound(R, L, nnz, n_fix, k, steps, c_pos=1.0, alpha=0.0):
    '''The bucket's least time in ms (the pipes overlap: the largest of
    the three), and what sets it.'''
    t_tensor, t_f32, t_bytes = cg_bucket_parts(R, L, nnz, n_fix, k, steps,
                                               c_pos, alpha)
    t_ops = max(t_tensor, t_f32)
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def _bf16_value(x):
    '''``x`` rounded to bfloat16 (round to nearest even), as a float.'''
    import struct
    b = struct.unpack('<I', struct.pack('<f', float(x)))[0]
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return struct.unpack('<f', struct.pack('<I', b))[0]


def union_ms(intervals):
    '''The length of the union of ``(start, end)`` intervals (any unit):
    work that overlaps on two streams counts once.'''
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy
