'''
B1, the BellKor bias refit over a layout's segment table: the
hand-written CUDA kernel (``csrc/bias_refit.cu``) and its plain PyTorch
version.

No TPU counterpart: the JAX package refits the fixed biases with numpy
on the host (``mfrec_tpu/models/mf.py``, ``compute_items_bias_bk`` and
``compute_users_bias_bk``), as the port does on a CPU model.  On a CUDA
model the alternating engine's layouts already hold every rating on the
card, grouped by row in K1's segment tables
(``half_pass_kernel.build_segments``): the item-axis table gives each
item's ratings, the user-axis table each user's with the item id in
``ent_fix``.  B1 sums them there with numpy's arithmetic: the residual
``r - f32(mu)`` (less ``bi[item]`` for the user biases) in f32, its sum
per row in f64, ``f32(sum / (K + n))``, 0 for a row with no rating.  Only
the order of the f64 sum differs from numpy's, so the biases agree with
it within an f32 ulp (and as a rule bit for bit).  The sum's order is
fixed (``csrc/bias_refit.cu``), so a table gives the same bits on every
run.

``bias_refit_ref`` is the same arithmetic in plain torch over the same
table, on any device; ``bias_refit`` is the wrapper: one launch for CUDA
tensors, ``bias_refit_ref`` for CPU tensors.  ``bias_refit.launches``
counts the launches.
'''
from __future__ import annotations

import ctypes

import numpy as np
import torch

# rows with at least this many ratings take a whole 16-warp block, the
# others one warp
BLOCK_ROW = 2048


def bias_refit_ref(segments, n_rows, mu, K, bi=None):
    '''The plain version of ``bias_refit``: the f32 residuals of segment
    table ``segments``' entries summed per row (``ent_row``) in f64 by
    ``index_add_``, then ``f32(sum / (K + n))``; NaN and rows with no
    entry 0.'''
    seg = segments
    x = seg.ent_r - torch.tensor(np.float32(mu), device=seg.ent_r.device)
    if bi is not None:
        x = x - bi[seg.ent_fix.long()]
    rows = seg.ent_row.long()
    total = torch.zeros(n_rows, dtype=torch.float64, device=x.device)
    total.index_add_(0, rows, x.double())
    count = torch.bincount(rows, minlength=n_rows)
    out = (total / (float(K) + count.double())).float()
    return torch.where(torch.isnan(out) | (count == 0),
                       torch.zeros_like(out), out)


def _check(segments, n_rows, bi):
    seg = segments
    if seg.max_row >= n_rows:
        raise ValueError('the segment table has rows past n_rows=%d'
                         % n_rows)
    if bi is not None and (bi.dim() != 1 or seg.max_fix >= bi.shape[0]):
        raise ValueError('bi must be [rows_fix] with every ent_fix inside')
    if bi is not None and bi.dtype != torch.float32:
        raise ValueError('bi must be float32, got %s' % bi.dtype)
    named = [('segments.%s' % f, getattr(seg, f))
             for f in ('blk_row', 'blk_seg0', 'blk_seg1', 'seg_ptr',
                       'ent_fix', 'ent_r', 'ent_row')]
    if bi is not None:
        named.append(('bi', bi))
    dev = seg.ent_r.device
    for name, t in named:
        if t.device != dev:
            raise ValueError('%s is on %s, segments.ent_r on %s'
                             % (name, t.device, dev))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)


def bias_refit(segments, n_rows, mu, K, bi=None):
    '''The BellKor biases of the ``n_rows`` rows of segment table
    ``segments`` as an f32 [n_rows] tensor on its device: with ``bi`` None
    the item biases from the item-axis table (``K`` = K3), with ``bi``
    (the item biases, f32) the user biases from the user-axis table
    (``K`` = K2).  ``mu`` is the overall mean (rounded to f32).  CUDA
    tensors: one launch of ``csrc/bias_refit.cu``; CPU tensors:
    ``bias_refit_ref``.'''
    _check(segments, n_rows, bi)
    seg = segments
    dev = seg.ent_r.device
    if dev.type == 'cpu':
        return bias_refit_ref(seg, n_rows, mu, K, bi)
    if dev.type != 'cuda':
        raise ValueError('bias_refit runs on cuda or cpu tensors, not %s'
                         % dev)
    out = torch.zeros(n_rows, dtype=torch.float32, device=dev)
    n_blocks = int(seg.blk_row.shape[0])
    if n_blocks == 0:                   # no rating: every bias 0
        return out
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.bias_refit_launch(
            out.data_ptr(), None if bi is None else bi.data_ptr(),
            seg.blk_row.data_ptr(), seg.blk_seg0.data_ptr(),
            seg.blk_seg1.data_ptr(), seg.seg_ptr.data_ptr(),
            seg.ent_fix.data_ptr(), seg.ent_r.data_ptr(),
            float(np.float32(mu)), float(K), n_blocks,
            int(np.count_nonzero(seg.blk_len >= BLOCK_ROW)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('bias_refit kernel launch failed: CUDA error %d '
                           '(%s)' % (rc, lib.bias_refit_error_string(
                               rc).decode()))
    bias_refit.launches += 1
    return out


bias_refit.launches = 0


def _declare(lib):
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_double
    lib.bias_refit_error_string.argtypes = [i]
    lib.bias_refit_error_string.restype = ctypes.c_char_p
    lib.bias_refit_launch.argtypes = [p, p, p, p, p, p, p, p, f, d, i, i, p]
    lib.bias_refit_launch.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('bias_refit', _declare)
