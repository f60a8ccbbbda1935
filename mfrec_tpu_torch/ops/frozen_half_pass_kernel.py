'''
K1f, the half-pass in which one column of the updated side moves: the
hand-written CUDA kernel (``csrc/frozen_half_pass.cu``) and its plain
PyTorch version.

FN's user half-pass (``mfrec_tpu/ops/fn.py:141-252``) runs K1 with every
rate but b_u's zeroed, so K1 does its whole 4 k T work a rating for one
scalar a row.  With the factor columns and the fixed side constant over
the half-pass, the part of the dot they give is too: K1f forms it once an
entry, ``s = sum_{c != col} bf16(a_c) ff_c`` in f32 (the products rounded
to bf16 first for k > 128, as K1 rounds them), then runs K1's T sweeps on
column ``col`` alone: ``dot = s + bf16(x) ff_col``, K1's clamped
residual, its bf16-rounded ``err * ff_col`` summed per row and its
update.  Every other column is left as it is, as K1 leaves a column of
rate 0.  The sums run in another order than K1's, so the two agree within
f32 rounding, not bit for bit.  It takes what FN runs K1 with: the
identity link, learned biases (``mu`` the base) and f32 fixed rows.

``frozen_half_pass_ref`` is that arithmetic in plain torch over a list of
batches, as ``half_pass_kernel.half_pass_ref`` loops K1's step.
``frozen_half_pass`` is the wrapper: for CUDA tensors one launch over the
layout's segment table (``half_pass_kernel.build_segments``, as K1 takes
it), for CPU tensors ``frozen_half_pass_ref`` -- by where the tensors lie.
``frozen_half_pass.launches`` counts the launches; a launching call adds
the table's entries, whose dots it formed once, to the counter
``k1f.entries`` (``utils/profiling.py``, while recording).
'''
from __future__ import annotations

import ctypes

import numpy as np
import torch

from mfrec_tpu_torch.ops import half_pass_kernel
from mfrec_tpu_torch.utils import profiling

_bf16 = half_pass_kernel._bf16


def frozen_half_pass_ref(F_upd, F_fix, batches, W, lrv, regv, mu, col,
                         inner_steps=1, clamp_pred=True, lo_r=1.0, hi_r=5.0,
                         row_mean=True):
    '''K1f in plain torch over batches ``(fix [nb, B], r, m, kl [nb, B],
    lo [nb])``, in order: per batch each entry's frozen part of the dot
    once, then T sweeps of column ``col`` of the batch's window.  Updates
    column ``col`` of ``F_upd`` in place; returns the summed SSE of the
    first sweeps (0-dim f32).'''
    fix, r, m, kl, lo = batches
    k = F_upd.shape[1]
    dot_sum = k <= 128
    lr, reg = lrv[col].float(), regv[col].float()
    sse = torch.zeros((), dtype=torch.float32, device=F_upd.device)
    for b, start in enumerate(lo.cpu().tolist()):
        win = F_upd[start:start + W]
        kl_b = kl[b].long()
        ff = F_fix[fix[b].long()]
        m_b, r_b = m[b].float(), r[b].float()
        cnt = torch.zeros(W, dtype=torch.float32, device=win.device)
        cnt.index_add_(0, kl_b, _bf16(m_b))
        alive = (cnt > 0).float()
        den = torch.clamp(cnt, min=1.0)
        fu = _bf16(win)[kl_b]
        fu[:, col] = 0.0
        prod = fu * ff
        s = (prod if dot_sum else _bf16(prod)).sum(1)      # formed once
        w = ff[:, col]
        x = win[:, col].clone()
        for t in range(int(inner_steps)):
            term = _bf16(x)[kl_b] * w
            pred = mu + (s + (term if dot_sum else _bf16(term)))
            if clamp_pred:
                pred = torch.clamp(pred, lo_r, hi_r)
            err = (r_b - pred) * m_b
            if t == 0:
                sse = sse + (err * err).sum()
            acc = torch.zeros(W, dtype=torch.float32, device=win.device)
            acc.index_add_(0, kl_b, _bf16(err * w))
            rx = reg * x
            gsum = acc / den - rx * alive if row_mean else acc - rx * cnt
            x = x + lr * gsum
        win[:, col] = x
    return sse


def frozen_half_pass(F_upd, F_fix, batches, W, lrv, regv, mu, col,
                     inner_steps=1, clamp_pred=True, lo_r=1.0, hi_r=5.0,
                     row_mean=True, segments=None):
    '''K1f over batches ``(fix, r, m, kl [nb, B], lo [nb])``: column
    ``col`` of ``F_upd`` [rows, k] f32 trained in place from ``F_fix``
    [rows, k] f32, every other column left as it is.  The
    caller's rates must leave only ``col`` moving (``lrv`` 0 elsewhere):
    K1 would then change nothing else either.  CUDA tensors: one launch
    over ``segments`` (``build_segments`` of the same batches, required);
    CPU tensors: ``frozen_half_pass_ref``.  Returns the SSE of the
    batches' first sweeps (0-dim f32).  Raises on a device, dtype, shape
    or option the kernel does not take, and on a CUDA error at launch.'''
    half_pass_kernel._check_args(F_upd, F_fix, batches, W, lrv, regv,
                                 'identity', inner_steps)
    if F_fix.dtype != torch.float32:
        raise ValueError('F_fix must be float32, got %s' % F_fix.dtype)
    k = F_upd.shape[1]
    if not 0 <= int(col) < k:
        raise ValueError('col=%d: 0..%d' % (col, k - 1))
    dev = F_upd.device
    if dev.type == 'cpu':
        return frozen_half_pass_ref(F_upd, F_fix, batches, W, lrv, regv, mu,
                                    int(col), inner_steps, clamp_pred, lo_r,
                                    hi_r, row_mean)
    if dev.type != 'cuda':
        raise ValueError('frozen_half_pass runs on cuda or cpu tensors, not '
                         '%s' % dev)
    seg = segments
    if seg is None:
        raise ValueError('a CUDA half-pass needs the segment table '
                         '(build_segments)')
    for field in half_pass_kernel.Segments._fields[:8]:
        t = getattr(seg, field)
        if t.device != dev or not t.is_contiguous():
            raise ValueError('segments.%s must be contiguous on %s'
                             % (field, dev))
    if seg.max_row >= F_upd.shape[0] or seg.max_fix >= F_fix.shape[0]:
        raise ValueError('the segment table reads past F_upd or F_fix')
    n_blocks = int(seg.blk_row.shape[0])
    if n_blocks == 0:                    # nothing masked in: no launch
        return torch.zeros((), dtype=torch.float32, device=dev)
    lib = _library()
    n_long, ovf_off, n_ovf = long_rows(seg, *geometry(k)[:2])
    inf = float('inf')
    lo_c, hi_c = (float(lo_r), float(hi_r)) if clamp_pred else (-inf, inf)
    with torch.cuda.device(dev):
        sse_rows = torch.empty(n_blocks, dtype=torch.float32, device=dev)
        ovf = torch.empty((max(n_ovf, 1), 4), dtype=torch.float32,
                          device=dev)
        rc = lib.frozen_half_pass_launch(
            F_upd.data_ptr(), F_fix.data_ptr(), seg.blk_row.data_ptr(), seg.blk_seg0.data_ptr(),
            seg.blk_seg1.data_ptr(), n_blocks, n_long, ovf_off.data_ptr(),
            ovf.data_ptr(), seg.seg_ptr.data_ptr(), seg.seg_cnt.data_ptr(),
            seg.ent_fix.data_ptr(), seg.ent_r.data_ptr(),
            seg.ent_m.data_ptr(), lrv.data_ptr(), regv.data_ptr(),
            float(mu), lo_c, hi_c, k, int(col), int(inner_steps),
            int(bool(row_mean)), sse_rows.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('frozen_half_pass kernel launch failed: CUDA error '
                           '%d (%s)' % (rc, lib.frozen_half_pass_error_string(
                               rc).decode()))
    frozen_half_pass.launches += 1
    profiling.count('k1f.entries', int(seg.ent_r.shape[0]))
    return sse_rows.sum()


frozen_half_pass.launches = 0


def long_rows(seg, warp_cap, block_cap):
    '''How K1f splits table ``seg``: (the rows longer than ``warp_cap``
    entries, which lead the table and run a block each; each such row's
    offset into the records past ``block_cap``, int32 on the table's
    device; those records in all).  Computed on the host from the rows'
    lengths once per table and capacities, and kept in ``seg.memo``.'''
    key = ('k1f_long_rows', warp_cap, block_cap)
    if key not in seg.memo:
        blk_len = np.asarray(seg.blk_len)
        n_long = int((blk_len > warp_cap).sum())
        if not (blk_len[:n_long] > warp_cap).all():
            raise ValueError('the segment table does not lead with its long '
                             'rows')
        over = np.maximum(blk_len[:n_long] - block_cap, 0)
        off = np.concatenate([[0], np.cumsum(over)]).astype(np.int64)
        if off[-1] >= 2 ** 31:
            raise ValueError('%d records past shared memory: the offsets '
                             'index int32' % off[-1])
        seg.memo[key] = (n_long, torch.from_numpy(
            off[:-1].astype(np.int32) if n_long else np.zeros(1, np.int32)
        ).to(seg.blk_row.device), int(off[-1]))
    return seg.memo[key]


_GEOMETRY = {}


def geometry(k):
    '''(the longest row a warp takes, the records a block keeps in shared
    memory, K1f's blocks an SM) at width ``k``, as the kernel states them
    (``frozen_half_pass_geometry``).  Needs CUDA.'''
    key = int(k)
    if key not in _GEOMETRY:
        lib = _library()
        out = [ctypes.c_int() for _ in range(3)]
        rc = lib.frozen_half_pass_geometry(key,
                                           *(ctypes.byref(x) for x in out))
        if rc != 0:
            raise RuntimeError(
                'frozen_half_pass_geometry failed: CUDA error %d (%s)'
                % (rc, lib.frozen_half_pass_error_string(rc).decode()))
        _GEOMETRY[key] = tuple(x.value for x in out)
    return _GEOMETRY[key]


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.frozen_half_pass_error_string.argtypes = [i]
    lib.frozen_half_pass_error_string.restype = ctypes.c_char_p
    lib.frozen_half_pass_launch.argtypes = [
        p, p, p, p, p, i, i, p, p, p, p, p, p, p, p, p, f, f, f, i, i, i, i,
        p, p]
    lib.frozen_half_pass_launch.restype = i
    lib.frozen_half_pass_geometry.argtypes = [i, p, p, p]
    lib.frozen_half_pass_geometry.restype = i


def _library():
    '''K1f's library, built if needed.'''
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('frozen_half_pass', _declare)
