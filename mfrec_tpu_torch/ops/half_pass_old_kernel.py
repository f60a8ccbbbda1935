'''
P1, the round-2 sorted-window batch step: the hand-written CUDA kernel
(``csrc/half_pass_old.cu``) and its plain PyTorch version.

Port of ``tools/ab_kernel.py`` (``half_pass_batch_old``, body
``_kernel_old``, with the static options it is called with: clamp to
[1, 5], row mean, mu + dot).  Per batch, T sweeps of

    fu = bf16(win)[kl];  dot = sum_k fu*ff (f32 at every k)
    err = (r - clamp(mu + dot, 1, 5))*m      (SSE from the first sweep)
    g = err*ff - regv*fu*m                   (per rating)
    acc = sum_b bf16([g_b | m_b]) into row kl_b, in f32
    win += lrv * acc[:, :k] / max(acc[:, k], 1)

It differs from K1 (``ops/half_pass_kernel.py``): the regularization
term rides each rating and is rounded to bf16 with it, the count is
summed every sweep, and there is no alive mask and no bf16-product rule
for k > 128.  It is also not the port's XLA-branch batch step
(``sgd_mf.make_alternating_epoch`` with ``use_kernel=False``): that one
reads the window in f32, P1 in bf16.

``half_pass_batch_old`` has the JAX signature (one batch);
``half_pass_old`` runs a list of batches (a half-pass) in one launch over
K1's segment table (``half_pass_kernel.build_segments``), as K1's wrapper
does.  CUDA tensors launch the kernel, CPU tensors run the plain versions
``half_pass_batch_old_ref`` / ``half_pass_old_ref``.
``half_pass_old.launches`` counts the calls that launched the kernel.
'''
from __future__ import annotations

import ctypes

import numpy as np
import torch

from mfrec_tpu_torch.ops import half_pass_kernel as hk


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _chunk_check(B, chunk):
    ch = min(int(chunk), B) if chunk else B
    if ch < 1 or B % ch:
        raise ValueError('the batch (%d) must be a multiple of the chunk '
                         '(%d): the TPU grid drops a ragged tail' % (B, ch))


def half_pass_batch_old_ref(window, ff, r, m, kl, lrv, regv, mu, W,
                            chunk=None, inner_steps=1):
    '''One batch step in plain torch, sweep by sweep as ``_kernel_old``
    computes it (the chunking only orders the f32 sums).  ``window``
    [W, k] f32, ``ff`` [B, k] (bf16 or f32), ``r``/``m`` [B], ``kl``
    [B] in [0, W), ``lrv``/``regv`` [k].  Returns (window [W, k], sse).'''
    _chunk_check(int(ff.shape[0]), chunk)
    kl = kl.long()
    ff = ff.float()
    r = r.float()
    m = m.float()
    k = window.shape[1]
    lrv = lrv.float()[None, :]
    regv = regv.float()[None, :]
    win = window.float().clone()
    sse = torch.zeros((), dtype=torch.float32, device=window.device)
    for t in range(int(inner_steps)):
        fu = _bf16(win)[kl]
        dot = (fu * ff).sum(-1)
        pred = torch.clamp(mu + dot, 1.0, 5.0)
        err = (r - pred) * m
        if t == 0:
            sse = (err * err).sum()
        g = err[:, None] * ff - regv * fu * m[:, None]
        gx = _bf16(torch.cat([g, m[:, None]], 1))
        acc = torch.zeros((W, k + 1), dtype=torch.float32,
                          device=window.device)
        acc.index_add_(0, kl, gx)
        win = win + lrv * (acc[:, :k] / torch.clamp(acc[:, k:], min=1.0))
    return win, sse


def half_pass_old_ref(F_upd, F_fix, batches, W, lrv, regv, mu,
                      inner_steps=1):
    '''The plain version over batches ``(fix, r, m, kl [nb, B], lo
    [nb])`` in order: window slice, step, write-back.  Updates ``F_upd``
    in place; returns the summed SSE.'''
    fix, r, m, kl, lo = batches
    sse = torch.zeros((), dtype=torch.float32, device=F_upd.device)
    for b, start in enumerate(lo.cpu().tolist()):
        win = F_upd[start:start + W]
        out, sse_b = half_pass_batch_old_ref(
            win, F_fix[fix[b].long()], r[b], m[b], kl[b], lrv, regv, mu, W,
            None, inner_steps)
        win.copy_(out)
        sse = sse + sse_b
    return sse


def half_pass_old(F_upd, F_fix, batches, W, lrv, regv, mu, inner_steps=1,
                  segments=None):
    '''P1 over a list of batches ``(fix, r, m, kl [nb, B], lo [nb])``,
    updating ``F_upd`` [rows, k] f32 in place from ``F_fix`` (bf16 on the
    A/B's path).  CUDA tensors: one launch of ``csrc/half_pass_old.cu``
    over ``segments`` (``build_segments`` of the same batches, required;
    rows of at least ``WIDE_ROW`` ratings in 32-warp blocks on a second
    stream, as K1); CPU tensors: ``half_pass_old_ref``.  Returns the SSE
    of the first sweeps.  Raises on what the kernel does not take and on
    a CUDA error at launch.'''
    hk._check_args(F_upd, F_fix, batches, W, lrv, regv, 'identity',
                   inner_steps)
    dev = F_upd.device
    if dev.type == 'cpu':
        return half_pass_old_ref(F_upd, F_fix, batches, W, lrv, regv, mu,
                                 inner_steps)
    if dev.type != 'cuda':
        raise ValueError('half_pass_old runs on cuda or cpu tensors, not %s'
                         % dev)
    lib = _library()
    k = F_upd.shape[1]

    def tail(sse_rows):
        seg = segments
        return (seg.seg_ptr.data_ptr(), seg.ent_fix.data_ptr(),
                seg.ent_r.data_ptr(), seg.ent_m.data_ptr(), lrv.data_ptr(),
                regv.data_ptr(), float(mu), k, int(inner_steps),
                sse_rows.data_ptr())

    sse, launched = hk.run_segments(
        F_upd, F_fix, segments, lib.half_pass_old_launch,
        lib.half_pass_old_error_string, 'half_pass_old', tail)
    half_pass_old.launches += launched
    return sse


half_pass_old.launches = 0


def half_pass_batch_old(window, ff, r, m, kl, lrv, regv, mu, W, chunk,
                        inner_steps):
    '''P1 on one batch, with the JAX signature: ``window`` [W, k] f32,
    ``ff`` [B, k], ``r``/``m``/``kl`` [B].  Returns (window_out, sse).
    CUDA tensors: the kernel over this batch's segment table (built on
    the host); CPU tensors: ``half_pass_batch_old_ref``.'''
    B = int(ff.shape[0])
    _chunk_check(B, chunk)
    if window.device.type == 'cpu':
        return half_pass_batch_old_ref(window, ff, r, m, kl, lrv, regv, mu,
                                       W, chunk, inner_steps)
    dev = window.device
    host = [x.detach().cpu().numpy()[None] for x in (r, m, kl)]
    fix = np.arange(B, dtype=np.int32)[None]
    seg = hk.build_segments(fix, *host, np.zeros(1, np.int32), W, dev)
    batches = (torch.from_numpy(fix).to(dev), r[None].contiguous(),
               m[None].contiguous(), kl[None].contiguous(),
               torch.zeros(1, dtype=torch.int32, device=dev))
    out = window.contiguous().clone()
    sse = half_pass_old(out, ff.contiguous(), batches, W, lrv, regv, mu,
                        inner_steps, segments=seg)
    return out, sse


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.half_pass_old_error_string.argtypes = [i]
    lib.half_pass_old_error_string.restype = ctypes.c_char_p
    lib.half_pass_old_launch.argtypes = [p, p, i, p, p, p, i, i, i, p, p, p,
                                         p, p, p, f, i, i, p, p]
    lib.half_pass_old_launch.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('half_pass_old', _declare)
