'''
P2, the deletion-probe variants of the sorted-window batch step: the
hand-written CUDA kernel (``csrc/probe.cu``) and its plain PyTorch
version.

Port of ``tools/kernel_probe.py`` (``run_one``, bodies ``make_kernel``
and ``make_kernel_2d``).  Each variant is K1's batch step (bf16 window
read, the row mean with the regularization identity and the alive mask,
the count built at t = 0, mu + dot clamped to [1, 5]) with one part
deleted or re-rounded, for timing only.  ``VARIANTS`` maps each of the
probe's seventeen names to the function it computes here (the probe's
1D/2D, ohT and ones-matvec distinctions are TPU layouts of the same
function); ``csrc/probe.cu`` lists them.

``probe_chain`` runs ``n_chain`` chained calls (each call's window feeds
the next, as the probe's ``run_chain`` scans them) on one problem
(``window`` [W, k], ``ff`` [B, k], ``r``/``m``/``kl`` [B]) or on G
independent ones (a leading G dimension).  ``ff`` is f32, as the probe
passes it, or bf16 (K1's storage) for the f32-dot variants ('full' and
its layouts).  CUDA tensors launch the kernel once, CPU tensors run the
plain version ``probe_chain_ref``.  ``probe_tables`` builds the kernel's
entry table once per ``kl``; pass it to time the launch alone.
``probe_chain.launches`` counts the launches.

The chunk ``ch`` matters only to the no_acc variants.  Their Pallas
bodies keep the dot alive with a 1e-6-scaled term of one entry per
chunk, which the plain version transcribes; the kernel leaves it out
(a per-row sum of the errors keeps its dot instead).  At the probe's
shape that term is ~1e-9 a sweep and moves no window entry by more than
2e-7 in ten sweeps, so both give the same window to rounding: the
regularization shrink alone.
'''
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

MAX_K = 128
# the function each probe variant computes, in csrc/probe.cu's V_* order
FUNCTIONS = ('f32dot', 'b16dot', 'b16chain', 'nofu', 'nofu_b16', 'noelem',
             'noelem_2d', 'nodot', 'noprod', 'noacc', 'noacc_2d')
VARIANTS = {
    'full': 'f32dot', 'dot_mxu': 'f32dot', 'all2d_sumk': 'f32dot',
    'all2d_sumk_ohT': 'f32dot',
    'dot_mxu_b16': 'b16dot', 'all2d': 'b16dot', 'all2d_ohT': 'b16dot',
    'bf16_chain': 'b16chain', 'all2d_bf16': 'b16chain',
    'no_fu': 'nofu', 'all2d_no_fu': 'nofu_b16',
    'no_elem': 'noelem', 'all2d_no_elem': 'noelem_2d',
    'all2d_no_dot': 'nodot', 'all2d_no_prod': 'noprod',
    'no_acc': 'noacc', 'all2d_no_acc': 'noacc_2d'}
NO_ACC = ('noacc', 'noacc_2d')


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _function(variant):
    if variant not in VARIANTS:
        raise ValueError('unknown probe variant %r (one of %s)'
                         % (variant, sorted(VARIANTS)))
    return VARIANTS[variant]


def _check_ch(B, ch, W, fn):
    if ch < 1 or B % ch:
        raise ValueError('the batch (%d) must be a multiple of the chunk '
                         '(%d): the TPU grid drops a ragged tail' % (B, ch))
    if fn in NO_ACC and ch < W:
        raise ValueError('the no_acc variants read W=%d rows of each chunk: '
                         'ch=%d is too small' % (W, ch))


def probe_step_ref(window, ff, r, m, kl, lrv, regv, variant, T, ch,
                   mu=3.5):
    '''One call of ``variant`` in plain torch, sweep by sweep as the
    Pallas body computes it.  ``window`` [W, k] f32, ``ff`` [B, k],
    ``r``/``m`` [B] f32, ``kl`` [B] in [0, W), ``lrv``/``regv`` [k].
    Returns (window_out [W, k], sse of the first sweep).'''
    fn = _function(variant)
    W, k = window.shape
    B = ff.shape[0]
    _check_ch(B, ch, W, fn)
    dev = window.device
    kl = kl.long()
    ff = ff.float()
    ffv = _bf16(ff) if fn == 'b16chain' else ff
    cnt = torch.zeros(W, dtype=torch.float32, device=dev)
    cnt.index_add_(0, kl, _bf16(m))
    alive = (cnt > 0).float()[:, None]
    den = torch.clamp(cnt, min=1.0)[:, None]
    lrv = lrv.float()[None, :]
    regv = regv.float()[None, :]
    win = window.float().clone()
    sse = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(int(T)):
        fu = ffv if fn in ('nofu', 'nofu_b16') else _bf16(win)[kl]
        prod = fu * ffv
        if fn in ('f32dot', 'nofu', 'noacc'):
            dot = prod.sum(1)
        elif fn == 'nodot':
            dot = _bf16(prod[:, 0])
        elif fn == 'noprod':
            dot = fu[:, 0]
        else:
            dot = _bf16(prod).sum(1)
        if fn == 'noelem':
            err = r
        elif fn == 'noelem_2d':
            err = r + dot * 1e-6
        else:
            err = (r - torch.clamp(mu + dot, 1.0, 5.0)) * m
        if t == 0:
            sse = (err * err).sum()
        acc = torch.zeros((W, k), dtype=torch.float32, device=dev)
        if fn == 'noacc':
            for j in range(B // ch):
                acc = acc + err[j * ch] * ff[j * ch:j * ch + W] * 1e-6
        elif fn == 'noacc_2d':
            gops = _bf16(err[:, None] * ff)
            for j in range(B // ch):
                acc = acc + gops[j * ch:j * ch + W] * 1e-6
        else:
            e = _bf16(err) if fn == 'b16chain' else err
            acc.index_add_(0, kl, _bf16(e[:, None] * ffv))
        reg = regv * win
        win = win + lrv * (acc / den - reg * alive)
    return win, sse


def probe_chain_ref(window, ff, r, m, kl, lrv, regv, variant, T, n_chain=1,
                    ch=None, mu=3.5):
    '''``n_chain`` chained calls of ``probe_step_ref`` per problem (one,
    or G with a leading dimension).  Returns (windows, summed sse).'''
    single = window.dim() == 2
    if single:
        window, ff, r, m, kl = (x[None] for x in (window, ff, r, m, kl))
    ch = int(ch or ff.shape[1])
    outs = []
    sse = torch.zeros((), dtype=torch.float32, device=window.device)
    for g in range(window.shape[0]):
        win = window[g]
        for _ in range(int(n_chain)):
            win, s = probe_step_ref(win, ff[g], r[g], m[g], kl[g], lrv,
                                    regv, variant, T, ch, mu)
            sse = sse + s
        outs.append(win)
    out = torch.stack(outs) if outs else window.clone()
    return (out[0] if single else out), sse


class ProbeTables(NamedTuple):
    '''The kernel's work list for one ``kl`` (G problems of B entries in
    W-row windows): ``ent`` the entries grouped by row (stable, as flat
    indices into the G*B entries), ``seg_ptr`` [G*W + 1] each row's range
    in it.'''
    G: int
    W: int
    B: int
    seg_ptr: torch.Tensor
    ent: torch.Tensor


def probe_tables(kl, W):
    '''``ProbeTables`` of ``kl`` ([B] or [G, B] int, every entry in [0,
    W)), on kl's device.'''
    klg = kl.reshape(-1, kl.shape[-1])
    G, B = klg.shape
    host = klg.detach().cpu().numpy().astype(np.int64)
    if host.size and (host.min() < 0 or host.max() >= W):
        raise ValueError('kl must lie in [0, %d)' % W)
    key = (np.arange(G, dtype=np.int64) * W)[:, None] + host
    ent = np.argsort(key.ravel(), kind='stable')
    seg_ptr = np.zeros(G * W + 1, np.int64)
    np.cumsum(np.bincount(key.ravel(), minlength=G * W), out=seg_ptr[1:])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            kl.device)

    return ProbeTables(G=G, W=W, B=B, seg_ptr=t(seg_ptr), ent=t(ent))


def probe_chain(window, ff, r, m, kl, lrv, regv, variant, T, n_chain=1,
                ch=None, mu=3.5, tables=None):
    '''``n_chain`` chained calls of probe variant ``variant`` at T sweeps
    on one problem (``window`` [W, k] f32, ``ff`` [B, k], ``r``/``m``/``kl``
    [B]) or G (a leading dimension on each).  ``ff`` is f32, or bf16 for
    the f32-dot variants.  ``ch`` (default B): the chunk.  CUDA tensors:
    one launch of ``csrc/probe.cu`` (``tables`` from ``probe_tables``,
    built here if not given); CPU tensors: ``probe_chain_ref``.  Returns
    (windows, sse summed over the calls).  Raises on what the kernel does
    not take and on a CUDA error at launch.'''
    fn = _function(variant)
    dev = window.device
    W, k = window.shape[-2:]
    B = ff.shape[-2]
    ch = int(ch or B)
    if not 1 <= k <= MAX_K:
        raise ValueError('k=%d: 1..%d' % (k, MAX_K))
    if int(T) < 1 or int(n_chain) < 0:
        raise ValueError('T >= 1 and n_chain >= 0')
    _check_ch(B, ch, W, fn)
    for name, x in (('window', window), ('ff', ff), ('r', r), ('m', m),
                    ('kl', kl), ('lrv', lrv), ('regv', regv)):
        if x.device != dev:
            raise ValueError('%s is on %s, window on %s' % (name, x.device,
                                                           dev))
        if not x.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
        ok = (torch.float32, torch.bfloat16) if name == 'ff' and \
            fn == 'f32dot' else (torch.float32,)
        if name != 'kl' and x.dtype not in ok:
            raise ValueError('%s of %s must be %s, got %s'
                             % (name, variant, ' or '.join(map(str, ok)),
                                x.dtype))
    if tuple(ff.shape[-1:]) != (k,) or tuple(lrv.shape) != (k,) or \
            tuple(regv.shape) != (k,) or r.shape != kl.shape or \
            m.shape != kl.shape or tuple(kl.shape[-1:]) != (B,):
        raise ValueError('shapes: window [.., W, k], ff [.., B, k], r/m/kl '
                         '[.., B], lrv/regv [k]')
    if dev.type == 'cpu':
        return probe_chain_ref(window, ff, r, m, kl, lrv, regv, variant, T,
                               n_chain, ch, mu)
    if dev.type != 'cuda':
        raise ValueError('probe_chain runs on cuda or cpu tensors, not %s'
                         % dev)
    tab = tables if tables is not None else probe_tables(kl, W)
    G = window.numel() // (W * k)
    if (tab.G, tab.W, tab.B) != (G, W, B) or tab.ent.device != dev:
        raise ValueError('the tables were built for another shape or device')
    lib = _library()
    out = window.clone()
    sse_rows = torch.empty(G * W, dtype=torch.float32, device=dev)
    live = torch.empty(G * W, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        rc = lib.probe_launch(
            out.data_ptr(), ff.data_ptr(), int(ff.dtype == torch.bfloat16),
            r.data_ptr(), m.data_ptr(), tab.seg_ptr.data_ptr(),
            tab.ent.data_ptr(), lrv.data_ptr(), regv.data_ptr(), float(mu),
            k, int(T), int(n_chain), G * W, FUNCTIONS.index(fn),
            sse_rows.data_ptr(), live.data_ptr(), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError('probe kernel launch failed: CUDA error %d (%s)'
                           % (rc, lib.probe_error_string(rc).decode()))
    probe_chain.launches += 1
    return out, sse_rows.sum()


probe_chain.launches = 0


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_error_string.argtypes = [i]
    lib.probe_error_string.restype = ctypes.c_char_p
    lib.probe_launch.argtypes = [p, p, i, p, p, p, p, p, p, f, i, i, i, i, i,
                                 p, p, p]
    lib.probe_launch.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('probe', _declare)
