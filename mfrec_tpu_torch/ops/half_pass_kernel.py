'''
K1, the fused sorted-window SGD batch step: the hand-written CUDA kernel
(``csrc/half_pass.cu``) and its plain PyTorch version.

Port of ``mfrec_tpu/ops/pallas_half_pass.py`` (``half_pass_batch``;
bodies ``_kernel_tloop``, ``_kernel`` and ``_kernel_resident``, which
compute the same step).  One batch step takes a window ``[W, k]`` f32 of
the updated factor side, the batch's fixed-side rows ``ff [B, k]``,
``r``, ``m``, ``kl [B]`` (window-local row ids), the per-column ``lrv``,
``regv [k]`` and ``mu``, and runs T gradient sweeps with the TPU
kernel's rounding: the window is read in bf16, ``eff*ff`` is rounded to
bf16 before it is summed per row in f32, and for k > 128 the
prediction's products are rounded to bf16 before their f32 sum (the JAX
epoch's ``dot_sum`` gate).  The SSE is the residual of the first
sweep.

``half_pass_batch_ref`` is that step in plain torch, ``half_pass_ref``
loops it over a layout's batches (window slice, step, write-back).
``half_pass`` is the wrapper: for CUDA tensors it launches K1 once over
the whole list of batches, for CPU tensors it runs ``half_pass_ref`` --
by where the tensors lie, never by what is installed.  The CUDA kernel
works row by row from a segment table (``build_segments``, built once
per layout on the host): window rows do not interact, so a half-pass is,
per updated row, its per-batch segments in batch order, T sweeps each.
The link and the fixed side's type are compile-time options: four
builds (``csrc/half_pass{,_f32,_logistic,_logistic_f32}.cu`` over
``csrc/half_pass.cuh``), one library each.  Both paths update ``F_upd``
in place (the JAX package donates it).  ``half_pass.launches`` counts
the calls that launched the kernel: one per half-pass (a call with hot
rows launches one grid of 8-warp blocks and one of clusters).
'''
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

MAX_K = 256
LINKS = ('identity', 'logistic')
# rows with at least this many ratings run in blocks of 32 warps instead
# of 8 (at k <= WIDE_MAX_K), on a second stream beside the others (P1)
WIDE_ROW = 4096
WIDE_MAX_K = 160
# K1 runs a row as a thread-block cluster (8 blocks, at k <= WIDE_MAX_K,
# on the second stream) when it has at least CLUSTER_ROW ratings and at
# least CLUSTER_SEG per segment on average: a cluster pays a barrier per
# sweep, which only long segments amortize.  16,384 measured the
# shortest item half-pass at the ML-10M shape on an H100 (PERF.md)
CLUSTER_ROW = 16384
CLUSTER_SEG = 1024
# K1's builds by (link, fixed side in bf16)
LIBRARIES = {('identity', True): 'half_pass', ('identity', False):
             'half_pass_f32', ('logistic', True): 'half_pass_logistic',
             ('logistic', False): 'half_pass_logistic_f32'}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def half_pass_batch_ref(window, ff, r, m, kl, lrv, regv, mu, W,
                        inner_steps=1, clamp_pred=True, lo_r=1.0, hi_r=5.0,
                        row_mean=True, bias_none=False, link='identity'):
    '''One batch step in plain torch, sweep by sweep as ``_kernel_tloop``
    computes it.  ``window`` [W, k] f32, ``ff`` [B, k] (bf16 or f32),
    ``r``/``m`` [B] f32, ``kl`` [B] int (every entry in [0, W)),
    ``lrv``/``regv`` [k] f32.  Returns (window_out [W, k] f32, sse
    0-dim f32).'''
    dot_sum = window.shape[1] <= 128
    kl = kl.long()
    ff = ff.float()
    m = m.float()
    r = r.float()
    cnt = torch.zeros(W, dtype=torch.float32, device=window.device)
    cnt.index_add_(0, kl, _bf16(m))
    alive = (cnt > 0).float()[:, None]
    den = torch.clamp(cnt, min=1.0)[:, None]
    lrv = lrv.float()[None, :]
    regv = regv.float()[None, :]
    win = window.float().clone()
    sse = None
    for t in range(int(inner_steps)):
        fu = _bf16(win)[kl]
        prod = fu * ff
        dot = (prod if dot_sum else _bf16(prod)).sum(1)
        if link == 'logistic':
            rng_w = hi_r - lo_r
            sig = torch.sigmoid(dot)
            pred = lo_r + sig * rng_w
            err = (r - pred) * m
            eff = err * sig * (1.0 - sig) * rng_w
        else:
            pred = (1.0 + dot) if bias_none else (mu + dot)
            if clamp_pred:
                pred = torch.clamp(pred, lo_r, hi_r)
            err = (r - pred) * m
            eff = err
        if t == 0:
            sse = (err * err).sum()
        acc = torch.zeros_like(win)
        acc.index_add_(0, kl, _bf16(eff[:, None] * ff))
        reg = regv * win
        if row_mean:
            gsum = acc / den - reg * alive
        else:
            gsum = acc - reg * cnt[:, None]
        win = win + lrv * gsum
    return win, sse


def half_pass_ref(F_upd, F_fix, batches, W, lrv, regv, mu, inner_steps=1,
                  clamp_pred=True, lo_r=1.0, hi_r=5.0, row_mean=True,
                  bias_none=False, link='identity'):
    '''The plain version over a list of batches, in order: slice each
    batch's window at ``lo``, gather its fixed rows, run
    ``half_pass_batch_ref``, write the window back.  ``batches`` is
    ``(fix [nb, B], r, m, kl [nb, B], lo [nb])``.  Updates ``F_upd`` in
    place; returns the summed SSE (0-dim f32).'''
    fix, r, m, kl, lo = batches
    lo_host = lo.cpu().tolist()
    sse = torch.zeros((), dtype=torch.float32, device=F_upd.device)
    for b, start in enumerate(lo_host):
        win = F_upd[start:start + W]
        out, sse_b = half_pass_batch_ref(
            win, F_fix[fix[b].long()], r[b], m[b], kl[b], lrv, regv, mu, W,
            inner_steps, clamp_pred, lo_r, hi_r, row_mean, bias_none, link)
        win.copy_(out)
        sse = sse + sse_b
    return sse


class Segments(NamedTuple):
    '''K1's work list for one set of batches (host-built, on a device).

    Blocks are rows, longest first: ``blk_row`` is the updated row of
    block x and ``blk_seg0``/``blk_seg1`` its segments.  Segment s covers
    entries ``seg_ptr[s]:seg_ptr[s+1]`` (one row's masked-in ratings of
    one batch, in batch order) and ``seg_cnt[s]`` is their sum of
    bf16(m).  ``ent_fix``/``ent_r``/``ent_m`` are the entries' fixed-side
    row, rating and mask, ``ent_row`` their updated row (K4's phase
    aggregation gathers by it).  ``longest`` is the largest row's entry
    count,
    ``longest_segments`` its number of segments; ``max_row`` and
    ``max_fix`` bound the rows it reads (host ints, so the wrapper checks
    them without a device sync); the first ``n_cluster`` blocks are K1's
    cluster rows (``CLUSTER_ROW``, ``CLUSTER_SEG``), longest first, then
    the other rows longest first, so that the first ``n_wide`` blocks are
    the rows of at least ``WIDE_ROW`` ratings; ``blk_len`` (numpy, on the
    host) is each block's entry count.'''
    blk_row: torch.Tensor
    blk_seg0: torch.Tensor
    blk_seg1: torch.Tensor
    seg_ptr: torch.Tensor
    seg_cnt: torch.Tensor
    ent_fix: torch.Tensor
    ent_r: torch.Tensor
    ent_m: torch.Tensor
    longest: int
    longest_segments: int
    max_row: int
    max_fix: int
    n_wide: int
    ent_row: torch.Tensor
    blk_len: np.ndarray
    n_cluster: int


def build_segments(fix, r, m, kl, lo, W, device):
    '''The segment table of batches ``(fix, r, m, kl [nb, B], lo [nb])``
    (numpy), on ``device``.  Entries with m == 0 are left out (they add
    nothing, and the layout's padding slots carry kl = 0 out of order);
    every other entry must have 0 <= kl < W.'''
    fix, r, m = np.asarray(fix), np.asarray(r, np.float32), \
        np.asarray(m, np.float32)
    kl, lo = np.asarray(kl), np.asarray(lo)
    b_idx, j_idx = np.nonzero(m != 0)          # batch-major order
    local = kl[b_idx, j_idx].astype(np.int64)
    if local.size and (local.min() < 0 or local.max() >= W):
        raise ValueError('a masked-in entry has kl outside [0, %d)' % W)
    rows = lo[b_idx].astype(np.int64) + local
    # stable: a row's entries keep batch order, then position order
    order = np.argsort(rows, kind='stable')
    rows, b_idx, j_idx = rows[order], b_idx[order], j_idx[order]
    n = rows.size
    if n >= 2 ** 31:
        raise ValueError('%d entries: the segment table indexes int32' % n)
    new_seg = np.ones(n, bool)
    new_seg[1:] = (rows[1:] != rows[:-1]) | (b_idx[1:] != b_idx[:-1])
    seg_start = np.nonzero(new_seg)[0]
    seg_ptr = np.append(seg_start, n)
    seg_row = rows[seg_start]
    m_ent = m[b_idx, j_idx]
    m16 = torch.from_numpy(m_ent).to(torch.bfloat16).float().numpy()
    seg_cnt = np.add.reduceat(m16, seg_start) if n else \
        np.zeros(0, np.float32)
    new_row = np.ones(seg_row.size, bool)
    new_row[1:] = seg_row[1:] != seg_row[:-1]
    row_first = np.nonzero(new_row)[0]
    row_end = np.append(row_first[1:], seg_row.size)
    row_len = seg_ptr[row_end] - seg_ptr[row_first]
    row_nseg = row_end - row_first
    cluster = (row_len >= CLUSTER_ROW) & (row_len >= CLUSTER_SEG * row_nseg)
    # K1's cluster rows, then the others; longest first within each (ties
    # in row order), so the long chains start first
    lpt = np.lexsort((-row_len, ~cluster))

    ent_fix = fix[b_idx, j_idx]

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return Segments(
        blk_row=t(seg_row[row_first][lpt], np.int32),
        blk_seg0=t(row_first[lpt], np.int32),
        blk_seg1=t(row_end[lpt], np.int32),
        seg_ptr=t(seg_ptr, np.int32), seg_cnt=t(seg_cnt, np.float32),
        ent_fix=t(ent_fix, np.int32),
        ent_r=t(r[b_idx, j_idx], np.float32), ent_m=t(m_ent, np.float32),
        longest=int(row_len.max()) if row_len.size else 0,
        longest_segments=int(row_nseg[np.argmax(row_len)])
        if row_len.size else 0,
        max_row=int(rows.max()) if n else -1,
        max_fix=int(ent_fix.max()) if n else -1,
        n_wide=int((row_len >= WIDE_ROW).sum()),
        ent_row=t(rows, np.int32), blk_len=row_len[lpt].astype(np.int64),
        n_cluster=int(cluster.sum()))


def _check_args(F_upd, F_fix, batches, W, lrv, regv, link, inner_steps):
    dev = F_upd.device
    if F_upd.dim() != 2 or F_fix.dim() != 2 or \
            F_fix.shape[1] != F_upd.shape[1]:
        raise ValueError('F_upd [rows, k] and F_fix [rows, k] must share k')
    k = F_upd.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError('k=%d: 1..%d' % (k, MAX_K))
    if F_upd.dtype != torch.float32:
        raise ValueError('F_upd must be float32, got %s' % F_upd.dtype)
    if F_fix.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError('F_fix must be float32 or bfloat16, got %s'
                         % F_fix.dtype)
    for name, t in (('F_upd', F_upd), ('F_fix', F_fix), ('lrv', lrv),
                    ('regv', regv)) + tuple(zip(('fix', 'r', 'm', 'kl', 'lo'),
                                                batches)):
        if t.device != dev:
            raise ValueError('%s is on %s, F_upd on %s' % (name, t.device,
                                                          dev))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    for name, t in (('lrv', lrv), ('regv', regv)):
        if t.dtype != torch.float32 or tuple(t.shape) != (k,):
            raise ValueError('%s must be float32 [%d]' % (name, k))
    if link not in LINKS:
        raise ValueError('link must be one of %s, got %r' % (LINKS, link))
    if int(inner_steps) < 1:
        raise ValueError('inner_steps must be >= 1')
    lo = batches[4]
    if dev.type == 'cpu' and lo.numel() and \
            int(lo.max()) + W > F_upd.shape[0]:
        raise ValueError('a window runs past the end of F_upd (pad it by W '
                         'rows)')


def half_pass(F_upd, F_fix, batches, W, lrv, regv, mu, inner_steps=1,
              clamp_pred=True, lo_r=1.0, hi_r=5.0, row_mean=True,
              bias_none=False, link='identity', segments=None):
    '''K1 over a list of batches ``(fix, r, m, kl [nb, B], lo [nb])``,
    updating ``F_upd`` [rows, k] f32 in place from ``F_fix`` [rows, k]
    (bf16 on the SGD path, f32 on the SVD++ and FN paths).  CUDA
    tensors: one launch of K1's build for ``link`` and ``F_fix``'s type
    over ``segments`` (``build_segments`` of the same batches, required;
    the rows of at least ``CLUSTER_ROW`` ratings as thread-block clusters
    on a second stream, joined back before it returns); CPU tensors:
    ``half_pass_ref``.  Returns the
    SSE of the batches' first sweeps (0-dim f32).  Raises on a device,
    dtype, shape or option the kernel does not take, and on a CUDA error
    at launch.'''
    _check_args(F_upd, F_fix, batches, W, lrv, regv, link, inner_steps)
    dev = F_upd.device
    if dev.type == 'cpu':
        return half_pass_ref(F_upd, F_fix, batches, W, lrv, regv, mu,
                             inner_steps, clamp_pred, lo_r, hi_r, row_mean,
                             bias_none, link)
    if dev.type != 'cuda':
        raise ValueError('half_pass runs on cuda or cpu tensors, not %s'
                         % dev)
    lib = _library(LIBRARIES[link, F_fix.dtype == torch.bfloat16])
    k = F_upd.shape[1]
    inf = float('inf')
    # the options as per-launch scalars: the prediction's base, and the
    # clamp's bounds (+-inf when off)
    base = 1.0 if bias_none else float(mu)
    lo_c, hi_c = (float(lo_r), float(hi_r)) if clamp_pred else (-inf, inf)

    def tail(sse_rows):
        seg = segments
        return (seg.seg_ptr.data_ptr(), seg.seg_cnt.data_ptr(),
                seg.ent_fix.data_ptr(), seg.ent_r.data_ptr(),
                seg.ent_m.data_ptr(), lrv.data_ptr(), regv.data_ptr(),
                base, lo_c, hi_c, float(lo_r), float(hi_r), k,
                int(inner_steps), int(bool(row_mean)), sse_rows.data_ptr())

    sse, launched = run_segments(
        F_upd, F_fix, segments, lib.half_pass_launch,
        lib.half_pass_error_string, 'half_pass', tail,
        n_wide=None if segments is None else segments.n_cluster)
    half_pass.launches += launched
    return sse


def run_segments(F_upd, F_fix, seg, launch, error_string, name, tail,
                 n_wide=None):
    '''Launch a kernel of K1's row design (``csrc/half_pass.cuh``,
    ``csrc/half_pass_old.cu``) over segment table ``seg``:
    ``launch(*head, begin, end, wide, *tail(sse_rows), stream)`` once per
    block kind, the first ``n_wide`` blocks (default ``seg.n_wide``, the
    rows of at least ``WIDE_ROW`` ratings; ``wide``: K1's clusters, P1's
    32-warp blocks) on a second stream joined back before it returns.
    Checks ``seg`` against the factors; raises on a CUDA error at launch.
    Returns (SSE as a 0-dim f32, whether it launched: not when nothing is
    masked in).'''
    dev = F_upd.device
    if seg is None:
        raise ValueError('a CUDA half-pass needs the segment table '
                         '(build_segments)')
    for field in Segments._fields[:8]:
        t = getattr(seg, field)
        if t.device != dev or not t.is_contiguous():
            raise ValueError('segments.%s must be contiguous on %s'
                             % (field, dev))
    k = F_upd.shape[1]
    if seg.max_row >= F_upd.shape[0] or seg.max_fix >= F_fix.shape[0]:
        raise ValueError('the segment table reads past F_upd or F_fix')
    n_blocks = int(seg.blk_row.shape[0])
    if n_blocks == 0:                    # nothing masked in: no launch
        return torch.zeros((), dtype=torch.float32, device=dev), False
    n_wide = (seg.n_wide if n_wide is None else n_wide) \
        if k <= WIDE_MAX_K else 0
    with torch.cuda.device(dev):
        main = torch.cuda.current_stream(dev)
        sse_rows = torch.empty(n_blocks, dtype=torch.float32, device=dev)
        head = (F_upd.data_ptr(), F_fix.data_ptr(),
                int(F_fix.dtype == torch.bfloat16), seg.blk_row.data_ptr(),
                seg.blk_seg0.data_ptr(), seg.blk_seg1.data_ptr())
        rest = tail(sse_rows)
        side = _side_stream(dev) if n_wide else None
        grids = [(0, n_wide, 1, side)] if n_wide else []
        if n_wide < n_blocks:
            grids.append((n_wide, n_blocks, 0, main))
        if side is not None:
            side.wait_stream(main)       # its inputs are written on main
        for begin, end, wide, stream in grids:
            rc = launch(*head, begin, end, wide, *rest, stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(
                    '%s kernel launch failed: CUDA error %d (%s)'
                    % (name, rc, error_string(rc).decode()))
        if side is not None:
            main.wait_stream(side)
    return sse_rows.sum(), True


half_pass.launches = 0
_side_streams = {}


def _side_stream(dev):
    '''The second stream of ``dev`` that the long rows' blocks run on.'''
    if dev not in _side_streams:
        _side_streams[dev] = torch.cuda.Stream(dev)
    return _side_streams[dev]


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.half_pass_error_string.argtypes = [i]
    lib.half_pass_error_string.restype = ctypes.c_char_p
    lib.half_pass_launch.argtypes = [p, p, i, p, p, p, i, i, i, p, p, p, p,
                                     p, p, p, f, f, f, f, f, i, i, i, p, p]
    lib.half_pass_launch.restype = i


def _library(name='half_pass'):
    '''One of K1's builds (``LIBRARIES``), built if needed.'''
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load(name, _declare)
