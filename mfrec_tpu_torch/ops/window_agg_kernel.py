'''
K4, sorted-window gradient aggregation: the hand-written CUDA kernel
(``csrc/window_agg.cu``) and its plain PyTorch version.

Port of ``mfrec_tpu/ops/pallas_window_agg.py`` (``window_aggregate``,
body ``_agg_kernel``).  For per-sample rows ``g [B, k]`` f32, window-local
ids ``kl [B]`` and a mask ``[B]``:

    gsum[w] = sum_{j: kl_j = w, mask_j > 0} bf16(g_j)      summed in f32
    cnt[w]  = #{j: kl_j = w, mask_j > 0}

Rows with ``mask == 0`` count nowhere, whatever their id.  Each element
is rounded to bf16 (round to nearest even) and the sum is taken in f32,
as the TPU kernel's bf16 one-hot product with f32 accumulation takes it.

Three entry points, each with its plain version beside it:

* ``window_aggregate(g, kl, mask, W)`` -> ``(gsum [W, k], cnt [W])``: one
  call of the JAX signature (an index-list launch, then a per-row sum);
  ``window_aggregate_ref`` is ``index_add_`` of the bf16-rounded rows plus
  a count.
* ``scan_aggregate(target, vals, segments)``: a whole phase of a
  sorted-pass layout in one launch -- ``target[row] += `` each of the
  row's per-batch sums, in batch order, as ``_scan_window_agg``'s scan
  adds them -- over K1's segment table
  (``half_pass_kernel.build_segments``), with ``vals`` the rows in the
  table's entry order; ``scan_aggregate_ref`` is the plain version.
* ``step_aggregate(targets, G, segments, coef, decay, step, row_mean)``:
  the SVD++ / FN item step of a whole epoch in one launch -- per updated
  row, over its segments in batch order, ``y += step *
  agg(bf16((c*G[u] - decay*y)*m))`` -- the per-batch ``_agg_window`` loop
  of ``make_alternating_implicit_epoch`` and ``make_fn_alternating_epoch``
  window by window; ``step_aggregate_ref`` is the plain version.

Each wrapper launches the CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors -- by where the tensors lie, never by what is
installed -- and raises for anything else.  ``window_aggregate.launches``,
``scan_aggregate.launches`` and ``step_aggregate.launches`` count the
calls that launched a kernel.
'''
from __future__ import annotations

import ctypes

import torch

MAX_K = 256
# the item step runs rows of at least this many entries one 16-warp block
# each (the hot items), every other row one warp
STEP_BLOCK_ROW = 512


def _bf16(x):
    return x.to(torch.bfloat16).float()


def window_aggregate_ref(g, kl, mask, W):
    '''The plain version of ``window_aggregate``: ``index_add_`` of the
    bf16-rounded masked-in rows, and their count.'''
    keep = mask > 0
    idx = kl[keep].long()
    gsum = torch.zeros((W, g.shape[1]), dtype=torch.float32, device=g.device)
    gsum.index_add_(0, idx, _bf16(g[keep]))
    cnt = torch.zeros(W, dtype=torch.float32, device=g.device)
    cnt.index_add_(0, idx, torch.ones(idx.shape[0], dtype=torch.float32,
                                      device=g.device))
    return gsum, cnt


def _check_call(g, kl, mask, W, check_ids):
    if g.dim() != 2 or kl.dim() != 1 or mask.dim() != 1 or \
            kl.shape[0] != g.shape[0] or mask.shape[0] != g.shape[0]:
        raise ValueError('g [B, k], kl [B] and mask [B] must share B')
    if not 1 <= g.shape[1] <= MAX_K:
        raise ValueError('k=%d: 1..%d' % (g.shape[1], MAX_K))
    if int(W) < 1:
        raise ValueError('W must be >= 1')
    for name, t, dtype in (('g', g, torch.float32), ('kl', kl, torch.int32),
                           ('mask', mask, torch.float32)):
        if t.dtype != dtype:
            raise ValueError('%s must be %s, got %s' % (name, dtype, t.dtype))
        if t.device != g.device:
            raise ValueError('%s is on %s, g on %s' % (name, t.device,
                                                      g.device))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    if check_ids and bool((((kl < 0) | (kl >= W)) & (mask > 0)).any()):
        raise ValueError('a masked-in row has kl outside [0, %d)' % W)


def window_aggregate(g, kl, mask, W, check_ids=True):
    '''K4: ``(gsum [W, k] f32, cnt [W] f32)`` of ``g [B, k]`` f32 by
    ``kl [B]`` int32 under ``mask [B]`` f32.  CUDA tensors: one launch of
    ``csrc/window_agg.cu``; CPU tensors: ``window_aggregate_ref``.

    ``check_ids`` checks ``0 <= kl < W`` for the masked-in rows (a device
    sync on CUDA); the training epochs pass False, their layouts having
    been checked once when they were built.  Raises on a device, dtype,
    shape or contiguity the kernel does not take, and on a CUDA error at
    launch.'''
    W = int(W)
    _check_call(g, kl, mask, W, check_ids)
    dev = g.device
    if dev.type == 'cpu':
        return window_aggregate_ref(g, kl, mask, W)
    if dev.type != 'cuda':
        raise ValueError('window_aggregate runs on cuda or cpu tensors, not '
                         '%s' % dev)
    B, k = g.shape
    lib = _library()
    # one allocation (a call is a few microseconds of device time, so the
    # host's share matters): gsum [W, k] and cnt [W] as f32, then the
    # rows' index lists -- offsets [W+1], the permutation [B] and, when
    # they do not fit in shared memory, the per-(row, warp) counts
    n_hist = _scratch_ints(lib, W)
    n_out = W * k + W
    with torch.cuda.device(dev):
        buf = torch.empty(n_out + W + 1 + max(B, 1) + n_hist,
                          dtype=torch.int32, device=dev)
        out = buf[:n_out].view(torch.float32)
        gsum, cnt = out[:W * k].view(W, k), out[W * k:]
        ptr = buf.data_ptr() + 4 * n_out
        rc = lib.window_agg_launch(
            g.data_ptr(), kl.data_ptr(), mask.data_ptr(), B, k, W,
            gsum.data_ptr(), cnt.data_ptr(), ptr, ptr + 4 * (W + 1),
            ptr + 4 * (W + 1 + max(B, 1)) if n_hist else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc)
    window_aggregate.launches += 1
    return gsum, cnt


window_aggregate.launches = 0
_scratch = {}


def _scratch_ints(lib, W):
    '''The int32 scratch the index lists need beyond offsets and the
    permutation at window W (the C side's rule), cached per W.'''
    if W not in _scratch:
        _scratch[W] = int(lib.window_agg_scratch_ints(W))
    return _scratch[W]


def scan_aggregate_ref(target, vals, segments, mean=False):
    '''The plain version of ``scan_aggregate``: each segment's sum of
    bf16-rounded rows (``index_add_``; divided by its length when
    ``mean``), added into its row's target in segment (batch) order, in
    the target's type (float64 gives the exact sums of the bf16 rows).'''
    seg = segments
    n_seg = int(seg.seg_cnt.shape[0])
    if n_seg == 0:
        return target
    k = vals.shape[1]
    lens = seg.seg_ptr[1:] - seg.seg_ptr[:-1]
    seg_of = torch.repeat_interleave(
        torch.arange(n_seg, device=vals.device), lens.long())
    sums = torch.zeros((n_seg, k), dtype=target.dtype, device=vals.device)
    sums.index_add_(0, seg_of, vals.to(torch.bfloat16).to(target.dtype))
    if mean:
        sums = sums / torch.clamp(lens.to(target.dtype), min=1.0)[:, None]
    rows = seg.blk_row.long()
    first, end = seg.blk_seg0.long(), seg.blk_seg1.long()
    for j in range(int((end - first).max())):
        live = end - first > j
        target[rows[live]] += sums[first[live] + j]
    return target


def _check_scan(target, vals, segments):
    if target.dim() != 2 or vals.dim() != 2 or \
            vals.shape[1] != target.shape[1]:
        raise ValueError('target [rows, k] and vals [n, k] must share k')
    if not 1 <= target.shape[1] <= MAX_K:
        raise ValueError('k=%d: 1..%d' % (target.shape[1], MAX_K))
    if vals.shape[0] != segments.ent_r.shape[0]:
        raise ValueError('vals has %d rows, the segment table %d entries'
                         % (vals.shape[0], segments.ent_r.shape[0]))
    if segments.max_row >= target.shape[0]:
        raise ValueError('the segment table reads past target')
    for name, t in (('target', target), ('vals', vals),
                    ('segments.blk_row', segments.blk_row),
                    ('segments.blk_seg0', segments.blk_seg0),
                    ('segments.blk_seg1', segments.blk_seg1),
                    ('segments.seg_ptr', segments.seg_ptr)):
        if t.device != target.device:
            raise ValueError('%s is on %s, target on %s'
                             % (name, t.device, target.device))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    for name, t in (('target', target), ('vals', vals)):
        if t.dtype != torch.float32:
            raise ValueError('%s must be float32, got %s' % (name, t.dtype))


def scan_aggregate(target, vals, segments, mean=False):
    '''K4 over a whole sorted-pass layout: for every row of the segment
    table ``segments`` (``half_pass_kernel.build_segments``), add each of
    its segments' sums of bf16-rounded ``vals`` rows (``vals [n_ent, k]``
    f32, in the table's entry order; divided by the segment's length when
    ``mean``) into ``target [rows, k]`` f32, in batch order.  Updates and
    returns ``target``.  CUDA tensors: one launch of
    ``csrc/window_agg.cu``; CPU tensors: ``scan_aggregate_ref``.'''
    _check_scan(target, vals, segments)
    dev = target.device
    if dev.type == 'cpu':
        return scan_aggregate_ref(target, vals, segments, mean)
    if dev.type != 'cuda':
        raise ValueError('scan_aggregate runs on cuda or cpu tensors, not %s'
                         % dev)
    n_rows = int(segments.blk_row.shape[0])
    if n_rows == 0:                     # nothing masked in: no launch
        return target
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.scan_agg_launch(
            target.data_ptr(), vals.data_ptr(), segments.blk_row.data_ptr(),
            segments.blk_seg0.data_ptr(), segments.blk_seg1.data_ptr(),
            segments.seg_ptr.data_ptr(), n_rows, target.shape[1],
            int(bool(mean)), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc)
    scan_aggregate.launches += 1
    return target


scan_aggregate.launches = 0


def step_aggregate_ref(targets, G, segments, coef=(None, None),
                       decay=(0.0, 0.0), step=1.0, row_mean=True):
    '''The plain version of ``step_aggregate``, the per-batch loop row by
    row: for j = 0, 1, ... the j-th segment of every row at once (rows do
    not interact), each entry's ``bf16((c*G[u] - decay*y)*m)`` summed per
    segment with ``index_add_`` in entry order (the order of the per-batch
    window sums), divided by the segment's count with ``row_mean``, and
    ``y + step*sum`` written back before segment j+1.'''
    seg = segments
    n_seg = int(seg.seg_cnt.shape[0])
    if n_seg == 0:
        return targets
    dev = G.device
    lens = (seg.seg_ptr[1:] - seg.seg_ptr[:-1]).long()
    seg_of = torch.repeat_interleave(torch.arange(n_seg, device=dev), lens)
    first, end = seg.blk_seg0.long(), seg.blk_seg1.long()
    # each segment's place in its row's chain (blocks are rows longest
    # first, a row's segments contiguous), and each entry's
    per_row = end - first
    pos = torch.arange(n_seg, device=dev) - torch.repeat_interleave(
        torch.cumsum(per_row, 0) - per_row, per_row)
    seg_pos = torch.empty(n_seg, dtype=torch.long, device=dev)
    seg_pos[torch.repeat_interleave(first, per_row) + pos] = pos
    ent_pos = seg_pos[seg_of]
    cnt = torch.clamp(lens.float(), min=1.0)[:, None]
    ent_row = seg.ent_row.long()
    for j in range(int((end - first).max())):
        sel = torch.nonzero(ent_pos == j).flatten()
        rows, segs = ent_row[sel], seg_of[sel]
        Gu = G[seg.ent_fix[sel].long()]
        m = seg.ent_m[sel][:, None]
        live = (first + j)[end - first > j]
        for t, tgt in enumerate(targets):
            cg = Gu if coef[t] is None else coef[t][sel][:, None] * Gu
            vals = (cg - decay[t] * tgt[rows]) * m
            sums = torch.zeros((n_seg, tgt.shape[1]), dtype=torch.float32,
                               device=dev)
            sums.index_add_(0, segs, vals.to(torch.bfloat16).float())
            sums = sums[live]
            if row_mean:
                sums = sums / cnt[live]
            y_rows = ent_row[seg.seg_ptr[live].long()]
            tgt[y_rows] = tgt[y_rows] + step * sums
    return targets


def _check_step(targets, G, segments, coef, decay):
    if len(targets) not in (1, 2) or len(coef) < len(targets) or \
            len(decay) < len(targets):
        raise ValueError('one or two targets, each with its coef and decay')
    k = G.shape[1] if G.dim() == 2 else -1
    if not 1 <= k * len(targets) <= MAX_K:
        raise ValueError('G [rows, k] with k * targets in 1..%d' % MAX_K)
    if segments.max_row >= min(t.shape[0] for t in targets) or \
            segments.max_fix >= G.shape[0]:
        raise ValueError('the segment table reads past a target or G')
    n = int(segments.ent_r.shape[0])
    named = [('G', G)] + [('targets[%d]' % x, t)
                          for x, t in enumerate(targets)]
    named += [('coef[%d]' % x, c) for x, c in enumerate(coef[:len(targets)])
              if c is not None]
    named += [('segments.%s' % f, getattr(segments, f))
              for f in ('blk_row', 'blk_seg0', 'blk_seg1', 'seg_ptr',
                        'ent_fix', 'ent_m', 'ent_row')]
    for name, t in named:
        if t.device != G.device:
            raise ValueError('%s is on %s, G on %s' % (name, t.device,
                                                      G.device))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    for name, t in named[:1 + len(targets)]:
        if t.dim() != 2 or t.shape[1] != k or t.dtype != torch.float32:
            raise ValueError('%s must be float32 [rows, %d]' % (name, k))
    for name, t in named[1 + len(targets):-7]:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError('%s must be float32 [%d]' % (name, n))


def step_aggregate(targets, G, segments, coef=(None, None),
                   decay=(0.0, 0.0), step=1.0, row_mean=True):
    '''The SVD++ / FN item step over a whole sorted-pass layout: for every
    row y of segment table ``segments`` (``half_pass_kernel.build_segments``
    of the item layout; the entries' fixed ids are users), over its
    segments in batch order, ``y += step * agg(bf16((c_e*G[u_e] -
    decay*y)*m_e))`` -- agg the f32 sum over the segment's entries, divided
    by max(count, 1) with ``row_mean``, y the row before that segment.

    ``targets``: one or two [rows, k] f32 tensors updated in place (SVD++'s
    Y; FN's X and Y), ``coef``/``decay`` one per target (``coef`` None for
    c = 1, else a per-entry f32 weight in the table's entry order), ``G``
    [rows_fix, k] f32, k * len(targets) <= 256.  Returns ``targets``.
    CUDA tensors: one launch of ``csrc/window_agg.cu``; CPU tensors:
    ``step_aggregate_ref``.'''
    targets = tuple(targets)
    coef, decay = tuple(coef), tuple(decay)
    _check_step(targets, G, segments, coef, decay)
    dev = G.device
    if dev.type == 'cpu':
        return step_aggregate_ref(targets, G, segments, coef, decay, step,
                                  row_mean)
    if dev.type != 'cuda':
        raise ValueError('step_aggregate runs on cuda or cpu tensors, not %s'
                         % dev)
    seg = segments
    n_rows = int(seg.blk_row.shape[0])
    if n_rows == 0:                     # nothing masked in: no launch
        return targets
    n_long = int((seg.blk_len >= STEP_BLOCK_ROW).sum())
    nt = len(targets)
    tg = [t.data_ptr() for t in targets] + [None]
    cf = [None if c is None else c.data_ptr() for c in coef[:nt]] + [None]
    dc = [float(x) for x in decay[:nt]] + [0.0]
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.step_agg_launch(
            tg[0], tg[1], cf[0], cf[1], dc[0], dc[1], G.data_ptr(),
            seg.blk_row.data_ptr(), seg.blk_seg0.data_ptr(),
            seg.blk_seg1.data_ptr(), seg.seg_ptr.data_ptr(),
            seg.ent_fix.data_ptr(), seg.ent_m.data_ptr(), float(step),
            G.shape[1], n_rows, n_long, int(bool(row_mean)), nt,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc)
    step_aggregate.launches += 1
    return targets


step_aggregate.launches = 0


def _raise_on(lib, rc):
    if rc != 0:
        raise RuntimeError('window_agg kernel launch failed: CUDA error %d '
                           '(%s)' % (rc, lib.window_agg_error_string(
                               rc).decode()))


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.window_agg_error_string.argtypes = [i]
    lib.window_agg_error_string.restype = ctypes.c_char_p
    lib.window_agg_scratch_ints.argtypes = [i]
    lib.window_agg_scratch_ints.restype = ctypes.c_longlong
    lib.window_agg_launch.argtypes = [p, p, p, i, i, i, p, p, p, p, p, p]
    lib.window_agg_launch.restype = i
    lib.scan_agg_launch.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.scan_agg_launch.restype = i
    lib.step_agg_launch.argtypes = [p, p, p, p, f, f, p, p, p, p, p, p, p, f,
                                    i, i, i, i, i, p]
    lib.step_agg_launch.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('window_agg', _declare)
