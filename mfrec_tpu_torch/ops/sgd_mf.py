'''
Sorted-window alternating SGD: the training path of the port.

Port of the default path of ``mfrec_tpu/ops/sgd_mf.py``:

* ``sorted_pass_layout`` (``:403-465``): the host layout of one
  half-pass.  The stream is sorted by the updated side's key (numpy's
  stable argsort: the JAX package's counting sort is stable, so the
  permutation is the same) and cut into batches of B ratings whose keys
  span at most W rows;
* ``augment_factors`` / ``split_factors`` (``:468-487``), numpy or torch;
* ``init_state`` (``:82-95``) and ``clamp`` (``:98``);
* ``make_alternating_epoch`` (``:491-868``): a P half-pass over the
  user-sorted stream (Q fixed), then a Q half-pass over the item-sorted
  stream (P fixed), each batch running T gradient sweeps on its window;
* ``_agg_window`` / ``_scan_window_agg`` (``:871-908``) and
  ``make_alternating_implicit_epoch`` (``:911-1003``): the SVD++ tier,
  whose five phases are window aggregations (K4) around the two
  half-passes.

``use_kernel`` takes the place of the JAX ``use_pallas_full``.  Off, each
batch runs the XLA branch's math (``:787-839``) in plain torch: the
window read in f32, the fixed side in f32, the per-sample gradient
``g = eff*ff - regv*fu*m`` rounded to bf16 before it is summed per row in
f32.  On, the half-pass goes through K1's wrapper
(``ops.half_pass_kernel.half_pass``): the CUDA kernel for CUDA tensors,
its plain version for CPU tensors; with ``ff_dtype='bfloat16'`` the fixed
side is cast to bf16 once per half-pass first (``:744-751``), else it
stays f32.  A user half-pass with ``freeze_user_factors`` (FN's, which
trains b_u alone) goes through K1f's wrapper instead
(``ops.frozen_half_pass_kernel.frozen_half_pass``): the same arithmetic,
each rating's frozen part of the dot formed once.  ``use_agg_kernel`` is
the JAX ``use_pallas_agg``: the plain sweep with K4
(``ops.window_agg_kernel.window_aggregate``) summing the gradients and
counts in place of ``index_add_``.

The aggregation phases and the SVD++ item step go through K4 the same
way: on a layout with K1's segment table (a CUDA model's) a whole phase
is one launch -- SVD++'s two through ``gather_aggregate`` and
``error_aggregate``, which gather each entry's row inside the kernel,
FN's through ``scan_aggregate`` -- and the item step one
``step_aggregate`` launch; otherwise each batch is one
``window_aggregate`` call, as the JAX scan takes it.

Not ported (opt-in on the JAX side, off the default path): the grouped
and gather-grouped half-passes, ``probe_ff``, ``locality_sort`` and the
epoch-builder memo (eager PyTorch compiles nothing, so there is nothing
to memoize).
'''
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mfrec_tpu_torch.ops import frozen_half_pass_kernel, half_pass_kernel, \
    serial_kernel, window_agg_kernel
from mfrec_tpu_torch.utils import profiling


class MFState(NamedTuple):
    '''Factor/bias state on one device.  P: [U, k]; Q: [I, k]; bu/bi:
    learned or precomputed biases; mu: overall average (0-dim); Y: [I, k]
    implicit-feedback item factors (the fused tier's SVD++ variant), or
    None.'''
    P: torch.Tensor
    Q: torch.Tensor
    bu: torch.Tensor
    bi: torch.Tensor
    mu: torch.Tensor
    Y: torch.Tensor = None


def init_state(nbr_users, nbr_items, k, feature_init=0.1, mode='constant',
               seed=0, dtype=torch.float32, device='cuda'):
    '''Factor state as ``mfrec_tpu/ops/sgd_mf.py:82-95`` makes it:
    ``'constant'`` fills P and Q with ``feature_init`` (the reference SGD
    init), ``'normal'`` draws them from N(0, feature_init) (the reference
    KMF init) with a ``torch.Generator`` seeded with ``seed`` (P, then
    Q).  ``jax.random`` gives other numbers from the same seed: to
    compare the packages, hand both the same factors.  Biases and mu are
    zero.  ``device``: 'cuda' (default; raises without a card) or
    'cpu'.'''
    from mfrec_tpu_torch.models.base import resolve_device
    dev = resolve_device(device)
    if mode == 'constant':
        P = torch.full((nbr_users, k), feature_init, dtype=dtype)
        Q = torch.full((nbr_items, k), feature_init, dtype=dtype)
    elif mode == 'normal':
        gen = torch.Generator().manual_seed(int(seed))
        f = float(feature_init)
        P = (torch.randn((nbr_users, k), generator=gen) * f).to(dtype)
        Q = (torch.randn((nbr_items, k), generator=gen) * f).to(dtype)
    else:
        raise ValueError("mode must be 'constant' or 'normal', got %r"
                         % (mode,))

    def z(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    return MFState(P=P.to(dev), Q=Q.to(dev), bu=z(nbr_users),
                   bi=z(nbr_items), mu=torch.zeros((), dtype=dtype,
                                                   device=dev))


def clamp(x, lo=1.0, hi=5.0):
    '''Rating clamp to [lo, hi] (the reference hardcodes [1, 5]; the
    bounds are honoured here, with the same defaults).'''
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, lo, hi)
    return np.clip(x, lo, hi)


def sorted_pass_layout(uidx, iidx, vals, batch_size, axis='user',
                       max_window=512):
    '''Host-side layout for one alternating half-epoch.

    Sorts the rating stream by the ``axis`` key so that every batch
    touches a contiguous window of factor rows.  A batch closes when it
    reaches ``batch_size`` ratings or its key span reaches
    ``max_window``.  Returns ``(ub, ib, rb, mb, kl, lo, W)``: batch arrays
    [nb, B] (padding slots: mask 0, the batch's first key), per-batch
    window-local key ids ``kl``, window starts ``lo`` and the window size
    W.'''
    key = uidx if axis == 'user' else iidx
    order = np.argsort(np.asarray(key), kind='stable')
    u, i, v = uidx[order], iidx[order], vals[order]
    k_sorted = key[order]
    n = u.shape[0]
    W = int(max_window)

    bounds = []
    start = 0
    while start < n:
        end = min(start + batch_size, n)
        limit = int(np.searchsorted(k_sorted, k_sorted[start] + W,
                                    side='left'))
        end = min(end, max(limit, start + 1))
        bounds.append((start, end))
        start = end
    nb = len(bounds)

    ub = np.zeros((nb, batch_size), np.int32)
    ib = np.zeros((nb, batch_size), np.int32)
    rb = np.zeros((nb, batch_size), np.float32)
    mb = np.zeros((nb, batch_size), np.float32)
    lo = np.zeros((nb,), np.int32)
    for b, (s, e) in enumerate(bounds):
        m = e - s
        ub[b, :m] = u[s:e]
        ib[b, :m] = i[s:e]
        rb[b, :m] = v[s:e]
        mb[b, :m] = 1.0
        # pad index slots with the batch's first key (valid window rows)
        ub[b, m:] = u[s]
        ib[b, m:] = i[s]
        lo[b] = k_sorted[s]
    keyb = ub if axis == 'user' else ib
    kl = (keyb - lo[:, None]).astype(np.int32)
    return ub, ib, rb, mb, kl, lo, W


def augment_factors(P, Q, bu, bi):
    '''Pack the biases into the factor matrices as extra columns,
    ``Paug = [P | bu | 1]`` and ``Qaug = [Q | 1 | bi]``, so that
    ``Paug_u . Qaug_i = P_u . Q_i + bu_u + bi_i``.  numpy or torch.'''
    if isinstance(P, torch.Tensor):
        onesP = torch.ones((P.shape[0], 1), dtype=P.dtype, device=P.device)
        onesQ = torch.ones((Q.shape[0], 1), dtype=Q.dtype, device=Q.device)
        return (torch.cat([P, bu[:, None], onesP], 1),
                torch.cat([Q, onesQ, bi[:, None]], 1))
    onesP = np.ones((P.shape[0], 1), P.dtype)
    onesQ = np.ones((Q.shape[0], 1), Q.dtype)
    return (np.concatenate([P, bu[:, None], onesP], axis=1),
            np.concatenate([Q, onesQ, bi[:, None]], axis=1))


def split_factors(Paug, Qaug):
    '''Inverse of ``augment_factors``: returns (P, Q, bu, bi).'''
    k = Paug.shape[1] - 2
    return Paug[:, :k], Qaug[:, :k], Paug[:, k], Qaug[:, k + 1]


class PassLayout:
    '''One half-pass's layout on a device: the batch tensors of
    ``sorted_pass_layout``, the window starts on the host (the plain path
    slices windows without a device sync), W, and -- when ``segments`` --
    K1's segment table, built here once.'''

    def __init__(self, layout, axis, device, segments=False):
        ub, ib, rb, mb, kl, lo, W = layout
        self.axis = axis
        self.W = int(W)
        # checked once here, so the per-batch K4 calls need not check
        inside = np.asarray(kl)[np.asarray(mb) != 0]
        if inside.size and (inside.min() < 0 or inside.max() >= self.W):
            raise ValueError('a masked-in entry has kl outside [0, %d)'
                             % self.W)
        self.lo_host = np.asarray(lo)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.u, self.i, self.r, self.m, self.kl, self.lo = (
            t(ub), t(ib), t(rb), t(mb), t(kl), t(lo))
        self.mask_sum = self.m.sum()
        fix = ib if axis == 'user' else ub
        self.segments = half_pass_kernel.build_segments(
            fix, rb, mb, kl, lo, self.W, device) if segments else None

    @property
    def nbr_batches(self):
        return int(self.lo_host.shape[0])

    def batches(self):
        '''``(fix, r, m, kl, lo)``: K1's per-batch inputs.'''
        fix = self.i if self.axis == 'user' else self.u
        return fix, self.r, self.m, self.kl, self.lo


def column_rates(kdim, upd_is_user, lr, K_u, K_i, lr_bu=0.0, lr_bi=0.0,
                 K_bu=0.0, K_bi=0.0, learned=False,
                 freeze_user_factors=False):
    '''Per-column learning rate and regularization (numpy f32 [kdim+2])
    for the rows ``[factors | bu | 1]`` (user side) or ``[factors | 1 |
    bi]`` (item side): the own-bias column learns only with learned
    biases, the constant column never, and ``freeze_user_factors`` leaves
    only b_u to the user half-pass.'''
    lrv = np.full(kdim + 2, lr, np.float32)
    regv = np.full(kdim + 2, K_u if upd_is_user else K_i, np.float32)
    own_bias_col = kdim if upd_is_user else kdim + 1
    const_col = kdim + 1 if upd_is_user else kdim
    lrv[own_bias_col] = (lr_bu if upd_is_user else lr_bi) if learned \
        else 0.0
    lrv[const_col] = 0.0
    regv[own_bias_col] = K_bu if upd_is_user else K_bi
    regv[const_col] = 0.0
    if freeze_user_factors and upd_is_user:
        lrv[:kdim] = 0.0
    return lrv, regv


def make_alternating_epoch(W_user, W_item, lr, K, lr_bu=0.0, lr_bi=0.0,
                           K_bu=0.0, K_bi=0.0, bias_mode='fixed',
                           clamp_pred=True, lo_r=1.0, hi_r=5.0,
                           row_mean=True, use_kernel=False, inner_steps=1,
                           link='identity', K_u=None, K_i=None,
                           freeze_user_factors=False, ff_dtype=None,
                           use_agg_kernel=False):
    '''Build an epoch over augmented factors: a P half-pass over the
    user-sorted stream (Q fixed), then a Q half-pass over the
    item-sorted stream (P fixed).  With ``row_mean`` each touched row
    takes its mean gradient over the batch; ``inner_steps`` = T sweeps
    per batch against the same fixed rows.

    ``epoch_fn(Paug, Qaug, mu, p_layout, q_layout, lr_scale=1.0)`` ->
    ``(Paug, Qaug, rmse)``, with ``PassLayout`` layouts.  Paug must have
    at least nbr_users + W_user rows (Qaug likewise).  The factors are
    updated in place (the JAX package donates them) and returned;
    ``rmse`` is a 0-dim tensor pooled over both half-passes and divided
    by the summed masks.  ``lr_scale`` multiplies every learning rate.

    ``link``: 'identity' or 'logistic' (pred = lo + sigmoid(s)*(hi-lo),
    the gradient picks up sigmoid'(s)*(hi-lo)).  ``K_u``/``K_i``:
    per-side factor regularization (default both K).
    ``freeze_user_factors``: the user half-pass trains only b_u (with
    ``use_kernel``, through K1f, recorded as the span
    ``fn.user_half_pass``; K1f takes FN's case alone: the identity link,
    learned biases, f32 fixed rows).
    ``ff_dtype``: None (f32) or 'bfloat16', the fixed side's type on the
    kernel path.  ``use_agg_kernel``: the agg-only tier (identity link
    only, as in the JAX package).'''
    if link not in half_pass_kernel.LINKS:
        raise ValueError('link must be one of %s, got %r'
                         % (half_pass_kernel.LINKS, link))
    if link != 'identity' and use_agg_kernel:
        raise ValueError('non-identity links: use the fused kernel '
                         '(use_kernel) or the plain path')
    if ff_dtype not in (None, 'bfloat16'):
        raise ValueError("ff_dtype must be None (f32) or 'bfloat16', got %r"
                         % (ff_dtype,))
    if freeze_user_factors and use_kernel and (
            link != 'identity' or bias_mode != 'learned' or ff_dtype):
        raise ValueError('freeze_user_factors on the kernel path takes the '
                         'identity link, learned biases and f32 fixed rows '
                         '(K1f), got link=%r, bias_mode=%r, ff_dtype=%r'
                         % (link, bias_mode, ff_dtype))
    learned = bias_mode == 'learned'
    bias_none = bias_mode == 'none'
    K_u = K if K_u is None else K_u
    K_i = K if K_i is None else K_i
    T = int(inner_steps)

    rates = {}

    def col_vectors(kdim, upd_is_user, device):
        # uploaded once per side and device: a pageable upload per
        # half-pass would stall the host on the kernel before it
        key = (kdim, upd_is_user, str(device))
        if key not in rates:
            rates[key] = tuple(
                torch.from_numpy(a).to(device) for a in column_rates(
                    kdim, upd_is_user, lr, K_u, K_i, lr_bu, lr_bi, K_bu,
                    K_bi, learned, freeze_user_factors))
        return rates[key]

    def plain_batch(win, ff, r, m, kl32, lrv, regv, mu, W):
        '''The XLA branch of the JAX half_pass for one batch: f32 window
        and fixed rows, bf16-rounded per-sample gradients summed by
        ``index_add_``, or by K4 on the agg-only tier.'''
        kl = kl32.long()
        cnt = None
        if row_mean and not use_agg_kernel:
            cnt = torch.zeros(W, dtype=torch.float32, device=win.device)
            cnt.index_add_(0, kl, m.to(torch.bfloat16).float())
            cnt = torch.clamp(cnt, min=1.0)[:, None]
        sse = None
        for t in range(T):
            fu = win[kl]
            dot = (fu * ff).sum(-1)
            if link == 'logistic':
                rng_w = hi_r - lo_r
                sig = torch.sigmoid(dot)
                pred = lo_r + sig * rng_w
                err = (r - pred) * m
                eff = err * sig * (1.0 - sig) * rng_w
            else:
                pred = (1.0 + dot) if bias_none else (mu + dot)
                if clamp_pred:
                    pred = clamp(pred, lo_r, hi_r)
                err = (r - pred) * m
                eff = err
            if t == 0:
                sse = (err * err).sum()
            g = eff[:, None] * ff - regv[None, :] * fu * m[:, None]
            if use_agg_kernel:
                gsum, cnt_a = window_agg_kernel.window_aggregate(
                    g, kl32, m, W, check_ids=False)
                if row_mean:
                    gsum = gsum / torch.clamp(cnt_a, min=1.0)[:, None]
            else:
                gsum = torch.zeros_like(win)
                gsum.index_add_(0, kl, g.to(torch.bfloat16).float())
                if row_mean:
                    gsum = gsum / cnt
            win = win + lrv[None, :] * gsum
        return win, sse

    def half_pass(F_upd, F_fix, mu, layout, W, upd_is_user, lr_scale):
        if layout.W != W:
            raise ValueError('layout window %d != epoch window %d'
                             % (layout.W, W))
        lrv, regv = col_vectors(F_upd.shape[1] - 2, upd_is_user,
                                F_upd.device)
        lrv = lrv * lr_scale             # f32 rates times the f32 scale
        if use_kernel:
            if ff_dtype == 'bfloat16':     # cast once per half-pass
                F_fix = F_fix.to(torch.bfloat16)
            args = (F_upd, F_fix, layout.batches(), W, lrv, regv, float(mu))
            opts = (clamp_pred, lo_r, hi_r, row_mean)
            if freeze_user_factors and upd_is_user:
                # only b_u moves (FN's user side): K1f forms each
                # rating's dot once and sweeps b_u alone
                with profiling.span('fn.user_half_pass'):
                    return frozen_half_pass_kernel.frozen_half_pass(
                        *args, F_upd.shape[1] - 2, T, *opts,
                        segments=layout.segments)
            return half_pass_kernel.half_pass(*args, T, *opts, bias_none,
                                              link, segments=layout.segments)
        fix, r, m, kl, _ = layout.batches()
        sse = torch.zeros((), dtype=torch.float32, device=F_upd.device)
        for b, lo in enumerate(layout.lo_host.tolist()):
            win = F_upd[lo:lo + W]
            out, sse_b = plain_batch(win, F_fix[fix[b].long()], r[b], m[b],
                                     kl[b], lrv, regv, mu, W)
            win.copy_(out)
            sse = sse + sse_b
        return sse

    def epoch_fn(Paug, Qaug, mu, p_layout, q_layout, lr_scale=1.0):
        # the RMSE pools both half-passes, so the convergence rule sees a
        # statistic no staler than half an epoch
        s = float(np.float32(lr_scale))
        mu = torch.as_tensor(mu, dtype=torch.float32)
        sse_p = half_pass(Paug, Qaug, mu, p_layout, W_user, True, s)
        sse_q = half_pass(Qaug, Paug, mu, q_layout, W_item, False, s)
        n = torch.clamp(p_layout.mask_sum + q_layout.mask_sum, min=1.0)
        return Paug, Qaug, torch.sqrt((sse_p + sse_q) / n)

    return epoch_fn


def _agg_window(g, kl, m, W, row_mean):
    '''Rows ``g [B, k]`` summed into the batch's W-row window by
    window-local ids ``kl`` (int32; masked rows count nowhere), each
    masked row ``g*m`` rounded to bf16 and summed in f32: K4.  Returns
    the [W, k] sums, or per-row means with ``row_mean``.'''
    gsum, cnt = window_agg_kernel.window_aggregate(
        g * m[:, None], kl, m, W, check_ids=False)
    if row_mean:
        gsum = gsum / torch.clamp(cnt, min=1.0)[:, None]
    return gsum


def _scan_window_agg(target, layout, source_fn, W, mean, fused=None):
    '''Add ``source_fn(u, i, r, m)`` rows into ``target`` windows over a
    sorted-pass layout, batch after batch -- the scatter-free profile
    aggregation phase of the implicit (SVD++) and FN tiers.  With K1's
    segment table on the layout, the whole phase is one K4 launch over
    the layout's masked-in entries: ``fused(target, segments)`` where
    given (a K4 entry that makes the same rows itself), else
    ``scan_aggregate`` of ``source_fn``'s rows (it sees the entries in the
    table's order); without a table, one K4 call per batch.  Updates
    ``target`` in place and returns it.'''
    if layout.W != W:
        raise ValueError('layout window %d != aggregation window %d'
                         % (layout.W, W))
    seg = layout.segments
    if seg is not None and fused is not None:
        return fused(target, seg)
    if seg is not None:
        u, i = (seg.ent_row, seg.ent_fix) if layout.axis == 'user' \
            else (seg.ent_fix, seg.ent_row)
        vals = source_fn(u.long(), i.long(), seg.ent_r, seg.ent_m)
        return window_agg_kernel.scan_aggregate(target, vals.contiguous(),
                                                seg, mean)
    for b, lo in enumerate(layout.lo_host.tolist()):
        vals = source_fn(layout.u[b].long(), layout.i[b].long(),
                         layout.r[b], layout.m[b])
        target[lo:lo + W] += _agg_window(vals, layout.kl[b], layout.m[b],
                                         W, mean)
    return target


def y_step_batches(Ypad, G, layout, K_y, step, row_mean):
    '''The SVD++ item step batch after batch (the JAX scan ``y_step``):
    each item window ``win += step * _agg_window(G[u] - K_y*win[kl])``,
    one K4 call per batch.  Updates ``Ypad`` in place.'''
    W = layout.W
    for b, lo in enumerate(layout.lo_host.tolist()):
        win = Ypad[lo:lo + W]
        kl = layout.kl[b]
        vals = G[layout.u[b].long()] - K_y * win[kl.long()]
        gsum = _agg_window(vals, kl, layout.m[b], W, row_mean)
        win.copy_(win + step * gsum)
    return Ypad


def make_alternating_implicit_epoch(W_user, W_item, lr, lr_y, K, K_y,
                                    clamp_pred=True, lo_r=1.0, hi_r=5.0,
                                    row_mean=True, inner_steps=1,
                                    use_kernel=False, ff_dtype=None):
    '''SVD++ (implicit feedback) at sorted-window speed:

        r_hat = mu + b_u + b_i + q_i . (p_u + |N(u)|^-1/2 sum_j y_j)

    Per epoch, as ``mfrec_tpu/ops/sgd_mf.py:917-950`` sets out:

      1. A[u] = nrm_u * sum_{j in R(u)} y_j (K4 over the user layout;
         with a segment table ``gather_aggregate``, which gathers the Y
         rows itself).
      2. P half-pass on the effective factors Peff = Paug + A; Paug =
         Peff - A afterwards (the f32 round trip of the JAX package).
      3. Q half-pass against the updated Peff.
      4. G[u] = nrm_u * sum_{i in R(u)} err_ui q_i (K4 over the user
         layout, errors from the updated Peff and Qaug; with a segment
         table ``error_aggregate``, which computes them in the kernel).
         With a table no phase holds a tensor of one row an entry.
      5. y_j += lr_y * (mean_{u: j in N(u)} G[u] - K_y y_j), batch after
         batch over the item layout (a window reads what the batch before
         it wrote): one ``step_aggregate`` launch over the layout's
         segment table, row by row, or without a table one K4 call per
         batch.

    ``epoch_fn(Paug, Qaug, Ypad, mu, p_layout, q_layout, nrm_rows,
    lr_scale=1.0) -> (Paug, Qaug, Ypad, rmse)``.  Ypad: [nbr_items +
    W_item, k] implicit factors, updated in place; nrm_rows: [nbr_users +
    W_user] per-user |N(u)|^-1/2 (0 for none), on the factors' device.
    Fixed-bias mode; the RMSE pools both half-passes.  ``lr_scale``
    scales the half-passes' rates and the Y step together.
    ``on_phase(name)``, if given, is called as each phase ends (a timing
    hook: 'aggregate Y', 'half-passes', 'aggregate errors', 'Y step').
    Recorded by ``utils.profiling``: ``svdpp.aggregate`` around each
    aggregation's launch, ``svdpp.half_passes`` around the two
    half-passes, ``svdpp.y_step`` around the item step.'''
    lo_c, hi_c = (lo_r, hi_r) if clamp_pred else (-np.inf, np.inf)
    base = make_alternating_epoch(W_user, W_item, lr, K, bias_mode='fixed',
                                  clamp_pred=clamp_pred, lo_r=lo_r,
                                  hi_r=hi_r, row_mean=row_mean,
                                  use_kernel=use_kernel,
                                  inner_steps=inner_steps, ff_dtype=ff_dtype)

    def epoch_fn(Paug, Qaug, Ypad, mu, p_layout, q_layout, nrm_rows,
                 lr_scale=1.0, on_phase=None):
        mark = on_phase or (lambda name: None)
        s = np.float32(lr_scale)
        step_y = float(np.float32(lr_y) * s)      # f32, as the JAX scalar
        mu = torch.as_tensor(mu, dtype=torch.float32)
        k = Ypad.shape[1]

        def zeros():
            return torch.zeros((Paug.shape[0], k), dtype=Paug.dtype,
                               device=Paug.device)

        # 1) user aggregates of Y (sum over rated items, then * nrm)
        A = zeros()
        with profiling.span('svdpp.aggregate'):
            _scan_window_agg(
                A, p_layout, lambda u, i, r, m: Ypad[i], W_user, mean=False,
                fused=lambda t, seg: window_agg_kernel.gather_aggregate(
                    t, Ypad, seg))
        Apad = torch.nn.functional.pad(A * nrm_rows[:, None], (0, 2))
        mark('aggregate Y')
        # 2+3) the alternating epoch on the effective factors
        Peff = Paug + Apad
        with profiling.span('svdpp.half_passes'):
            Peff, Qaug, rmse = base(Peff, Qaug, mu, p_layout, q_layout,
                                    float(s))
        Paug = Peff - Apad
        mark('half-passes')

        # 4) error-weighted item-factor sums into user windows
        def err_q(u, i, r, m):
            ff = Qaug[i]
            pred = mu + (Peff[u] * ff).sum(-1)
            if clamp_pred:
                pred = clamp(pred, lo_r, hi_r)
            return ((r - pred) * m)[:, None] * ff[:, :k]

        G = zeros()
        with profiling.span('svdpp.aggregate'):
            _scan_window_agg(
                G, p_layout, err_q, W_user, mean=False,
                fused=lambda t, seg: window_agg_kernel.error_aggregate(
                    t, Peff, Qaug, seg, mu, lo_c, hi_c))
        G = G * nrm_rows[:, None]
        mark('aggregate errors')
        # 5) G rows into item windows, step Y batch after batch (the
        # decay rides per sample, so untouched rows get none): one launch
        # over the item layout's segment table where it has one
        if q_layout.W != W_item:
            raise ValueError('layout window %d != epoch window %d'
                             % (q_layout.W, W_item))
        with profiling.span('svdpp.y_step'):
            if q_layout.segments is not None:
                window_agg_kernel.step_aggregate(
                    (Ypad,), G.contiguous(), q_layout.segments,
                    decay=(K_y,), step=step_y, row_mean=row_mean)
            else:
                y_step_batches(Ypad, G, q_layout, K_y, step_y, row_mean)
        mark('Y step')
        return Paug, Qaug, Ypad, rmse

    return epoch_fn


# --------------------------------------------------------------------------
# Serial tier: exact reference semantics (oracle / small retrains)
# --------------------------------------------------------------------------

def serial_feature_epoch(pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr, K,
                         mu, bu, bi, lr_bu, lr_bi, K_bu, K_bi,
                         bias_mode='none', lo=1.0, hi=5.0, update_users=True,
                         update_items=True, P=None, Q=None):
    '''One strictly sequential epoch of single-feature Funk SGD
    (``mfrec_tpu/ops/sgd_mf.py:109-171``): S1 for CUDA tensors, its plain
    version for CPU tensors (``ops.serial_kernel``).

    pf [U] / qf [I]: the user and item feature-f columns; cache [N] the
    per-rating frozen prediction of the features before f; uidx/iidx
    int32 [N], r f32 [N].  bias_mode 'none' (baseline 1), 'fixed'
    (baseline mu + bi + bu) or 'learned' (the full dot from the
    feature's starting P and Q, and SGD on the biases; needs P and Q).
    ``update_users`` / ``update_items`` are the fold-in masks.  Updates
    pf, qf (and bu, bi when learned) in place, where the JAX function
    returns new arrays, and returns ``(pf, qf, bu, bi, rmse)``.'''
    return serial_kernel.serial_epoch(
        pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr, K, mu, bu, bi,
        lr_bu, lr_bi, K_bu, K_bi, bias_mode=bias_mode, lo=lo, hi=hi,
        update_users=update_users, update_items=update_items, P=P, Q=Q)


def update_cache(pf, qf, cache, uidx, iidx, mu, bu, bi, bias_mode='none',
                 lo=1.0, hi=5.0):
    '''Freeze feature f into the per-rating cache after it converges
    (``mfrec_tpu/ops/sgd_mf.py:174-185``; ``serial_kernel.
    cache_update_ref``, which S1 repeats on the card).  Returns the new
    cache.'''
    return serial_kernel.cache_update_ref(pf, qf, cache, uidx, iidx, mu, bu,
                                          bi, bias_mode, lo, hi)


# --------------------------------------------------------------------------
# Mini-batch tiers: fused, funk-fused, multi-regularization
# --------------------------------------------------------------------------

def batch_ratings(uidx, iidx, r, batch_size, seed=None):
    '''Host-side: pad and reshape COO ratings to the [nb, B] scan layout
    (``mfrec_tpu/ops/sgd_mf.py:1006-1020``, the same permutation and
    bytes).  Returns (ub, ib, rb, mask).'''
    n = uidx.shape[0]
    if seed is not None:
        perm = np.random.default_rng(seed).permutation(n)
        uidx, iidx, r = uidx[perm], iidx[perm], r[perm]
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    mask = np.ones(n, np.float32)
    uidx = np.pad(uidx, (0, pad)).reshape(nb, batch_size)
    iidx = np.pad(iidx, (0, pad)).reshape(nb, batch_size)
    r = np.pad(r, (0, pad)).reshape(nb, batch_size).astype(np.float32)
    mask = np.pad(mask, (0, pad)).reshape(nb, batch_size)
    return uidx, iidx, r, mask


class ScatterPlan(NamedTuple):
    '''A fixed-order scatter-add of each batch's rows, built on the host.
    For batch b: ``perm[b, :nval[b]]`` orders its entries by row (stable,
    so a row's entries keep stream order), the rows run in
    ``lens[b, :nseg[b]]``-long segments and ``rows[b, :nseg[b]]`` are the
    segments' rows, each once.'''
    perm: torch.Tensor
    lens: torch.Tensor
    rows: torch.Tensor
    nval: tuple
    nseg: tuple


def scatter_plan(rows, device, valid=None):
    '''The ``ScatterPlan`` of ``rows`` [nb, n] (numpy ints) on ``device``;
    ``valid`` [nb, n] (bool) leaves entries out.'''
    key = np.asarray(rows).astype(np.int64)
    nb, n = key.shape
    if valid is None:
        nval = np.full(nb, n, np.int64)
    else:
        valid = np.asarray(valid, bool)
        nval = valid.sum(1).astype(np.int64)
        key = np.where(valid, key, np.iinfo(np.int64).max)
    order = np.argsort(key, axis=1, kind='stable')
    sk = np.take_along_axis(key, order, 1)
    inside = np.arange(n)[None, :] < nval[:, None]
    start = np.ones((nb, n), bool)
    start[:, 1:] = sk[:, 1:] != sk[:, :-1]
    start &= inside
    nseg = start.sum(1)
    b_idx, j_idx = np.nonzero(start)
    seg = (np.cumsum(start, 1) - 1)[b_idx, j_idx]
    nxt = np.append(j_idx[1:], 0)
    last = np.append(b_idx[1:] != b_idx[:-1], True)
    end = np.where(last, nval[b_idx], nxt)
    lens = np.zeros((nb, n), np.int64)
    out_rows = np.zeros((nb, n), np.int64)
    lens[b_idx, seg] = end - j_idx
    out_rows[b_idx, seg] = sk[b_idx, j_idx]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ScatterPlan(t(order), t(lens), t(out_rows),
                       tuple(int(x) for x in nval), tuple(int(x) for x in nseg))


def plan_sums(vals, plan, b):
    '''Batch ``b``'s entries summed per row in a fixed order: returns
    ``(rows, sums)``, each row once, its entries summed in stream order
    (``torch.segment_reduce`` over the plan's permutation).'''
    nv, ns = plan.nval[b], plan.nseg[b]
    g = vals.index_select(0, plan.perm[b, :nv])
    sums = torch.segment_reduce(g, 'sum', lengths=plan.lens[b, :ns],
                                unsafe=True)
    return plan.rows[b, :ns], sums


def plan_add_(target, vals, plan, b):
    '''``target[rows_e] += vals_e`` over batch ``b``'s entries e, in place
    and in a fixed order: ``plan_sums``, then one add per row (distinct
    rows, so ``index_add_`` involves no race).  The same on every run, on
    any device; JAX's scatter on the CPU adds a row's entries one by one
    instead, so the two differ by f32 rounding where a row repeats.'''
    rows, sums = plan_sums(vals, plan, b)
    target.index_add_(0, rows, sums)


def fused_plan(ub, ib, device):
    '''The user-side and item-side ``ScatterPlan`` of a batched stream
    (``batch_ratings``'s ub, ib; numpy or tensors).'''
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)
    return (scatter_plan(host(ub), device), scatter_plan(host(ib), device))


def _rmse(sse, mb):
    n = torch.clamp(mb.sum(), min=1.0)
    return torch.sqrt(sse / n)


def make_fused_epoch(batch_size, lr, K, lr_bu=0.0, lr_bi=0.0, K_bu=0.0,
                     K_bi=0.0, bias_mode='fixed', clamp_pred=True, lo=1.0,
                     hi=5.0, implicit=False):
    '''The all-features mini-batch epoch (``mfrec_tpu/ops/sgd_mf.py:
    188-259``).  ``epoch_fn(state, ub, ib, rb, mb, flists=None,
    fmask=None, plan=None) -> (state, rmse)``: per batch of the [nb, B]
    stream, gather the P and Q rows, predict, and add the regularized
    step to every touched row, duplicates accumulating (synchronous
    mini-batch SGD).  The state (``MFState``) is updated in place and
    returned; every step of a batch reads the batch's starting state, as
    in the JAX scan.  ``plan`` is ``fused_plan(ub, ib)`` (built here when
    None): the rows' sums are taken in a fixed order (``plan_add_``), so
    a run on the card repeats bit for bit.

    ``implicit=True``: SVD++ prediction with ``state.Y`` over each user's
    padded rated list (``flists``/``fmask`` [U, L]), the Y step added
    over those lists (an ops-level variant, as in the JAX package).'''
    learned = bias_mode == 'learned'

    def epoch_fn(state, ub, ib, rb, mb, flists=None, fmask=None, plan=None):
        P, Q, bu, bi, mu, Y = state
        if plan is None:
            plan = fused_plan(ub, ib, P.device)
        uplan, iplan = plan
        yplan = None
        if implicit:
            fl_host = flists.cpu().numpy()[ub.cpu().numpy()]
            yplan = scatter_plan(fl_host.reshape(fl_host.shape[0], -1),
                                 P.device)
        sses = []
        for b in range(int(ub.shape[0])):
            u, i = ub[b].long(), ib[b].long()
            r, m = rb[b], mb[b]
            pu, qi = P[u], Q[i]
            if implicit:
                fl = flists[u].long()
                fm = fmask[u]
                Yg = Y[fl]
                ysum = (Yg * fm[..., None]).sum(1)
                fnorm = torch.rsqrt(torch.clamp(fm.sum(1), min=1.0))[:, None]
                pu_eff = pu + fnorm * ysum
            else:
                pu_eff = pu
            dot = (pu_eff * qi).sum(-1)
            if bias_mode == 'none':
                pred = 1.0 + dot
            else:
                pred = mu + bu[u] + bi[i] + dot
            if clamp_pred:
                pred = clamp(pred, lo, hi)
            err = (r - pred) * m
            sses.append((err * err).sum())
            gP = err[:, None] * qi - K * pu * m[:, None]
            gQ = err[:, None] * pu_eff - K * qi * m[:, None]
            if learned:
                dbu = lr_bu * (err - K_bu * bu[u] * m)
                dbi = lr_bi * (err - K_bi * bi[i] * m)
            if implicit:
                gy = (err[:, None] * fnorm * qi)[:, None, :] * fm[..., None] \
                    - K * Yg * fm[..., None]
            plan_add_(P, lr * gP, uplan, b)
            plan_add_(Q, lr * gQ, iplan, b)
            if learned:
                plan_add_(bu, dbu, uplan, b)
                plan_add_(bi, dbi, iplan, b)
            if implicit:
                plan_add_(Y, (lr * gy).reshape(-1, gy.shape[-1]), yplan, b)
        return state, _rmse(torch.stack(sses).sum(), mb)

    return epoch_fn


def make_multi_reg_epoch(lr, bias_mode='fixed', clamp_pred=True, lo=1.0,
                         hi=5.0):
    '''S models with different regularization strengths trained in one
    pass over the batches (``mfrec_tpu/ops/sgd_mf.py:262-308``, the
    fused epoch vmapped over (P, Q, K)): the factors stacked on a leading
    axis, each batch's ops run for all S at once.

    ``epoch_fn(Ps [S,U,k], Qs [S,I,k], Ks [S], bu [U], bi [I], mu, ub,
    ib, rb, mb, plan=None) -> (Ps, Qs, rmses [S])``, Ps and Qs updated in
    place; ``plan`` as in ``make_fused_epoch``.'''

    def seg_add(T, g, plan, b):
        # the S models' rows side by side: one fixed-order segment sum
        S, B, k = g.shape
        rows, sums = plan_sums(g.permute(1, 0, 2).reshape(B, S * k), plan,
                               b)
        T.index_add_(1, rows, sums.reshape(-1, S, k).permute(1, 0, 2))

    def epoch_fn(Ps, Qs, Ks, bu, bi, mu, ub, ib, rb, mb, plan=None):
        if plan is None:
            plan = fused_plan(ub, ib, Ps.device)
        uplan, iplan = plan
        Kc = Ks.to(Ps.dtype)[:, None, None]
        sse = torch.zeros(Ps.shape[0], dtype=Ps.dtype, device=Ps.device)
        for b in range(int(ub.shape[0])):
            u, i = ub[b].long(), ib[b].long()
            r, m = rb[b], mb[b]
            pu, qi = Ps[:, u], Qs[:, i]
            dot = (pu * qi).sum(-1)
            pred = (1.0 + dot) if bias_mode == 'none' \
                else (mu + bu[u] + bi[i] + dot)
            if clamp_pred:
                pred = clamp(pred, lo, hi)
            err = (r - pred) * m
            sse = sse + (err * err).sum(-1)
            gP = lr * (err[..., None] * qi - Kc * pu * m[None, :, None])
            gQ = lr * (err[..., None] * pu - Kc * qi * m[None, :, None])
            seg_add(Ps, gP, uplan, b)
            seg_add(Qs, gQ, iplan, b)
        return Ps, Qs, _rmse(sse, mb)

    return epoch_fn


def make_funk_fused_feature_epoch(lr, K, bias_mode='none', lo=1.0, hi=5.0):
    '''One mini-batch epoch of single-feature Funk training
    (``mfrec_tpu/ops/sgd_mf.py:310-350``): the serial tier's cache,
    trailing term and clamping, over batches with fixed-order
    scatter-adds.  ``epoch_fn(pf [U,1], qf [I,1], trailing, ub, ib, rb,
    mb, cb, plan=None) -> (pf, qf, rmse)``, ``cb`` [nb, B] the
    stream-aligned cache (for 'fixed', the baseline folded in up front);
    pf and qf updated in place.'''

    def epoch_fn(pf, qf, trailing, ub, ib, rb, mb, cb, plan=None):
        if plan is None:
            plan = fused_plan(ub, ib, pf.device)
        uplan, iplan = plan
        sse = torch.zeros((), dtype=torch.float32, device=pf.device)
        for b in range(int(ub.shape[0])):
            u, i = ub[b].long(), ib[b].long()
            r, m, c = rb[b], mb[b], cb[b]
            pu, qi = pf[u, 0], qf[i, 0]
            pred = clamp(c + pu * qi, lo, hi)
            pred = clamp(pred + trailing, lo, hi)
            err = (r - pred) * m
            sse = sse + (err * err).sum()
            dp = lr * (err * qi - K * pu * m)
            dq = lr * (err * pu - K * qi * m)
            plan_add_(pf, dp[:, None], uplan, b)
            plan_add_(qf, dq[:, None], iplan, b)
        return pf, qf, _rmse(sse, mb)

    return epoch_fn


def make_funk_fused_learned_epoch(lr, lr_bu, lr_bi, K, K_bu, K_bi, lo=1.0,
                                  hi=5.0):
    '''The learned-bias funk-fused epoch (``mfrec_tpu/ops/sgd_mf.py:
    352-389``): the off-feature dot rides a stream-aligned cache ``off``
    [nb, B], ``pred = clamp(mu + bu + bi + off + pf*qf + trailing)``.
    ``epoch_fn(pf, qf, bu, bi, mu, trailing, ub, ib, rb, mb, off,
    plan=None) -> (pf, qf, bu, bi, rmse)``, all updated in place.'''

    def epoch_fn(pf, qf, bu, bi, mu, trailing, ub, ib, rb, mb, off,
                 plan=None):
        if plan is None:
            plan = fused_plan(ub, ib, pf.device)
        uplan, iplan = plan
        sse = torch.zeros((), dtype=torch.float32, device=pf.device)
        for b in range(int(ub.shape[0])):
            u, i = ub[b].long(), ib[b].long()
            r, m, o = rb[b], mb[b], off[b]
            pu, qi = pf[u, 0], qf[i, 0]
            pred = clamp(mu + bu[u] + bi[i] + o + pu * qi, lo, hi)
            pred = clamp(pred + trailing, lo, hi)
            err = (r - pred) * m
            sse = sse + (err * err).sum()
            dbu = lr_bu * (err - K_bu * bu[u] * m)
            dbi = lr_bi * (err - K_bi * bi[i] * m)
            dp = lr * (err * qi - K * pu * m)
            dq = lr * (err * pu - K * qi * m)
            plan_add_(bu, dbu, uplan, b)
            plan_add_(bi, dbi, iplan, b)
            plan_add_(pf, dp[:, None], uplan, b)
            plan_add_(qf, dq[:, None], iplan, b)
        return pf, qf, bu, bi, _rmse(sse, mb)

    return epoch_fn


def funk_fused_update_cache(pf, qf, ub, ib, cb, lo=1.0, hi=5.0):
    '''Freeze a converged feature into the stream-aligned cache
    (``mfrec_tpu/ops/sgd_mf.py:391-400``).'''
    return clamp(cb + pf[ub.long(), 0] * qf[ib.long(), 0], lo, hi)
