'''
S1, the serial Funk tier: the hand-written CUDA kernel
(``csrc/serial_funk.cu``) and its plain PyTorch version.

Port of ``serial_feature_epoch`` from ``mfrec_tpu/ops/sgd_mf.py``
(``:109-171``), a ``lax.fori_loop`` outside any Pallas kernel: one
strictly sequential epoch of single-feature Funk SGD over a rating
stream, the reference's ``gd_estimator.pyx`` loops rating by rating (the
cached partial prediction, the trailing-value term, [lo, hi] clamping,
pre-update gradient reads); and of the per-feature loop around it
(``mfrec_tpu/models/gd.py:910-927``), which runs epochs until
``converge_continues`` says stop.  It is the exactness oracle and the
fold-in retrain path of ``GDRecommender`` (``engine='funk'``,
``retrain_user``, ``add_user``...).

Two entries, both one launch of the kernel for CUDA tensors:
``serial_converge`` runs a feature's epochs under the rule on the card
and reads their rmse once; ``serial_epoch`` runs one epoch and returns
its rmse as a device scalar.  CPU tensors take the plain versions,
``serial_converge_ref`` (``serial_feature_epoch_ref`` under the same
rule) and ``serial_feature_epoch_ref``.  Kernel and plain version
compute every step in f32 in the same order with no fused multiply-add,
so they agree bit for bit; the JAX function on the CPU may contract a
multiply and an add into one FMA, so the port agrees with it to a few
f32 ulps.

The kernel walks the stream in chunks of 32 ratings, one a lane, by a
schedule built once a stream on the host (``build_schedule``, a
``SerialPlan``): each rating's round in its chunk and where each of its
rows comes from (another lane's register, or the row table).
``serial_converge.launches`` counts the kernel's launches and
``serial_converge.epochs`` the epochs they ran.
'''
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

BIAS_MODES = ('none', 'fixed', 'learned')
CHUNK = 32                     # ratings a chunk, one a lane of warp 0
# where a rating's row is read: the table (or the columns), the register
# of a lane of the chunk before, or of an earlier lane of its own chunk
SRC_TABLE, SRC_PREV, SRC_IN = 0, 1, 2
# the row table's bytes in shared memory: a block's 227 KB, less 1 KB
TABLE_LIMIT = 227 * 1024 - 1024
MAX_EPOCHS_A_LAUNCH = 4096
_INT32 = 2 ** 31 - 1


def epoch_scalars(f, dim, f_init, lr, K, mu, lr_bu, lr_bi, K_bu, K_bi, lo,
                  hi):
    '''The epoch's scalars as the JAX function sees them, each an f32
    value held in a Python float: ``trailing = (dim - f - 1) * f_init *
    f_init`` in f32, the rates and regularizations rounded to f32.'''
    f32 = np.float32
    trailing = f32(f32(int(dim) - int(f) - 1) * f32(f_init)) * f32(f_init)
    vals = dict(lr=lr, K=K, mu=mu, lr_bu=lr_bu, lr_bi=lr_bi, K_bu=K_bu,
                K_bi=K_bi, lo=lo, hi=hi, trailing=trailing)
    return {name: float(f32(float(v))) for name, v in vals.items()}


def converge_continues(ep, rmse, rmse_last, min_epochs, max_epochs,
                       min_improvement):
    '''The funk tiers' per-feature rule (``mfrec_tpu/models/gd.py:
    910-917``): after ``ep`` epochs, the last two rmse ``rmse`` and
    ``rmse_last`` (2.0 and 2.0 before the first), whether another epoch
    runs.  Python floats, compared in double; the kernel evaluates the
    same expression on the f32 rmse widened to double.'''
    return ((ep < min_epochs or rmse <= rmse_last - min_improvement)
            and not ep >= max_epochs)


def seq_dot(A, B):
    '''Row dots of ``A`` and ``B`` [n, k] summed over the columns in order,
    every product and sum rounded to f32 (the kernel's learned-mode dot).'''
    d = A[:, 0] * B[:, 0]
    for c in range(1, A.shape[1]):
        d = d + A[:, c] * B[:, c]
    return d


def _check(pf, qf, cache, uidx, iidx, r, bu, bi, bias_mode, P, Q, f):
    if bias_mode not in BIAS_MODES:
        raise ValueError('bias_mode must be one of %s, got %r'
                         % (BIAS_MODES, bias_mode))
    dev = pf.device
    n = int(uidx.shape[0])
    for name, t in (('pf', pf), ('qf', qf)):
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 1 \
                or (t.shape[0] > 1 and t.stride(0) < 1):
            raise ValueError('%s must be a 1-d f32 tensor (a column of P '
                             'or Q may do) on %s' % (name, dev))
    for name, t, dtype, size in (
            ('cache', cache, torch.float32, n), ('r', r, torch.float32, n),
            ('uidx', uidx, torch.int32, n), ('iidx', iidx, torch.int32, n),
            ('bu', bu, torch.float32, pf.shape[0]),
            ('bi', bi, torch.float32, qf.shape[0])):
        if t.device != dev or t.dtype != dtype or t.dim() != 1 \
                or not t.is_contiguous() \
                or (size is not None and t.shape[0] != size):
            raise ValueError('%s must be a contiguous 1-d %s tensor on %s%s'
                             % (name, dtype, dev, '' if size is None
                                else ' of length %d' % size))
    if n < 1:
        raise ValueError('the stream is empty')
    if bias_mode == 'learned':
        if P is None or Q is None:
            raise ValueError("bias_mode 'learned' needs P and Q")
        for name, t, rows in (('P', P, pf.shape[0]), ('Q', Q, qf.shape[0])):
            if t.device != dev or t.dtype != torch.float32 or t.dim() != 2 \
                    or not t.is_contiguous() or t.shape[0] != rows:
                raise ValueError('%s must be a contiguous [%d, k] f32 tensor '
                                 'on %s' % (name, rows, dev))
        if P.shape[1] != Q.shape[1] or not 0 <= int(f) < P.shape[1]:
            raise ValueError('P and Q must share k, with 0 <= f < k')


def serial_feature_epoch_ref(pf, qf, cache, uidx, iidx, r, f, dim, f_init,
                             lr, K, mu, bu, bi, lr_bu, lr_bi, K_bu, K_bi,
                             bias_mode='none', lo=1.0, hi=5.0,
                             update_users=True, update_items=True, P=None,
                             Q=None):
    '''The plain version: the stream walked rating by rating in torch.
    Updates ``pf``, ``qf`` (and, learned, ``bu``, ``bi``) in place and
    returns ``(pf, qf, bu, bi, rmse)``, rmse a 0-dim f32 tensor.  What
    does not depend on the chain (the cached base, or in learned mode the
    full dot and P[u,f]*Q[i,f] from the feature's starting P and Q) is
    computed for the whole stream first, in the kernel's order.'''
    sc = epoch_scalars(f, dim, f_init, lr, K, mu, lr_bu, lr_bi, K_bu, K_bi,
                       lo, hi)
    lo, hi, tr = sc['lo'], sc['hi'], sc['trailing']
    lr, K = sc['lr'], sc['K']
    learned = bias_mode == 'learned'
    ul, il = uidx.long(), iidx.long()
    if learned:
        dots = seq_dot(P[ul], Q[il])
        pqf = P[ul, f] * Q[il, f]
    elif bias_mode == 'fixed':
        base = torch.where(cache > 0, cache, (sc['mu'] + bi[il]) + bu[ul])
    else:
        base = torch.where(cache > 0, cache, torch.ones_like(cache))
    sse = torch.zeros((), dtype=torch.float32, device=pf.device)
    for s, (u, i) in enumerate(zip(uidx.tolist(), iidx.tolist())):
        cf, mf = pf[u], qf[i]
        if learned:
            t = ((sc['mu'] + bi[i]) + bu[u] + dots[s]) - pqf[s]
            p = torch.clamp(t + cf * mf, lo, hi)
        else:
            p = torch.clamp(base[s] + cf * mf, lo, hi)
        p = torch.clamp(p + tr, lo, hi)
        err = r[s] - p
        sse = sse + err * err
        if learned:
            dbu = sc['lr_bu'] * (err - sc['K_bu'] * bu[u])
            dbi = sc['lr_bi'] * (err - sc['K_bi'] * bi[i])
            bu[u].add_(dbu)
            bi[i].add_(dbi)
        dq = lr * (err * cf - K * mf) if update_items else None
        dp = lr * (err * mf - K * cf) if update_users else None
        if update_items:
            qf[i].add_(dq)
        if update_users:
            pf[u].add_(dp)
    # a 0-dim divisor on the tensors' device: CUDA divides by a CPU
    # scalar as a product with its reciprocal, which may round otherwise
    n = torch.tensor(float(uidx.shape[0]), device=pf.device)
    return pf, qf, bu, bi, torch.sqrt(sse / n)


def cache_update_ref(pf, qf, cache, uidx, iidx, mu, bu, bi,
                     bias_mode='none', lo=1.0, hi=5.0):
    '''Feature f frozen into the per-rating cache after it converges
    (``mfrec_tpu/ops/sgd_mf.py:174-185``): ``clamp(base + pf[u]*qf[i])``,
    base the cache where positive, else 1 (``'none'``) or ``(mu + bi[i])
    + bu[u]``.  Order-independent, so one vectorized pass; returns the
    new cache.'''
    ul, il = uidx.long(), iidx.long()
    if bias_mode == 'none':
        alt = torch.ones_like(cache)
    else:
        alt = (float(mu) + bi[il]) + bu[ul]
    base = torch.where(cache > 0, cache, alt)
    return torch.clamp(base + pf[ul] * qf[il], lo, hi)


def serial_converge_ref(pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr,
                        K, mu, bu, bi, lr_bu, lr_bi, K_bu, K_bi,
                        bias_mode='none', lo=1.0, hi=5.0, update_users=True,
                        update_items=True, P=None, Q=None, min_epochs=1,
                        max_epochs=1, min_improvement=0.0,
                        update_cache=False):
    '''The plain version of a feature's epochs: ``serial_feature_epoch_ref``
    while ``converge_continues``, each rmse read on the host, on copies of
    ``pf`` and ``qf`` (columns of P and Q may be given: the epochs read
    the feature's starting P and Q), written back at the end; then, with
    ``update_cache`` and not learned, ``cache`` updated in place by
    ``cache_update_ref``.  Returns ``(pf, qf, bu, bi, history)``, history
    the epochs' rmse as floats.'''
    cf = pf.clone(memory_format=torch.contiguous_format)
    cq = qf.clone(memory_format=torch.contiguous_format)
    history, rmse, rmse_last = [], 2.0, 2.0
    while converge_continues(len(history), rmse, rmse_last, min_epochs,
                             max_epochs, min_improvement):
        rmse_last = rmse
        rmse = float(serial_feature_epoch_ref(
            cf, cq, cache, uidx, iidx, r, f, dim, f_init, lr, K, mu, bu, bi,
            lr_bu, lr_bi, K_bu, K_bi, bias_mode, lo, hi, update_users,
            update_items, P, Q)[4])
        history.append(rmse)
    pf.copy_(cf)
    qf.copy_(cq)
    if update_cache and bias_mode != 'learned':
        cache.copy_(cache_update_ref(pf, qf, cache, uidx, iidx, mu, bu, bi,
                                     bias_mode, lo, hi))
    return pf, qf, bu, bi, history


# --------------------------------------------------------------- schedule
def _cyclic_neighbours(ids):
    '''For each position s of ``ids``: the position of the same id before
    it and after it, the stream read as a cycle (an id seen once is its
    own neighbour both ways).'''
    ids = np.asarray(ids, np.int64)
    n = ids.shape[0]
    order = np.argsort(ids, kind='stable')
    sid = ids[order]
    first = np.ones(n, bool)
    first[1:] = sid[1:] != sid[:-1]
    last = np.ones(n, bool)
    last[:-1] = first[1:]
    grp = np.cumsum(first) - 1
    j = np.arange(n)
    pj, nj = j - 1, j + 1
    pj[first] = np.flatnonzero(last)[grp[first]]
    nj[last] = np.flatnonzero(first)[grp[last]]
    prev, nxt = np.empty(n, np.int64), np.empty(n, np.int64)
    prev[order] = order[pj]
    nxt[order] = order[nj]
    return prev, nxt


def build_schedule(uidx, iidx):
    '''The kernel's schedule of a stream, one int32 word a rating (the
    stream cut into chunks of ``CHUNK``, rating s on lane s % 32 of
    chunk s // 32; the stream repeats, epoch after epoch):

    - bits 0-4, its round: 0, or one more than the latest round of the
      earlier ratings of its chunk that share its user or its item;
    - bits 5-6 and 7-11, where its user row comes from and the lane:
      ``SRC_IN`` if an earlier rating of the chunk wrote it (that
      rating's lane), ``SRC_PREV`` if the last to write it was a rating
      of the chunk before (cyclically: chunk 0's is the last chunk, and a
      one-chunk stream's is itself), else ``SRC_TABLE``;
    - bits 12-13 and 14-18, the same for its item row;
    - bits 19 and 20, whether it is the last rating of its chunk to write
      its user row, its item row (it then stores the row).'''
    uidx = np.asarray(uidx, np.int64)
    iidx = np.asarray(iidx, np.int64)
    n = uidx.shape[0]
    s = np.arange(n)
    ch = s // CHUNK
    nch = -(-n // CHUNK)
    word = np.zeros(n, np.int64)
    inside = []
    for shift, ids in ((5, uidx), (12, iidx)):
        prev, nxt = _cyclic_neighbours(ids)
        pch = prev // CHUNK
        within = (prev < s) & (pch == ch)
        before = ~within & (pch == (ch - 1) % nch)
        src = np.where(within, SRC_IN, np.where(before, SRC_PREV, SRC_TABLE))
        last = ~((nxt > s) & (nxt // CHUNK == ch))
        word |= (src << shift) | ((prev % CHUNK) << (shift + 2)) \
            | (last.astype(np.int64) << (19 if shift == 5 else 20))
        inside.append((within, prev))
    rounds = np.zeros(n, np.int64)
    for j in range(min(CHUNK, n)):
        at = s[j::CHUNK]
        rr = np.zeros(at.shape[0], np.int64)
        for within, prev in inside:
            m = within[at]
            rr[m] = np.maximum(rr[m], rounds[prev[at[m]]] + 1)
        rounds[at] = rr
    return (word | rounds).astype(np.int32)


def decode_schedule(sched):
    '''The fields of ``build_schedule``'s words, as int arrays.'''
    w = np.asarray(sched, np.int64)
    return dict(round=w & 31, usrc=(w >> 5) & 3, ulane=(w >> 7) & 31,
                isrc=(w >> 12) & 3, ilane=(w >> 14) & 31,
                ulast=(w >> 19) & 1, ilast=(w >> 20) & 1)


def chunk_rounds(sched):
    '''Rounds an epoch: over the chunks, one more than the latest round.'''
    rr = decode_schedule(sched)['round']
    pad = np.zeros(-(-rr.shape[0] // CHUNK) * CHUNK, np.int64)
    pad[:rr.shape[0]] = rr
    return int((pad.reshape(-1, CHUNK).max(1) + 1).sum())


def longest_chain(uidx, iidx):
    '''The longest path, in ratings, through one epoch of the stream's
    dependencies (rating s waits for the last earlier rating on its user
    and on its item): what no schedule can shorten.'''
    du = [0] * (int(np.max(uidx)) + 1)
    di = [0] * (int(np.max(iidx)) + 1)
    best = 0
    for u, i in zip(np.asarray(uidx).tolist(), np.asarray(iidx).tolist()):
        d = max(du[u], di[i]) + 1
        du[u] = di[i] = d
        best = max(best, d)
    return best


class SerialPlan(NamedTuple):
    '''A stream's plan for the kernel, built once a stream: ``table``
    whether the distinct rows (``ucols``, ``icols``) sit in shared
    memory, ``lu``/``li`` each rating's table row (without the table:
    its global id), ``sched`` its schedule word; ``rounds`` the rounds an
    epoch takes.'''
    n: int
    learned: bool
    table: bool
    nu: int
    ni: int
    rounds: int
    lu: torch.Tensor
    li: torch.Tensor
    sched: torch.Tensor
    ucols: torch.Tensor
    icols: torch.Tensor


def serial_plan(uidx, iidx, learned=False, device='cuda', smem=None):
    '''The plan of a stream (int arrays or tensors of global ids) for
    ``bias_mode='learned'`` or not: the table of its distinct rows, in
    shared memory when it fits (``smem=None``; True: it must, False: the
    columns stay in device memory), and its schedule.'''
    u = (uidx.cpu().numpy() if torch.is_tensor(uidx)
         else np.asarray(uidx)).astype(np.int64)
    i = (iidx.cpu().numpy() if torch.is_tensor(iidx)
         else np.asarray(iidx)).astype(np.int64)
    ucols, lu = np.unique(u, return_inverse=True)
    icols, li = np.unique(i, return_inverse=True)
    nu, ni = int(ucols.shape[0]), int(icols.shape[0])
    fits = (nu + ni) * 4 * (2 if learned else 1) <= TABLE_LIMIT
    if smem and not fits:
        raise ValueError('the stream\'s %d + %d distinct rows do not fit in '
                         'shared memory' % (nu, ni))
    table = fits if smem is None else bool(smem)
    if not table:
        lu, li = u, i
    sched = build_schedule(u, i)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return SerialPlan(int(u.shape[0]), bool(learned), table, nu, ni,
                      chunk_rounds(sched), t(lu), t(li), t(sched), t(ucols),
                      t(icols))


# ----------------------------------------------------------------- kernel
def _epoch_bound(x):
    '''An epoch bound as the kernel's int: for every epoch count ep >= 0,
    ``ep < x`` reads as ``ep < _epoch_bound(x)``.'''
    x = float(x)
    if x != x:
        raise ValueError('an epoch bound is NaN')
    if x >= _INT32:
        return _INT32
    if x <= -_INT32:
        return -_INT32
    return int(math.ceil(x))


def _launch(pf, qf, cache, uidx, iidx, r, f, sc, bu, bi, bias_mode,
            update_users, update_items, P, Q, plan, rule, cap,
            cache_out=False):
    '''One launch of the kernel: up to ``cap`` epochs under ``rule`` =
    (ep0, rmse0, rmse_last0, min_epochs, max_epochs, min_improvement);
    ``cache_out``: freeze the feature into ``cache`` if the rule stops in
    it.  Returns the device buffer [cap + 1]: the epochs' rmse as f32
    bits, then their count.'''
    dev = pf.device
    if dev.type != 'cuda':
        raise ValueError('S1 runs on cuda or cpu tensors, not %s' % dev)
    learned = bias_mode == 'learned'
    n = int(uidx.shape[0])
    if plan.n != n or plan.learned != learned or plan.lu.device != dev:
        raise ValueError('the plan is not this stream\'s (n %d, learned %s, '
                         '%s)' % (plan.n, plan.learned, plan.lu.device))
    lib = _library()
    k = int(P.shape[1]) if learned else 1
    aux = torch.empty(2 * n if learned else n, dtype=torch.float32,
                      device=dev)
    out = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    ep0, rmse0, rmse_last0, min_ep, max_ep, min_imp = rule

    def ptr(t):
        return t.data_ptr() if t is not None else None

    code = lib.serial_funk_converge(
        ptr(pf), ptr(qf), pf.stride(0), qf.stride(0), ptr(bu), ptr(bi),
        ptr(cache), int(bool(cache_out)), ptr(uidx), ptr(iidx), ptr(r), ptr(plan.lu), ptr(plan.li), ptr(plan.sched),
        ptr(plan.ucols), ptr(plan.icols), plan.nu, plan.ni, int(plan.table),
        ptr(P) if learned else None, ptr(Q) if learned else None, k,
        int(f) if learned else 0, ptr(aux), n, BIAS_MODES.index(bias_mode),
        int(bool(update_users)), int(bool(update_items)), sc['lr'], sc['K'],
        sc['mu'], sc['lr_bu'], sc['lr_bi'], sc['K_bu'], sc['K_bi'], sc['lo'],
        sc['hi'], sc['trailing'], int(ep0), float(rmse0), float(rmse_last0),
        _epoch_bound(min_ep), _epoch_bound(max_ep), float(min_imp), int(cap),
        ptr(out), torch.cuda.current_stream(dev).cuda_stream)
    if code:
        raise RuntimeError('serial_funk launch failed: %s'
                           % lib.serial_funk_error_string(code).decode())
    serial_converge.launches += 1
    return out


def serial_converge(pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr, K, mu,
                    bu, bi, lr_bu, lr_bi, K_bu, K_bi, bias_mode='none',
                    lo=1.0, hi=5.0, update_users=True, update_items=True,
                    P=None, Q=None, min_epochs=1, max_epochs=1,
                    min_improvement=0.0, update_cache=False, plan=None,
                    smem=None):
    '''Feature f's epochs until ``converge_continues`` stops (the
    arguments of ``serial_converge_ref``, which CPU tensors run; ``pf``
    and ``qf`` may be columns of P and Q).  CUDA tensors: one launch of
    ``csrc/serial_funk.cu`` that runs the epochs and the rule on the card
    (another only past ``MAX_EPOCHS_A_LAUNCH`` epochs) and, with
    ``update_cache``, freezes the feature into ``cache`` (a launch of no
    epoch if the rule runs none); then one host read of the epochs'
    rmse.  ``plan``: the stream's ``serial_plan`` (built here if None,
    with ``smem``).  Returns ``(pf, qf, bu, bi, history)``, history the
    epochs' rmse as floats.  Raises on what the kernel does not take and
    on a CUDA error at launch.'''
    _check(pf, qf, cache, uidx, iidx, r, bu, bi, bias_mode, P, Q, f)
    if pf.device.type == 'cpu':
        return serial_converge_ref(
            pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr, K, mu, bu, bi,
            lr_bu, lr_bi, K_bu, K_bi, bias_mode, lo, hi, update_users,
            update_items, P, Q, min_epochs, max_epochs, min_improvement,
            update_cache)
    learned = bias_mode == 'learned'
    cols = pf, qf
    if learned:     # the dots read the feature's starting P and Q
        pf, qf = (t.clone(memory_format=torch.contiguous_format)
                  for t in cols)
    cache_out = update_cache and not learned
    sc = epoch_scalars(f, dim, f_init, lr, K, mu, lr_bu, lr_bi, K_bu, K_bi,
                       lo, hi)
    history, rmse, rmse_last = [], 2.0, 2.0
    while True:
        go = converge_continues(len(history), rmse, rmse_last, min_epochs,
                                max_epochs, min_improvement)
        if not (go or cache_out):
            break
        if plan is None:
            plan = serial_plan(uidx, iidx, learned, pf.device, smem)
        cap = min(_epoch_bound(max_epochs) - len(history),
                  MAX_EPOCHS_A_LAUNCH) if go else 0
        out = _launch(pf, qf, cache, uidx, iidx, r, f, sc, bu, bi, bias_mode,
                      update_users, update_items, P, Q, plan,
                      (len(history), rmse, rmse_last, min_epochs, max_epochs,
                       min_improvement), cap, cache_out).cpu()
        count = int(out[cap])
        got = out[:count].view(torch.float32).tolist()
        serial_converge.epochs += count
        if not got:
            break
        rmse_last = got[-2] if count > 1 else rmse
        rmse = got[-1]
        history += got
        if not converge_continues(len(history), rmse, rmse_last, min_epochs,
                                  max_epochs, min_improvement):
            break
    if learned:
        for col, t in zip(cols, (pf, qf)):
            col.copy_(t)
    return cols + (bu, bi, history)


serial_converge.launches = 0
serial_converge.epochs = 0


def serial_epoch(pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr, K, mu, bu,
                 bi, lr_bu, lr_bi, K_bu, K_bi, bias_mode='none', lo=1.0,
                 hi=5.0, update_users=True, update_items=True, P=None,
                 Q=None, smem=None, plan=None):
    '''S1 over one feature epoch (the arguments of
    ``serial_feature_epoch_ref``, which CPU tensors run).  CUDA tensors:
    one launch of ``csrc/serial_funk.cu`` for one epoch, in place on
    ``pf``, ``qf`` (and ``bu``, ``bi`` in learned mode); returns ``(pf,
    qf, bu, bi, rmse)``, rmse a device scalar, nothing read on the host.
    ``plan`` and ``smem`` as for ``serial_converge``.'''
    _check(pf, qf, cache, uidx, iidx, r, bu, bi, bias_mode, P, Q, f)
    if pf.device.type == 'cpu':
        return serial_feature_epoch_ref(
            pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr, K, mu, bu, bi,
            lr_bu, lr_bi, K_bu, K_bi, bias_mode, lo, hi, update_users,
            update_items, P, Q)
    if plan is None:
        plan = serial_plan(uidx, iidx, bias_mode == 'learned', pf.device,
                           smem)
    sc = epoch_scalars(f, dim, f_init, lr, K, mu, lr_bu, lr_bi, K_bu, K_bi,
                       lo, hi)
    out = _launch(pf, qf, cache, uidx, iidx, r, f, sc, bu, bi, bias_mode,
                  update_users, update_items, P, Q, plan,
                  (0, 2.0, 2.0, 1, 1, 0.0), 1)
    serial_converge.epochs += 1
    return pf, qf, bu, bi, out[:1].view(torch.float32)[0]


def chain_latency_ns(device='cuda', n=1 << 20, iters=5):
    '''One rating's dependent chain on the card, ns: one thread runs n
    and 2n ratings on one user and item (``serial_funk_chain_probe``),
    the median time of each by CUDA events, their difference over n.'''
    lib = _library()
    dev = torch.device(device)
    out = torch.zeros(2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ms(m):
        times = []
        for _ in range(iters + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            code = lib.serial_funk_chain_probe(int(m), out.data_ptr(), stream)
            b.record()
            if code:
                raise RuntimeError(
                    'serial_funk_chain_probe failed: %s'
                    % lib.serial_funk_error_string(code).decode())
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times[1:]))

    return (ms(2 * n) - ms(n)) * 1e6 / n


def _declare(lib):
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_double
    lib.serial_funk_error_string.argtypes = [i]
    lib.serial_funk_error_string.restype = ctypes.c_char_p
    lib.serial_funk_converge.argtypes = (
        [p, p, i, i, p, p, p, i] + [p] * 8 + [i, i, i, p, p, i, i, p, i, i, i,
                                              i] + [f] * 10
        + [i, d, d, i, i, d, i, p, p])
    lib.serial_funk_converge.restype = i
    lib.serial_funk_chain_probe.argtypes = [i, p, p]
    lib.serial_funk_chain_probe.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('serial_funk', _declare)
