'''
S2, the serial kernel-MF tier: the hand-written CUDA kernel
(``csrc/kmf_serial.cu``) and its plain PyTorch version.

Port of ``kmf_serial_epoch`` from ``mfrec_tpu/ops/kmf.py`` (``:34-65``),
a ``lax.fori_loop`` outside any Pallas kernel: one strictly sequential
epoch over a rating stream, each step a k-wide dot through the link
(logistic or linear), then ``bu``, ``bi``, ``Q[i]`` and ``P[u]`` updated
in that order from the rows as they were before the step, the
``update_users`` / ``update_items`` masks deciding which sides change;
and of the driver loop around it (``mfrec_tpu/models/kmf.py:333-355``),
which runs epochs under ``ConvergenceDriver``'s rule.  It is
``KMFRecommender``'s ``engine='serial'`` and every KMF fold-in.

Two entries, both one launch of the kernel for CUDA tensors:
``kmf_serial_converge`` runs a call's epochs under the rule on the card
and reads their rmse once; ``kmf_serial_epoch`` runs one epoch and
returns its rmse as a device scalar.  CPU tensors take the plain
versions, ``kmf_serial_converge_ref`` and ``kmf_serial_epoch_ref``.
Kernel and plain version compute every step in f32 in the same order
with no fused multiply-add, the dot as ``tree_dot`` (the kernel's lanes
and shuffle tree), so they agree bit for bit wherever the card's
``expf`` equals ``torch.exp``; the JAX function on the CPU sums the dot
in XLA's order and may contract a multiply and an add into one FMA, so
the port agrees with it to a few f32 ulps a step.

The kernel runs each chunk of 32 ratings on its compute warps side by
side, by a plan built once a call on the host (``kmf_plan``): S1's
schedule (``serial_kernel.build_schedule``: each rating's round in its
chunk, where each of its rows comes from, whether it writes a row last
in its chunk) and each chunk's ratings dealt to the warps
(``assign_warps``).
``kmf_serial_converge.launches`` counts the kernel's launches and
``kmf_serial_converge.epochs`` the epochs they ran.
'''
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from mfrec_tpu_torch.ops import serial_kernel
from mfrec_tpu_torch.ops.serial_kernel import _epoch_bound as _bound
from mfrec_tpu_torch.ops.serial_kernel import converge_continues

LINKS = ('logistic', 'linear')
LANES = 32                     # a warp: lane l holds columns l, l + 32, ...
MAX_K = 256
CHUNK = serial_kernel.CHUNK    # ratings a chunk of the schedule
_XOR = {}
_ONE = {}


def epoch_scalars(lr, K_users, K_items, K_bias, lo, hi):
    '''The epoch's scalars as the JAX function sees them, each an f32
    value held in a Python float; ``rng = hi - lo`` in double, then
    rounded to f32.'''
    f32 = np.float32
    vals = dict(lr=lr, K_users=K_users, K_items=K_items, K_bias=K_bias,
                lo=lo, rng=float(hi) - float(lo))
    return {name: float(f32(float(v))) for name, v in vals.items()}


def tree_dot(a, b):
    '''Dots over the last axis of ``a`` and ``b`` [..., k] f32, summed as
    the kernel's warp sums them: lane l takes columns l, l + 32, ...,
    adds their products in order from +0, then five xor-shuffle rounds
    (offsets 16, 8, 4, 2, 1) add each lane's sum to its partner's.'''
    k = int(a.shape[-1])
    nc = -(-k // LANES)
    pad = nc * LANES - k
    prod = torch.nn.functional.pad(a, (0, pad)) \
        * torch.nn.functional.pad(b, (0, pad))
    prod = prod.reshape(prod.shape[:-1] + (nc, LANES))
    p = torch.zeros(prod.shape[:-2] + (LANES,), dtype=a.dtype,
                    device=a.device)
    for c in range(nc):
        p = p + prod[..., c, :]
    for off in (16, 8, 4, 2, 1):
        key = (off, str(a.device))
        if key not in _XOR:
            _XOR[key] = torch.arange(LANES, device=a.device) ^ off
        p = p + p[..., _XOR[key]]
    return p[..., 0]


def _check(P, Q, bu, bi, uidx, iidx, r, kernel):
    if kernel not in LINKS:
        raise ValueError('kernel must be one of %s, got %r' % (LINKS, kernel))
    dev = P.device
    n = int(uidx.shape[0])
    for name, t in (('P', P), ('Q', Q)):
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError('%s must be a contiguous 2-d f32 tensor on %s'
                             % (name, dev))
    k = int(P.shape[1])
    if int(Q.shape[1]) != k or not 1 <= k <= MAX_K:
        raise ValueError('P and Q must share k, 1 <= k <= %d (got %d, %d)'
                         % (MAX_K, k, int(Q.shape[1])))
    for name, t, dtype, size in (
            ('bu', bu, torch.float32, P.shape[0]),
            ('bi', bi, torch.float32, Q.shape[0]),
            ('uidx', uidx, torch.int32, n), ('iidx', iidx, torch.int32, n),
            ('r', r, torch.float32, n)):
        if t.device != dev or t.dtype != dtype or t.dim() != 1 \
                or not t.is_contiguous() or t.shape[0] != size:
            raise ValueError('%s must be a contiguous 1-d %s tensor of '
                             'length %d on %s' % (name, dtype, size, dev))
    if n < 1:
        raise ValueError('the stream is empty')


def kmf_serial_epoch_ref(P, Q, bu, bi, uidx, iidx, r, lr, K_users, K_items,
                         K_bias, kernel='logistic', lo=1.0, hi=5.0,
                         update_users=True, update_items=True):
    '''The plain version: the stream walked rating by rating in torch, in
    the kernel's f32 operation order.  Updates ``P``, ``Q``, ``bu``,
    ``bi`` in place and returns ``(P, Q, bu, bi, rmse)``, rmse a 0-dim f32
    tensor.'''
    sc = epoch_scalars(lr, K_users, K_items, K_bias, lo, hi)
    dev = P.device
    sse = torch.zeros((), dtype=torch.float32, device=dev)
    for s, (u, i) in enumerate(zip(uidx.tolist(), iidx.tolist())):
        err, P[u], Q[i], bu[u], bi[i] = rating_step(
            P[u].clone(), Q[i].clone(), bu[u].clone(), bi[i].clone(), r[s],
            sc, kernel, update_users, update_items)
        sse = sse + err * err
    # a 0-dim divisor on the tensors' device: CUDA divides by a CPU
    # scalar as a product with its reciprocal, which may round otherwise
    n = torch.tensor(float(uidx.shape[0]), device=dev)
    return P, Q, bu, bi, torch.sqrt(sse / n)


def rating_step(cf, mf, ub, ib, rv, sc, kernel, update_users, update_items):
    '''One rating of the plain version, in the kernel's f32 order: from
    its rows ``cf`` = P[u], ``mf`` = Q[i] [k] and biases ``ub``, ``ib``
    (0-dim) as they were before it, its rating ``rv`` and the epoch's
    scalars ``sc`` (``epoch_scalars``), returns ``(err, cf', mf', ub',
    ib')``, a side the masks do not update unchanged.'''
    lr, Kb, Ku, Ki = sc['lr'], sc['K_bias'], sc['K_users'], sc['K_items']
    key = str(cf.device)
    if key not in _ONE:
        _ONE[key] = torch.ones((), dtype=torch.float32, device=cf.device)
    one = _ONE[key]
    dot = (tree_dot(cf, mf) + ub) + ib
    if kernel == 'logistic':
        sig = one / (one + torch.exp(-dot))
        pred = sc['lo'] + sig * sc['rng']
        dgrad = (sig * (one - sig)) * sc['rng']
        err = rv - pred
        grad = err * dgrad
    else:
        err = rv - dot
        grad = err
    cf2, mf2, ub2, ib2 = cf, mf, ub, ib
    if update_users:
        ub2 = ub + lr * (grad - Kb * ub)
    if update_items:
        ib2 = ib + lr * (grad - Kb * ib)
        mf2 = mf + lr * (grad * cf - Ki * mf)
    if update_users:
        cf2 = cf + lr * (grad * mf - Ku * cf)
    return err, cf2, mf2, ub2, ib2


def kmf_serial_converge_ref(P, Q, bu, bi, uidx, iidx, r, lr, K_users,
                            K_items, K_bias, kernel='logistic', lo=1.0,
                            hi=5.0, update_users=True, update_items=True,
                            min_epochs=1, max_epochs=1, min_improvement=0.0):
    '''The plain version of a call's epochs: ``kmf_serial_epoch_ref``
    while ``converge_continues`` (``ConvergenceDriver``'s rule with no
    plateau decay), each rmse read on the host, stopping after the first
    that is not finite.  Returns ``(P, Q, bu, bi, history)``, history the
    epochs' rmse as floats (a non-finite one last).'''
    history, rmse, rmse_last = [], 2.0, 2.0
    while converge_continues(len(history), rmse, rmse_last, min_epochs,
                             max_epochs, min_improvement):
        rmse_last = rmse
        rmse = float(kmf_serial_epoch_ref(
            P, Q, bu, bi, uidx, iidx, r, lr, K_users, K_items, K_bias,
            kernel, lo, hi, update_users, update_items)[4])
        history.append(rmse)
        if not math.isfinite(rmse):
            break
    return P, Q, bu, bi, history


# --------------------------------------------------------------------- plan
WARPS = 16                     # the kernel's compute warps (its NW)
WARP_TABLE = (WARPS + 4) // 4 * 4   # a chunk's job table: WARPS + 1 starts
# the plan's word: build_schedule's, its round field replaced by the
# rating's lane in its chunk, and for each side whether the row comes
# from the registers of its warp's previous job, or from another warp's
# slot once that warp has flagged it; and whether a rating flags its slot
REG_U, REG_I, WAIT_U, WAIT_I = 1 << 21, 1 << 22, 1 << 23, 1 << 24
NOTIFY = 1 << 25               # another warp waits on the rating's slot
# the next rating on the side's row reads it from this rating's slot
STORE_U, STORE_I = 1 << 26, 1 << 27
SYNC = 1 << 28                 # it reads a slot its own warp wrote


class KmfPlan(NamedTuple):
    '''A stream's plan for the kernel, built once a call (``kmf_plan``):
    ``rec`` [nch * 32, 4] int32, each chunk's ratings as its compute
    warps' job lists (warp 0's first, each in round order), each as its
    user, its item, its word and its rating's f32 bits, past the
    stream's end zeros; ``wst`` [nch, 20] int32, where each warp's jobs
    start in its chunk's records (``WARPS + 1`` starts); ``rounds`` the
    rounds an epoch takes (a chunk's longest chain of ratings that share
    a row, summed).'''
    n: int
    nch: int
    rounds: int
    rec: torch.Tensor
    wst: torch.Tensor


def _host(a, dtype):
    return (a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)) \
        .astype(dtype)


def assign_warps(rnd, usrc, ulane, isrc, ilane):
    '''The stream's ratings (their rounds and sources, by stream index)
    onto the compute warps, chunk by chunk: in order of (round, lane), a
    rating goes to the warp of a rating of its chunk whose row it reads
    (the warp that ran it last, if any; else the one of the later round),
    otherwise to the least loaded warp.  Returns (warp, order in the
    warp, word bits) by stream index: each side read from the registers
    of the warp's previous job (``REG_*``), after another warp flags its
    slot (``WAIT_*``) or from a slot its warp wrote (``SYNC``); the
    rating flags its own slot (``NOTIFY``).'''
    n = len(rnd)
    s = np.arange(n)
    seq = np.lexsort((s, rnd, s // CHUNK)).tolist()
    rnd, usrc, ulane, isrc, ilane = (np.asarray(x).tolist() for x in (
        rnd, usrc, ulane, isrc, ilane))
    warp, order, bits = [0] * n, [0] * n, [0] * n
    src_in = serial_kernel.SRC_IN
    chunk, load, last = -1, None, None
    for j in seq:
        base = j - j % CHUNK
        if base != chunk:
            chunk, load, last = base, [0] * WARPS, [-1] * WARPS
        pu = base + ulane[j] if usrc[j] == src_in else -1
        pi = base + ilane[j] if isrc[j] == src_in else -1
        w = -1
        if pu >= 0 and last[warp[pu]] == pu:
            w = warp[pu]
        if pi >= 0 and last[warp[pi]] == pi:
            w = warp[pi]
        if w < 0:
            if pu >= 0 and pi >= 0:
                w = warp[pu] if rnd[pu] >= rnd[pi] else warp[pi]
            elif pu >= 0 or pi >= 0:
                w = warp[max(pu, pi)]
            else:
                w = load.index(min(load))
        for p, reg, wait in ((pu, REG_U, WAIT_U), (pi, REG_I, WAIT_I)):
            if p >= 0:
                if warp[p] != w:
                    bits[j] |= wait
                    bits[p] |= NOTIFY
                elif last[w] == p:
                    bits[j] |= reg
                else:
                    bits[j] |= SYNC
        warp[j], order[j] = w, load[w]
        load[w] += 1
        last[w] = j
    return (np.asarray(warp, np.int64), np.asarray(order, np.int64),
            np.asarray(bits, np.int64))


def kmf_plan(uidx, iidx, r, device='cuda'):
    '''The plan of a stream (ids and ratings as arrays or tensors) on
    ``device``: ``serial_kernel.build_schedule``'s rounds, sources and
    last-writer marks, each chunk's ratings dealt to the compute warps
    (``assign_warps``).'''
    u, i = _host(uidx, np.int64), _host(iidx, np.int64)
    rv = _host(r, np.float32)
    n = int(u.shape[0])
    if n < 1 or i.shape[0] != n or rv.shape[0] != n:
        raise ValueError('the stream is empty or its arrays differ in length')
    sched = serial_kernel.build_schedule(u, i).astype(np.int64)
    f = serial_kernel.decode_schedule(sched)
    s = np.arange(n)
    ch = s // CHUNK
    nch = -(-n // CHUNK)
    warp, order, bits = assign_warps(f['round'], f['usrc'], f['ulane'],
                                     f['isrc'], f['ilane'])
    word = (sched & ~np.int64(CHUNK - 1)) | (s % CHUNK) | bits
    wst = np.zeros((nch, WARP_TABLE), np.int32)
    wst[:, 1:WARPS + 1] = np.cumsum(np.bincount(
        ch * WARPS + warp, minlength=nch * WARPS).reshape(nch, WARPS), 1)
    top = np.zeros(nch, np.int64)
    np.maximum.at(top, ch, f['round'])
    rounds = int((top + 1).sum())
    # a side goes into the slot only for a next rating on its row that
    # reads it there: in the chunk after, or in this chunk not from its
    # warp's registers (a rating further on reads it from device memory)
    for ids, src, reg, store in ((u, f['usrc'], REG_U, STORE_U),
                                 (i, f['isrc'], REG_I, STORE_I)):
        nxt = serial_kernel._cyclic_neighbours(ids)[1]
        read = (src[nxt] == serial_kernel.SRC_PREV) | (
            (src[nxt] == serial_kernel.SRC_IN) & ((word[nxt] & reg) == 0))
        word |= np.where(read, store, 0)
    rec = np.zeros((nch * CHUNK, 4), np.int32)
    rec[ch * CHUNK + wst[ch, warp] + order] = np.stack(
        [u, i, word, rv.view(np.int32)], 1)

    def t(a):
        return torch.from_numpy(a).to(device)

    return KmfPlan(n, nch, rounds, t(rec), t(wst))


# ------------------------------------------------------------------- kernel
def _launch(P, Q, bu, bi, plan, sc, kernel, update_users, update_items, rule,
            cap):
    '''One launch: up to ``cap`` epochs under ``rule`` = (min_epochs,
    max_epochs, min_improvement) from epoch 0.  Returns the device buffer
    [cap + 1]: the epochs' rmse as f32 bits, then their count.'''
    dev = P.device
    if dev.type != 'cuda':
        raise ValueError('S2 runs on cuda or cpu tensors, not %s' % dev)
    lib = _library()
    out = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    min_ep, max_ep, min_imp = rule
    k = int(P.shape[1])
    vec = k % 4 == 0 and P.data_ptr() % 16 == 0 and Q.data_ptr() % 16 == 0
    code = lib.kmf_serial_converge(
        P.data_ptr(), Q.data_ptr(), bu.data_ptr(), bi.data_ptr(),
        plan.rec.data_ptr(), plan.wst.data_ptr(), plan.n, plan.nch, WARPS, k,
        int(kernel == 'logistic'), int(bool(update_users)),
        int(bool(update_items)), int(vec), sc['lr'], sc['K_users'],
        sc['K_items'], sc['K_bias'], sc['lo'], sc['rng'], _bound(min_ep),
        _bound(max_ep), float(min_imp), int(cap), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if code:
        raise RuntimeError('kmf_serial launch failed: %s'
                           % lib.kmf_serial_error_string(code).decode())
    kmf_serial_converge.launches += 1
    return out


def _plan_for(plan, uidx, iidx, r, dev):
    '''``plan``, checked against the stream, or the stream's own.'''
    if plan is None:
        return kmf_plan(uidx, iidx, r, dev)
    if plan.n != int(uidx.shape[0]) or plan.rec.device != dev:
        raise ValueError('the plan is not this stream\'s (n %d, %s)'
                         % (plan.n, plan.rec.device))
    return plan


def kmf_serial_converge(P, Q, bu, bi, uidx, iidx, r, lr, K_users, K_items,
                        K_bias, kernel='logistic', lo=1.0, hi=5.0,
                        update_users=True, update_items=True, min_epochs=1,
                        max_epochs=1, min_improvement=0.0, plan=None):
    '''A call's epochs until the rule stops or an rmse is not finite (the
    arguments of ``kmf_serial_converge_ref``, which CPU tensors run).
    CUDA tensors: one launch of ``csrc/kmf_serial.cu`` that runs the
    epochs and the rule on the card, in place on P, Q, bu, bi, then one
    host read of the epochs' rmse (no launch if the rule runs none).
    ``plan``: the stream's ``kmf_plan`` (built here if None).  Returns
    ``(P, Q, bu, bi, history)``.  Raises on what the kernel does not take
    and on a CUDA error at launch.'''
    _check(P, Q, bu, bi, uidx, iidx, r, kernel)
    if P.device.type == 'cpu':
        return kmf_serial_converge_ref(
            P, Q, bu, bi, uidx, iidx, r, lr, K_users, K_items, K_bias,
            kernel, lo, hi, update_users, update_items, min_epochs,
            max_epochs, min_improvement)
    if not converge_continues(0, 2.0, 2.0, min_epochs, max_epochs,
                              min_improvement):
        return P, Q, bu, bi, []
    plan = _plan_for(plan, uidx, iidx, r, P.device)
    cap = _bound(max_epochs)
    sc = epoch_scalars(lr, K_users, K_items, K_bias, lo, hi)
    out = _launch(P, Q, bu, bi, plan, sc, kernel, update_users, update_items,
                  (min_epochs, max_epochs, min_improvement), cap).cpu()
    count = int(out[cap])
    kmf_serial_converge.epochs += count
    return P, Q, bu, bi, out[:count].view(torch.float32).tolist()


kmf_serial_converge.launches = 0
kmf_serial_converge.epochs = 0


def kmf_serial_epoch(P, Q, bu, bi, uidx, iidx, r, lr, K_users, K_items,
                     K_bias, kernel='logistic', lo=1.0, hi=5.0,
                     update_users=True, update_items=True, plan=None):
    '''S2 over one epoch (the arguments of ``kmf_serial_epoch_ref``, which
    CPU tensors run).  CUDA tensors: one launch of ``csrc/kmf_serial.cu``
    for one epoch, in place on P, Q, bu, bi; returns ``(P, Q, bu, bi,
    rmse)``, rmse a device scalar, nothing read on the host.  ``plan`` as
    for ``kmf_serial_converge``.'''
    _check(P, Q, bu, bi, uidx, iidx, r, kernel)
    if P.device.type == 'cpu':
        return kmf_serial_epoch_ref(P, Q, bu, bi, uidx, iidx, r, lr, K_users,
                                    K_items, K_bias, kernel, lo, hi,
                                    update_users, update_items)
    plan = _plan_for(plan, uidx, iidx, r, P.device)
    sc = epoch_scalars(lr, K_users, K_items, K_bias, lo, hi)
    out = _launch(P, Q, bu, bi, plan, sc, kernel, update_users, update_items,
                  (1, 1, 0.0), 1)
    kmf_serial_converge.epochs += 1
    return P, Q, bu, bi, out[:1].view(torch.float32)[0]


def chain_latency_ns(k, kernel='logistic', device='cuda', n=1 << 16,
                     iters=5):
    '''One rating's dependent chain on the card at width k, ns, measured
    apart from S2 (``kmf_serial_chain_probe``: one warp holds the rows in
    registers, their columns different from lane to lane as a row's are,
    and runs only the chain, every rating on one user and one item, no
    loads, stores or selects): n and 2n ratings, the median time of each
    by CUDA events, their difference over n.'''
    if kernel not in LINKS:
        raise ValueError('kernel must be one of %s, got %r' % (LINKS, kernel))
    if not 1 <= k <= MAX_K:
        raise ValueError('1 <= k <= %d, got %d' % (MAX_K, k))
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
            code = lib.kmf_serial_chain_probe(
                int(m), int(k), int(kernel == 'logistic'), out.data_ptr(),
                stream)
            b.record()
            if code:
                raise RuntimeError(
                    'kmf_serial_chain_probe failed: %s'
                    % lib.kmf_serial_error_string(code).decode())
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times[1:]))

    return (ms(2 * n) - ms(n)) * 1e6 / n


def _declare(lib):
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_double
    lib.kmf_serial_error_string.argtypes = [i]
    lib.kmf_serial_error_string.restype = ctypes.c_char_p
    lib.kmf_serial_converge.argtypes = (
        [p] * 6 + [i] * 8 + [f] * 6 + [i, i, d, i, p, p])
    lib.kmf_serial_converge.restype = i
    lib.kmf_serial_chain_probe.argtypes = [i, i, i, p, p]
    lib.kmf_serial_chain_probe.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('kmf_serial', _declare)
