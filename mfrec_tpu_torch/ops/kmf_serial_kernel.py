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
``kmf_serial_converge.launches`` counts the kernel's launches and
``kmf_serial_converge.epochs`` the epochs they ran.
'''
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from mfrec_tpu_torch.ops.serial_kernel import _epoch_bound as _bound
from mfrec_tpu_torch.ops.serial_kernel import converge_continues

LINKS = ('logistic', 'linear')
LANES = 32                     # a warp: lane l holds columns l, l + 32, ...
MAX_K = 256
_XOR = {}


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
    lr, Kb, Ku, Ki = sc['lr'], sc['K_bias'], sc['K_users'], sc['K_items']
    dev = P.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    sse = torch.zeros((), dtype=torch.float32, device=dev)
    for s, (u, i) in enumerate(zip(uidx.tolist(), iidx.tolist())):
        cf, mf = P[u].clone(), Q[i].clone()
        dot = (tree_dot(cf, mf) + bu[u]) + bi[i]
        if kernel == 'logistic':
            sig = one / (one + torch.exp(-dot))
            pred = sc['lo'] + sig * sc['rng']
            dgrad = (sig * (one - sig)) * sc['rng']
            err = r[s] - pred
            grad = err * dgrad
        else:
            err = r[s] - dot
            grad = err
        sse = sse + err * err
        if update_users:
            bu[u] = bu[u] + lr * (grad - Kb * bu[u])
        if update_items:
            bi[i] = bi[i] + lr * (grad - Kb * bi[i])
            Q[i] = mf + lr * (grad * cf - Ki * mf)
        if update_users:
            P[u] = cf + lr * (grad * mf - Ku * cf)
    # a 0-dim divisor on the tensors' device: CUDA divides by a CPU
    # scalar as a product with its reciprocal, which may round otherwise
    n = torch.tensor(float(uidx.shape[0]), device=dev)
    return P, Q, bu, bi, torch.sqrt(sse / n)


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


# ----------------------------------------------------------------- kernel
def _launch(P, Q, bu, bi, uidx, iidx, r, sc, kernel, update_users,
            update_items, rule, cap):
    '''One launch: up to ``cap`` epochs under ``rule`` = (min_epochs,
    max_epochs, min_improvement) from epoch 0.  Returns the device buffer
    [cap + 1]: the epochs' rmse as f32 bits, then their count.'''
    dev = P.device
    if dev.type != 'cuda':
        raise ValueError('S2 runs on cuda or cpu tensors, not %s' % dev)
    lib = _library()
    out = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    min_ep, max_ep, min_imp = rule
    code = lib.kmf_serial_converge(
        P.data_ptr(), Q.data_ptr(), bu.data_ptr(), bi.data_ptr(),
        uidx.data_ptr(), iidx.data_ptr(), r.data_ptr(), int(uidx.shape[0]),
        int(P.shape[1]), int(kernel == 'logistic'), int(bool(update_users)),
        int(bool(update_items)), sc['lr'], sc['K_users'], sc['K_items'],
        sc['K_bias'], sc['lo'], sc['rng'], _bound(min_ep), _bound(max_ep),
        float(min_imp), int(cap), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if code:
        raise RuntimeError('kmf_serial launch failed: %s'
                           % lib.kmf_serial_error_string(code).decode())
    kmf_serial_converge.launches += 1
    return out


def kmf_serial_converge(P, Q, bu, bi, uidx, iidx, r, lr, K_users, K_items,
                        K_bias, kernel='logistic', lo=1.0, hi=5.0,
                        update_users=True, update_items=True, min_epochs=1,
                        max_epochs=1, min_improvement=0.0):
    '''A call's epochs until the rule stops or an rmse is not finite (the
    arguments of ``kmf_serial_converge_ref``, which CPU tensors run).
    CUDA tensors: one launch of ``csrc/kmf_serial.cu`` that runs the
    epochs and the rule on the card, in place on P, Q, bu, bi, then one
    host read of the epochs' rmse (no launch if the rule runs none).
    Returns ``(P, Q, bu, bi, history)``.  Raises on what the kernel does
    not take and on a CUDA error at launch.'''
    _check(P, Q, bu, bi, uidx, iidx, r, kernel)
    if P.device.type == 'cpu':
        return kmf_serial_converge_ref(
            P, Q, bu, bi, uidx, iidx, r, lr, K_users, K_items, K_bias,
            kernel, lo, hi, update_users, update_items, min_epochs,
            max_epochs, min_improvement)
    if not converge_continues(0, 2.0, 2.0, min_epochs, max_epochs,
                              min_improvement):
        return P, Q, bu, bi, []
    cap = _bound(max_epochs)
    sc = epoch_scalars(lr, K_users, K_items, K_bias, lo, hi)
    out = _launch(P, Q, bu, bi, uidx, iidx, r, sc, kernel, update_users,
                  update_items, (min_epochs, max_epochs, min_improvement),
                  cap).cpu()
    count = int(out[cap])
    kmf_serial_converge.epochs += count
    return P, Q, bu, bi, out[:count].view(torch.float32).tolist()


kmf_serial_converge.launches = 0
kmf_serial_converge.epochs = 0


def kmf_serial_epoch(P, Q, bu, bi, uidx, iidx, r, lr, K_users, K_items,
                     K_bias, kernel='logistic', lo=1.0, hi=5.0,
                     update_users=True, update_items=True):
    '''S2 over one epoch (the arguments of ``kmf_serial_epoch_ref``, which
    CPU tensors run).  CUDA tensors: one launch of ``csrc/kmf_serial.cu``
    for one epoch, in place on P, Q, bu, bi; returns ``(P, Q, bu, bi,
    rmse)``, rmse a device scalar, nothing read on the host.'''
    _check(P, Q, bu, bi, uidx, iidx, r, kernel)
    if P.device.type == 'cpu':
        return kmf_serial_epoch_ref(P, Q, bu, bi, uidx, iidx, r, lr, K_users,
                                    K_items, K_bias, kernel, lo, hi,
                                    update_users, update_items)
    sc = epoch_scalars(lr, K_users, K_items, K_bias, lo, hi)
    out = _launch(P, Q, bu, bi, uidx, iidx, r, sc, kernel, update_users,
                  update_items, (1, 1, 0.0), 1)
    kmf_serial_converge.epochs += 1
    return P, Q, bu, bi, out[:1].view(torch.float32)[0]


def chain_latency_ns(k, kernel='logistic', device='cuda', n=1 << 16,
                     iters=5):
    '''One rating's dependent chain on the card at width k, ns, measured
    apart from S2 (``kmf_serial_chain_probe``: one warp holds the rows in
    registers and runs only the chain, every rating on one user and one
    item, no loads, stores or selects): n and 2n ratings, the median time
    of each by CUDA events, their difference over n.'''
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
        [p] * 7 + [i] * 5 + [f] * 6 + [i, i, d, i, p, p])
    lib.kmf_serial_converge.restype = i
    lib.kmf_serial_chain_probe.argtypes = [i, i, i, p, p]
    lib.kmf_serial_chain_probe.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('kmf_serial', _declare)
