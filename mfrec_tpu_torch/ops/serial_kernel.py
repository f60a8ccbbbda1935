'''
S1, the serial Funk feature epoch: the hand-written CUDA kernel
(``csrc/serial_funk.cu``) and its plain PyTorch version.

Port of ``serial_feature_epoch`` from ``mfrec_tpu/ops/sgd_mf.py``
(``:109-171``), a ``lax.fori_loop`` outside any Pallas kernel: one
strictly sequential epoch of single-feature Funk SGD over a rating
stream, the reference's ``gd_estimator.pyx`` loops rating by rating (the
cached partial prediction, the trailing-value term, [lo, hi] clamping,
pre-update gradient reads).  It is the exactness oracle and the fold-in
retrain path of ``GDRecommender`` (``engine='funk'``, ``retrain_user``,
``add_user``...).

``serial_epoch`` takes the kernel for CUDA tensors, one launch per
epoch, and the plain version ``serial_feature_epoch_ref`` for CPU
tensors.  Both compute every step in f32 in the same order with no fused
multiply-add, so they agree bit for bit; the JAX function on the CPU may
contract a multiply and an add into one FMA, so the port agrees with it
to a few f32 ulps.  ``serial_epoch.launches`` counts the kernel's
launches.
'''
from __future__ import annotations

import ctypes

import numpy as np
import torch

BIAS_MODES = ('none', 'fixed', 'learned')


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
    for name, t, dtype, size in (
            ('pf', pf, torch.float32, None), ('qf', qf, torch.float32, None),
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


def serial_epoch(pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr, K, mu, bu,
                 bi, lr_bu, lr_bi, K_bu, K_bi, bias_mode='none', lo=1.0,
                 hi=5.0, update_users=True, update_items=True, P=None,
                 Q=None, smem=None):
    '''S1 over one feature epoch (the arguments of
    ``serial_feature_epoch_ref``, which CPU tensors run).  CUDA tensors:
    one launch of ``csrc/serial_funk.cu``, in place on ``pf``, ``qf`` (and
    ``bu``, ``bi`` in learned mode); returns ``(pf, qf, bu, bi, rmse)``,
    rmse a device scalar.  ``smem`` (default: when the columns fit in
    shared memory and the stream has at least U + I ratings) keeps the
    columns in shared memory for the epoch.  Raises on what the kernel
    does not take and on a CUDA error at launch.'''
    _check(pf, qf, cache, uidx, iidx, r, bu, bi, bias_mode, P, Q, f)
    dev = pf.device
    if dev.type == 'cpu':
        return serial_feature_epoch_ref(
            pf, qf, cache, uidx, iidx, r, f, dim, f_init, lr, K, mu, bu, bi,
            lr_bu, lr_bi, K_bu, K_bi, bias_mode, lo, hi, update_users,
            update_items, P, Q)
    if dev.type != 'cuda':
        raise ValueError('serial_epoch runs on cuda or cpu tensors, not %s'
                         % dev)
    lib = _library()
    U, I, n = int(pf.shape[0]), int(qf.shape[0]), int(uidx.shape[0])
    learned = bias_mode == 'learned'
    fits = lib.serial_funk_smem_bytes(U, I, int(learned)) > 0
    if smem is None:
        smem = fits and n >= U + I
    elif smem and not fits:
        raise ValueError('the columns (%d + %d rows) do not fit in shared '
                         'memory' % (U, I))
    sc = epoch_scalars(f, dim, f_init, lr, K, mu, lr_bu, lr_bi, K_bu, K_bi,
                       lo, hi)
    k = int(P.shape[1]) if learned else 1
    rmse = torch.empty((), dtype=torch.float32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    code = lib.serial_funk_launch(
        ptr(pf), ptr(qf), ptr(cache), ptr(uidx), ptr(iidx), ptr(r), ptr(bu),
        ptr(bi), ptr(P) if learned else None, ptr(Q) if learned else None,
        n, U, I, k, int(f) if learned else 0, BIAS_MODES.index(bias_mode),
        int(bool(update_users)), int(bool(update_items)), int(bool(smem)),
        sc['lr'], sc['K'], sc['mu'], sc['lr_bu'], sc['lr_bi'], sc['K_bu'],
        sc['K_bi'], sc['lo'], sc['hi'], sc['trailing'], ptr(rmse),
        torch.cuda.current_stream(dev).cuda_stream)
    if code:
        raise RuntimeError('serial_funk launch failed: %s'
                           % lib.serial_funk_error_string(code).decode())
    serial_epoch.launches += 1
    return pf, qf, bu, bi, rmse


serial_epoch.launches = 0


def chain_floor_ms(n, device='cuda', iters=5):
    '''The chain floor of an n-rating epoch on the card: the median time
    (CUDA events) of one thread following n dependent shared-memory loads
    (``serial_funk_chain_probe``).'''
    lib = _library()
    dev = torch.device(device)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = []
    for _ in range(iters + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        code = lib.serial_funk_chain_probe(int(n), 1024, out.data_ptr(),
                                           stream)
        b.record()
        if code:
            raise RuntimeError('serial_funk_chain_probe failed: %s'
                               % lib.serial_funk_error_string(code).decode())
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[1:]))


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.serial_funk_error_string.argtypes = [i]
    lib.serial_funk_error_string.restype = ctypes.c_char_p
    lib.serial_funk_smem_bytes.argtypes = [i, i, i]
    lib.serial_funk_smem_bytes.restype = ctypes.c_longlong
    lib.serial_funk_launch.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                       i, i, i, i, i, i, i, i, i,
                                       f, f, f, f, f, f, f, f, f, f, p, p]
    lib.serial_funk_launch.restype = i
    lib.serial_funk_chain_probe.argtypes = [i, i, p, p]
    lib.serial_funk_chain_probe.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('serial_funk', _declare)
