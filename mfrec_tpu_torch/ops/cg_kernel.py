'''
K2, warm-started Jacobi-preconditioned CG on batched k x k systems: the
hand-written CUDA kernel (``csrc/pcg.cu``) and its plain PyTorch version.

Port of ``mfrec_tpu/ops/pallas_cg.py`` (``pcg_solve_resident``, body
``_kernel``).  ``M [R, k, k]``, ``b``, ``x0 [R, k]`` f32 -> ``x [R, k]``
f32 after ``steps`` iterations with the TPU kernel's Jacobi
preconditioner and guarded step sizes.  The mat-vec is row-wise,
``(M v)_i = sum_j M[i, j] v_j``, and uses no symmetry.

``pcg_solve_ref`` is ``_kernel`` in plain torch (its mat-vec a
multiply-and-sum over the last axis, as the TPU kernel's).
``pcg_solve_kernel`` is the wrapper: for CUDA tensors it launches K2 once
over all R systems (none for R = 0), for CPU tensors it runs
``pcg_solve_ref`` -- by where the tensors lie, never by what is
installed.  The TPU kernel's padding of R to a block multiple fits VMEM
and is not carried over.  ``pcg_solve_kernel.launches`` counts the calls
that launched the kernel.

The ALS path runs K2 fused with its bucket's Gram assembly:
``cg_bucket_kernel`` (``csrc/cg_bucket.cu``, sharing the iteration in
``csrc/pcg.cuh``) gathers one nnz bucket's neighbour rows of the bf16
fixed side, weights them, forms ``M = HHreg + Awb^T Ab`` on the tensor
cores and ``b``, runs the PCG and writes the solved rows into ``out`` in
place: the JAX package's ``_bucket_cg_body`` (``mfrec_tpu/ops/als.py``)
with ``pcg_impl='pallas'``.  Its plain version ``cg_bucket_ref`` is the
composition it replaces: ``ops.als.cg_system``, ``pcg_solve_ref`` and the
write-back.  ``cg_bucket_kernel.launches`` counts its launches.
'''
from __future__ import annotations

import ctypes

import torch

MAX_K = 256
EPS = 1e-20
DIAG_MIN = 1e-12


def pcg_solve_ref(M, b, x0, steps):
    '''``steps`` Jacobi-PCG iterations from ``x0``, as ``_kernel``
    computes them: M [R, k, k], b, x0 [R, k] -> x [R, k], all f32.'''
    M, b, x = M.float(), b.float(), x0.float()
    D = torch.clamp(torch.diagonal(M, dim1=1, dim2=2), min=DIAG_MIN)

    def Mv(v):
        return (M * v[:, None, :]).sum(-1)

    zero = torch.zeros((), dtype=torch.float32, device=M.device)
    r = b - Mv(x)
    z = r / D
    p = z
    rz = (r * z).sum(-1, keepdim=True)
    for _ in range(int(steps)):
        Mp = Mv(p)
        denom = (p * Mp).sum(-1, keepdim=True)
        a = torch.where(denom > EPS, rz / torch.clamp(denom, min=EPS), zero)
        x = x + a * p
        r = r - a * Mp
        z = r / D
        rz_new = (r * z).sum(-1, keepdim=True)
        beta = torch.where(rz > EPS, rz_new / torch.clamp(rz, min=EPS), zero)
        p = z + beta * p
        rz = rz_new
    return x


def _check_args(M, b, x0, steps):
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError('M must be [R, k, k], got %s' % (tuple(M.shape),))
    R, k = M.shape[0], M.shape[1]
    for name, t in (('b', b), ('x0', x0)):
        if tuple(t.shape) != (R, k):
            raise ValueError('%s must be [%d, %d], got %s'
                             % (name, R, k, tuple(t.shape)))
    for name, t in (('M', M), ('b', b), ('x0', x0)):
        if t.dtype != torch.float32:
            raise ValueError('%s must be float32, got %s' % (name, t.dtype))
        if t.device != M.device:
            raise ValueError('%s is on %s, M on %s' % (name, t.device,
                                                      M.device))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    if not 1 <= k <= MAX_K:
        raise ValueError('k=%d: K2 takes 1..%d' % (k, MAX_K))
    if int(steps) < 0:
        raise ValueError('steps must be >= 0, got %r' % (steps,))


def pcg_solve_kernel(M, b, x0, steps):
    '''K2 over R systems: M [R, k, k], b, x0 [R, k], f32 and contiguous,
    1 <= k <= 256.  CUDA tensors: one launch of ``csrc/pcg.cu`` on the
    current stream (none for R = 0); CPU tensors: ``pcg_solve_ref``.
    Returns a new x [R, k].  Raises on a device, dtype or shape the
    kernel does not take, and on a CUDA error at launch.'''
    _check_args(M, b, x0, steps)
    dev = M.device
    if dev.type == 'cpu':
        return pcg_solve_ref(M, b, x0, steps)
    if dev.type != 'cuda':
        raise ValueError('pcg_solve_kernel runs on cuda or cpu tensors, not '
                         '%s' % dev)
    out = torch.empty_like(b)
    R, k = b.shape
    if R == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pcg_launch(M.data_ptr(), b.data_ptr(), x0.data_ptr(),
                            out.data_ptr(), R, k, int(steps),
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('pcg kernel launch failed: CUDA error %d (%s)'
                           % (rc, lib.pcg_error_string(rc).decode()))
    pcg_solve_kernel.launches += 1
    return out


pcg_solve_kernel.launches = 0


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pcg_error_string.argtypes = [i]
    lib.pcg_error_string.restype = ctypes.c_char_p
    lib.pcg_launch.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, p]
    lib.pcg_launch.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('pcg', _declare)


def cg_bucket_ref(Fb, out, HHreg, rows, nbr_idx, nbr_val, mask, c_pos,
                  alpha, steps, return_system=False):
    '''The fused bucket kernel's plain version: ``cg_system`` (the bf16
    gather, the weighting and the f32 sums of exact products), then
    ``pcg_solve_ref`` from ``out[rows]``, then ``out[rows] = x`` in
    place.  Returns ``out``, or ``(out, M, b)`` with
    ``return_system``.'''
    from mfrec_tpu_torch.ops.als import cg_system
    M, b, x0 = cg_system(Fb, out, HHreg, rows, nbr_idx, nbr_val, mask,
                         c_pos, alpha)
    x = pcg_solve_ref(M, b, x0, steps)
    out[rows.long()] = x.to(out.dtype)
    return (out, M, b) if return_system else out


def padded_k(k):
    '''The fixed side's columns for the fused kernel: k rounded up to a
    multiple of 8, so that each bf16 row is a whole number of 16-byte
    copies.'''
    return -(-int(k) // 8) * 8


def _check_bucket(Fb, out, HHreg, rows, nbr_idx, nbr_val, mask, steps):
    if out.dim() != 2 or out.dtype != torch.float32:
        raise ValueError('out must be [n, k] float32, got %s %s'
                         % (tuple(out.shape), out.dtype))
    k = out.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError('k=%d: the fused K2 takes 1..%d' % (k, MAX_K))
    if Fb.dim() != 2 or Fb.dtype != torch.bfloat16:
        raise ValueError('Fb must be [n, kF] bfloat16, got %s %s'
                         % (tuple(Fb.shape), Fb.dtype))
    if Fb.shape[1] != padded_k(k):
        raise ValueError('Fb has %d columns: k=%d takes %d (ops.als.'
                         '_fixed_bf16)' % (Fb.shape[1], k, padded_k(k)))
    if Fb.shape[0] < 1:
        raise ValueError('Fb has no rows')
    if nbr_idx.dim() != 2:
        raise ValueError('nbr_idx must be [R, L], got %s'
                         % (tuple(nbr_idx.shape),))
    R, L = nbr_idx.shape
    want = (('HHreg', HHreg, (k, k), torch.float32),
            ('rows', rows, (R,), torch.int32),
            ('nbr_idx', nbr_idx, (R, L), torch.int32),
            ('nbr_val', nbr_val, (R, L), torch.float32),
            ('mask', mask, (R, L), torch.float32))
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape:
            raise ValueError('%s must be %s, got %s'
                             % (name, shape, tuple(t.shape)))
        if t.dtype != dtype:
            raise ValueError('%s must be %s, got %s' % (name, dtype, t.dtype))
    for name, t in (('Fb', Fb), ('out', out)) + tuple(
            (w[0], w[1]) for w in want):
        if t.device != out.device:
            raise ValueError('%s is on %s, out on %s' % (name, t.device,
                                                        out.device))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    if Fb.data_ptr() % 16:
        raise ValueError('Fb must start on a 16-byte boundary')
    if int(steps) < 0:
        raise ValueError('steps must be >= 0, got %r' % (steps,))


def cg_bucket_kernel(Fb, out, HHreg, rows, nbr_idx, nbr_val, mask, c_pos,
                     alpha, steps, return_system=False):
    '''One ALS nnz bucket by the fused K2: Fb [n, padded_k(k)] bf16 fixed
    side on a 16-byte boundary (as ``ops.als._fixed_bf16`` makes it:
    whole 16-byte rows for the kernel's copies), out [n_upd, k] f32 (the
    rows ``rows`` [R] int32 solved in place, warm-started from their values), HHreg
    [k, k] f32, nbr_idx [R, L] int32, nbr_val and mask [R, L] f32, all
    contiguous on one device, 1 <= k <= 256.  CUDA tensors: one launch
    of ``csrc/cg_bucket.cu`` on the current stream (none for R = 0);
    CPU tensors: ``cg_bucket_ref``.  Returns ``out``, or ``(out, M, b)``
    with ``return_system`` (M [R, k, k] and b [R, k] f32, written by the
    kernel for tests only).  Raises on what the kernel does not take and
    on a CUDA error at launch.'''
    _check_bucket(Fb, out, HHreg, rows, nbr_idx, nbr_val, mask, steps)
    dev = out.device
    if dev.type == 'cpu':
        return cg_bucket_ref(Fb, out, HHreg, rows, nbr_idx, nbr_val, mask,
                             c_pos, alpha, steps, return_system)
    if dev.type != 'cuda':
        raise ValueError('cg_bucket_kernel runs on cuda or cpu tensors, not '
                         '%s' % dev)
    R, L = nbr_idx.shape
    k = out.shape[1]
    M = b = None
    if return_system:
        M = torch.empty((R, k, k), dtype=torch.float32, device=dev)
        b = torch.empty((R, k), dtype=torch.float32, device=dev)
    if R == 0:
        return (out, M, b) if return_system else out
    lib = _bucket_library()
    with torch.cuda.device(dev):
        scr = torch.empty((R, k, k), dtype=torch.float32, device=dev) \
            if _m_streamed(k) else None
        rc = lib.cg_bucket_launch(
            Fb.data_ptr(), Fb.shape[0], Fb.shape[1], out.data_ptr(),
            out.shape[0], HHreg.data_ptr(), rows.data_ptr(),
            nbr_idx.data_ptr(), nbr_val.data_ptr(), mask.data_ptr(), R, L, k,
            float(c_pos), float(alpha), int(steps),
            None if scr is None else scr.data_ptr(),
            None if M is None else M.data_ptr(),
            None if b is None else b.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('cg_bucket kernel launch failed: CUDA error %d (%s)'
                           % (rc, lib.cg_bucket_error_string(rc).decode()))
    cg_bucket_kernel.launches += 1
    return (out, M, b) if return_system else out


cg_bucket_kernel.launches = 0


def _m_streamed(k):
    '''Whether the fused kernel keeps M in shared memory at this k on
    the current CUDA device (False) or streams it from a scratch buffer
    (True).'''
    rc = _bucket_library().cg_bucket_m_streamed(int(k))
    if rc < 0:
        raise RuntimeError('cg_bucket: no device attributes')
    return bool(rc)


def _declare_bucket(lib):
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.cg_bucket_error_string.argtypes = [i]
    lib.cg_bucket_error_string.restype = ctypes.c_char_p
    lib.cg_bucket_m_streamed.argtypes = [i]
    lib.cg_bucket_m_streamed.restype = i
    lib.cg_bucket_launch.argtypes = [p, ll, i, p, ll, p, p, p, p, p, ll, i,
                                     i, f, f, i, p, p, p, p]
    lib.cg_bucket_launch.restype = i


def _bucket_library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('cg_bucket', _declare_bucket)
