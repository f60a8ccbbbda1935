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
