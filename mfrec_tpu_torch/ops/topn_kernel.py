'''
K3, fused top-n retrieval: the hand-written CUDA kernel
(``csrc/topn.cu``) and its plain PyTorch twin.

Port of ``mfrec_tpu/ops/pallas_topk.py``.  For a batch of users it
returns the n best items of ``((P.Q^T + mu) + bu) + bi`` with each
user's already-rated items excluded, as ``(idx [B, n] int32,
scores [B, n] f32)`` ordered by (score desc, item id asc) -- the order
the TPU kernel's extract-max merge gives.

Modes, as in the TPU kernel: exact (f32) by default; ``bf16_dot`` rounds
P and Q to bf16 with f32 accumulation; ``packed`` quantizes every score
toward -inf by clearing the low 12 bits of its monotone int32 key (the
id-in-mantissa merge).  ``fast`` in the model layer sets both.

``topn_scores_kernel`` launches the kernel for CUDA tensors and runs
``topn_scores_ref`` for CPU tensors -- by where the tensors lie, never
by what is installed.  Item padding is not needed: the kernel bound-
checks ``i < I``.

Rated lists reach the kernel as ``rated_idx [B, L] int32`` and
``rated_cnt [B] int32``: the first ``rated_cnt[u]`` ids of row u,
ascending (CSR order, what ``ops.topk.pad_rated_lists`` gives).
``kernel_rated_lists`` turns a (rated_idx, rated_mask) pair into that
form and checks it.
'''
from __future__ import annotations

import ctypes

import numpy as np
import torch

NEG = -3.0e38
PACK_BITS = 12
MAX_N = 1024
MAX_K = 256
MAX_B = 65535


def kernel_rated_lists(rated_idx, rated_mask):
    '''Host: ``(rated_idx, rated_mask)`` [B, L] -> ``(idx int32 [B, L],
    cnt int32 [B])`` with each row's valid ids first and ascending.
    Rows already in that form (the ``pad_rated_lists`` layout) pass
    through; others are compacted and sorted.'''
    idx = np.asarray(rated_idx, np.int32)
    valid = np.asarray(rated_mask) > 0
    cnt = valid.sum(1).astype(np.int32)
    L = idx.shape[1]
    prefix = valid == (np.arange(L)[None, :] < cnt[:, None])
    ordered = (np.diff(idx, axis=1) >= 0) | ~valid[:, 1:]
    if not (prefix.all() and ordered.all()):
        key = np.where(valid, idx, np.iinfo(np.int32).max)
        idx = np.sort(key, axis=1)
        idx = np.where(np.arange(L)[None, :] < cnt[:, None], idx, 0)
    return np.ascontiguousarray(idx, np.int32), cnt


def _quantize(s):
    '''Clear the low PACK_BITS of the monotone int32 key of f32 ``s``
    (toward -inf), as ``pallas_topk._block_topn_packed`` does.'''
    bits = s.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    key = key & ~((1 << PACK_BITS) - 1)
    return torch.where(key >= 0, key, key ^ 0x7FFFFFFF).view(torch.float32)


def topn_scores_ref(P_rows, Q, bu_rows, bi, mu, n, rated_idx=None,
                    rated_cnt=None, bf16_dot=False, packed=False):
    '''Plain PyTorch twin of the kernel: one matmul, the bias terms in
    the kernel's order, rated ids set to NEG, the optional packed
    quantization, then a stable descending sort (ties: lower id
    first).'''
    P = P_rows.float()
    Qf = Q.float()
    if bf16_dot:
        P = P.to(torch.bfloat16).float()
        Qf = Qf.to(torch.bfloat16).float()
    s = torch.matmul(P, Qf.T)
    s = ((s + float(mu)) + bu_rows.float()[:, None]) + bi.float()[None, :]
    if rated_idx is not None and rated_idx.shape[1]:
        L = rated_idx.shape[1]
        valid = (torch.arange(L, device=s.device)[None, :]
                 < rated_cnt.to(s.device)[:, None])
        rows = torch.arange(s.shape[0], device=s.device)[:, None].expand(-1, L)
        s[rows[valid], rated_idx.long()[valid]] = NEG
    if packed:
        s = _quantize(s)
    scores, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return idx[:, :n].to(torch.int32), scores[:, :n].contiguous()


def topn_agreement(idx, scores, ref_idx, ref_scores, n, atol, rtol=0.0,
                   tie=None):
    '''Hold a top-n result to a reference top-n (numpy or CPU tensors).
    ``ref_*`` may hold n+1 columns, which tells a quasi-tie at the cut
    from a wrong id.  On every slot the reference fills (score > NEG/2)
    the result fills it too, scores agree within ``atol + rtol*|ref|``,
    and ids agree unless the reference's score there lies within ``tie``
    (default: the score tolerance) of a neighbour's.  Returns
    ``(ok, max_abs_err, swaps)``, swaps counting the id mismatches.'''
    idx = np.asarray(idx)
    scores = np.asarray(scores, np.float64)
    ref_idx = np.asarray(ref_idx)
    ref_s = np.asarray(ref_scores, np.float64)
    rs = ref_s[:, :n]
    valid = rs > NEG / 2
    if not np.array_equal(valid, scores > NEG / 2):
        return False, float('inf'), -1
    tol = atol + rtol * np.abs(rs)
    err = np.where(valid, np.abs(scores - rs), 0.0)
    tie_tol = tol if tie is None else tie
    pad = np.full((ref_s.shape[0], 1), np.inf)
    left = np.concatenate([pad, ref_s], 1)[:, :n]
    right = np.concatenate([ref_s, pad], 1)[:, 1:n + 1]
    near = (np.abs(rs - left) <= tie_tol) | (np.abs(rs - right) <= tie_tol)
    mism = valid & (idx != ref_idx[:, :n])
    ok = bool((err <= tol).all() and (~mism | near).all())
    return ok, float(err.max()) if err.size else 0.0, int(mism.sum())


def _check_args(P_rows, Q, bu_rows, bi, n, rated_idx, rated_cnt, bf16_dot):
    dev = P_rows.device
    B, k = P_rows.shape if P_rows.dim() == 2 else (None, None)
    if B is None or Q.dim() != 2 or Q.shape[1] != k:
        raise ValueError('P_rows [B, k] and Q [I, k] must share k')
    I = Q.shape[0]
    named = [('P_rows', P_rows, torch.float32, (B, k)),
             ('Q', Q, torch.bfloat16 if Q.dtype == torch.bfloat16
              else torch.float32, (I, k)),
             ('bu_rows', bu_rows, torch.float32, (B,)),
             ('bi', bi, torch.float32, (I,))]
    if rated_idx is not None:
        L = rated_idx.shape[1] if rated_idx.dim() == 2 else -1
        named += [('rated_idx', rated_idx, torch.int32, (B, L)),
                  ('rated_cnt', rated_cnt, torch.int32, (B,))]
    elif rated_cnt is not None:
        raise ValueError('rated_cnt given without rated_idx')
    for name, t, dtype, shape in named:
        if t.device != dev:
            raise ValueError('%s is on %s, P_rows on %s' % (name, t.device,
                                                            dev))
        if t.dtype != dtype:
            raise ValueError('%s must be %s, got %s' % (name, dtype, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError('%s must have shape %s, got %s'
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('%s must be contiguous' % name)
    if Q.dtype == torch.bfloat16 and not bf16_dot:
        raise ValueError('a bf16 Q needs bf16_dot=True')
    if not 1 <= B <= MAX_B:
        raise ValueError('batch of %d users: 1..%d' % (B, MAX_B))
    if not 1 <= k <= MAX_K:
        raise ValueError('rank %d: 1..%d' % (k, MAX_K))
    if not 1 <= int(n) <= min(MAX_N, I):
        raise ValueError('n=%d: 1..min(%d, I=%d)' % (n, MAX_N, I))


def topn_scores_kernel(P_rows, Q, bu_rows, bi, mu, n, rated_idx=None,
                       rated_cnt=None, bf16_dot=False, packed=False):
    '''Top-n retrieval.  CUDA tensors: launch K3 (``csrc/topn.cu``) on
    the current stream; CPU tensors: ``topn_scores_ref``.  Raises on a
    device, dtype, shape or contiguity the kernel does not take, and on
    a CUDA error at launch.  ``topn_scores_kernel.launches`` counts the
    kernel's launches.'''
    _check_args(P_rows, Q, bu_rows, bi, n, rated_idx, rated_cnt, bf16_dot)
    dev = P_rows.device
    if dev.type == 'cpu':
        return topn_scores_ref(P_rows, Q, bu_rows, bi, mu, n, rated_idx,
                               rated_cnt, bf16_dot, packed)
    if dev.type != 'cuda':
        raise ValueError('topn_scores_kernel runs on cuda or cpu tensors, '
                         'not %s' % dev)
    lib = _library()
    B, k = P_rows.shape
    I = Q.shape[0]
    n = int(n)
    with torch.cuda.device(dev):
        ws = int(lib.topn_workspace(B, I, n))
        ws_a = torch.empty(ws, dtype=torch.int64, device=dev)
        ws_b = torch.empty(ws, dtype=torch.int64, device=dev)
        idx = torch.empty((B, n), dtype=torch.int32, device=dev)
        scores = torch.empty((B, n), dtype=torch.float32, device=dev)
        L = 0 if rated_idx is None else int(rated_idx.shape[1])
        rc = lib.topn_launch(
            P_rows.data_ptr(), Q.data_ptr(), int(Q.dtype == torch.bfloat16),
            bu_rows.data_ptr(), bi.data_ptr(), float(mu),
            rated_idx.data_ptr() if L else None,
            rated_cnt.data_ptr() if L else None,
            L, B, I, k, n, int(bool(bf16_dot)), int(bool(packed)),
            ws_a.data_ptr(), ws_b.data_ptr(), idx.data_ptr(),
            scores.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('topn kernel launch failed: CUDA error %d (%s)'
                           % (rc, lib.topn_error_string(rc).decode()))
    topn_scores_kernel.launches += 1
    return idx, scores


topn_scores_kernel.launches = 0


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topn_workspace.argtypes = [i, i, i]
    lib.topn_workspace.restype = ctypes.c_longlong
    lib.topn_error_string.argtypes = [i]
    lib.topn_error_string.restype = ctypes.c_char_p
    lib.topn_launch.argtypes = [p, p, i, p, p, ctypes.c_float, p, p,
                                i, i, i, i, i, i, i, p, p, p, p, p]
    lib.topn_launch.restype = i


def _library():
    from mfrec_tpu_torch.ops import _cuda_build
    return _cuda_build.load('topn', _declare)
