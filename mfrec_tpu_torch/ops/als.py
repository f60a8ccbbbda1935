'''
Weighted-regularized implicit ALS (WRMF): batched normal equations per
nnz bucket.  Port of ``mfrec_tpu/ops/als.py``.

Per half-sweep, one Gram ``HH = F^T F`` of the fixed side, then per
bucket of ``Ratings.padded_rows`` the rank-L corrections and the solve:
batched Cholesky (``solver='exact'``, ``_bucket_solve``) or warm-started
Jacobi-PCG (``solver='cg'``, ``_bucket_cg_body``).  The CG path gathers
the fixed side in bf16 and assembles ``M`` and ``b`` with f32 sums of
exact products; on a CUDA model the gather, the assembly, the iterations
and the write-back of one bucket are one launch of the fused K2
(``ops.cg_kernel.cg_bucket_kernel``).

Model (Hu/Koren/Volinsky ICDM'08, as the reference implements it):
confidence ``c_ui = 1 + c_pos`` for observed pairs and 1 otherwise (or
``1 + alpha * r_ui`` with ``alpha > 0``), preference 1 for observed.
Per user u:
    M_u = HH + sum_{i in N(u)} (c_ui - 1) q_i q_i^T + reg*I
    b_u = sum_{i in N(u)} c_ui q_i
    p_u = M_u^{-1} b_u

Where the JAX package returns new arrays, the bucket bodies here write
the solved rows into ``out`` in place (rows are unique within a bucket);
the half-sweeps, ``cg_epoch`` and ``als_wrmf_train`` copy their inputs
first, so to a caller they stay functional.  Every f32 matrix product
here runs at full f32 precision (no TF32), whatever the process-wide
setting: ``ieee_f32`` sets it around each product.
'''
from __future__ import annotations

import contextlib

import numpy as np
import torch

from mfrec_tpu_torch.ops.cg_kernel import cg_bucket_kernel, padded_k, \
    pcg_solve_ref
from mfrec_tpu_torch.utils import profiling


@contextlib.contextmanager
def ieee_f32():
    '''Full-f32 matrix products inside the block (no TF32 on a GPU); the
    caller's setting is restored after.'''
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _confidence_m1(nbr_val, mask, c_pos, alpha):
    '''``c_ui - 1`` on the observed slots, 0 on the padding.'''
    c = float(alpha) * nbr_val if float(alpha) > 0 else \
        torch.full_like(nbr_val, float(c_pos))
    return c * mask


def _gather(F, nbr_idx):
    '''``F[nbr_idx]``: [R, L] ids -> [R, L, k] rows (int32 ids taken).'''
    R, L = nbr_idx.shape
    return torch.index_select(F, 0, nbr_idx.reshape(-1)).reshape(
        R, L, F.shape[1])


def _eye(k, reg, device):
    return float(reg) * torch.eye(k, dtype=torch.float32, device=device)


def _bucket_solve(F, out, HH, rows, nbr_idx, nbr_val, mask, c_pos, alpha,
                  reg, gram_dtype=None):
    '''Solve the normal equations for one nnz bucket by batched Cholesky
    and write the rows into ``out`` (in place; also returned).

    F: [n_other, k] fixed side; out: [n_this, k]; rows: [R];
    nbr_idx/nbr_val/mask: [R, L].  ``gram_dtype=torch.bfloat16`` rounds
    the rank-L correction's operands (the masked rows, and the rows
    times ``c - 1``) to bf16 and sums their products in f32; ``b`` and
    the solve stay f32.'''
    k = F.shape[1]
    A = _gather(F, nbr_idx) * mask[..., None]            # [R, L, k]
    cm1 = _confidence_m1(nbr_val, mask, c_pos, alpha)    # [R, L]
    Aw = A * cm1[..., None]
    if gram_dtype is not None:
        # bf16(A * cm1), then widened: products of bf16 values are exact
        # in f32, so the f32 product sums them as the MXU einsum does
        Ag = A.to(gram_dtype).float()
        Aw = Aw.to(gram_dtype).float()
    else:
        Ag = A
    with ieee_f32():
        M = HH[None] + torch.bmm(Aw.transpose(1, 2), Ag)
    del Aw, Ag
    M = M + _eye(k, reg, F.device)[None]
    b = ((1.0 + cm1)[..., None] * A).sum(1)               # [R, k]
    # jnp.linalg.cholesky symmetrizes its input, (M + M^T) / 2; the bf16
    # Gram with alpha > 0 is not symmetric (bf16(A*cm1)^T bf16(A))
    L = torch.linalg.cholesky((M + M.transpose(1, 2)) / 2)
    sol = torch.cholesky_solve(b[..., None], L)[..., 0]
    out[rows.long()] = sol.to(out.dtype)
    return out


def pcg_solve(M, b, x0, steps):
    '''Warm-started Jacobi-preconditioned CG on batched systems: M
    [R, k, k], b [R, k], x0 [R, k] -> x [R, k], the mat-vec one batched
    [k, k] @ [k, 1] product.  The plain loop a CPU model runs (the JAX
    package's XLA ``pcg_solve``).'''
    def Mv(v):
        with ieee_f32():
            return torch.matmul(M, v[..., None])[..., 0]

    D = torch.clamp(torch.diagonal(M, dim1=1, dim2=2), min=1e-12)
    eps = 1e-20
    zero = torch.zeros((), dtype=torch.float32, device=M.device)
    x = x0
    r = b - Mv(x)
    z = r / D
    p = z
    rz = (r * z).sum(-1)
    for _ in range(int(steps)):
        Mp = Mv(p)
        denom = (p * Mp).sum(-1)
        a = torch.where(denom > eps, rz / torch.clamp(denom, min=eps), zero)
        x = x + a[:, None] * p
        r = r - a[:, None] * Mp
        z = r / D
        rz_new = (r * z).sum(-1)
        beta = torch.where(rz > eps, rz_new / torch.clamp(rz, min=eps), zero)
        p = z + beta[:, None] * p
        rz = rz_new
    return x


def cg_system(F, out, HHreg, rows, nbr_idx, nbr_val, mask, c_pos, alpha):
    '''One bucket's CG systems: ``(M [R, k, k], b [R, k], x0 [R, k])``.

    ``F`` may be pre-cast to bf16 (one cast per half-sweep) and have
    more columns than ``out`` (``_fixed_bf16``'s padding): the first k
    are read.  The gather is unmasked (a padded slot reads row 0); the
    mask enters through ``cm1`` and ``(1 + cm1) * mask``.  ``M = HHreg +
    Awb^T Ab`` with ``Ab = bf16(F[nbr_idx])`` and ``Awb = Ab *
    bf16(cm1)`` (a bf16 product), summed in f32 from the widened bf16
    operands; ``b = sum_l (1 + cm1) mask * Ab``, in f32.'''
    k = out.shape[1]
    Ab = _gather(F[:, :k], nbr_idx).to(torch.bfloat16)      # [R, L, k]
    cm1 = _confidence_m1(nbr_val, mask, c_pos, alpha)       # [R, L]
    Awb = Ab * cm1[..., None].to(torch.bfloat16)
    Af = Ab.float()
    del Ab
    with ieee_f32():
        M = HHreg[None] + torch.bmm(Awb.float().transpose(1, 2), Af)
        del Awb
        b = torch.bmm(((1.0 + cm1) * mask)[:, None, :], Af)[:, 0]
    return M, b, out[rows.long()]


def _bucket_cg_body(F, out, HHreg, rows, nbr_idx, nbr_val, mask, c_pos,
                    alpha, reg, steps, pcg_impl='xla'):
    '''Gram assembly and ``steps`` PCG iterations for one nnz bucket,
    warm-started from the rows' current values; writes the rows into
    ``out`` (in place; also returned).

    On CUDA tensors always the fused K2 (``cg_bucket_kernel``: gather,
    Gram, PCG and write-back in one launch), whatever ``pcg_impl``; ``F``
    is then the fixed side as ``_fixed_bf16`` makes it.  On CPU tensors
    ``cg_system`` and then ``pcg_impl='pallas'`` runs K2's plain version
    (the Pallas kernel's numerics) and any other value the plain loop
    ``pcg_solve`` (the XLA loop's).'''
    if out.is_cuda:
        return cg_bucket_kernel(F, out, HHreg, rows, nbr_idx, nbr_val, mask,
                                c_pos, alpha, steps)
    M, b, x0 = cg_system(F, out, HHreg, rows, nbr_idx, nbr_val, mask,
                         c_pos, alpha)
    if pcg_impl == 'pallas':
        x = pcg_solve_ref(M, b, x0, steps)
    else:
        x = pcg_solve(M, b, x0, steps)
    del M, b
    out[rows.long()] = x.to(out.dtype)
    return out


def _fixed_bf16(F):
    '''The fixed side in bf16, cast once per half-sweep, padded with zero
    columns to a multiple of 8 (whole 16-byte rows for the fused K2's
    gathers; ``cg_system`` reads the first k).'''
    k = F.shape[1]
    Fb = F.to(torch.bfloat16)
    if k % 8:
        Fb = torch.nn.functional.pad(Fb, (0, padded_k(k) - k))
    return Fb


def _hh(F, reg=None):
    '''``F^T F`` (+ ``reg*I``) in f32.'''
    with ieee_f32():
        HH = (F.T @ F).float()
    if reg is not None:
        HH = HH + _eye(F.shape[1], reg, F.device)
    return HH


def cg_epoch(P, Q, u_alive, i_alive, user_buckets, item_buckets, c_pos,
             alpha, reg, steps, pcg_impl='xla'):
    '''One CG epoch (the body of ``make_cg_epoch``): the user half-sweep
    over ``user_buckets`` against Q, the item half-sweep over
    ``item_buckets`` against the new P, each followed by zeroing the rows
    with no interactions (``u_alive``/``i_alive`` [n, 1]).  Returns new
    (P, Q).'''
    P, Q = P.clone(), Q.clone()
    HHreg = _hh(Q, reg)
    Qb = _fixed_bf16(Q)                # one cast per half-sweep
    for rows, nidx, nval, mask in user_buckets:
        _bucket_cg_body(Qb, P, HHreg, rows, nidx, nval, mask, c_pos, alpha,
                        reg, steps, pcg_impl)
    del Qb
    P.mul_(u_alive)
    HHreg = _hh(P, reg)
    Pb = _fixed_bf16(P)
    for rows, nidx, nval, mask in item_buckets:
        _bucket_cg_body(Pb, Q, HHreg, rows, nidx, nval, mask, c_pos, alpha,
                        reg, steps, pcg_impl)
    del Pb
    Q.mul_(i_alive)
    return P, Q


def device_buckets(buckets, device):
    '''A ``padded_rows`` bucket list as tensors on ``device``, uploaded
    once for a whole training run (tensors already there pass through);
    the host-resident arrays it hands over count as ``h2d_bytes``.
    ``WRMFRecommender`` keeps its lists between ``train()`` calls on an
    unchanged ratings store.'''
    dev = torch.device(device)
    profiling.count('h2d_bytes', _host_nbytes(
        x for b in buckets for x in b
        if not torch.is_tensor(x) or x.device != dev))
    return [tuple(torch.as_tensor(x).to(dev) for x in b) for b in buckets]


def als_half_sweep_cg(F_fixed, F_update, buckets, c_pos=1.0, alpha=0.0,
                      reg=0.015, cg_steps=6):
    '''One half-sweep by warm-started PCG (the fused K2 on CUDA tensors,
    the plain loop on CPU tensors); same buckets contract as
    ``als_half_sweep``.  Returns the new ``F_update``.'''
    dev = F_update.device
    F_update = F_update.clone()
    HHreg = _hh(F_fixed, reg)
    Fb = _fixed_bf16(F_fixed)
    for bucket in device_buckets(buckets, dev):
        _bucket_cg_body(Fb, F_update, HHreg, *bucket, c_pos, alpha, reg,
                        int(cg_steps))
    return F_update


def als_half_sweep(F_fixed, F_update, buckets, c_pos=1.0, alpha=0.0,
                   reg=0.015, gram_dtype=None):
    '''One half-sweep (all users, or all items) by batched Cholesky.

    buckets: output of ``Ratings.padded_rows`` -- list of (rows,
    nbr_idx, nbr_val, mask) with per-bucket shapes.  Returns the new
    ``F_update``.'''
    dev = F_update.device
    F_update = F_update.clone()
    HH = _hh(F_fixed)
    for bucket in device_buckets(buckets, dev):
        _bucket_solve(F_fixed, F_update, HH, *bucket, c_pos, alpha, reg,
                      gram_dtype)
    return F_update


def _alive_mask(buckets, nrows):
    alive = np.zeros((nrows, 1), np.float32)
    for rows, _, _, _ in buckets:
        alive[np.asarray(rows.cpu() if torch.is_tensor(rows) else rows)] = 1.0
    return alive


def _host_nbytes(arrays):
    '''The bytes of the host-resident arrays among ``arrays`` (numpy
    arrays and CPU tensors).'''
    return sum(a.nbytes for a in arrays
               if not torch.is_tensor(a) or a.device.type == 'cpu')


def _device_alive(buckets, nrows, device):
    '''``_alive_mask`` on ``device`` from device buckets: [nrows, 1] f32,
    1 on a row that has a bucket and 0 on a never-rated row.'''
    alive = torch.zeros((nrows, 1), dtype=torch.float32, device=device)
    if buckets:
        alive.index_fill_(0, torch.cat([b[0] for b in buckets]).long(), 1.0)
    return alive


def als_wrmf_train(P, Q, user_buckets, item_buckets, nbr_epochs=20,
                   c_pos=1.0, alpha=0.0, reg=0.015, callback=None,
                   gram_dtype=None, solver='exact', cg_steps=6,
                   cg_warm_steps=None, cg_warmup_epochs=2,
                   pcg_impl='auto', device=None):
    '''Full WRMF training: alternate user and item half-sweeps
    (reference main loop ``als_implicit.pyx:250-352``) on ``device``
    (default: P's).

    P: [U, k] user factors, Q: [I, k] item factors (f32 tensors, not
    modified).  user_buckets index into Q (each user's rated items);
    item_buckets index into P; buckets already on the device (as
    ``WRMFRecommender`` keeps them) pass through.  Returns new (P, Q).
    P, Q and any host-resident buckets go to the device in the span
    ``als.upload``, whose host-resident bytes count as ``h2d_bytes``;
    the alive masks are built there, on the device, from the buckets'
    rows.  The epochs run in ``als.epochs`` (``utils.profiling``).

    Rows with no ratings come back exactly zero: the reference solves
    M^-1 @ 0 = 0 for them during the pass (``als_implicit.pyx:296-302``),
    where the buckets skip them.  Each half-sweep multiplies its side by
    its alive mask on the device, so they do not carry their init values
    into the next Gram; with ``nbr_epochs=0`` the call does it once.

    ``solver='cg'`` runs warm-started PCG half-sweeps (``cg_epoch``),
    ``cg_steps`` iterations per solve for the first ``cg_warmup_epochs``
    epochs and ``cg_warm_steps`` (default: ``cg_steps``) after; 'exact'
    is batched Cholesky (the oracle-parity mode), where ``gram_dtype``
    (None or ``torch.bfloat16``) selects the rank-L corrections' input
    type.

    ``pcg_impl``: 'auto' (default) runs the fused K2 on a CUDA model and
    the plain loop ``pcg_solve`` on a CPU model.  On a CUDA model every
    value runs the fused K2 -- the rule ``use_pallas`` follows for
    retrieval; on a CPU model 'pallas' runs K2's plain version and 'xla'
    the plain loop.
    '''
    dev = P.device if device is None else torch.device(device)
    if pcg_impl in (None, 'auto'):
        pcg_impl = 'pallas' if dev.type == 'cuda' else 'xla'
    with profiling.span('als.upload'):
        profiling.count('h2d_bytes', _host_nbytes([P, Q]))
        P, Q = P.to(dev), Q.to(dev)
        user_buckets = device_buckets(user_buckets, dev)
        item_buckets = device_buckets(item_buckets, dev)
        u_alive = _device_alive(user_buckets, P.shape[0], dev)
        i_alive = _device_alive(item_buckets, Q.shape[0], dev)
    if cg_warm_steps is None:
        cg_warm_steps = cg_steps
    with profiling.span('als.epochs'):
        if nbr_epochs == 0:
            P, Q = P * u_alive, Q * i_alive
        for epoch in range(nbr_epochs):
            if solver == 'cg':
                steps = cg_steps if epoch < cg_warmup_epochs \
                    else cg_warm_steps
                P, Q = cg_epoch(P, Q, u_alive, i_alive, user_buckets,
                                item_buckets, float(c_pos), float(alpha),
                                float(reg), int(steps), pcg_impl)
            else:
                P = als_half_sweep(Q, P, user_buckets, c_pos, alpha, reg,
                                   gram_dtype) * u_alive
                Q = als_half_sweep(P, Q, item_buckets, c_pos, alpha, reg,
                                   gram_dtype) * i_alive
            if callback is not None:
                callback(epoch, P, Q)
    return P, Q


# --------------------------------------------------------------------------
# Slow oracle (numpy, mirrors the Cython reference exactly)
# --------------------------------------------------------------------------

def als_wrmf_oracle(nbr_epochs, dim, u, v, users_row, users_col, items_row,
                    items_col, nbr_users, nbr_items, c_pos=1, k=0.015):
    '''Direct numpy re-expression of ``als_implicit.pyx:211-352`` (same
    inputs: (row-count-with-leading-0, col-index) arrays, u=[dim, items],
    v=[dim, users]).  Kept as the slow-oracle twin for tests -- the
    reference's own pattern (``als_wrmf_dense``, ``als_implicit.pyx:71``).'''
    for _ in range(nbr_epochs):
        HH = u @ u.T
        start = 0
        for j in range(users_row.shape[0] - 1):
            start += users_row[j]
            span = users_row[j + 1]
            cols = users_col[start:start + span]
            sub = u[:, cols]
            M = HH + c_pos * (sub @ sub.T) + k * np.eye(dim)
            rhs = (1 + c_pos) * sub.sum(1)
            v[:, j] = np.linalg.inv(M) @ rhs
        HH = v @ v.T
        start = 0
        for j in range(items_row.shape[0] - 1):
            start += items_row[j]
            span = items_row[j + 1]
            cols = items_col[start:start + span]
            sub = v[:, cols]
            M = HH + c_pos * (sub @ sub.T) + k * np.eye(dim)
            rhs = (1 + c_pos) * sub.sum(1)
            u[:, j] = np.linalg.inv(M) @ rhs
    return u, v
