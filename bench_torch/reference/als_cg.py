'''
Plain PyTorch reference of implicit-feedback weighted ALS (Hu, Koren,
Volinsky, ICDM 2008) solved by warm-started Jacobi-preconditioned
conjugate gradients, as the configuration states it.

Per user u, with the observed items N(u), confidence 1 + c_pos on them
and preference 1:

    M_u = Q^T Q + reg I + c_pos * sum_{i in N(u)} q_i q_i^T
    b_u = (1 + c_pos) * sum_{i in N(u)} q_i
    p_u <- ``steps`` PCG iterations on M_u p = b_u from the current p_u

then the items the same way against the new P; a row with no
interaction is zero.  An epoch's steps are ``cg_steps`` for the first
``cg_warmup_epochs`` epochs of a call and ``cg_warm_steps`` after.

Precision (the configuration's): Q^T Q, the PCG and b in float32; the
rows in each rank-1 correction and in b rounded to bfloat16, their exact
products summed (here in float64, so that the sum does not depend on
the order a sparse product takes, then rounded once to float32).  With
``dtype=torch.bfloat16`` every float32 quantity is held in bfloat16: the
control.  The corrections of all rows
come from one sparse product of the interaction matrix with the rows'
outer products.  No code of the program is used.
'''
from __future__ import annotations

import numpy as np
import torch

ROW_BLOCK = 1 << 14


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def pcg(M, b, x, steps, dtype):
    '''``steps`` Jacobi-PCG iterations on the batched systems M x = b.'''
    def Mv(v):
        return torch.matmul(M, v[..., None])[..., 0]

    eps = 1e-20
    zero = torch.zeros((), dtype=dtype, device=M.device)
    D = torch.clamp(torch.diagonal(M, dim1=1, dim2=2), min=1e-12)
    r = b - Mv(x)
    z = r / D
    p = z
    rz = (r * z).sum(-1)
    for _ in range(int(steps)):
        Mp = Mv(p)
        den = (p * Mp).sum(-1)
        a = torch.where(den > eps, rz / torch.clamp(den, min=eps), zero)
        x = x + a[:, None] * p
        r = r - a[:, None] * Mp
        z = r / D
        rz_new = (r * z).sum(-1)
        beta = torch.where(rz > eps, rz_new / torch.clamp(rz, min=eps), zero)
        p = z + beta[:, None] * p
        rz = rz_new
    return x


def params_of(cfg):
    p = dict(cfg['parameters'])
    p.update(cfg.get('fixed', {}))
    return p


def buckets(rows, cols, nrows, ladder=(8, 16, 32, 64, 128, 256, 512, 1024,
                                       2048, 4096, 8192)):
    '''One side's nnz buckets as the work is padded: rows grouped by their
    count into the power-of-two ladder (extended past its top to the
    largest row), each (R, L, nnz, distinct fixed rows).'''
    counts = np.bincount(rows, minlength=nrows)
    top = int(counts.max()) if counts.size else 0
    blist = [b for b in ladder if b <= top] or [ladder[0]]
    while blist[-1] < top:
        blist.append(blist[-1] * 2)
    which = np.full(nrows, -1, np.int64)
    prev = 0
    for j, L in enumerate(blist):
        sel = counts > prev if L == blist[-1] else \
            (counts > prev) & (counts <= L)
        which[sel & (which < 0)] = j
        prev = L
    ent = which[rows]
    out = []
    for j, L in enumerate(blist):
        R = int((which == j).sum())
        if R == 0:
            continue
        m = ent == j
        out.append(dict(R=R, L=int(L), nnz=int(m.sum()),
                        n_fix=int(np.unique(cols[m]).shape[0])))
    return out


def work(u, i, v, cfg, device):
    '''Both sides' buckets, k, and the parameters the bounds need.'''
    p = params_of(cfg)
    return {'user_buckets': buckets(u, i, cfg['data']['users']),
            'item_buckets': buckets(i, u, cfg['data']['items']),
            'k': int(p['nbr_features']), 'users': cfg['data']['users'],
            'items': cfg['data']['items'], 'params': p}


class Reference:
    '''The reference over one interaction set: ``run(P0, Q0, calls)``.
    ``keep``: a fault's rule leaving interactions out (a function of the
    count returning a bool mask over them), else None.'''

    @classmethod
    def build(cls, u, i, v, cfg, device, keep=None):
        return cls(u, i, cfg['data']['users'], cfg['data']['items'],
                   params_of(cfg), device, keep)

    def losses(self, states):
        return [self.loss(P, Q) for P, Q in states]

    def __init__(self, u, i, U, I, params, device, keep=None):
        self.U, self.I = U, I
        self.p = params
        self.device = device
        if keep is not None:
            m = keep(u.shape[0]).cpu().numpy()
            u, i = u[m], i[m]
        uu = torch.from_numpy(u.astype(np.int64)).to(device)
        ii = torch.from_numpy(i.astype(np.int64)).to(device)
        self.R = self._csr(uu, ii, U, I)
        self.Rt = self._csr(ii, uu, I, U)
        self.u_alive = (torch.bincount(uu, minlength=U) > 0)[:, None]
        self.i_alive = (torch.bincount(ii, minlength=I) > 0)[:, None]

    @staticmethod
    def _csr(rows, cols, nr, nc):
        order = torch.argsort(rows * nc + cols)
        idx = torch.stack([rows[order], cols[order]])
        val = torch.ones(rows.shape[0], dtype=torch.float64,
                         device=rows.device)
        return torch.sparse_coo_tensor(idx, val, (nr, nc)).coalesce() \
            .to_sparse_csr()

    def half_sweep(self, R, F_fix, F_upd, steps, dtype):
        k = F_fix.shape[1]
        c = float(self.p['c_pos'])
        reg = float(self.p['regularization_model'])
        Ff = F_fix.float()
        HH = (Ff.T @ Ff + reg * torch.eye(k, device=Ff.device)).double()
        # bf16 rows, their products exact and summed in float64, then M
        # and b rounded once to float32: a sum that does not depend on
        # the order the sparse product takes
        Fb = _bf16(Ff).double()
        outer = (Fb[:, :, None] * Fb[:, None, :]).reshape(-1, k * k)
        out = torch.empty_like(F_upd)
        n = F_upd.shape[0]
        for lo in range(0, n, ROW_BLOCK):
            hi = min(lo + ROW_BLOCK, n)
            Rb = _row_block(R, lo, hi)
            G = torch.sparse.mm(Rb, outer).reshape(-1, k, k)
            M = (HH[None] + c * G).float().to(dtype)
            del G
            b = ((1.0 + c) * torch.sparse.mm(Rb, Fb)).float().to(dtype)
            out[lo:hi] = pcg(M, b, F_upd[lo:hi].to(dtype), steps,
                             dtype).to(out.dtype)
        return out

    def run(self, P0, Q0, calls, dtype=torch.float32):
        '''From numpy ``P0``, ``Q0``, train calls of ``calls`` epochs each
        in turn; returns [(P, Q) after each call] as numpy float32.'''
        dev = self.device
        P = torch.from_numpy(np.ascontiguousarray(P0, np.float32)).to(dev)
        Q = torch.from_numpy(np.ascontiguousarray(Q0, np.float32)).to(dev)
        p = self.p
        out = []
        for epochs in calls:
            for e in range(epochs):
                steps = p['cg_steps'] if e < p['cg_warmup_epochs'] \
                    else p['cg_warm_steps']
                P = self.half_sweep(self.R, Q, P, steps, dtype) \
                    * self.u_alive
                Q = self.half_sweep(self.Rt, P, Q, steps, dtype) \
                    * self.i_alive
            out.append((P.float().cpu().numpy().copy(),
                        Q.float().cpu().numpy().copy()))
        return None, out

    def loss(self, P, Q):
        '''The weighted objective of (P, Q), numpy, in float64:
        sum over all pairs of c (pref - p.q)^2 + reg (|P|^2 + |Q|^2).'''
        dev = self.device
        X = torch.from_numpy(np.asarray(P, np.float64)).to(dev)
        Y = torch.from_numpy(np.asarray(Q, np.float64)).to(dev)
        c = float(self.p['c_pos'])
        reg = float(self.p['regularization_model'])
        total = float(((X.T @ X) * (Y.T @ Y)).sum())
        crow = self.R.crow_indices()
        col = self.R.col_indices()
        rows = torch.repeat_interleave(
            torch.arange(self.U, device=dev), crow[1:] - crow[:-1])
        s = 0.0
        step = 1 << 22
        for a in range(0, rows.shape[0], step):
            d = (X[rows[a:a + step]] * Y[col[a:a + step]]).sum(1)
            s += float(((1.0 + c) * (1.0 - d) ** 2 - d * d).sum())
        return total + s + reg * float((X * X).sum() + (Y * Y).sum())


def _row_block(R, lo, hi):
    '''Rows [lo, hi) of a CSR matrix, as CSR.'''
    crow = R.crow_indices()
    a, b = int(crow[lo]), int(crow[hi])
    return torch.sparse_csr_tensor(crow[lo:hi + 1] - a, R.col_indices()[a:b],
                                   R.values()[a:b], (hi - lo, R.shape[1]))
