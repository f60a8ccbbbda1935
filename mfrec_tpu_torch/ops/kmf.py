'''
Kernel matrix-factorization SGD (Rendle & Schmidt-Thieme, RecSys'08).

Port of ``mfrec_tpu/ops/kmf.py``: the prediction is a full dot product
through a link function (logistic or identity), the biases are learned
jointly.

* ``kmf_serial_epoch``: the order-faithful serial epoch (the oracle tier
  and the fold-in retrains) -- S2 (``ops.kmf_serial_kernel``) for CUDA
  tensors, its plain version for CPU tensors.
* ``make_kmf_fused_epoch``: the mini-batch epoch -- gathers, a batched
  dot, the link, and scatter-adds in a fixed order (``sgd_mf.plan_add_``),
  plain PyTorch on every device (JAX computes it in XLA, not in Pallas).
'''
from __future__ import annotations

import torch

from mfrec_tpu_torch.ops import sgd_mf
# the serial epoch (mfrec_tpu/ops/kmf.py:34-65): S2 for CUDA tensors, its
# plain version for CPU tensors
from mfrec_tpu_torch.ops.kmf_serial_kernel import kmf_serial_epoch  # noqa


def _link(dot, kernel, lo, hi):
    '''``(pred, dpred/ddot)`` of the link (``mfrec_tpu/ops/kmf.py:20-29``).'''
    rng = hi - lo
    if kernel == 'logistic':
        sig = torch.sigmoid(dot)
        pred = lo + sig * rng
        dgrad = sig * (1.0 - sig) * rng
    else:
        pred = dot
        dgrad = torch.ones_like(dot)
    return pred, dgrad


def make_kmf_fused_epoch(kernel='logistic', lr=0.01, K_users=0.1,
                         K_items=0.1, K_bias=0.007, lo=1.0, hi=5.0,
                         update_users=True, update_items=True):
    '''The mini-batch epoch builder (``mfrec_tpu/ops/kmf.py:68-98``), over
    ``sgd_mf.batch_ratings``'s [nb, B] layout and mask.
    ``epoch_fn(P, Q, bu, bi, ub, ib, rb, mb, plan=None) -> (P, Q, bu, bi,
    rmse)``: every step of a batch reads the batch's starting state, the
    rows' sums are added in a fixed order (``plan`` is
    ``sgd_mf.fused_plan(ub, ib)``, built here when None), so a run on the
    card repeats bit for bit.  Updates in place.'''

    def epoch_fn(P, Q, bu, bi, ub, ib, rb, mb, plan=None):
        if plan is None:
            plan = sgd_mf.fused_plan(ub, ib, P.device)
        uplan, iplan = plan
        sses = []
        for b in range(int(ub.shape[0])):
            u, i = ub[b].long(), ib[b].long()
            r, m = rb[b], mb[b]
            pu, qi = P[u], Q[i]
            dot = (pu * qi).sum(-1) + bu[u] + bi[i]
            pred, dgrad = _link(dot, kernel, lo, hi)
            err = (r - pred) * m
            sses.append((err * err).sum())
            grad = err * dgrad
            if update_users:
                sgd_mf.plan_add_(bu, lr * (grad - K_bias * bu[u] * m),
                                 uplan, b)
                sgd_mf.plan_add_(P, lr * (grad[:, None] * qi
                                          - K_users * pu * m[:, None]),
                                 uplan, b)
            if update_items:
                sgd_mf.plan_add_(bi, lr * (grad - K_bias * bi[i] * m),
                                 iplan, b)
                sgd_mf.plan_add_(Q, lr * (grad[:, None] * pu
                                          - K_items * qi * m[:, None]),
                                 iplan, b)
        n = torch.clamp(mb.sum(), min=1.0)
        return P, Q, bu, bi, torch.sqrt(torch.stack(sses).sum() / n)

    return epoch_fn
