'''
Top-N retrieval, plain PyTorch: score every item, mask the rated ones,
stable sort.  Port of ``mfrec_tpu/ops/topk.py``.

This is the retrieval of a model on ``device='cpu'`` when it does not
ask for the kernel; a CUDA model always retrieves through K3
(``ops.topn_kernel``).
'''
from __future__ import annotations

import numpy as np
import torch

from mfrec_tpu_torch.data.ratings import padded_segment_gather

NEG = -3.0e38


def topn_scores(P_rows, Q, bu_rows, bi, mu, rated_idx, rated_mask, n,
                predictor='dot_plus_one', lo=1.0, hi=5.0):
    '''Top-n items for a batch of users.

    P_rows: [B, k] user factors; Q: [I, k]; bu_rows: [B]; bi: [I];
    rated_idx/rated_mask: [B, L] padded per-user rated-item lists (those
    items are excluded).
    predictor:
      'dot_plus_one' -> dot + 1.0
      'dot'          -> plain dot
      'bias'         -> mu + bu + bi + dot
      'logistic'     -> lo + sigmoid(dot + bu + bi) * (hi - lo)
    Returns (idx [B, n] int32, scores [B, n] f32) sorted descending, ties
    to the lower item id.
    '''
    dot = torch.matmul(P_rows, Q.T)
    if predictor == 'dot_plus_one':
        s = dot + 1.0
    elif predictor == 'dot':
        s = dot
    elif predictor == 'bias':
        s = mu + bu_rows[:, None] + bi[None, :] + dot
    elif predictor == 'logistic':
        z = dot + bu_rows[:, None] + bi[None, :]
        s = lo + torch.sigmoid(z) * (hi - lo)
    else:
        raise ValueError(predictor)
    hit = rated_mask > 0
    rows = torch.arange(s.shape[0], device=s.device)[:, None].expand_as(hit)
    s = s.index_put((rows[hit], rated_idx.long()[hit]),
                    torch.tensor(NEG, dtype=s.dtype, device=s.device))
    scores, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return idx[:, :n].to(torch.int32), scores[:, :n].contiguous()


def pad_rated_lists(ratings, user_indices, cap=None, pad_to=None):
    '''Host-side: padded already-rated lists for a batch of users —
    vectorized grid fill (no per-user python loop).  ``pad_to`` pads the
    list width UP to a fixed value (serving: one shape across all batch
    compositions).  Rows come in CSR order: valid ids first, ascending.'''
    ptr, items, _ = ratings.csr()
    users = np.asarray(user_indices, np.int64)
    counts = ptr[users + 1] - ptr[users]
    L = int(max(counts.max() if counts.size else 0, 1))
    # L policy: round up to a power of two, so consecutive batches share
    # a few widths
    L = 1 << (L - 1).bit_length()
    if cap is not None:
        L = min(L, int(cap))
    if pad_to is not None:
        # pad_to AFTER cap: the fixed serving width is a shape contract;
        # a cap must never silently undercut it
        L = max(L, int(pad_to))
    idx, mask = padded_segment_gather(ptr, users, L, items)
    return idx, mask
