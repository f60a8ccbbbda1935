'''
Factor-space similarity search, plain PyTorch: one matmul and a stable
sort.  Port of ``similar_topk`` and the helpers it uses from
``mfrec_tpu/ops/similarity.py``.

Methods:
  'cosine'        a.b / (|a||b|)
  'cosine_log'    log1p(cosine)
  'pearson'       cosine of row-mean-centered vectors
  'norm_cosine'   log1p(cosine of component-mean-centered vectors)
  'euclidean'     negative euclidean distance
'''
from __future__ import annotations

import torch

NEG = -3.0e38


def _normalize(F, eps=1e-12):
    norms = torch.sqrt((F * F).sum(1))
    return F / torch.clamp(norms, min=eps)[:, None]


def similarity_to_queries(F, query_rows, method='cosine'):
    '''Similarities of every row of F [n, k] to each query row [B, k].
    Returns [B, n].'''
    if method == 'euclidean':
        d2 = ((query_rows[:, None, :] - F[None, :, :]) ** 2).sum(-1)
        return -torch.sqrt(torch.clamp(d2, min=0.0))
    if method == 'pearson':
        F = F - F.mean(dim=1, keepdim=True)
        query_rows = query_rows - query_rows.mean(dim=1, keepdim=True)
    if method == 'norm_cosine':
        # queries center by F's component mean, like the rows of F
        mu = F.mean(dim=0, keepdim=True)
        F = F - mu
        query_rows = query_rows - mu
    s = torch.matmul(_normalize(query_rows), _normalize(F).T)
    if method in ('cosine_log', 'norm_cosine'):
        s = torch.log1p(torch.clamp(s, min=-1.0 + 1e-7))
    elif method not in ('cosine', 'pearson'):
        raise ValueError(method)
    return s


def similar_topk(F, query_idx, k, method='cosine', exclude_self=True):
    '''Top-k most-similar rows of F for each query index (ties to the
    lower row id).  Returns (idx [B, k] int64, sims [B, k]).'''
    q = F[query_idx]
    s = similarity_to_queries(F, q, method=method)
    if exclude_self:
        n = F.shape[0]
        onehot = query_idx[:, None] == torch.arange(n, device=F.device)[None]
        s = torch.where(onehot, torch.tensor(NEG, dtype=s.dtype,
                                             device=s.device), s)
    sims, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return idx[:, :k], sims[:, :k]
