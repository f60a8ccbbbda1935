'''
MFRecommender — the matrix-factorization common layer: BellKor
regularized bias estimates, random-normal factor init, and top-N
recommendation.  Port of ``mfrec_tpu/models/mf.py``.

Retrieval: a model on ``device='cuda'`` always goes through the
hand-written K3 kernel (``ops.topn_kernel``), whatever the retrieval
options; ``fast=True`` selects its bf16 + packed mode.  A model on
``device='cpu'`` runs the plain ``ops.topk.topn_scores``, or the
kernel's plain twin when it asks for the kernel (``use_pallas`` or
``fast``).
'''
from __future__ import annotations

import numpy as np
import torch

from mfrec_tpu_torch.models.base import BaseRecommender
from mfrec_tpu_torch.ops import topk as topk_ops
from mfrec_tpu_torch.ops import topn_kernel
from mfrec_tpu_torch.utils import math_


class MFRecommender(BaseRecommender):
    '''Base class for the matrix factorization based recommenders.'''

    # predictor name -> retrieval score mode
    _PREDICTOR_MODES = {
        'predict_rating': 'dot_plus_one',
        'predict_rating_with_bias': 'bias',
        'predict_logistic': 'logistic',
        'predict_linear': 'bias',
    }

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 device='cuda'):
        BaseRecommender.__init__(self, nbr_users, nbr_items, parameters,
                                 device=device)
        self.neighborhood = 500

    # ------------------------------------------------------------- helpers
    def _alternating_layouts(self, max_window):
        '''The sorted-pass layouts of the alternating engine on the
        model's device (``ops.sgd_mf.PassLayout``; with K1's segment
        tables on a CUDA model), cached on the ratings store's identity
        token and snapshot ``version`` (+ batch/window).  The token keeps
        a store swapped in by ``load_state``, whose version restarts at
        0, from reusing another store's layouts.'''
        from mfrec_tpu_torch.ops import sgd_mf
        store = self.ratings
        key = (store.token, store.version, store.nnz, self.batch_size,
               max_window)
        cached = getattr(self, '_alt_layout_cache', None)
        if cached is not None and cached[0] == key:
            return cached[1]
        self._alt_layout_cache = None    # free the old tables first
        uidx, iidx, vals = store.coo()
        on_card = self.device.type == 'cuda'
        pl_, ql_ = (sgd_mf.PassLayout(
            sgd_mf.sorted_pass_layout(uidx, iidx, vals, self.batch_size,
                                      axis=axis, max_window=max_window),
            axis, self.device, segments=on_card)
            for axis in ('user', 'item'))
        out = (pl_, ql_, pl_.W, ql_.W)
        self._alt_layout_cache = (key, out)
        return out

    def clamping(self, value, min=1.0, max=5.0):
        '''Clamp to [min, max] (``mfrec_tpu/models/mf.py:65-68``).'''
        return float(np.clip(value, min, max))

    def init_feature_normal(self, mean=0.0, std=0.1):
        '''Random-normal factor init from the model's numpy rng (Q, then
        P: the same seed gives the JAX package's factors).'''
        k = self.dimensionality
        self.Q = self.rng.normal(mean, std,
                                 (self.nbr_items, k)).astype(np.float32)
        self.P = self.rng.normal(mean, std,
                                 (self.nbr_users, k)).astype(np.float32)

    # -------------------------------------------------------------- biases
    def compute_items_bias_bk(self):
        '''Regularized item bias, BellKor shrinkage sum/(K3+N)
        (reference mf.py:78-97).'''
        if not self.overall_bias:
            self.compute_overall_avg()
        u, i, v = self.ratings.coo()
        counts = self.ratings.item_counts()
        dev = np.bincount(i, weights=v - self.overall_bias,
                          minlength=self.nbr_items)
        K3 = getattr(self, 'K3', 0.01)
        with np.errstate(invalid='ignore'):
            bias = dev / (K3 + counts)
        bias[counts == 0] = 0.0
        self.items_bias = np.nan_to_num(bias).astype(np.float32)

    def compute_users_bias_bk(self):
        '''Regularized user bias over item-bias-adjusted residuals
        (reference mf.py:100-121).'''
        if not self.overall_bias:
            self.compute_overall_avg()
        if self.items_bias is None:
            self.compute_items_bias_bk()
        u, i, v = self.ratings.coo()
        counts = self.ratings.user_counts()
        resid = v - self.overall_bias - self.items_bias[i]
        dev = np.bincount(u, weights=resid, minlength=self.nbr_users)
        K2 = getattr(self, 'K2', 0.01)
        with np.errstate(invalid='ignore'):
            bias = dev / (K2 + counts)
        bias[counts == 0] = 0.0
        self.users_bias = np.nan_to_num(bias).astype(np.float32)

    # ---------------------------------------------------------- prediction
    def _predictor_mode(self, predictor):
        '''The retrieval score mode of ``predictor``.  Every predictor of
        the ported models has one; the JAX package's per-item host loop for
        predictors without one is not ported.'''
        if predictor == 'predict':
            return getattr(self, '_default_predictor_mode', 'dot_plus_one')
        try:
            return self._PREDICTOR_MODES[predictor]
        except KeyError:
            raise ValueError('predictor %r has no retrieval score mode'
                             % predictor) from None

    def _pallas_score_terms(self, mode):
        '''Map a predictor mode onto the retrieval kernel's fixed score
        form ``mu + bu + bi + P@Q^T``: returns (bu_full, bi_full, mu,
        post) where ``post`` is an optional monotone host transform
        applied to the returned [B, n] scores (ranking is decided in the
        kernel, so a monotone post-map keeps the ids exact — used for the
        logistic link).'''
        zu = np.zeros(self.nbr_users, np.float32)
        zi = np.zeros(self.nbr_items, np.float32)
        bu = np.asarray(self.users_bias, np.float32) \
            if self.users_bias is not None else zu
        bi = np.asarray(self.items_bias, np.float32) \
            if self.items_bias is not None else zi
        if mode == 'dot_plus_one':
            return zu, zi, 1.0, None
        if mode == 'dot':
            return zu, zi, 0.0, None
        if mode == 'logistic':
            lo, hi = float(self.min_rating), float(self.max_rating)

            def post(s):
                return math_.sigmoid(np.clip(s, -60.0, 60.0),
                                     scale_range=hi - lo, y0=lo)

            return bu, bi, 0.0, post
        return bu, bi, float(self.overall_bias or 0.0), None   # 'bias'

    def device_item_terms(self, predictor='predict', bf16=False):
        '''The kernel's item-side operands on the model's device:
        ``(Q [I, k] f32 or bf16, bi [I] f32)`` with the item bias mapped
        for ``predictor``'s mode.  Pass as ``recommend_batch(device_q=)``
        to skip the per-call upload (the serving view caches one).'''
        _, bi_eff, _, _ = self._pallas_score_terms(
            self._predictor_mode(predictor))
        Q = torch.from_numpy(np.ascontiguousarray(self.Q, np.float32))
        Q = Q.to(self.device)
        if bf16:
            Q = Q.to(torch.bfloat16)
        return Q, torch.from_numpy(np.ascontiguousarray(bi_eff)).to(
            self.device)

    def _kernel_topn(self, P_rows, Q, bu_rows, bi, mu, rated_idx,
                     rated_mask, n, bf16_dot=False, packed=False):
        '''K3 on the model's device; numpy in (``Q``/``bi`` may already be
        device tensors), numpy out.'''
        dev = self.device

        def put(a, dtype):
            if isinstance(a, torch.Tensor):
                return a
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        ridx, rcnt = topn_kernel.kernel_rated_lists(rated_idx, rated_mask)
        idx, scores = topn_kernel.topn_scores_kernel(
            put(P_rows, np.float32), put(Q, np.float32),
            put(bu_rows, np.float32), put(bi, np.float32), float(mu), n,
            rated_idx=put(ridx, np.int32), rated_cnt=put(rcnt, np.int32),
            bf16_dot=bf16_dot, packed=packed)
        return idx.cpu().numpy(), scores.cpu().numpy()

    def find_recommended_items(self, user_index=None, user_label=None,
                               nbr_recommendations=5, output_label=False,
                               predictor='predict', neighborhood=None):
        '''Top-N recommendation for one user.

        By default ALL items are scored, rated items masked.  Pass
        ``neighborhood=C`` (or ``neighborhood=True`` to use
        ``self.neighborhood``) to instead score a random C-item candidate
        subset (reference mf.py:144-193).  Returns ([ids], [scores]).
        '''
        if user_index is None:
            user_index = self.users.index[user_label]
        mode = self._predictor_mode(predictor)
        rated_idx, rated_mask = topk_ops.pad_rated_lists(self.ratings,
                                                         [user_index])
        on_card = self.device.type == 'cuda'
        if on_card:
            bu, bi, mu, post = self._pallas_score_terms(mode)
        else:
            bu = self.users_bias if self.users_bias is not None \
                else np.zeros(self.nbr_users, np.float32)
            bi = self.items_bias if self.items_bias is not None \
                else np.zeros(self.nbr_items, np.float32)
            mu = self.overall_bias if self.overall_bias else 0.0
        Q = np.asarray(self.Q, np.float32)
        cand = None
        if neighborhood:
            C = self.neighborhood if neighborhood is True \
                else int(neighborhood)
            if C < self.nbr_items:
                cand = np.sort(self.rng.choice(self.nbr_items, C,
                                               replace=False))
                Q = Q[cand]
                bi = bi[cand]
                # remap rated ids into candidate-local ids (missing -> mask 0)
                local = np.searchsorted(cand, rated_idx)
                local = np.clip(local, 0, C - 1)
                hit = cand[local] == rated_idx
                rated_mask = rated_mask * hit
                rated_idx = np.where(hit, local, 0).astype(np.int32)
        n = min(int(nbr_recommendations), Q.shape[0])
        P_row = np.asarray(self.P[None, user_index], np.float32)
        bu_row = np.asarray([bu[user_index]], np.float32)
        if on_card:
            idx, scores = self._kernel_topn(P_row, Q, bu_row, bi, mu,
                                            rated_idx, rated_mask, n)
        else:
            dev = self.device
            idx, scores = topk_ops.topn_scores(
                torch.from_numpy(P_row).to(dev),
                torch.from_numpy(Q).to(dev), torch.from_numpy(bu_row).to(dev),
                torch.from_numpy(np.asarray(bi, np.float32)).to(dev),
                float(mu), torch.from_numpy(rated_idx).to(dev),
                torch.from_numpy(rated_mask).to(dev), n, predictor=mode,
                lo=self.min_rating, hi=self.max_rating)
            idx, scores = idx.cpu().numpy(), scores.cpu().numpy()
        ids = idx[0]
        vals = np.asarray(scores[0], np.float64)
        keep = vals > topk_ops.NEG / 2
        if on_card and post is not None:
            vals = post(vals)
        if cand is not None:
            ids = cand[ids]
        return [int(x) if not output_label else self.items.labels[int(x)]
                for x in ids[keep]], [float(v) for v in vals[keep]]

    def recommend_batch(self, user_indices, nbr_recommendations=5,
                        predictor='predict', use_pallas=False,
                        sharded=None, mask_rated=True, rated_pad_to=None,
                        score_dtype=None, packed_merge=False,
                        fast=False, device_q=None):
        '''Batched top-N for many users in one device call — the serving
        path.  Returns (idx [B, n] int32, scores [B, n] f32) numpy.

        On a CUDA model every call goes through K3; ``use_pallas`` only
        matters on a CPU model, where it selects the kernel's plain twin
        over ``ops.topk.topn_scores``.  The predictor mode is mapped onto
        the kernel's ``mu + bu + bi + dot`` form (the logistic link is a
        monotone host post-map, so ids match).

        ``fast=True``: the kernel's bf16 score products (f32
        accumulation) and packed merge (scores quantized toward -inf by
        <= 2^-11 relative, so quasi-ties may reorder); it is shorthand
        for ``score_dtype='bfloat16', packed_merge=True``.

        ``device_q``: the ``(Q, bi)`` device pair from
        ``device_item_terms(predictor, bf16=fast)``, to skip the per-call
        upload of the item matrix.

        ``sharded=True`` (multi-device retrieval) is not ported yet.'''
        if sharded:
            raise NotImplementedError(
                'sharded retrieval is not ported yet (ROADMAP queue 1, '
                'item 9: multi-device engines)')
        if fast:
            use_pallas = True
            score_dtype = 'bfloat16'
            packed_merge = True
        users = np.asarray(user_indices)
        n = min(int(nbr_recommendations), self.nbr_items)
        if mask_rated:
            rated_idx, rated_mask = topk_ops.pad_rated_lists(
                self.ratings, users, pad_to=rated_pad_to)
        else:
            rated_idx = np.zeros((len(users), 1), np.int32)
            rated_mask = np.zeros((len(users), 1), np.float32)
        mode = self._predictor_mode(predictor)
        if use_pallas or self.device.type == 'cuda':
            bu_eff, bi_eff, mu_eff, post = self._pallas_score_terms(mode)
            Q, bi = device_q if device_q is not None else (self.Q, bi_eff)
            idx, scores = self._kernel_topn(
                self.P[users], Q, bu_eff[users], bi, mu_eff, rated_idx,
                rated_mask, n, bf16_dot=score_dtype == 'bfloat16',
                packed=bool(packed_merge))
            if post is not None:
                scores = post(scores)
            return idx, scores
        bu = self.users_bias if self.users_bias is not None \
            else np.zeros(self.nbr_users, np.float32)
        bi = self.items_bias if self.items_bias is not None \
            else np.zeros(self.nbr_items, np.float32)
        mu = float(self.overall_bias or 0.0)
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        idx, scores = topk_ops.topn_scores(
            put(self.P[users], np.float32), put(self.Q, np.float32),
            put(bu[users], np.float32), put(bi, np.float32), mu,
            put(rated_idx, np.int32), put(rated_mask, np.float32), n,
            predictor=mode, lo=self.min_rating, hi=self.max_rating)
        return idx.cpu().numpy(), scores.cpu().numpy()
