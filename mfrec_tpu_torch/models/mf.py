'''
MFRecommender — the matrix-factorization common layer: BellKor
regularized bias estimates, random-normal factor init, and top-N
recommendation.  Port of ``mfrec_tpu/models/mf.py``.

Retrieval: a model on ``device='cuda'`` always goes through the
hand-written K3 kernel (``ops.topn_kernel``), whatever the retrieval
options; ``fast=True`` selects its bf16 + packed mode.  A model on
``device='cpu'`` runs the plain ``ops.topk.topn_scores``, or the
kernel's plain twin when it asks for the kernel (``use_pallas`` or
``fast``).  A predictor with no retrieval score mode (an SVD++ model's
``predict_rating_implicit``, KMF's ``predict_linear_neg``) scores every
unrated item on the host through the predictor itself, as the JAX
package does (``mfrec_tpu/models/mf.py:226-262``).
'''
from __future__ import annotations

import numpy as np
import torch

from mfrec_tpu_torch.models.base import BaseRecommender, DefaultRate, Error
from mfrec_tpu_torch.ops import sgd_mf
from mfrec_tpu_torch.ops import topk as topk_ops
from mfrec_tpu_torch.ops import topn_kernel
from mfrec_tpu_torch.utils import math_, profiling


def _host(t, n):
    '''The first ``n`` rows of a device tensor as a writable numpy array.'''
    return np.array(t[:n].cpu().numpy())


def _pad_rows(t, n):
    '''``t`` with ``n`` zero rows appended: the spare rows past a side's
    end that the alternating engine's windows never run off.'''
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 1) + (0, n))


class MFRecommender(BaseRecommender):
    '''Base class for the matrix factorization based recommenders.'''

    # logged when an alternating tier substitutes the row-mean rate
    _ROW_MEAN_NOTE = ('alternating engine: learning_rate not set; using the '
                      'row-mean default 0.15 (assign learning_rate explicitly '
                      'to override)')

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
    @property
    def _on_card(self):
        '''Whether the model runs the hand-written kernels: a CUDA model
        always does, a CPU model runs their plain versions.'''
        return self.device.type == 'cuda'

    def _to_device(self, a, dtype=np.float32):
        '''A copy of numpy ``a`` (as ``dtype``; None keeps its own) as a
        tensor on the model's device: the epochs update it in place.'''
        return torch.from_numpy(np.array(a, dtype)).to(self.device)

    # ----------------------------------------------- the alternating tiers
    def _alternating_layouts(self, max_window, reused_counter=None):
        '''The sorted-pass layouts of the alternating engine on the
        model's device (``ops.sgd_mf.PassLayout``; with K1's segment
        tables on a CUDA model), kept on an unchanged ratings store
        (``_store_cached``, + batch/window).  ``reused_counter``: a
        ``utils.profiling`` counter that counts one when they were
        kept.'''
        def build():
            uidx, iidx, vals = self.ratings.coo()
            pl_, ql_ = (sgd_mf.PassLayout(
                sgd_mf.sorted_pass_layout(uidx, iidx, vals, self.batch_size,
                                          axis=axis, max_window=max_window),
                axis, self.device, segments=self._on_card)
                for axis in ('user', 'item'))
            return (pl_, ql_, pl_.W, ql_.W)
        layouts, reused = self._store_cached('_alt_layout_cache', build,
                                             self.batch_size, max_window)
        if reused and reused_counter:
            profiling.count(reused_counter, 1)
        return layouts

    def _sgd_window(self):
        '''The layout window W of the SGD and KMF alternating tiers.'''
        return min(128, max(self.nbr_users, self.nbr_items))

    def _alt_lrs(self):
        '''Learning rates for the alternating (row-mean step) engine.
        When the user has not set a rate (it is still the DefaultRate
        sentinel), use the row-mean default 0.15: one averaged step per
        row and batch barely moves at the per-sample default.  An
        explicit value always wins; an unset bias rate follows the
        factor rate.'''
        def chosen(attr):
            return not isinstance(getattr(self, attr), DefaultRate)

        if chosen('learning_rate'):
            lr = float(self.learning_rate)
        else:
            lr = 0.15
            self.logger.info(self._ROW_MEAN_NOTE)
        lr_bu = float(self.learning_rate_users) \
            if chosen('learning_rate_users') else lr
        lr_bi = float(self.learning_rate_items) \
            if chosen('learning_rate_items') else lr
        return lr, lr_bu, lr_bi

    def _lr_schedule(self):
        '''(lr_decay, lr_plateau_decay), each checked to lie in (0, 1].'''
        decay = float(self.lr_decay)
        if not (0.0 < decay <= 1.0):
            raise Error('lr_decay must be in (0, 1] (got %r)'
                        % self.lr_decay)
        plateau = float(self.lr_plateau_decay)
        if not (0.0 < plateau <= 1.0):
            raise Error('lr_plateau_decay must be in (0, 1] (got %r)'
                        % self.lr_plateau_decay)
        return decay, plateau

    def _user_norms(self, W_user):
        '''``|N(u)|^-1/2`` per user (0 for none) and ``W_user`` zero rows
        past the end, on the model's device.'''
        counts = np.asarray(self.ratings.user_counts(), np.float32)
        nrm = np.zeros(self.nbr_users + W_user, np.float32)
        nrm[:counts.shape[0]] = np.where(
            counts > 0, 1.0 / np.sqrt(np.maximum(counts, 1.0)), 0.0)
        return torch.from_numpy(nrm).to(self.device)

    @staticmethod
    def _augmented(P, Q, bu, bi, W_user, W_item):
        '''``sgd_mf.augment_factors`` of the device factors and biases,
        each side with its window's spare rows.'''
        return sgd_mf.augment_factors(
            _pad_rows(P, W_user), _pad_rows(Q, W_item),
            _pad_rows(bu, W_user), _pad_rows(bi, W_item))

    def _alternating_epochs(self, driver, epoch, state, args, decay=1.0,
                            verbose=False, log_epoch=None):
        '''The alternating tiers' convergence loop: ``epoch(*state, *args,
        scale) -> (*state, rmse)`` under ``driver``, epoch ``e`` at the f32
        rate scale ``driver.lr_scale * decay ** e``, until the driver
        stops.  ``log_epoch(n, rmse)``, if given, runs as epoch ``n``
        (from 1) ends.  Sets ``rmse_history``, logs the final scale when
        the plateau decay engaged and, if ``verbose``, each epoch's rmse;
        returns the final state.'''
        def step(st):
            *st, rmse = epoch(*st, *args, np.float32(
                driver.lr_scale * decay ** len(driver.history)))
            if log_epoch is not None:
                log_epoch(len(driver.history) + 1, rmse)
            return st, rmse

        state = driver.run(step, state)
        self.rmse_history = driver.history
        if driver.plateau_decay < 1.0 and driver.lr_scale < 1.0:
            self.logger.info('plateau decay engaged: final lr scale %g',
                             driver.lr_scale)
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)
        return state

    def _from_augmented(self, Paug, Qaug, biases):
        '''The augmented factors' P and Q (and, if ``biases``, the learned
        biases) back as the model's numpy arrays.'''
        P, Q, bu, bi = sgd_mf.split_factors(Paug, Qaug)
        self.P = _host(P, self.nbr_users)
        self.Q = _host(Q, self.nbr_items)
        if biases:
            self.users_bias = _host(bu, self.nbr_users)
            self.items_bias = _host(bi, self.nbr_items)

    def clamping(self, value, min=1.0, max=5.0):
        '''Clamp to [min, max] (``mfrec_tpu/models/mf.py:65-68``).'''
        return float(np.clip(value, min, max))

    def warmyup(self):
        '''Kept for API parity (reference mf.py:64-65): the CSC/CSR views
        are cached inside the ratings store.'''
        self.ratings.csc()

    def init_feature_normal(self, mean=0.0, std=0.1):
        '''Random-normal factor init from the model's numpy rng (Q, then
        P: the same seed gives the JAX package's factors).'''
        k = self.dimensionality
        self.Q = self.rng.normal(mean, std,
                                 (self.nbr_items, k)).astype(np.float32)
        self.P = self.rng.normal(mean, std,
                                 (self.nbr_users, k)).astype(np.float32)

    def init_user_features(self, user_index, mean=0.0, std=0.1):
        '''Redraw one user's row from the model's numpy rng.'''
        self.P[user_index] = self.rng.normal(
            mean, std, self.dimensionality).astype(np.float32)

    def init_item_features(self, item_index, mean=0.0, std=0.1):
        '''Redraw one item's row from the model's numpy rng.'''
        self.Q[item_index] = self.rng.normal(
            mean, std, self.dimensionality).astype(np.float32)

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

    def compute_biases_bk_on_device(self, p_layout, q_layout):
        '''``compute_items_bias_bk`` then ``compute_users_bias_bk`` over
        the ratings the alternating engine's layouts hold on the card:
        B1 (``ops.bias_refit_kernel``) over ``q_layout``'s segment table
        (item-axis) for the item biases, then over ``p_layout``'s
        (user-axis) for the user biases, with numpy's arithmetic (f32
        residuals, f64 sums), so within an f32 ulp of it.  The biases come
        back as numpy f32.  Counts ``bias.device_refits``.'''
        from mfrec_tpu_torch.ops import bias_refit_kernel
        if not self.overall_bias:
            self.compute_overall_avg()
        mu = self.overall_bias
        bi = bias_refit_kernel.bias_refit(q_layout.segments, self.nbr_items,
                                          mu, getattr(self, 'K3', 0.01))
        bu = bias_refit_kernel.bias_refit(p_layout.segments, self.nbr_users,
                                          mu, getattr(self, 'K2', 0.01),
                                          bi=bi)
        self.items_bias = bi.cpu().numpy()
        self.users_bias = bu.cpu().numpy()
        profiling.count('bias.device_refits', 1)

    # ---------------------------------------------------------- prediction
    def predict_rating_by_label(self, user_label, item_label,
                                predictor='predict'):
        '''``predictor`` on a (user, item) label pair; the overall average
        (or 0) for an unknown label (``mfrec_tpu/models/mf.py:125-132``).'''
        try:
            item_index = self.items.index[item_label]
            user_index = self.users.index[user_label]
            return float(getattr(self, predictor)(item_index, user_index))
        except KeyError:
            return self.overall_bias if self.overall_bias else 0.0

    def _predictor_mode(self, predictor):
        '''The retrieval score mode of ``predictor``, or None for a
        predictor without one (it then scores on the host).'''
        if predictor == 'predict':
            return getattr(self, '_default_predictor_mode', 'dot_plus_one')
        return self._PREDICTOR_MODES.get(predictor)

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
        if mode is None:
            return self._find_recommended_items_host(
                user_index, nbr_recommendations, output_label, predictor)
        rated_idx, rated_mask = topk_ops.pad_rated_lists(self.ratings,
                                                         [user_index])
        on_card = self._on_card
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

    def _score_unrated_host(self, user_index, predictor):
        '''The all-items score vector of ``predictor`` for one user,
        vectorized over items, or None to score item by item through the
        predictor.  None here; a model whose predictor has a vectorized
        form overrides it.  Rated items' slots may hold anything: the
        caller zeroes them.'''
        return None

    def _find_recommended_items_host(self, user_index, nbr_recommendations,
                                     output_label, predictor):
        '''Top-N through the predictor on the host
        (``mfrec_tpu/models/mf.py:236-262``): every unrated item scored,
        rated items at 0, NaN at 0; items whose score is exactly 0 left
        out; a stable sort on the negated scores.'''
        rated = self.ratings.rated_mask_for_user(user_index)
        scores = self._score_unrated_host(user_index, predictor)
        if scores is None:
            scores = np.zeros(self.nbr_items)
            fn = getattr(self, predictor)
            for i in range(self.nbr_items):
                if rated[i]:
                    continue
                try:
                    scores[i] = fn(i, user_index)
                except Error:
                    scores[i] = 0.0
        else:
            scores = np.asarray(scores, np.float64).copy()
            scores[np.asarray(rated[:self.nbr_items], bool)] = 0.0
        scores = np.nan_to_num(scores)
        nz = np.nonzero(scores)[0]
        order = nz[np.argsort(-scores[nz], kind='stable')]
        order = order[:nbr_recommendations]
        out = [self.items.labels[int(i)] if output_label else int(i)
               for i in order]
        return out, [float(scores[i]) for i in order]

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

        A predictor with no score mode scores on the host, user by user
        (``find_recommended_items``; rated items always masked), its rows
        padded with id 0 and score ``topk.NEG`` past the user's list.

        ``sharded=True`` (multi-device retrieval) is not ported yet.'''
        n = min(int(nbr_recommendations), self.nbr_items)
        mode = self._predictor_mode(predictor)
        if mode is None:
            users = np.asarray(user_indices)
            idx = np.zeros((len(users), n), np.int32)
            sc = np.full((len(users), n), topk_ops.NEG, np.float32)
            for row, uu in enumerate(users):
                ids, vals = self.find_recommended_items(
                    user_index=int(uu), nbr_recommendations=n,
                    predictor=predictor)
                idx[row, :len(ids)] = ids[:n]
                sc[row, :len(vals)] = vals[:n]
            return idx, sc
        if sharded:
            raise NotImplementedError(
                'sharded retrieval is not ported yet (ROADMAP queue 1, '
                'item 9: multi-device engines)')
        if fast:
            use_pallas = True
            score_dtype = 'bfloat16'
            packed_merge = True
        users = np.asarray(user_indices)
        if mask_rated:
            rated_idx, rated_mask = topk_ops.pad_rated_lists(
                self.ratings, users, pad_to=rated_pad_to)
        else:
            rated_idx = np.zeros((len(users), 1), np.int32)
            rated_mask = np.zeros((len(users), 1), np.float32)
        if use_pallas or self._on_card:
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
