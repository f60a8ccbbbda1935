'''
FNRecommender -- the Koren KDD'08 factorized item-item neighborhood
model.  Port of ``mfrec_tpu/models/fn.py``:

    r_hat(u,i) = mu + b_u + b_i
               + q_i . |R(u)|^-1/2 sum_{j in R(u)} [(r_uj - b_uj) x_j + y_j]

trained on the model's device: with ``engine='auto'`` / ``'alternating'``
on the sorted-window alternating tier (``ops.fn.make_fn_alternating_epoch``),
a CUDA model through K1 (``csrc/half_pass.cu``) and K4
(``csrc/window_agg.cu``), a CPU model through the XLA branch's math in
plain torch; with ``engine='fused'`` on the per-batch scatter tier
(``ops.fn.make_fn_epoch``, the JAX package's oracle-parity tier), plain
torch ops with fixed-order scatter-adds.  The parameter
names, defaults and ``DefaultRate`` sentinels are the JAX model's
(``PARAMETERS_INDEX``: ``regularization_users`` -> K_users regularizes
y, ``regularization_items`` -> K_items regularizes q and x,
``regularization_bias`` -> K_bias both biases).

After ``train()`` the per-user profiles a_u are materialized into
``self.P`` in full f32 (the alternating tier over its user layout, the
fused tier from its padded lists), so retrieval (K3 on a CUDA model)
serves an FN model unchanged: prediction is mu + b_u + b_i + P[u].Q[i].

The alternating tier records the ``utils.profiling`` span tree
``fn.train`` (``fn.init``, ``fn.layouts``, ``fn.upload``, ``fn.epochs``,
``fn.profiles``, ``fn.writeback``) and the counters ``h2d_bytes`` and
``fn.layouts_reused``.

``engine='auto'`` means ``'alternating'``; the sharded engine is not
ported yet and raises.
'''
from __future__ import annotations

import numpy as np
import torch

from mfrec_tpu_torch.engine.trainer import ConvergenceDriver
from mfrec_tpu_torch.models.base import DefaultRate, Error
from mfrec_tpu_torch.models.mf import MFRecommender, _host, _pad_rows
from mfrec_tpu_torch.ops import fn as fn_ops
from mfrec_tpu_torch.ops import sgd_mf
from mfrec_tpu_torch.utils import profiling

_UNPORTED_ENGINES = {
    'alternating_sharded': 'queue 1 item 9 (multi-device engines)',
}


class FNRecommender(MFRecommender):
    '''Factorized Neighborhood Recommendation Engine (Koren KDD'08 §4).'''

    PARAMETERS_INDEX = {'nbr_epochs': 'nbr_epochs',
                        'min_improvement': 'min_improvement',
                        'feature_init': 'feature_init',
                        'learning_rate': 'learning_rate',
                        'learning_rate_users': 'learning_rate_users',
                        'learning_rate_items': 'learning_rate_items',
                        'regularization_users': 'K_users',
                        'regularization_items': 'K_items',
                        'regularization_bias': 'K_bias',
                        'nbr_features': 'dimensionality',
                        'batch_size': 'batch_size',
                        'engine': 'engine',
                        'inner_steps': 'inner_steps'}

    _default_predictor_mode = 'bias'

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 filename=False, device='cuda'):
        MFRecommender.__init__(self, nbr_users, nbr_items, None,
                               device=device)

        # Reference FN defaults (fn.py:44-53); the rates are DefaultRate
        # sentinels, numerically 0.01: the alternating engine substitutes
        # the row-mean 0.15 for a rate the user has not chosen (_fn_lrs)
        self.nbr_epochs = 200
        self.min_improvement = 0.0001
        self.feature_init = 0.1
        self.learning_rate = DefaultRate(0.01)
        self.learning_rate_users = DefaultRate(0.01)
        self.learning_rate_items = DefaultRate(0.01)
        self.K_users = 0.1
        self.K_items = 0.1
        self.K_bias = 0.007
        self.dimensionality = 40
        self.batch_size = 16384
        self.engine = 'auto'
        # sweeps per window batch (the JAX package's time-to-quality
        # choice, mfrec_tpu/models/fn.py:84-95)
        self.inner_steps = 64

        if parameters:
            self.set_parameters(parameters)

        self.rmse_history = []
        self.X = None                 # explicit-weight item factors
        self.Y = None                 # implicit-offset item factors

    def __repr__(self):
        return ('Factorized Neighborhood Recommendation Engine\n'
                'Number of users: %d\nNumber of items: %d\n'
                % (self.nbr_users, self.nbr_items))

    # ------------------------------------------------------------- training
    def train(self, initialize_model=True, verbose=False):
        '''Train the factorized-neighborhood objective on the sorted-window
        alternating tier (``engine='auto'``/``'alternating'``) or the
        per-batch scatter tier (``'fused'``); q and x regularized by
        K_items, y by K_users.'''
        engine = 'alternating' if self.engine == 'auto' else self.engine
        if engine in _UNPORTED_ENGINES:
            raise NotImplementedError(
                'engine %r is not ported yet (ROADMAP %s); use '
                "engine='alternating' or 'fused'"
                % (engine, _UNPORTED_ENGINES[engine]))
        if engine == 'alternating':
            self._train_alternating(initialize_model, verbose)
        elif engine == 'fused':
            self._train_fused(initialize_model, verbose)
        else:
            raise Error('unknown engine %r' % (self.engine,))

    def _fn_lrs(self, default):
        '''Engine rates: any plain-float assignment (even of the reference
        default 0.01) counts as a user choice; unset rates get
        ``default``.'''
        def val(attr):
            v = getattr(self, attr)
            return default if isinstance(v, DefaultRate) else float(v)
        return (val('learning_rate'), val('learning_rate_users'),
                val('learning_rate_items'))

    def _init_or_resume(self, initialize_model):
        '''A fresh ``FNState`` (its seed drawn from ``self.rng``, as the
        JAX model draws it) or a copy of the model's current arrays, on
        the host (``_upload`` moves it to the model's device).'''
        if initialize_model or self.Q is None or self.X is None:
            return fn_ops.init_fn_state(
                self.nbr_users, self.nbr_items, self.dimensionality,
                feature_init=self.feature_init,
                seed=int(self.rng.integers(2 ** 31)),
                mu=self.overall_bias or 0.0, device='cpu')
        return fn_ops.FNState(
            *(torch.from_numpy(np.array(a, np.float32)) for a in (
                self.Q, self.X, self.Y, self.users_bias, self.items_bias)),
            mu=torch.tensor(np.float32(self.overall_bias or 0.0)))

    def _upload(self, host):
        '''``host`` (an ``FNState`` from ``_init_or_resume``) on the
        model's device.'''
        return fn_ops.FNState(*(t.to(self.device) for t in host[:5]),
                              mu=host.mu)

    def _materialize(self, state, profiles):
        '''Post-train: the user profiles a_u (computed on the model's
        device) into ``self.P``, and every factor back as numpy.'''
        self.P = _host(profiles, self.nbr_users)
        self.Q = _host(state.Q, self.nbr_items)
        self.X = _host(state.X, self.nbr_items)
        self.Y = _host(state.Y, self.nbr_items)
        self.users_bias = _host(state.bu, self.nbr_users)
        self.items_bias = _host(state.bi, self.nbr_items)

    def _fn_epoch(self, st, use_kernel=None):
        '''The FN epoch (``ops.fn.make_fn_alternating_epoch``) as this
        model runs it, its starting state ``(Paug, Qaug, Xpad, Ypad)``
        from ``st`` (an ``FNState`` on the model's device), and its fixed
        arguments ``(mu, p_layout, q_layout, nrm_rows)``: W=512 layouts
        (the aggregation phases couple rows across the batch), the user
        factor columns zero until phase 1 installs the profiles.
        ``use_kernel`` defaults to whether the model is on a CUDA
        device.'''
        k = self.dimensionality
        p_layout, q_layout, W_user, W_item = self._alternating_layouts(512)
        lr, lr_bu, lr_bi = self._fn_lrs(0.15)   # row-mean window steps
        Paug, Qaug = self._augmented(
            torch.zeros((self.nbr_users, k), device=self.device), st.Q,
            st.bu, st.bi, W_user, W_item)
        state = (Paug, Qaug, _pad_rows(st.X, W_item),
                 _pad_rows(st.Y, W_item))
        nrm_rows = self._user_norms(W_user)
        mu = torch.tensor(np.float32(self.overall_bias or 0.0))
        if use_kernel is None:
            use_kernel = self._on_card
        epoch = fn_ops.make_fn_alternating_epoch(
            W_user, W_item, lr, lr_bu, lr_bi, lr, K=self.K_items,
            K_bu=self.K_bias, K_bi=self.K_bias, K_x=self.K_items,
            K_y=self.K_users, lo=self.min_rating, hi=self.max_rating,
            inner_steps=self.inner_steps, use_kernel=use_kernel)
        return epoch, state, (mu, p_layout, q_layout, nrm_rows)

    def _train_fused(self, initialize_model=True, verbose=False):
        '''Per-batch scatter-add tier (``ops.fn.make_fn_epoch``;
        ``mfrec_tpu/models/fn.py:177-201``) at the per-sample reference
        rates, on the model's device.'''
        uidx, iidx, vals = self.ratings.shuffled(
            int(self.rng.integers(2 ** 31)))
        self.compute_overall_avg()
        state = self._upload(self._init_or_resume(initialize_model))
        lists = fn_ops.padded_user_lists(self.ratings)
        ub, ib, rb, mb = sgd_mf.batch_ratings(uidx, iidx, vals,
                                              self.batch_size)
        plan = fn_ops.fn_plan(ub, ib, lists[0], lists[2], mb, self.device)
        fl, fv, fm, ub, ib, rb, mb = (
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (*lists, ub, ib, rb, mb))
        lr, lr_bu, lr_bi = self._fn_lrs(0.01)   # reference per-sample rates
        epoch = fn_ops.make_fn_epoch(
            lr, lr_bu, lr_bi, self.K_items, self.K_bias, self.K_bias,
            K_y=self.K_users, lo=self.min_rating, hi=self.max_rating)
        driver = ConvergenceDriver(1, self.nbr_epochs, self.min_improvement)
        state = driver.run(
            lambda s: epoch(s, ub, ib, rb, mb, fl, fv, fm, plan=plan), state)
        self.rmse_history = driver.history
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)
        self._materialize(state, fn_ops.user_aggregates(state, fl, fv, fm))

    def _train_alternating(self, initialize_model=True, verbose=False):
        '''Sorted-window alternating tier: profile aggregation, both
        half-passes and the X/Y steps, all window work on the model's
        device; the span tree ``fn.train``.'''
        with profiling.span('fn.train'):
            self.compute_overall_avg()
            k = self.dimensionality
            with profiling.span('fn.init'):
                host = self._init_or_resume(initialize_model)
            # the call's layouts first, so that _fn_epoch finds them kept
            with profiling.span('fn.layouts'):
                self._alternating_layouts(
                    512, reused_counter='fn.layouts_reused')
            with profiling.span('fn.upload'):
                epoch, state, (mu, p_layout, q_layout, nrm_rows) = \
                    self._fn_epoch(self._upload(host))
                profiling.count('h2d_bytes', sum(
                    t.nbytes for t in (*host[:5], nrm_rows)))
            with profiling.span('fn.epochs'):
                Paug, Qaug, Xpad, Ypad = self._alternating_epochs(
                    ConvergenceDriver(1, self.nbr_epochs,
                                      self.min_improvement),
                    epoch, state, (mu, p_layout, q_layout, nrm_rows),
                    verbose=verbose)
            final = fn_ops.FNState(
                Q=Qaug[:self.nbr_items, :k], X=Xpad[:self.nbr_items],
                Y=Ypad[:self.nbr_items], bu=Paug[:self.nbr_users, k],
                bi=Qaug[:self.nbr_items, k + 1], mu=mu)
            with profiling.span('fn.profiles'):
                profiles = fn_ops.user_profiles(final, p_layout, nrm_rows)
            with profiling.span('fn.writeback'):
                self._materialize(final, profiles)

    def get_rmse_history(self):
        return np.asarray(self.rmse_history)

    def _extra_state_arrays(self):
        '''Checkpoint X too (P holds derived profiles and is saved as
        svd_v; Y rides items_feedback), so fold-in works after a load.'''
        return {} if self.X is None else {'X': self.X}

    # ----------------------------------------------------------- prediction
    def predict_rating_with_bias(self, item_index, user_index):
        '''mu + b_u + b_i + q_i . a_u (profile a_u precomputed at train).'''
        return float(self.clamping(
            self.overall_bias + self.users_bias[user_index]
            + self.items_bias[item_index]
            + self.Q[item_index] @ self.P[user_index],
            self.min_rating, self.max_rating))

    predict = predict_rating_with_bias
    predict_rating = predict_rating_with_bias

    def refresh_user_profile(self, user_index):
        '''Recompute one user's a_u from the current ratings -- the FN
        fold-in: new ratings change the profile with no retraining.'''
        ptr, items, vals = self.ratings.csr()
        s, e = int(ptr[user_index]), int(ptr[user_index + 1])
        ids = items[s:e]
        if ids.size == 0:
            self.P[user_index] = 0.0
            return
        resid = vals[s:e] - (self.overall_bias
                             + self.users_bias[user_index]
                             + self.items_bias[ids])
        nrm = 1.0 / np.sqrt(ids.size)
        self.P[user_index] = nrm * (resid @ self.X[ids]
                                    + self.Y[ids].sum(0))

    def add_user(self, user_label, users_ratings_index, users_ratings):
        '''Fold in a new user: append, store the ratings, build the
        profile -- no gradient steps.'''
        new_id = self.users.add(user_label)
        self.ratings.grow(nbr_users=new_id + 1)
        self.ratings.set_many(
            np.full(len(users_ratings), new_id, np.int32),
            np.asarray(users_ratings_index, np.int32),
            np.asarray(users_ratings, np.float32))
        self.P = np.resize(self.P, (new_id + 1, self.dimensionality))
        self.users_bias = np.resize(self.users_bias, new_id + 1)
        self.users_bias[new_id] = 0.0
        self.refresh_user_profile(new_id)
        return new_id
