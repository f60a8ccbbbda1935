'''
GDRecommender — Funk/BellKor SGD matrix factorization.

Port of ``mfrec_tpu/models/gd.py``: the constructor with the reference
parameter names and defaults (``PARAMETERS_INDEX``), training on the
single-device sorted-window alternating engine, the predictors and
``predict_batch``.

Training (``train``/``feature_training``, ``feature_training_bias``)
runs ``ops.sgd_mf.make_alternating_epoch`` on the model's device: a CUDA
model through the hand-written K1 kernel (``csrc/half_pass.cu``), a CPU
model through the XLA branch's math in plain torch -- the counterpart of
the JAX model's ``use_pallas_full = backend != 'cpu'``.  The factors stay
on the device across epochs (one host sync per epoch, the RMSE the
convergence rule reads) and come back as numpy at the end, so serving
works on a model the port trained.

``engine='auto'`` means ``'alternating'``: a port model lives on one
explicit device, where the JAX model picks ``alternating_sharded`` when
``len(jax.devices()) > 1``.  The other engines and ``resilience > 0`` are
not ported yet and raise.
'''
from __future__ import annotations

import numpy as np
import torch

from mfrec_tpu_torch.engine.trainer import ConvergenceDriver
from mfrec_tpu_torch.models.base import DefaultRate, Error
from mfrec_tpu_torch.models.mf import MFRecommender
from mfrec_tpu_torch.ops import sgd_mf

# engines of the JAX model that the port does not have yet -> ROADMAP item
_UNPORTED_ENGINES = {
    'funk': 'queue 1 item 6 (the other GD engines)',
    'funk_fused': 'queue 1 item 6 (the other GD engines)',
    'fused': 'queue 1 item 6 (the other GD engines)',
    'dsgd': 'queue 1 item 6 (the other GD engines)',
    'alternating_sharded': 'queue 1 item 9 (multi-device engines)',
    'alternating_ring': 'queue 1 item 9 (multi-device engines)',
}


class GDRecommender(MFRecommender):
    '''Gradient Descent based Recommendation Engine (regularized MF via SGD;
    Funk 2006 / Koren KDD'08 — see reference gradient_descent.py:27-56).'''

    PARAMETERS_INDEX = {'min_epochs': 'min_epochs',
                        'max_epochs': 'max_epochs',
                        'min_improvement': 'min_improvement',
                        'feature_init': 'feature_init',
                        'learning_rate': 'learning_rate',
                        'learning_rate_users': 'learning_rate_users',
                        'learning_rate_items': 'learning_rate_items',
                        'regularization_model': 'K',
                        'regularization_users_bias': 'K2',
                        'regularization_items_bias': 'K3',
                        'nbr_features': 'dimensionality',
                        'batch_size': 'batch_size',
                        'engine': 'engine',
                        'inner_steps': 'inner_steps',
                        'inner_steps_implicit': 'inner_steps_implicit',
                        'lr_decay': 'lr_decay',
                        'lr_plateau_decay': 'lr_plateau_decay',
                        'init_mode': 'init_mode',
                        'n_slices': 'n_slices',
                        'resilience': 'resilience',
                        'resilience_snapshot_every':
                            'resilience_snapshot_every',
                        'resilience_dir': 'resilience_dir',
                        'sharded_pallas_half': 'sharded_pallas_half'}

    _default_predictor_mode = 'dot_plus_one'

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 filename=False, device='cuda'):
        MFRecommender.__init__(self, nbr_users, nbr_items, None,
                               device=device)

        # Reference defaults (gradient_descent.py:77-87); the rates are
        # DefaultRate sentinels, numerically 0.001 (see _alt_lrs)
        self.min_epochs = 275
        self.max_epochs = 275
        self.min_improvement = 0.0001
        self.feature_init = 0.1
        self.learning_rate = DefaultRate(0.001)
        self.learning_rate_users = DefaultRate(0.001)
        self.learning_rate_items = DefaultRate(0.001)
        self.K = 0.05
        self.K2 = 0.01
        self.K3 = 0.01
        self.dimensionality = 40

        # training-engine settings, with the JAX package's defaults (batch
        # 16384 ratings, T=128 sweeps per batch, W=128 windows)
        self.engine = 'auto'
        self.batch_size = 16384
        self.inner_steps = 128
        self.inner_steps_implicit = 32
        # per-epoch multiplicative rate decay: rate = lr * lr_decay**epoch
        self.lr_decay = 1.0
        # ConvergenceDriver plateau decay: at a stall, scale the rate by
        # this and continue until the scale floors (1.0 disables)
        self.lr_plateau_decay = 1.0
        # 'auto': N(0, feature_init) from self.rng for the joint engines
        # (a constant init collapses joint training to rank 1), the
        # reference's constant fill for the feature-sequential ones
        self.init_mode = 'auto'
        self.n_slices = 1
        self.sharded_pallas_half = 0
        self.resilience = 0
        self.resilience_snapshot_every = 5
        self.resilience_dir = None

        if parameters:
            self.set_parameters(parameters)
        self.rmse_history = []
        self.components_mean = None

    # --------------------------------------------------------------- utils
    def get_rmse_history(self):
        return np.asarray(self.rmse_history)

    # feature-sequential tiers: the reference constant init is both
    # correct and load-bearing there (trailing-term estimates)
    _SEQUENTIAL_ENGINES = ('funk', 'funk_fused')

    def _init_factors(self, initialize_model, sequential=None):
        '''Factor init (``mfrec_tpu/models/gd.py:220-257``): the same
        numpy draws from ``self.rng``, so the same seed gives the JAX
        model's factors bit for bit.'''
        if not (initialize_model or self.P is None or self.Q is None):
            return
        k = self.dimensionality
        mode = getattr(self, 'init_mode', 'auto')
        if mode not in ('auto', 'constant', 'normal'):
            raise Error("init_mode must be 'auto', 'constant' or "
                        "'normal' (got %r)" % (mode,))
        if mode == 'auto':
            seq = (sequential if sequential is not None
                   else self.engine in self._SEQUENTIAL_ENGINES)
            mode = 'constant' if seq else 'normal'
        if mode == 'constant':
            self.P = np.full((self.nbr_users, k), self.feature_init,
                             np.float32)
            self.Q = np.full((self.nbr_items, k), self.feature_init,
                             np.float32)
        else:
            scale = abs(float(self.feature_init))
            if scale == 0.0:
                # an all-zero init is itself a fixed point of joint
                # training (zero factor gradients with fixed biases)
                raise Error(
                    "feature_init must be non-zero for init_mode="
                    "'normal' (an all-zero init freezes joint training; "
                    "set feature_init, e.g. 0.05)")
            self.P = self.rng.normal(0.0, scale, (self.nbr_users, k)) \
                .astype(np.float32)
            self.Q = self.rng.normal(0.0, scale, (self.nbr_items, k)) \
                .astype(np.float32)

    def _zero_biases(self):
        return (np.zeros(self.nbr_users, np.float32),
                np.zeros(self.nbr_items, np.float32))

    def _state(self, with_bias, mu=None):
        '''The factors and biases as f32 tensors on the model's device.'''
        zu, zi = self._zero_biases()
        bu = self.users_bias if (with_bias and self.users_bias is not None) \
            else zu
        bi = self.items_bias if (with_bias and self.items_bias is not None) \
            else zi

        def t(a):
            return torch.from_numpy(np.array(a, np.float32)).to(self.device)

        return sgd_mf.MFState(
            P=t(self.P), Q=t(self.Q), bu=t(bu), bi=t(bi),
            mu=torch.tensor(np.float32(
                mu if mu is not None else (self.overall_bias or 0.0))))

    def _alt_lrs(self):
        '''Learning rates for the alternating (row-mean step) engine.
        When the user has not set a rate (it is still the DefaultRate
        sentinel), use the row-mean default 0.15: one averaged step per
        row and batch barely moves at the per-sample default 0.001.  An
        explicit value always wins.'''
        def chosen(attr):
            return not isinstance(getattr(self, attr), DefaultRate)

        if chosen('learning_rate'):
            lr = float(self.learning_rate)
        else:
            lr = 0.15
            self.logger.info(
                'alternating engine: learning_rate not set; using the '
                'row-mean default 0.15 (assign learning_rate explicitly to '
                'override)')
        lr_bu = float(self.learning_rate_users) \
            if chosen('learning_rate_users') else lr
        lr_bi = float(self.learning_rate_items) \
            if chosen('learning_rate_items') else lr
        return lr, lr_bu, lr_bi

    # ------------------------------------------------- alternating engine
    def _run_alternating(self, bias_mode, verbose=False):
        '''Sorted-window alternating epochs
        (``ops.sgd_mf.make_alternating_epoch``) under the convergence
        driver, with ``lr_decay`` and ``lr_plateau_decay``.'''
        lr, lr_bu, lr_bi = self._alt_lrs()
        mw = min(128, max(self.nbr_users, self.nbr_items))
        decay = float(self.lr_decay)
        if not (0.0 < decay <= 1.0):
            raise Error('lr_decay must be in (0, 1] (got %r)'
                        % self.lr_decay)
        plateau = float(self.lr_plateau_decay)
        if not (0.0 < plateau <= 1.0):
            raise Error('lr_plateau_decay must be in (0, 1] (got %r)'
                        % self.lr_plateau_decay)
        p_layout, q_layout, W_user, W_item = self._alternating_layouts(mw)
        state = self._state(with_bias=(bias_mode != 'none'))
        pad = torch.nn.functional.pad
        # W spare rows past each side's end: a window never runs off it
        Paug, Qaug = sgd_mf.augment_factors(
            pad(state.P, (0, 0, 0, W_user)), pad(state.Q, (0, 0, 0, W_item)),
            pad(state.bu, (0, W_user)), pad(state.bi, (0, W_item)))
        mu = state.mu
        epoch = sgd_mf.make_alternating_epoch(
            W_user, W_item, lr, self.K, lr_bu=lr_bu, lr_bi=lr_bi,
            K_bu=self.K2, K_bi=self.K3, bias_mode=bias_mode,
            lo_r=self.min_rating, hi_r=self.max_rating,
            inner_steps=self.inner_steps,
            use_kernel=self.device.type == 'cuda')
        driver = ConvergenceDriver(self.min_epochs, self.max_epochs,
                                   self.min_improvement,
                                   plateau_decay=plateau)

        def one_epoch(pq):
            Pa, Qa = pq
            s = driver.lr_scale
            if decay == 1.0 and s == 1.0:
                Pa, Qa, rmse = epoch(Pa, Qa, mu, p_layout, q_layout)
            else:
                e = len(driver.history)
                Pa, Qa, rmse = epoch(Pa, Qa, mu, p_layout, q_layout,
                                     np.float32(s * decay ** e))
            return (Pa, Qa), rmse

        Paug, Qaug = driver.run(one_epoch, (Paug, Qaug))
        if plateau < 1.0 and driver.lr_scale < 1.0:
            self.logger.info('plateau decay engaged: final lr scale %g',
                             driver.lr_scale)
        self.rmse_history = driver.history
        P, Q, bu, bi = sgd_mf.split_factors(Paug, Qaug)

        def host(t, n):
            return np.array(t[:n].cpu().numpy())

        self.P = host(P, self.nbr_users)
        self.Q = host(Q, self.nbr_items)
        if bias_mode == 'learned':
            self.users_bias = host(bu, self.nbr_users)
            self.items_bias = host(bi, self.nbr_items)
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)

    # ------------------------------------------------------------ training
    def feature_training(self, initialize_model=True, handle_bias=False,
                         verbose=False):
        '''Main SGD training (reference gradient_descent.py:506-542).
        handle_bias=False -> baseline 1.0; handle_bias=True -> fixed
        BellKor biases computed first, then held.'''
        self._init_factors(initialize_model)
        if handle_bias:
            self.compute_overall_avg()
            self.compute_items_bias_bk()
            self.compute_users_bias_bk()
            mode = 'fixed'
        else:
            mode = 'none'
        self._dispatch_engine(mode, verbose)

    def _dispatch_engine(self, mode, verbose):
        '''``engine='auto'`` and ``'alternating'`` run the sorted-window
        engine; every other engine, and ``resilience > 0``, raises.'''
        engine = self.engine
        if engine == 'auto':
            engine = 'alternating'
        if int(self.resilience) > 0:
            raise Error(
                'resilience > 0 is not ported yet (ResilientDriver needs '
                'its snapshots ported: ROADMAP queue 1 item 1); set '
                'resilience=0')
        if engine in _UNPORTED_ENGINES:
            raise NotImplementedError(
                'engine %r is not ported yet (ROADMAP %s); use '
                "engine='alternating'" % (engine, _UNPORTED_ENGINES[engine]))
        if engine != 'alternating':
            raise Error('unknown engine %r' % (engine,))
        self._run_alternating(mode, verbose=verbose)

    train = feature_training

    def feature_training_bias(self, initialize_model=True, handle_bias=False,
                              verbose=False):
        '''SGD with learned biases (reference gradient_descent.py:472-503)
        on the same engine: the BellKor biases are the starting point.'''
        self._init_factors(initialize_model)
        self.compute_overall_avg()
        self.compute_items_bias_bk()
        self.compute_users_bias_bk()
        self._dispatch_engine('learned', verbose)

    # ---------------------------------------------------------- predictors
    def predict_rating(self, item_index, user_index):
        '''dot + 1.0 baseline (reference gradient_descent.py:621-631).'''
        return float(self.Q[item_index] @ self.P[user_index] + 1.0)

    predict = predict_rating

    def predict_rating_with_bias(self, item_index, user_index):
        '''dot + mu + b_i + b_u (reference gradient_descent.py:637-648).'''
        return float(self.Q[item_index] @ self.P[user_index]
                     + self.overall_bias + self.items_bias[item_index]
                     + self.users_bias[user_index])

    def predict_rating_by_label(self, user_label, item_label):
        try:
            item_index = self.items.index[item_label]
            user_index = self.users.index[user_label]
            return self.predict_rating(item_index, user_index)
        except KeyError:
            return self.baseline_predictor(user_label, item_label)

    def predict_batch(self, item_indices, user_indices,
                      predictor='predict_rating'):
        '''Vectorized pairwise prediction.'''
        dots = (self.Q[np.asarray(item_indices)]
                * self.P[np.asarray(user_indices)]).sum(-1)
        if predictor in ('predict_rating', 'predict'):
            return dots + 1.0
        if predictor == 'predict_rating_with_bias':
            return (dots + self.overall_bias
                    + self.items_bias[np.asarray(item_indices)]
                    + self.users_bias[np.asarray(user_indices)])
        raise KeyError(predictor)

    # ------------------------------------------------------ GD similarity
    def compute_components_mean(self):
        self.components_mean = np.asarray(self.Q).mean(axis=0)

    def similar_items(self, item_index, nbr_recommendations=2,
                      similarity_threshold=False, similarities_output=False,
                      method='pearson'):
        '''GD override: similarity over factor components 1..dim (component
        0 excluded) with pearson default (reference
        gradient_descent.py:827-875).'''
        F = np.asarray(self.Q, np.float32)[:, 1:self.dimensionality]
        if method == 'norm_cosine':
            self.compute_components_mean()
            F = F - self.components_mean[None, 1:self.dimensionality]
            method = 'cosine_log'
        return self._similar_topk(F, int(item_index), nbr_recommendations,
                                  similarity_threshold, similarities_output,
                                  method)
