'''
KMFRecommender — kernel matrix factorization (logistic / linear kernels).

Port of ``mfrec_tpu/models/kmf.py`` (Rendle & Schmidt-Thieme:
Online-Updating Regularized Kernel Matrix Factorization Models for
Large-Scale Recommender Systems, RecSys 2008), with the JAX class's
``PARAMETERS_INDEX``, defaults and public methods.  Engines, on the
model's device:

* ``engine='auto'`` / ``'alternating'``: the sorted-window alternating
  epochs with the link inside the batch step
  (``ops.sgd_mf.make_alternating_epoch(link=...)``), on a CUDA model
  through K1's logistic or identity build with an f32 fixed side, on a
  CPU model through the XLA branch's math in plain torch;
* ``engine='fused'``: the mini-batch epoch (``ops.kmf.make_kmf_fused_epoch``),
  plain torch with fixed-order scatter-adds;
* ``engine='serial'``: the reference's rating-by-rating epoch
  (``ops.kmf_serial_kernel.kmf_serial_converge``: on a CUDA model the
  hand-written S2 kernel, ``csrc/kmf_serial.cu``, one launch for a call's
  epochs and the convergence rule).  Every fold-in (``retrain_user``,
  ``retrain_item``, ``add_user``, ``add_item``) runs it too.

One deliberate difference from the JAX package: there,
``engine='serial'`` skips the refusal of ``lr_decay`` /
``lr_plateau_decay`` != 1 that ``'fused'`` applies (ROADMAP queue 3,
R5); here ``train(engine='serial')`` refuses them as ``'fused'`` does.
The fold-ins keep working on such a model.
'''
from __future__ import annotations

import math

import numpy as np
import torch

from mfrec_tpu_torch.engine.trainer import ConvergenceDriver
from mfrec_tpu_torch.models.base import DefaultRate, Error
from mfrec_tpu_torch.models.mf import MFRecommender, _host
from mfrec_tpu_torch.ops import kmf as kmf_ops
from mfrec_tpu_torch.ops import kmf_serial_kernel, sgd_mf
from mfrec_tpu_torch.ops.serial_kernel import converge_continues


class KMFRecommender(MFRecommender):
    '''Kernel Matrix Factorization Recommendation Engine.'''

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
                        'inner_steps': 'inner_steps',
                        'lr_decay': 'lr_decay',
                        'lr_plateau_decay': 'lr_plateau_decay'}

    _default_predictor_mode = 'logistic'
    _ROW_MEAN_NOTE = ('alternating engine: learning_rate not set; using the '
                      'row-mean default 0.15 (assign learning_rate to '
                      'override)')

    KERNELS = ('train_logistic_kernel', 'train_linear_kernel')

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 filename=False, device='cuda'):
        MFRecommender.__init__(self, nbr_users, nbr_items, None,
                               device=device)
        # the JAX package's defaults (mfrec_tpu/models/kmf.py:53-92):
        # min_improvement None runs exactly nbr_epochs epochs, a float
        # stops early on ConvergenceDriver's rule
        self.nbr_epochs = 200
        self.min_improvement = None
        self.feature_init = 0.1
        self.learning_rate = DefaultRate(0.01)
        self.learning_rate_users = DefaultRate(0.01)
        self.learning_rate_items = DefaultRate(0.01)
        self.K_users = 0.1
        self.K_items = 0.1
        self.K_bias = 0.007
        self.dimensionality = 40
        self.engine = 'auto'
        self.batch_size = 16384
        self.inner_steps = 64
        self.lr_decay = 1.0
        self.lr_plateau_decay = 1.0
        self.rmse_history = []
        if parameters:
            self.set_parameters(parameters)

    # ---------------------------------------------------------- predictors
    def predict_logistic(self, item_index, user_index):
        '''min + sigmoid(dot + biases) * range (reference kmf.py:79-85).'''
        s = float(self.Q[item_index] @ self.P[user_index]
                  + self.items_bias[item_index]
                  + self.users_bias[user_index])
        return self.min_rating + (1.0 / (1.0 + np.exp(-s))) \
            * (self.max_rating - self.min_rating)

    def predict_linear(self, item_index, user_index):
        return float(self.Q[item_index] @ self.P[user_index]
                     + self.items_bias[item_index]
                     + self.users_bias[user_index])

    def predict_linear_neg(self, item_index, user_index):
        s = self.predict_linear(item_index, user_index)
        return self.min_rating + s * (self.max_rating - self.min_rating)

    predict = predict_logistic

    def predict_batch(self, item_indices, user_indices,
                      predictor='predict_logistic'):
        '''Vectorized pairwise prediction.'''
        dots = ((self.Q[np.asarray(item_indices)]
                 * self.P[np.asarray(user_indices)]).sum(-1)
                + self.items_bias[np.asarray(item_indices)]
                + self.users_bias[np.asarray(user_indices)])
        if predictor in ('predict_logistic', 'predict'):
            return self.min_rating + (1.0 / (1.0 + np.exp(-dots))) \
                * (self.max_rating - self.min_rating)
        if predictor == 'predict_linear':
            return dots
        if predictor == 'predict_linear_neg':
            return self.min_rating + dots * (self.max_rating - self.min_rating)
        raise KeyError(predictor)

    def predict_rating_by_label(self, user_label, item_label,
                                predictor='predict_logistic'):
        try:
            item_index = self.items.index[item_label]
            user_index = self.users.index[user_label]
            return float(getattr(self, predictor)(item_index, user_index))
        except KeyError:
            return self.overall_bias if self.overall_bias else 0.0

    # ------------------------------------------------------------ training
    @staticmethod
    def _kernel_name(kernel):
        if kernel not in ('train_logistic_kernel', 'train_linear_kernel',
                          'logistic', 'linear'):
            raise Error('Unknown kernel: %r' % (kernel,))
        return 'logistic' if 'logistic' in kernel else 'linear'

    def train(self, initialize_model=True, verbose=False,
              kernel='train_logistic_kernel'):
        '''SGD training through the chosen link kernel
        (reference kmf.py:197-220).'''
        link = self._kernel_name(kernel)
        if initialize_model or self.P is None:
            self.init_feature_normal(0.0, 0.1)
        self.compute_overall_avg()
        self.items_bias = np.zeros(self.nbr_items, np.float32)
        self.users_bias = np.zeros(self.nbr_users, np.float32)

        engine = self.engine
        if engine == 'auto':
            engine = 'alternating'
        if engine == 'serial':
            self._kmf_driver(allow_schedules=False)     # no R5
            self._train_serial(link, verbose, True, True, None)
            return
        if engine == 'alternating':
            self._train_alternating(link, verbose)
            return
        if engine != 'fused':
            raise Error('unknown engine %r' % (self.engine,))

        uidx, iidx, vals = self.ratings.shuffled(int(self.rng.integers(2**31)))
        ub, ib, rb, mb = sgd_mf.batch_ratings(uidx, iidx, vals,
                                              self.batch_size)
        plan = sgd_mf.fused_plan(ub, ib, self.device)
        epoch_fn = kmf_ops.make_kmf_fused_epoch(
            kernel=link, lr=float(self.learning_rate), K_users=self.K_users,
            K_items=self.K_items, K_bias=self.K_bias, lo=self.min_rating,
            hi=self.max_rating)
        ub, ib, rb, mb = (self._to_device(a, None) for a in (ub, ib, rb, mb))
        driver, _ = self._kmf_driver(allow_schedules=False)

        def one_epoch(st):
            *st, rmse = epoch_fn(*st, ub, ib, rb, mb, plan=plan)
            if verbose:
                self.logger.info('EPOCHS: %d RMSE: %s',
                                 len(driver.history) + 1, float(rmse))
            return tuple(st), rmse

        st = driver.run(one_epoch, tuple(self._to_device(a) for a in (
            self.P, self.Q, self.users_bias, self.items_bias)))
        self.rmse_history = driver.history
        self.P, self.Q = _host(st[0], self.nbr_users), _host(st[1],
                                                             self.nbr_items)
        self.users_bias = _host(st[2], self.nbr_users)
        self.items_bias = _host(st[3], self.nbr_items)

    def _kmf_driver(self, allow_schedules):
        '''The convergence driver of the KMF engines
        (``mfrec_tpu/models/kmf.py:200-232``): min_improvement None runs
        exactly nbr_epochs epochs, a float stops early on the improvement
        rule; a non-finite RMSE raises.  The schedules are wired on the
        alternating tier only; the other engines refuse them.'''
        decay, plateau = self._lr_schedule()
        if not allow_schedules and (decay != 1.0 or plateau != 1.0):
            raise Error("lr_decay/lr_plateau_decay are only wired on "
                        "engine='alternating' (got engine=%r)"
                        % (self.engine,))
        if plateau < 1.0 and self.min_improvement is None:
            raise Error('lr_plateau_decay needs min_improvement set — '
                        'the stall trigger IS the improvement rule')
        ne = int(self.nbr_epochs)
        if self.min_improvement is None:
            driver = ConvergenceDriver(ne, ne, 0.0, plateau_decay=plateau)
        else:
            driver = ConvergenceDriver(1, ne, float(self.min_improvement),
                                       plateau_decay=plateau)
        return driver, decay

    def _alt_lr(self):
        '''Row-mean learning rate for the alternating tier, also its bias
        rate (``_alt_lrs``' first).'''
        return self._alt_lrs()[0]

    def _train_alternating(self, link, verbose):
        '''Kernel MF on the sorted-window alternating tier
        (``mfrec_tpu/models/kmf.py:248-312``): the link inside the batch
        step, learned biases on the augmented columns, no global mean, no
        clamp, per-side factor regularization, the bias rates = lr, the
        fixed side in f32.'''
        lr = self._alt_lr()
        p_layout, q_layout, W_user, W_item = \
            self._alternating_layouts(self._sgd_window())
        Paug, Qaug = self._augmented(*(self._to_device(a) for a in (
            self.P, self.Q, self.users_bias, self.items_bias)),
            W_user, W_item)
        epoch = sgd_mf.make_alternating_epoch(
            W_user, W_item, lr, self.K_users,
            lr_bu=lr, lr_bi=lr, K_bu=self.K_bias, K_bi=self.K_bias,
            bias_mode='learned', clamp_pred=False,
            lo_r=self.min_rating, hi_r=self.max_rating,
            inner_steps=self.inner_steps,
            link='logistic' if link == 'logistic' else 'identity',
            K_u=self.K_users, K_i=self.K_items, use_kernel=self._on_card)
        driver, decay = self._kmf_driver(allow_schedules=True)
        mu = torch.zeros((), dtype=torch.float32)   # no global-mean term
        Paug, Qaug = self._alternating_epochs(
            driver, epoch, (Paug, Qaug), (mu, p_layout, q_layout), decay,
            log_epoch=(lambda n, rmse: self.logger.info(
                'EPOCHS: %d RMSE: %s', n, float(rmse))) if verbose else None)
        self._from_augmented(Paug, Qaug, biases=True)

    def _train_serial(self, link, verbose, update_users, update_items,
                      ratings):
        '''The order-faithful serial epochs (``mfrec_tpu/models/kmf.py:
        314-354``) under the convergence rule, with no schedule refusal
        (the fold-ins run on a model whose training uses lr_decay): on a
        CUDA model one S2 launch for all of them, by the stream's plan
        (built once a call), then one read of their rmse.  Only the rows
        the stream rates go to the device and back: no rating touches the
        others.'''
        if ratings is None:
            uidx, iidx, vals = self.ratings.shuffled(
                int(self.rng.integers(2**31)))
        else:
            uidx, iidx, vals = ratings
        ne = int(self.nbr_epochs)
        rule = (ne, ne, 0.0) if self.min_improvement is None \
            else (1, ne, float(self.min_improvement))
        if len(vals) == 0:
            # the JAX epoch of no rating has rmse sqrt(0 / 0)
            history = [float('nan')] if converge_continues(
                0, 2.0, 2.0, *rule) else []
            self._raise_if_diverged(history)
            self.rmse_history = history
            return
        users, uidx = np.unique(np.asarray(uidx), return_inverse=True)
        items, iidx = np.unique(np.asarray(iidx), return_inverse=True)
        P, Q, bu, bi = (self._to_device(np.asarray(a)[ids])
                        for a, ids in ((self.P, users), (self.Q, items),
                                       (self.users_bias, users),
                                       (self.items_bias, items)))
        plan = kmf_serial_kernel.kmf_plan(uidx, iidx, vals, self.device) \
            if self._on_card else None
        history = kmf_serial_kernel.kmf_serial_converge(
            P, Q, bu, bi, self._to_device(uidx, np.int32),
            self._to_device(iidx, np.int32), self._to_device(vals),
            float(self.learning_rate), self.K_users, self.K_items,
            self.K_bias, kernel=link, lo=self.min_rating, hi=self.max_rating,
            update_users=update_users, update_items=update_items,
            min_epochs=rule[0], max_epochs=rule[1],
            min_improvement=rule[2], plan=plan)[4]
        if verbose:
            for e, r in enumerate(history):
                self.logger.info('EPOCHS: %d RMSE: %s', e + 1, r)
        self._raise_if_diverged(history)
        self.rmse_history = history
        sides = ((('P', users, P), ('users_bias', users, bu))
                 if update_users else ()) + \
            ((('Q', items, Q), ('items_bias', items, bi))
             if update_items else ())
        for name, ids, t in sides:       # a masked side is unchanged
            full = np.array(getattr(self, name), np.float32)
            full[ids] = t.cpu().numpy()
            setattr(self, name, full)

    @staticmethod
    def _raise_if_diverged(history):
        '''ConvergenceDriver's guard: a non-finite last rmse raises its
        ``FloatingPointError``, before the model takes the new state.'''
        if history and not math.isfinite(history[-1]):
            raise FloatingPointError(
                'training diverged: rmse=%r at epoch %d (reduce the '
                'learning rate or batch size)'
                % (history[-1], len(history) - 1))

    # --------------------------------------------------------------- fold-in
    def _retrain(self, axis, index, ratings_index, ratings, verbose, kernel):
        link = self._kernel_name(kernel)
        ratings_index = np.asarray(ratings_index)
        valid = np.where(ratings_index[:, axis] == index)[0]
        if axis == 0:
            self.init_user_features(index)
        else:
            self.init_item_features(index)
        chunk = (ratings_index[valid, 0].astype(np.int32),
                 ratings_index[valid, 1].astype(np.int32),
                 np.asarray(ratings, np.float32)[valid])
        self._train_serial(link, verbose, axis == 0, axis == 1, chunk)

    def retrain_user(self, user_index, ratings_index, ratings, verbose=False,
                     kernel='train_logistic_kernel'):
        '''Fold-in retrain of one user's vector (reference kmf.py:120-132):
        its row redrawn, then the serial epochs over its ratings with the
        items fixed.'''
        self._retrain(0, user_index, ratings_index, ratings, verbose, kernel)

    def retrain_item(self, item_index, ratings_index, ratings, verbose=False,
                     kernel='train_logistic_kernel'):
        self._retrain(1, item_index, ratings_index, ratings, verbose, kernel)

    def add_user(self, user_label, users_ratings_index, users_ratings):
        '''Add + fold-in a new user (reference kmf.py:149-171).'''
        users_ratings_index = np.asarray(users_ratings_index)
        users_ratings = np.asarray(users_ratings, np.float32)
        if users_ratings_index.shape[0] != users_ratings.shape[0]:
            raise Error('The index and the ratings array must be the same size')
        new_id = self.users.add(user_label)
        self.ratings.grow(nbr_users=new_id + 1)
        self.P = np.resize(self.P, (new_id + 1, self.dimensionality))
        self.users_bias = np.resize(self.users_bias, new_id + 1)
        self.users_bias[new_id] = 0.0
        ratings_index = np.zeros((users_ratings.shape[0], 2), np.int32)
        ratings_index[:, 0] = new_id
        ratings_index[:, 1] = users_ratings_index
        self.retrain_user(new_id, ratings_index, users_ratings)
        return new_id

    def add_item(self, item_label, items_ratings_index, items_ratings):
        items_ratings_index = np.asarray(items_ratings_index)
        items_ratings = np.asarray(items_ratings, np.float32)
        if items_ratings_index.shape[0] != items_ratings.shape[0]:
            raise Error('The index and the ratings array must be the same size')
        new_id = self.items.add(item_label)
        self.ratings.grow(nbr_items=new_id + 1)
        self.Q = np.resize(self.Q, (new_id + 1, self.dimensionality))
        self.items_bias = np.resize(self.items_bias, new_id + 1)
        self.items_bias[new_id] = 0.0
        ratings_index = np.zeros((items_ratings.shape[0], 2), np.int32)
        ratings_index[:, 1] = new_id
        ratings_index[:, 0] = items_ratings_index
        self.retrain_item(new_id, ratings_index, items_ratings)
        return new_id
