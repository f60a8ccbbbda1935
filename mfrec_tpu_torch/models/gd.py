'''
GDRecommender — Funk/BellKor SGD matrix factorization, serving side.

Port of ``mfrec_tpu/models/gd.py``: the constructor with the reference
parameter names and defaults (``PARAMETERS_INDEX``), the predictors and
``predict_batch``.  Training is not ported yet: ``train()`` raises.  A
trained model comes in through ``load_state`` (the JAX package's
checkpoint format) or ``mfrec_tpu_torch.interop``.
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu_torch.models.base import DefaultRate
from mfrec_tpu_torch.models.mf import MFRecommender


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
        # DefaultRate sentinels, numerically 0.001
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

        # training-engine settings, kept with the JAX package's defaults
        # so parameter dicts carry over unchanged
        self.engine = 'auto'
        self.batch_size = 16384
        self.inner_steps = 128
        self.inner_steps_implicit = 32
        self.lr_decay = 1.0
        self.lr_plateau_decay = 1.0
        self.init_mode = 'auto'
        self.n_slices = 1
        self.sharded_pallas_half = 0
        self.resilience = 0
        self.resilience_snapshot_every = 5
        self.resilience_dir = None

        if parameters:
            self.set_parameters(parameters)
        self.components_mean = None

    def train(self, *args, **kwargs):
        raise NotImplementedError(
            'GDRecommender training is not ported to PyTorch yet (ROADMAP '
            'queue 1, items 1-4: the training slice with the K1 batch-step '
            'kernel); train with mfrec_tpu and load the state with '
            'mfrec_tpu_torch.interop.load_jax_state')

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
