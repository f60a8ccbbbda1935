'''
WRMFRecommender -- implicit-feedback weighted ALS.

Port of ``mfrec_tpu/models/wrmf.py``: the constructor with the reference
parameter names and defaults (``PARAMETERS_INDEX``), the predictors and
``train()`` for both solvers on the model's device through
``ops.als.als_wrmf_train``.  With ``solver='cg'`` each nnz bucket of a
CUDA model runs in one launch of the hand-written fused K2 kernel
(``csrc/cg_bucket.cu``: gather, Gram, PCG and write-back), a CPU model's
in the plain loop (the JAX model's XLA loop on the CPU).  The
factors come back as numpy, so retrieval (K3 on a GPU) and serving work
on a model the port trained.

``engine='auto'`` means ``'als'``: a port model lives on one explicit
device, where the JAX model picks ``'als_sharded'`` when
``len(jax.devices()) > 1``.  ``'als_sharded'`` is not ported yet and
raises.

Hu, Koren, Volinsky: Collaborative Filtering for Implicit Feedback
Datasets, ICDM 2008.
'''
from __future__ import annotations

import numpy as np
import torch

from mfrec_tpu_torch.models.base import Error
from mfrec_tpu_torch.models.mf import MFRecommender
from mfrec_tpu_torch.ops import als as als_ops
from mfrec_tpu_torch.utils import profiling


class WRMFRecommender(MFRecommender):
    '''Weighted Regularized Matrix Factorization Recommendation Engine.'''

    PARAMETERS_INDEX = {'nbr_epochs': 'nbr_epochs',
                        'feature_init': 'feature_init',
                        'regularization_model': 'K',
                        'neighborhood': 'neighborhood',
                        'nbr_features': 'dimensionality',
                        'c_pos': 'c_pos',
                        'alpha': 'alpha',
                        'gram_dtype': 'gram_dtype',
                        'solver': 'solver',
                        'cg_steps': 'cg_steps',
                        'cg_warm_steps': 'cg_warm_steps',
                        'cg_warmup_epochs': 'cg_warmup_epochs',
                        'pcg_impl': 'pcg_impl',
                        'engine': 'engine',
                        'init_mode': 'init_mode'}

    _default_predictor_mode = 'dot'

    def __init__(self, nbr_users=4, nbr_items=6, parameters=None,
                 device='cuda'):
        MFRecommender.__init__(self, nbr_users, nbr_items, None,
                               device=device)

        # Reference defaults (wrmf.py:39-43)
        self.nbr_epochs = 20
        self.feature_init = 0.1
        self.K = 0.025
        self.dimensionality = 20
        self.neighborhood = 500
        # Confidence weighting: c_pos keeps the reference default and
        # alpha > 0 switches to rating-scaled confidence c_ui = 1 + alpha*r;
        # self.K is honored (the reference hardcodes 0.015 at its call
        # site, wrmf.py:110).
        self.c_pos = 1.0
        self.alpha = 0.0
        # 'bfloat16': the exact solver's rank-L Gram corrections take bf16
        # inputs with f32 sums (the solves stay f32); None keeps all f32.
        self.gram_dtype = None
        # solver='cg': warm-started PCG half-sweeps (bf16 gather, the fused
        # K2 on a GPU); 'exact': batched Cholesky (oracle parity).
        self.solver = 'exact'
        self.cg_steps = 6
        # After cg_warmup_epochs, cg_warm_steps PCG iterations per solve
        # (None = no drop).
        self.cg_warm_steps = None
        self.cg_warmup_epochs = 2
        # pcg_impl: 'auto' runs the fused K2 on a CUDA model and the plain
        # loop on a CPU model; on a CUDA model every value runs the fused
        # K2, on a CPU model 'pallas' runs K2's plain version and 'xla' the
        # plain loop.
        self.pcg_impl = 'auto'
        # engine: 'auto' and 'als' run the single-device bucket sweeps;
        # 'als_sharded' is not ported yet.
        self.engine = 'auto'
        # init_mode='normal' (default): N(0, feature_init) factor init.
        # 'constant' keeps the reference's constant fill (wrmf.py:92-93),
        # under which every column stays identical (a rank-1 model).
        self.init_mode = 'normal'

        if parameters:
            self.set_parameters(parameters)

    def predict(self, item_index, user_index):
        '''Plain dot product (reference wrmf.py:67-69).'''
        return float(self.Q[item_index] @ self.P[user_index])

    def predict_batch(self, item_indices, user_indices, predictor='predict'):
        return (self.Q[np.asarray(item_indices)]
                * self.P[np.asarray(user_indices)]).sum(-1)

    def predict_rating_by_label(self, user_label, item_label):
        try:
            return self.predict(self.items.index[item_label],
                                self.users.index[user_label])
        except KeyError:
            return 0.0

    def train(self, initialize_model=True, handle_bias=False, verbose=False):
        '''ALS training (reference wrmf.py:83-110): binarized implicit
        preferences, alternating batched normal-equation solves.  Recorded
        by ``utils.profiling`` as the span tree ``wrmf.train``.

        Both sides' buckets live on the model's device between calls on
        an unchanged store (``_als_buckets``): a call that finds them
        counts ``als.layouts_reused`` and uploads only P and Q; a write,
        a consolidation or ``load_state`` makes the next call build and
        upload them again.  Never-rated rows come back exactly zero,
        zeroed on the device by ``ops.als.als_wrmf_train``.'''
        with profiling.span('wrmf.train'):
            self._train(initialize_model, verbose)

    def _als_buckets(self):
        '''Both sides' ``padded_rows`` on the model's device, kept on an
        unchanged ratings store (``_store_cached``); a call that finds
        them counts ``als.layouts_reused``.'''
        def build():
            return tuple(als_ops.device_buckets(
                self.ratings.padded_rows(axis=axis), self.device)
                for axis in ('user', 'item'))
        out, reused = self._store_cached('_als_device_cache', build,
                                         self.device)
        if reused:
            profiling.count('als.layouts_reused', 1)
        return out

    def _train(self, initialize_model, verbose):
        with profiling.span('wrmf.init'):
            if initialize_model or self.P is None:
                # P, then Q: the same seed gives the JAX model's factors
                k = self.dimensionality
                if self.init_mode == 'normal':
                    self.P = self.rng.normal(
                        0.0, self.feature_init,
                        (self.nbr_users, k)).astype(np.float32)
                    self.Q = self.rng.normal(
                        0.0, self.feature_init,
                        (self.nbr_items, k)).astype(np.float32)
                else:        # 'constant': reference-faithful (see __init__)
                    self.P = np.full((self.nbr_users, k), self.feature_init,
                                     np.float32)
                    self.Q = np.full((self.nbr_items, k), self.feature_init,
                                     np.float32)

        # WRMF reads no SVD++ feedback arrays (``initialize_rated_feedback``)
        with profiling.span('wrmf.feedback'):
            self.compute_overall_avg()

        engine = 'als' if self.engine == 'auto' else self.engine
        if engine == 'als_sharded':
            raise NotImplementedError(
                "engine 'als_sharded' is not ported yet (ROADMAP queue 1 "
                "item 9: multi-device engines); use engine='als'")
        if engine != 'als':
            raise Error('unknown engine %r' % (self.engine,))

        with profiling.span('wrmf.buckets'):
            user_buckets, item_buckets = self._als_buckets()

        def host(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32))

        # als_wrmf_train uploads P and Q; the buckets are on the device
        P, Q = als_ops.als_wrmf_train(
            host(self.P), host(self.Q), user_buckets, item_buckets,
            nbr_epochs=int(self.nbr_epochs),
            c_pos=float(self.c_pos), alpha=float(self.alpha),
            reg=float(self.K),
            gram_dtype=torch.bfloat16 if self.gram_dtype == 'bfloat16'
            else None,
            solver=self.solver, cg_steps=int(self.cg_steps),
            cg_warm_steps=(None if self.cg_warm_steps is None
                           else int(self.cg_warm_steps)),
            cg_warmup_epochs=int(self.cg_warmup_epochs),
            pcg_impl=self.pcg_impl,
            callback=(lambda e, P, Q: self.logger.info('Epoch : %d', e))
            if verbose else None, device=self.device)
        with profiling.span('wrmf.writeback'):
            self.P = P.cpu().numpy()
            self.Q = Q.cpu().numpy()
