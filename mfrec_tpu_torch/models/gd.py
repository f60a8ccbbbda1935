'''
GDRecommender — Funk/BellKor SGD matrix factorization.

Port of ``mfrec_tpu/models/gd.py``: the constructor with the reference
parameter names and defaults (``PARAMETERS_INDEX``), the single-device
training engines, the SVD++ tier, fold-in, the predictors,
``predict_batch`` and the GD similarity overrides.

Engines, on the model's device:

* ``engine='auto'`` / ``'alternating'``: the sorted-window alternating
  epochs (``ops.sgd_mf.make_alternating_epoch``), on a CUDA model through
  the hand-written K1 kernel (``csrc/half_pass.cu``), on a CPU model
  through the XLA branch's math in plain torch -- the counterpart of the
  JAX model's ``use_pallas_full = backend != 'cpu'``;
* ``engine='fused'``: all-features mini-batch SGD
  (``ops.sgd_mf.make_fused_epoch``), plain torch ops with fixed-order
  scatter-adds, so a CUDA run repeats bit for bit;
* ``engine='funk'``: the reference's feature-by-feature loop, exact
  (``ops.serial_kernel.serial_converge``: on a CUDA model the
  hand-written S1 kernel, ``csrc/serial_funk.cu``, one launch a
  feature); fold-in (``add_user``,
  ``retrain_user``...) and ``feature_training2`` / ``_dev`` /
  ``_online_prototype`` run it too;
* ``engine='funk_fused'``: the same schedule over mini-batches
  (``make_funk_fused_feature_epoch`` / ``_learned_epoch``).

``feature_training_implicit`` (SVD++) runs
``ops.sgd_mf.make_alternating_implicit_epoch``, its aggregation phases
through K4 (``csrc/window_agg.cu``) on a CUDA model, which gathers each
rating's row inside the kernel, so the epoch holds nothing of one row a
rating (the Netflix Prize shape at 100 factors fits one H100).  The
factors stay on the device across epochs (one host sync per epoch, the
RMSE the convergence rule reads) and come back as numpy at the end.

The fixed BellKor biases (``train(handle_bias=True)``,
``feature_training_bias``, ``feature_training_implicit``) are refit from
the ratings on every call: on a CUDA model on the alternating engine on
the card, by the hand-written B1 (``csrc/bias_refit.cu``) over the
layouts' segment tables, which the call fetches first; else with numpy
on the host (``MFRecommender.compute_items_bias_bk``).

``engine='auto'`` means ``'alternating'``: a port model lives on one
explicit device, where the JAX model picks ``alternating_sharded`` when
``len(jax.devices()) > 1``.  The multi-device engines (``'dsgd'``,
``'alternating_sharded'``, ``'alternating_ring'``) and ``resilience > 0``
are not ported yet and raise.
'''
from __future__ import annotations

import numpy as np
import torch

from mfrec_tpu_torch.engine.trainer import ConvergenceDriver
from mfrec_tpu_torch.models.base import DefaultRate, Error
from mfrec_tpu_torch.models.mf import MFRecommender, _host, _pad_rows
from mfrec_tpu_torch.ops import serial_kernel, sgd_mf
from mfrec_tpu_torch.ops import similarity as sim_ops
from mfrec_tpu_torch.utils import profiling

# engines of the JAX model that the port does not have yet -> ROADMAP item
_UNPORTED_ENGINES = {
    'dsgd': 'queue 1 item 9 (multi-device engines: ring DSGD over a '
            'device mesh)',
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
    # the single-device engines and the methods that run them
    _RUNS = {'alternating': '_run_alternating', 'fused': '_run_fused',
             'funk': '_run_funk', 'funk_fused': '_run_funk_fused'}

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

    def set_ratings_iterator(self, iterator):
        '''Ingest from an external iterator (e.g. a DB cursor) of
        (user_index, item_index, value) rows, drained into the ratings
        store (``mfrec_tpu/models/gd.py:199-205``).'''
        for row in iterator:
            self.ratings.set(int(row[0]), int(row[1]), float(row[2]))

    def feature_training_dev(self, initialize_model=True, probe=None,
                             verbose=False):
        '''Funk training returning the per-epoch rmse trace (reference
        gradient_descent.py:577-599).'''
        self._init_factors(initialize_model, sequential=True)
        self._run_funk('none', verbose=verbose)
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

    def _state(self, with_bias, mu=None, rows=None):
        '''The factors and biases as f32 tensors on the model's device;
        ``rows`` = (user ids, item ids): only those rows, in that order.'''
        zu, zi = self._zero_biases()
        bu = self.users_bias if (with_bias and self.users_bias is not None) \
            else zu
        bi = self.items_bias if (with_bias and self.items_bias is not None) \
            else zi
        users, items = rows if rows is not None else (slice(None),) * 2

        def t(a, ids):
            return self._to_device(np.asarray(a)[ids])

        return sgd_mf.MFState(
            P=t(self.P, users), Q=t(self.Q, items), bu=t(bu, users),
            bi=t(bi, items),
            mu=torch.tensor(np.float32(
                mu if mu is not None else (self.overall_bias or 0.0))))

    def _writeback(self, state, with_bias=False):
        '''The state's P, Q (and biases) back as numpy.'''
        self.P = _host(state.P, self.nbr_users)
        self.Q = _host(state.Q, self.nbr_items)
        if with_bias:
            self.users_bias = _host(state.bu, self.nbr_users)
            self.items_bias = _host(state.bi, self.nbr_items)

    def _batched(self, uidx, iidx, vals, seed=None):
        '''``batch_ratings`` on the host, then the batches and their
        fixed-order scatter plans on the model's device.'''
        ub, ib, rb, mb = sgd_mf.batch_ratings(uidx, iidx, vals,
                                              self.batch_size, seed=seed)
        plan = sgd_mf.fused_plan(ub, ib, self.device)
        ub, ib, rb, mb = (torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in (ub, ib, rb, mb))
        return ub, ib, rb, mb, plan

    # ------------------------------------------------------- fused engine
    def _run_fused(self, bias_mode, verbose=False, ratings=None, seed=None):
        '''All-features mini-batch epochs (``ops.sgd_mf.make_fused_epoch``)
        under the convergence driver, at the per-sample reference rates
        (``mfrec_tpu/models/gd.py:288-312``).'''
        if ratings is None:
            uidx, iidx, vals = self.ratings.coo()
        else:
            uidx, iidx, vals = ratings
        ub, ib, rb, mb, plan = self._batched(
            uidx, iidx, vals,
            seed=seed if seed is not None else int(self.rng.integers(2**31)))
        epoch = sgd_mf.make_fused_epoch(
            self.batch_size, float(self.learning_rate), self.K,
            lr_bu=float(self.learning_rate_users),
            lr_bi=float(self.learning_rate_items), K_bu=self.K2,
            K_bi=self.K3, bias_mode=bias_mode, lo=self.min_rating,
            hi=self.max_rating)
        state = self._state(with_bias=(bias_mode != 'none'))
        driver = ConvergenceDriver(self.min_epochs, self.max_epochs,
                                   self.min_improvement)
        state = driver.run(lambda st: epoch(st, ub, ib, rb, mb, plan=plan),
                           state)
        self.rmse_history = driver.history
        if verbose:
            for e, r in enumerate(driver.history):
                self.logger.info('epoch %d rmse %.5f', e, r)
        self._writeback(state, with_bias=(bias_mode == 'learned'))

    # -------------------------------------------------- funk_fused engine
    def _converge_feature(self, epoch, f, verbose):
        '''The funk tiers' per-feature rule (``mfrec_tpu/models/gd.py:
        346-357``, ``serial_kernel.converge_continues``): ``epoch()`` runs
        one epoch of feature ``f`` and returns its rmse (a device scalar,
        read once an epoch), until the feature stops improving.'''
        rmse, ep = 2.0, 0
        rmse_last = rmse
        while serial_kernel.converge_continues(
                ep, rmse, rmse_last, self.min_epochs, self.max_epochs,
                self.min_improvement):
            rmse_last = rmse
            rmse = float(epoch())
            self.rmse_history.append(rmse)
            ep += 1
        if verbose:
            self.logger.info('feature %d epochs %d rmse %.5f', f, ep, rmse)

    def _trailing(self, f):
        '''The trailing-value term of feature f, (k - f - 1) * f_init^2,
        as the JAX model rounds it (in double, then to f32).'''
        return float(np.float32((self.dimensionality - f - 1)
                                * self.feature_init ** 2))

    def _run_funk_fused(self, bias_mode, verbose=False):
        '''The reference's feature-by-feature Funk schedule (rating cache,
        trailing term, per-feature convergence) over mini-batches
        (``mfrec_tpu/models/gd.py:315-366``).  bias_mode 'learned' uses
        the full-dot formulation with an off-feature dot cache.'''
        if bias_mode == 'learned':
            return self._run_funk_fused_learned(verbose)
        uidx, iidx, vals = self.ratings.shuffled(
            int(self.rng.integers(2**31)))
        ub, ib, rb, mb, plan = self._batched(uidx, iidx, vals)
        ubh, ibh = ub.cpu().numpy(), ib.cpu().numpy()
        if bias_mode == 'fixed':
            base = (self.overall_bias + self.items_bias[ibh]
                    + self.users_bias[ubh]).astype(np.float32)
        else:
            base = np.ones(ubh.shape, np.float32)
        cb = torch.from_numpy(base).to(self.device)
        st = self._state(with_bias=False)
        P, Q = st.P, st.Q
        k = self.dimensionality
        epoch = sgd_mf.make_funk_fused_feature_epoch(
            float(self.learning_rate), self.K, bias_mode=bias_mode,
            lo=self.min_rating, hi=self.max_rating)
        self.rmse_history = []
        for f in range(k):
            pf, qf = P[:, f:f + 1].clone(), Q[:, f:f + 1].clone()
            trailing = self._trailing(f)
            self._converge_feature(lambda: epoch(
                pf, qf, trailing, ub, ib, rb, mb, cb, plan=plan)[2], f,
                verbose)
            P[:, f:f + 1] = pf
            Q[:, f:f + 1] = qf
            cb = sgd_mf.funk_fused_update_cache(pf, qf, ub, ib, cb,
                                                lo=self.min_rating,
                                                hi=self.max_rating)
        self.P, self.Q = _host(P, self.nbr_users), _host(Q, self.nbr_items)

    def _run_funk_fused_learned(self, verbose=False):
        '''Feature-by-feature learned-bias training over mini-batches
        (``mfrec_tpu/models/gd.py:368-414``): the off-feature dot rides
        a stream-aligned cache, refreshed after each feature.'''
        uidx, iidx, vals = self.ratings.shuffled(
            int(self.rng.integers(2 ** 31)))
        ub, ib, rb, mb, plan = self._batched(uidx, iidx, vals)
        st = self._state(with_bias=True)
        P, Q, bu, bi = st.P, st.Q, st.bu, st.bi
        mu = float(np.float32(self.overall_bias or 0.0))
        k = self.dimensionality
        epoch = sgd_mf.make_funk_fused_learned_epoch(
            float(self.learning_rate), float(self.learning_rate_users),
            float(self.learning_rate_items), self.K, self.K2, self.K3,
            lo=self.min_rating, hi=self.max_rating)
        ul, il = ub.long(), ib.long()
        full_dot = (P[ul] * Q[il]).sum(-1)           # [nb, B] stream cache
        self.rmse_history = []
        for f in range(k):
            pf, qf = P[:, f:f + 1].clone(), Q[:, f:f + 1].clone()
            off = full_dot - pf[ul, 0] * qf[il, 0]
            trailing = self._trailing(f)
            self._converge_feature(lambda: epoch(
                pf, qf, bu, bi, mu, trailing, ub, ib, rb, mb, off,
                plan=plan)[4], f, verbose)
            P[:, f:f + 1] = pf
            Q[:, f:f + 1] = qf
            full_dot = off + pf[ul, 0] * qf[il, 0]
        self.P, self.Q = _host(P, self.nbr_users), _host(Q, self.nbr_items)
        self.users_bias = _host(bu, self.nbr_users)
        self.items_bias = _host(bi, self.nbr_items)

    # ------------------------------------------------- alternating engine
    def _sgd_driver(self):
        '''``(driver, lr_decay)`` of the alternating and SVD++ tiers: the
        convergence driver with ``lr_plateau_decay``, and the per-epoch
        decay.'''
        decay, plateau = self._lr_schedule()
        return ConvergenceDriver(self.min_epochs, self.max_epochs,
                                 self.min_improvement,
                                 plateau_decay=plateau), decay

    def _run_alternating(self, bias_mode, verbose=False):
        '''Sorted-window alternating epochs
        (``ops.sgd_mf.make_alternating_epoch``) under the convergence
        driver, with ``lr_decay`` and ``lr_plateau_decay``.'''
        lr, lr_bu, lr_bi = self._alt_lrs()
        driver, decay = self._sgd_driver()
        # kept on the store: the call's fetch (``_call_layouts``) built them
        p_layout, q_layout, W_user, W_item = \
            self._alternating_layouts(self._sgd_window())
        with profiling.span('gd.upload'):
            state = self._state(with_bias=(bias_mode != 'none'))
            profiling.count('h2d_bytes', sum(
                t.nbytes for t in (state.P, state.Q, state.bu, state.bi)))
            Paug, Qaug = self._augmented(state.P, state.Q, state.bu,
                                         state.bi, W_user, W_item)
        epoch = sgd_mf.make_alternating_epoch(
            W_user, W_item, lr, self.K, lr_bu=lr_bu, lr_bi=lr_bi,
            K_bu=self.K2, K_bi=self.K3, bias_mode=bias_mode,
            lo_r=self.min_rating, hi_r=self.max_rating,
            inner_steps=self.inner_steps, use_kernel=self._on_card,
            ff_dtype='bfloat16')
        with profiling.span('gd.epochs'):
            Paug, Qaug = self._alternating_epochs(
                driver, epoch, (Paug, Qaug), (state.mu, p_layout, q_layout),
                decay, verbose)
        with profiling.span('gd.writeback'):
            self._from_augmented(Paug, Qaug, bias_mode == 'learned')

    # -------------------------------------------------------- funk engine
    def _run_funk(self, bias_mode, verbose=False, update_users=True,
                  update_items=True, ratings=None):
        '''Feature-by-feature training with the reference's exact
        semantics (``mfrec_tpu/models/gd.py:883-941``): per feature, S1
        epochs on P's and Q's column until the feature converges, then
        the feature frozen into the rating cache (on a CUDA model one
        launch for all of it, then one read of the epochs' rmse; the
        stream's plan built once a call).  Only the rows the stream rates
        go to the device and back: no rating touches the others.'''
        if ratings is None:
            uidx, iidx, vals = self.ratings.shuffled(
                int(self.rng.integers(2**31)))
        else:
            uidx, iidx, vals = ratings
        users, uidx = np.unique(np.asarray(uidx), return_inverse=True)
        items, iidx = np.unique(np.asarray(iidx), return_inverse=True)
        plan = (serial_kernel.serial_plan(uidx, iidx, bias_mode == 'learned',
                                          self.device)
                if self._on_card and len(vals) else None)

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device)

        uidx, iidx, r = (t(uidx, np.int32), t(iidx, np.int32),
                         t(vals, np.float32))
        k = self.dimensionality
        st = self._state(with_bias=(bias_mode != 'none'),
                         rows=(users, items))
        P, Q, bu, bi = st.P, st.Q, st.bu, st.bi
        mu = float(st.mu)
        cache = torch.zeros(r.shape, dtype=torch.float32, device=self.device)
        self.rmse_history = []
        for f in range(k):
            hist = serial_kernel.serial_converge(
                P[:, f], Q[:, f], cache, uidx, iidx, r, f, k,
                self.feature_init, float(self.learning_rate), self.K, mu, bu,
                bi, float(self.learning_rate_users),
                float(self.learning_rate_items), self.K2, self.K3,
                bias_mode=bias_mode, lo=self.min_rating, hi=self.max_rating,
                update_users=update_users, update_items=update_items, P=P,
                Q=Q, min_epochs=self.min_epochs, max_epochs=self.max_epochs,
                min_improvement=self.min_improvement, update_cache=True,
                plan=plan)[4]
            self.rmse_history += hist
            if verbose:
                self.logger.info('feature %d epochs %d rmse %.5f', f,
                                 len(hist), hist[-1] if hist else 2.0)

        def back(full, n, ids, rows):
            out = np.array(np.asarray(full)[:n], np.float32)
            out[ids] = rows.cpu().numpy()
            return out

        self.P = back(self.P, self.nbr_users, users, P)
        self.Q = back(self.Q, self.nbr_items, items, Q)
        if bias_mode == 'learned':
            zu, zi = self._zero_biases()
            self.users_bias = back(
                zu if self.users_bias is None else self.users_bias,
                self.nbr_users, users, bu)
            self.items_bias = back(
                zi if self.items_bias is None else self.items_bias,
                self.nbr_items, items, bi)

    # ------------------------------------------------------------ training
    def feature_training(self, initialize_model=True, handle_bias=False,
                         verbose=False):
        '''Main SGD training (reference gradient_descent.py:506-542).
        handle_bias=False -> baseline 1.0; handle_bias=True -> fixed
        BellKor biases computed first, then held.  Recorded by
        ``utils.profiling`` as the span tree ``gd.train``.'''
        with profiling.span('gd.train'):
            with profiling.span('gd.init'):
                self._init_factors(initialize_model)
            engine = self._checked_engine()
            layouts = self._call_layouts(engine)
            if handle_bias:
                self._bellkor_biases('gd.bias', layouts)
            self._dispatch_engine(engine, 'fixed' if handle_bias else 'none',
                                  verbose)

    def _call_layouts(self, engine):
        '''On the alternating engine, the call's layouts, fetched first
        (span ``gd.layouts``): the bias refit reads their segment tables
        on a CUDA model, and ``_run_alternating`` finds them kept on the
        store.  None on the other engines.'''
        if engine != 'alternating':
            return None
        with profiling.span('gd.layouts'):
            return self._alternating_layouts(self._sgd_window())

    def _bellkor_biases(self, span, layouts):
        '''The overall mean and the BellKor biases, in span ``span``: on
        the card (``compute_biases_bk_on_device``) when ``layouts`` are
        the alternating engine's with segment tables, which only a CUDA
        model builds; numpy (``compute_items_bias_bk``,
        ``compute_users_bias_bk``) otherwise.'''
        with profiling.span(span):
            self.compute_overall_avg()
            if layouts is not None and layouts[0].segments is not None:
                self.compute_biases_bk_on_device(layouts[0], layouts[1])
            else:
                self.compute_items_bias_bk()
                self.compute_users_bias_bk()

    def _checked_engine(self):
        '''``self.engine`` resolved (``'auto'`` = ``'alternating'``), with
        the JAX model's refusals of the options only ``'alternating'``
        wires (``mfrec_tpu/models/gd.py:960-1011``); ``resilience > 0``
        and the multi-device engines raise.'''
        engine = self.engine
        if engine == 'auto':
            engine = 'alternating'
        if int(self.resilience) > 0 and engine != 'alternating':
            raise Error(
                "resilience is only wired on engine='alternating' "
                "(got %r); set engine='alternating' or resilience=0"
                % (engine,))
        if float(self.lr_decay) != 1.0 and engine != 'alternating':
            raise Error(
                "lr_decay is only wired on engine='alternating' "
                "(got %r); set engine='alternating' or lr_decay=1.0"
                % (engine,))
        if float(self.lr_plateau_decay) != 1.0:
            if engine != 'alternating':
                raise Error(
                    "lr_plateau_decay is only wired on "
                    "engine='alternating' (got %r)" % (engine,))
            if int(self.resilience) > 0:
                raise Error('lr_plateau_decay and resilience>0 are '
                            'mutually exclusive (the resilient driver '
                            'uses its lr scale for rollback backoff)')
        if int(self.resilience) > 0:
            raise Error(
                'resilience > 0 is not ported yet (ResilientDriver needs '
                'its snapshots ported: ROADMAP queue 1 item 1); set '
                'resilience=0')
        if engine in _UNPORTED_ENGINES:
            raise NotImplementedError(
                'engine %r is not ported yet (ROADMAP %s); use a '
                "single-device engine ('alternating', 'fused', 'funk' or "
                "'funk_fused')" % (engine, _UNPORTED_ENGINES[engine]))
        if engine not in self._RUNS:
            raise Error('unknown engine %r' % (engine,))
        return engine

    def _dispatch_engine(self, engine, mode, verbose):
        '''Run ``engine`` (from ``_checked_engine``) in bias ``mode``.'''
        getattr(self, self._RUNS[engine])(mode, verbose=verbose)

    train = feature_training

    def feature_training_bias(self, initialize_model=True, handle_bias=False,
                              verbose=False):
        '''SGD with learned biases (reference gradient_descent.py:472-503)
        on the same engine: the BellKor biases are the starting point.'''
        self._init_factors(initialize_model)
        engine = self._checked_engine()
        self._bellkor_biases('gd.bias', self._call_layouts(engine))
        self._dispatch_engine(engine, 'learned', verbose)

    def feature_training_implicit(self, initialize_model=True,
                                  verbose=False):
        '''SVD++ with implicit feedback factors Y (reference
        gradient_descent.py:547-574; ``mfrec_tpu/models/gd.py:1025-1058``):
        the joint init, the BellKor biases, the feedback arrays, Y = 0,
        then the sorted-window implicit tier.  Every engine but
        ``'alternating_sharded'`` runs that tier, as in the JAX model.
        Recorded by ``utils.profiling`` as the span tree ``svdpp.train``.'''
        with profiling.span('svdpp.train'):
            with profiling.span('svdpp.init'):
                self._init_factors(initialize_model, sequential=False)
            if self.engine == 'alternating_sharded':
                raise NotImplementedError(
                    "engine 'alternating_sharded' is not ported yet (ROADMAP "
                    "%s); use engine='alternating'"
                    % _UNPORTED_ENGINES['alternating_sharded'])
            # the call's layouts first: the refit reads their segment
            # tables on a CUDA model, and _implicit_epoch finds them kept
            with profiling.span('svdpp.layouts'):
                layouts = self._alternating_layouts(
                    512, reused_counter='svdpp.layouts_reused')
            self._bellkor_biases('svdpp.bias', layouts)
            with profiling.span('svdpp.feedback'):
                self.initialize_rated_feedback()
                self.Y = np.zeros_like(self.Q)
            self._run_alternating_implicit(verbose=verbose)

    def _implicit_epoch(self, use_kernel=None):
        '''The SVD++ epoch (``ops.sgd_mf.make_alternating_implicit_epoch``)
        as this model runs it, its starting state ``(Paug, Qaug, Ypad)``
        from the model's P, Q, biases and Y, and its fixed arguments
        ``(mu, p_layout, q_layout, nrm_rows)``, on the model's device:
        W=512 layouts, ``inner_steps_implicit`` sweeps, the fixed side in
        f32 (bf16 rounding hurts the Y-coupled convergence:
        ``mfrec_tpu/models/gd.py:724-726``).  ``use_kernel`` defaults to
        whether the model is on a CUDA device.  The layouts come from the
        store's cache (``feature_training_implicit`` fetched them first);
        span ``svdpp.upload`` and the counter ``h2d_bytes``.'''
        lr, _, _ = self._alt_lrs()
        # the aggregation phases couple rows across the batch: W=512
        p_layout, q_layout, W_user, W_item = self._alternating_layouts(512)
        with profiling.span('svdpp.upload'):
            state = self._state(with_bias=True)
            Y = self._to_device(self.Y)
            nrm_rows = self._user_norms(W_user)
            profiling.count('h2d_bytes', sum(
                t.nbytes for t in (state.P, state.Q, state.bu, state.bi, Y,
                                   nrm_rows)))
            Paug, Qaug = self._augmented(state.P, state.Q, state.bu,
                                         state.bi, W_user, W_item)
            Ypad = _pad_rows(Y, W_item)
        if use_kernel is None:
            use_kernel = self._on_card
        epoch = sgd_mf.make_alternating_implicit_epoch(
            W_user, W_item, lr, lr, self.K, self.K, lo_r=self.min_rating,
            hi_r=self.max_rating, inner_steps=self.inner_steps_implicit,
            use_kernel=use_kernel)
        return epoch, (Paug, Qaug, Ypad), (state.mu, p_layout, q_layout,
                                            nrm_rows)

    def _run_alternating_implicit(self, verbose=False):
        '''SVD++ epochs under the convergence driver, with ``lr_decay``
        and ``lr_plateau_decay`` scaling the half-passes and the Y step
        together; P, Q and Y come back as numpy.  Spans ``svdpp.epochs``
        and ``svdpp.writeback``.'''
        driver, decay = self._sgd_driver()
        epoch, state, args = self._implicit_epoch()
        with profiling.span('svdpp.epochs'):
            Paug, Qaug, Ypad = self._alternating_epochs(
                driver, epoch, state, args, decay, verbose)
        with profiling.span('svdpp.writeback'):
            self._from_augmented(Paug, Qaug, biases=False)
            self.Y = _host(Ypad, self.nbr_items)

    def feature_training2(self, initialize_model=True, verbose=False):
        '''Caller-controlled funk subloops (reference
        gradient_descent.py:299-328): the same semantics as
        engine='funk'.'''
        self._init_factors(initialize_model, sequential=True)
        self._run_funk('none', verbose=verbose)

    def feature_training_folding(self, initialize_model=False,
                                 handle_bias=False, verbose=False):
        '''Warm-start continuation (reference
        gradient_descent.py:450-469).'''
        self.feature_training(initialize_model=initialize_model,
                              handle_bias=handle_bias, verbose=verbose)
        self.compute_components_mean()

    def feature_training_batch(self, batch_size=10000, probeset=None,
                               verbose=False):
        '''Sequential mini-batch / online training over rating chunks
        (reference gradient_descent.py:331-355): the fused tier on each
        chunk in turn; returns the probe RMSE after each chunk.'''
        from mfrec_tpu_torch.eval.metrics import test_predict_rating
        idx, vals = self.get_ratings(randomize_order=False)
        n = idx.shape[0]
        nbr_batchs = max(n // batch_size, 1)
        bounds = np.linspace(0, n, nbr_batchs + 1).astype(int)
        rmse_probe = np.zeros(nbr_batchs)
        self._init_factors(True, sequential=False)   # fused = joint
        for b in range(nbr_batchs):
            chunk = (idx[bounds[b]:bounds[b + 1], 0],
                     idx[bounds[b]:bounds[b + 1], 1],
                     vals[bounds[b]:bounds[b + 1]].astype(np.float32))
            self._run_fused('none', ratings=chunk, verbose=verbose)
            if probeset is not None:
                rmse_probe[b] = test_predict_rating(
                    self, probeset, nbr_samples=20000, quiet=True)[0]
        return rmse_probe

    def feature_training_online_prototype(self, ratings_index, ratings,
                                          initialize_cache=True,
                                          initialize_model=True,
                                          verbose=False):
        '''Online training on an explicit rating chunk (reference
        gradient_descent.py:358-409): the funk tier on that chunk.'''
        self._init_factors(initialize_model, sequential=True)
        chunk = (ratings_index[:, 0].astype(np.int32),
                 ratings_index[:, 1].astype(np.int32),
                 np.asarray(ratings, np.float32))
        self._run_funk('none', verbose=verbose, ratings=chunk)

    def feature_training_prototype(self, verbose=False, randomize=False):
        '''The pure-numpy funk loop (``ops.reference_numpy.
        funk_train_oracle``; reference gradient_descent.py:214-257), kept
        as the slow twin.'''
        from mfrec_tpu_torch.ops.reference_numpy import funk_train_oracle
        idx, vals = self.get_ratings(randomize_order=False)
        U = np.full((self.dimensionality, self.nbr_items), self.feature_init)
        V = np.full((self.dimensionality, self.nbr_users), self.feature_init)
        funk_train_oracle(self.min_epochs, self.max_epochs,
                          self.min_improvement, self.dimensionality,
                          self.feature_init, self.learning_rate, self.K,
                          U, V, idx, vals, bias_mode='none')
        self.svd_u, self.svd_v = U, V

    def feature_training_prototype_p(self, verbose=False, randomize=False,
                                     nbr_batch=2):
        '''Zinkevich parameter-averaged parallel SGD (reference
        gradient_descent.py:124-211), the shards simulated in one process
        as the reference does: the funk tier on each shard from the same
        start, then the factors averaged.'''
        idx, vals = self.get_ratings(randomize_order=False)
        n = idx.shape[0]
        cuts = np.linspace(0, n, nbr_batch + 1).astype(int)
        self._init_factors(True, sequential=True)    # funk per shard
        shards_P = []
        shards_Q = []
        for b in range(nbr_batch):
            sl = slice(cuts[b], cuts[b + 1])
            chunk = (idx[sl, 0].astype(np.int32), idx[sl, 1].astype(np.int32),
                     vals[sl].astype(np.float32))
            model = GDRecommender.__new__(GDRecommender)
            model.__dict__.update(self.__dict__)
            model.P, model.Q = self.P.copy(), self.Q.copy()
            model._run_funk('none', verbose=verbose, ratings=chunk)
            shards_P.append(model.P)
            shards_Q.append(model.Q)
        self.P = np.mean(shards_P, axis=0)
        self.Q = np.mean(shards_Q, axis=0)

    # ---------------------------------------------------------- predictors
    def estimate_rating(self, feature_index, user_index, f, cache=False,
                        trailing=False):
        '''Single-feature cached estimator (reference
        gradient_descent.py:602-618).'''
        s = cache if (cache and cache > 0) else 1.0
        s += float(self.Q[feature_index, f] * self.P[user_index, f])
        s = self.clamping(s, self.min_rating, self.max_rating)
        if trailing:
            s += ((self.dimensionality - f - 1)
                  * self.feature_init * self.feature_init)
            s = self.clamping(s, self.min_rating, self.max_rating)
        return s

    def predict_rating(self, item_index, user_index):
        '''dot + 1.0 baseline (reference gradient_descent.py:621-631).'''
        return float(self.Q[item_index] @ self.P[user_index] + 1.0)

    predict = predict_rating

    def predict_rating_with_bias(self, item_index, user_index):
        '''dot + mu + b_i + b_u (reference gradient_descent.py:637-648).'''
        return float(self.Q[item_index] @ self.P[user_index]
                     + self.overall_bias + self.items_bias[item_index]
                     + self.users_bias[user_index])

    def predict_rating_implicit(self, item_index, user_index):
        '''SVD++ predictor with the feedback-sum user vector (reference
        gradient_descent.py:651-667).'''
        seek, span = self.feedback_hash[user_index]
        if span <= 0:
            return self.predict_rating_with_bias(item_index, user_index)
        items_id = self.feedback_rated[seek:seek + span, 1]
        p_u = self.P[user_index] + self.Y[items_id].sum(0) / np.sqrt(span)
        return float(self.Q[item_index] @ p_u + self.overall_bias
                     + self.items_bias[item_index]
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

    # --------------------------------------------------------------- fold-in
    def folding_in_new_user(self, label, ratings):
        '''Project a ratings vector onto the item factors (reference
        gradient_descent.py:412-428).'''
        Qt = self.svd_u.T          # [items, dim] in reference orientation
        return np.asarray(ratings) @ Qt / (np.linalg.norm(Qt) ** 2)

    def folding_in_new_item(self, label, ratings):
        Pt = self.svd_v.T
        return np.asarray(ratings) @ Pt / (np.linalg.norm(Pt) ** 2)

    def _retrain(self, axis, index, ratings_index, ratings, verbose):
        '''Fold-in retrain of one user (axis 0) or item (axis 1): a random
        re-init of its row, then the funk tier with fixed biases over its
        ratings, the other side frozen (reference gradient_descent.py:
        879-905, estimator_loop_with_bias_dev with the fold-in masks).'''
        valid = np.where(ratings_index[:, axis] == index)[0]
        if axis == 0:
            self.init_user_features(index)
        else:
            self.init_item_features(index)
        self._ensure_bias_arrays()
        chunk = (ratings_index[valid, 0].astype(np.int32),
                 ratings_index[valid, 1].astype(np.int32),
                 np.asarray(ratings, np.float32)[valid])
        self._run_funk('fixed', verbose=verbose, update_users=axis == 0,
                       update_items=axis == 1, ratings=chunk)

    def retrain_user(self, user_index, ratings_index, ratings, verbose=False):
        self._retrain(0, user_index, ratings_index, ratings, verbose)

    def retrain_item(self, item_index, ratings_index, ratings, verbose=False):
        self._retrain(1, item_index, ratings_index, ratings, verbose)

    def _ensure_bias_arrays(self):
        '''Biases for every user and item: computed or zero-filled where
        missing, zero-padded after a fold-in grew the model.'''
        if self.overall_bias is None:
            self.compute_overall_avg()
        if self.items_bias is None or self.users_bias is None:
            self.initialize_bias()
        if self.items_bias.shape[0] < self.nbr_items:
            self.items_bias = np.pad(
                self.items_bias, (0, self.nbr_items
                                  - self.items_bias.shape[0]))
        if self.users_bias.shape[0] < self.nbr_users:
            self.users_bias = np.pad(
                self.users_bias, (0, self.nbr_users
                                  - self.users_bias.shape[0]))

    def _fold_in(self, axis, label, other_index, values):
        '''Append a user (axis 0) or item (axis 1) and fold it in from
        its ratings, the training matrix untouched (reference
        gradient_descent.py:908-954).  The factor matrix grows by
        ``np.resize`` (old rows repeated) before the new row is drawn,
        as in the JAX model, so the same seed draws the same row.'''
        other_index = np.asarray(other_index)
        values = np.asarray(values, np.float32)
        if other_index.shape[0] != values.shape[0]:
            raise Error('The index and the ratings array must be the same '
                        'size')
        if axis == 0:
            new_id = self.users.add(label)
            self.ratings.grow(nbr_users=new_id + 1)
            self.P = np.resize(self.P, (new_id + 1, self.dimensionality))
        else:
            new_id = self.items.add(label)
            self.ratings.grow(nbr_items=new_id + 1)
            self.Q = np.resize(self.Q, (new_id + 1, self.dimensionality))
        ratings_index = np.zeros((values.shape[0], 2), np.int32)
        ratings_index[:, axis] = new_id
        ratings_index[:, 1 - axis] = other_index
        self._retrain(axis, new_id, ratings_index, values, False)
        return new_id

    def add_user(self, user_label, users_ratings_index, users_ratings):
        '''Add and fold in a new user from its item ids and ratings;
        returns the new user's index.'''
        return self._fold_in(0, user_label, users_ratings_index,
                             users_ratings)

    def add_item(self, item_label, items_ratings_index, items_ratings):
        '''Add and fold in a new item from its user ids and ratings;
        returns the new item's index.'''
        return self._fold_in(1, item_label, items_ratings_index,
                             items_ratings)

    # ------------------------------------------------------ GD similarity
    def similar_users(self, user_index, nbr_recommendations=2,
                      similarity_threshold=False, similarities_output=False,
                      method='cosine_binary'):
        '''GD override: binary rated-set cosine by default (reference
        gradient_descent.py:712-766), one product over the dense 0/1
        rating indicator on the model's device (fine at ML-100K scale;
        for large catalogues use a factor-space method, 'cosine' or
        'pearson').'''
        if method != 'cosine_binary':
            return MFRecommender.similar_users(
                self, user_index, nbr_recommendations, similarity_threshold,
                similarities_output, method)
        B = torch.from_numpy(self.ratings.to_dense() != 0).to(
            self.device, torch.float32)
        n = B.shape[0]
        nbr = nbr_recommendations
        if nbr == 'All':
            nbr = n - 1
        idx, sims = sim_ops.binary_cosine_topk(
            B, torch.tensor([int(user_index)], device=self.device),
            min(int(nbr), n - 1))
        ids = idx[0].cpu().numpy()
        vals = sims[0].cpu().numpy().astype(np.float64)
        ids, vals = self._apply_threshold(ids, vals, similarity_threshold)
        if not similarities_output:
            return [int(x) for x in ids]
        return [int(x) for x in ids], [float(v) for v in vals]

    def compute_components_mean(self):
        self.components_mean = np.asarray(self.Q).mean(axis=0)

    def _normalize_cosine_similarity(self, A, B):
        '''Component-mean-centred log-cosine (reference
        gradient_descent.py:814-824).'''
        An = np.asarray(A) - self.components_mean[1:self.dimensionality]
        Bn = np.asarray(B) - self.components_mean[1:self.dimensionality]
        ip = float(An @ Bn)
        if ip == 0:
            return 0.0
        return float(np.log(1.0 + ip / (np.linalg.norm(An)
                                        * np.linalg.norm(Bn))))

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

    def find_user_top_match(self, user_index, nbr_recommendations=5):
        '''GD override: every item scored with the dot predictor
        (reference gradient_descent.py:769-802), through retrieval (K3 on
        a CUDA model).'''
        return self.find_recommended_items(
            user_index=user_index, nbr_recommendations=nbr_recommendations,
            predictor='predict_rating')
