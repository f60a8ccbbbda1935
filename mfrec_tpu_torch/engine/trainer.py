'''
Convergence driver: port of ``ConvergenceDriver`` from
``mfrec_tpu/engine/trainer.py`` (pure Python, copied; that module
imports jax for ``ResilientDriver``, which is not ported yet).  The one
addition is the ``converge.sync`` span (``utils.profiling``) around each
epoch's wait for its rmse.

The reference's epoch rule (``gd_estimator.pyx:360,455,545``):

    while (epoch < min_epochs) or (rmse <= rmse_last - min_improvement):

with rmse initialized to 2.0 -- train at least ``min_epochs`` epochs and
keep going while the training RMSE still improves by ``min_improvement``;
``max_epochs`` is honoured as a safety cap.  The improvement test runs
on the host between epochs (one scalar device->host sync per epoch).
'''
from __future__ import annotations

from mfrec_tpu_torch.utils import profiling


class ConvergenceDriver:
    '''Stateful epoch loop with the reference's improvement rule and an
    rmse history (reference ``rmse_history``: ``gradient_descent.py:93,114``).'''

    def __init__(self, min_epochs, max_epochs, min_improvement,
                 nan_guard=True, plateau_decay=1.0, min_lr_scale=0.01):
        self.min_epochs = int(min_epochs)
        self.max_epochs = int(max_epochs)
        self.min_improvement = float(min_improvement)
        self.nan_guard = nan_guard
        self.history = []
        # Plateau-onset learning-rate decay: when the improvement rule
        # would stop, multiply ``lr_scale`` by ``plateau_decay`` and keep
        # training instead — until the scale floors at ``min_lr_scale``
        # (then the reference stop rule applies unchanged).  Measured at
        # ML-10M (bench_logs/r4/ttq_decay_plateau.log): decay FROM the
        # plateau breaks below the constant-rate trajectory, while decay
        # from epoch 0 loses everywhere (ttq_decay_ml10m.log) — so this
        # is the only decay shape worth turning on.  1.0 disables (the
        # reference semantics, and the shipped default).
        self.plateau_decay = float(plateau_decay)
        self.min_lr_scale = float(min_lr_scale)
        self.lr_scale = 1.0

    def _plateau_step(self):
        '''One decay step at a stall; True = keep training.'''
        if self.plateau_decay >= 1.0 or self.lr_scale <= self.min_lr_scale:
            return False
        self.lr_scale = max(self.lr_scale * self.plateau_decay,
                            self.min_lr_scale)
        return True

    def run(self, epoch_fn, state):
        '''epoch_fn(state) -> (state, rmse_scalar).  Returns final state.
        ``epoch_fn`` may read ``self.lr_scale`` (the plateau-decay knob);
        it is only ever updated between epochs.'''
        import math
        rmse = 2.0
        rmse_last = rmse      # min_epochs=0 means converge-only, not crash
        epoch = 0
        while (epoch < self.min_epochs
               or rmse <= rmse_last - self.min_improvement
               or self._plateau_step()):
            if epoch >= self.max_epochs:
                break
            rmse_last = rmse
            state, rmse_dev = epoch_fn(state)
            with profiling.span('converge.sync'):
                rmse = float(rmse_dev)
            if self.nan_guard and not math.isfinite(rmse):
                raise FloatingPointError(
                    'training diverged: rmse=%r at epoch %d (reduce the '
                    'learning rate or batch size)' % (rmse, epoch))
            self.history.append(rmse)
            epoch += 1
        return state
