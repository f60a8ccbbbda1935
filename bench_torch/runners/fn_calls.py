'''
The ``fn_calls`` traffic: back-to-back public ``train()`` calls of an
``FNRecommender`` (Koren's Asymmetric-SVD) over the configuration's data,
and the check of the epochs set-up drove through that same call against
the plain reference.

As ``svdpp_calls``, with FN's leaves: set-up hands the model a start made
from the seed (Q, X and Y; zero biases) and runs the mix's check calls,
each from that start (``restart``); their served profiles P, Q, X, Y and
rmse histories are kept on the host.  Each window call is
``epochs_a_call`` epochs from a fresh draw (``initialize_model``), the
served profiles' materialization included, and the rate counts the
ratings of every whole call, times its epochs, over their wall time.
Under ``--trace 1`` the window records the program's spans and places
them on launch marks, as ``svdpp_calls`` does.
'''
from __future__ import annotations

import numpy as np
import torch

from lib import data as data_laws
from runners import svdpp_calls, train_calls
from runners.train_calls import norm_gap


def start_items(cfg, seed, device):
    '''The check's start: N(0, feature_init) Q, X and Y from the seed.'''
    spec = cfg['data']
    k = int(cfg['parameters']['nbr_features'])
    gen = data_laws.make_generator(int(seed) + 7919, device)
    s = float(cfg['parameters']['feature_init'])
    return tuple((s * torch.randn((spec['items'], k), generator=gen,
                                  device=device)).cpu().numpy()
                 for _ in range(3))


class Runner(svdpp_calls.Runner):

    def _call(self, epochs, initialize):
        train_calls.set_epochs(self.model, self.cfg, epochs)
        with self.spans.span('train'):
            self.model.train(initialize_model=initialize)

    def setup(self):
        cfg, mix = self.cfg, self.mix
        self.u, self.i, self.v = train_calls.make_data(cfg, self.seed,
                                                       self.device)
        m = train_calls.make_model(cfg, self.device)
        m.seed(self.seed)
        m.set_ratings(self.u, self.i, self.v)
        self.model = m
        self.nnz = int(m.ratings.nnz)
        self.Q0, self.X0, self.Y0 = start_items(cfg, self.seed, self.device)
        U, I = cfg['data']['users'], cfg['data']['items']
        self.states, self.losses = [], []
        for epochs in mix['check_calls']:
            if mix['restart'] or not self.states:
                m.Q, m.X, m.Y = (a.copy() for a in (self.Q0, self.X0,
                                                    self.Y0))
                m.users_bias = np.zeros(U, np.float32)
                m.items_bias = np.zeros(I, np.float32)
            self._call(epochs, False)
            self.states.append(tuple(a.copy() for a in (m.P, m.Q, m.X, m.Y)))
            self.losses += [float(x) for x in m.rmse_history]
        if not mix['continue_from_check']:
            m.P = m.Q = m.X = m.Y = None

    def _reference(self, dtype=torch.float32, keep=None):
        """The reference's (P, Q, X, Y) after each check call and its rmse
        history, and the reference itself.  With ``restart`` it runs the
        longest call once and reads each call's state and losses from that
        run's prefix."""
        mod = self.reference()
        ref = mod.Reference.build(self.u, self.i, self.v, self.cfg,
                                  self.device, keep=keep)
        calls = self.mix['check_calls']
        if self.mix['restart']:
            ends = sorted(set(calls))
            steps = [b - a for a, b in zip([0] + ends[:-1], ends)]
            h, st = ref.run(self.Q0, self.X0, self.Y0, steps, dtype)
            at = dict(zip(ends, st))
            hist = [x for c in calls for x in h[:c]]
            states = [at[c] for c in calls]
        else:
            hist, states = ref.run(self.Q0, self.X0, self.Y0, calls, dtype)
        return ref, states, hist

    def _readings(self, ref, states, losses, ref_states, ref_losses):
        # P's start: the profiles of the start, so that P's gap is of
        # what the epochs changed
        dev = ref.device
        U, I = ref.U, ref.I
        P0 = ref.profiles(*(torch.from_numpy(a).to(dev) for a in
                            (self.X0, self.Y0)),
                          torch.zeros(U, device=dev),
                          torch.zeros(I, device=dev),
                          torch.tensor(ref.mu, device=dev), ref.nrm,
                          rounded=False).cpu().numpy()
        start = tuple(a.astype(np.float64) for a in
                      (P0, self.Q0, self.X0, self.Y0))
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(losses, ref_losses)) \
            if len(losses) == len(ref_losses) else float('inf')
        return {'loss_gap': loss_gap,
                'step1_gap': norm_gap(states[0], ref_states[0], start),
                'change_gap': norm_gap(states[-1], ref_states[-1], start)}


# ---------------------------------------------------------------- faults
# Planted under the public ``train()`` by ``monkeypatch.setattr``;
# ``tests/test_checks.py`` holds each to coming out not correct.

def unchanged_state(monkeypatch):
    '''Epochs that return the state unchanged.'''
    from mfrec_tpu_torch.models import fn
    monkeypatch.setattr(fn.FNRecommender, '_alternating_epochs',
                        lambda self, driver, epoch, state, *a, **k: state)


FAULTS = [unchanged_state, train_calls.half_batch]
