'''
The ``train_calls`` traffic: back-to-back public ``train()`` calls of a
model over the configuration's data, and the check of the training steps
set-up drove through that same call against the plain reference.

Set-up builds the model on the data, hands it a start made from the seed
and runs the mix's check calls through ``train()`` (the first pays the
program's one-off layouts and kernel loads): their states and losses are
kept on the host.  With ``continue_from_check`` the window's calls go on
from where they ended (``initialize_model`` false); with ``restart``
each check call starts from the seed's start again.  Each window call is
``epochs_a_call`` epochs; the window runs calls until ``seconds`` have
passed, and its rate counts the ratings of every whole call, times its
epochs, over their wall time, under the name the configuration gives
it (``train.rate_metric``).
'''
from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch

from lib import data as data_laws
from lib.trace import Spans, profiled


def make_model(cfg, device):
    import mfrec_tpu_torch.models as models
    cls = getattr(models, cfg['model'])
    return cls(cfg['data']['users'], cfg['data']['items'],
               dict(cfg['parameters']), device=device)


def make_data(cfg, seed, device):
    spec = cfg['data']
    if spec['law'] == 'explicit':
        return data_laws.explicit_ratings(spec, seed, device)[0]
    if spec['law'] == 'implicit':
        return data_laws.implicit_interactions(spec, seed, device)
    raise ValueError('unknown data law %r' % spec['law'])


def start_factors(cfg, seed, device):
    '''The check's start: N(0, feature_init) P and Q from the seed.'''
    spec = cfg['data']
    k = int(cfg['parameters']['nbr_features'])
    gen = data_laws.make_generator(int(seed) + 7919, device)
    s = float(cfg['parameters']['feature_init'])
    P = s * torch.randn((spec['users'], k), generator=gen, device=device)
    Q = s * torch.randn((spec['items'], k), generator=gen, device=device)
    return P.cpu().numpy(), Q.cpu().numpy()


def set_epochs(model, cfg, epochs):
    if cfg['train']['epochs_by'] == 'min_max':
        model.min_epochs = model.max_epochs = int(epochs)
    else:
        model.nbr_epochs = int(epochs)


def norm_gap(prog, ref, start):
    '''The worst leaf's gap between the norms of the program's and the
    reference's change from ``start``, against the larger of the
    reference's norm of that leaf and of the median leaf.  Leaves the
    reference leaves still (under a thousandth of the median leaf's
    norm) are left out, unless the program moves them: that reads 1.'''
    rn = [float(np.linalg.norm(r.astype(np.float64) - s)) for r, s
          in zip(ref, start)]
    pn = [float(np.linalg.norm(p.astype(np.float64) - s)) for p, s
          in zip(prog, start)]
    med = float(np.median(rn))
    worst = 0.0
    for a, b in zip(pn, rn):
        if b < 1e-3 * med:
            if a >= 1e-3 * med:
                return 1.0
            continue
        worst = max(worst, abs(a - b) / max(b, med))
    return worst


class Runner:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.spans = Spans()
        self.work_cache = None

    def _call(self, epochs, initialize):
        set_epochs(self.model, self.cfg, epochs)
        kw = dict(self.cfg['train'].get('call', {}))
        with self.spans.span('train'):
            self.model.train(initialize_model=initialize, **kw)

    def setup(self):
        cfg, mix = self.cfg, self.mix
        self.u, self.i, self.v = make_data(cfg, self.seed, self.device)
        m = make_model(cfg, self.device)
        m.seed(self.seed)
        m.set_ratings(self.u, self.i, self.v)
        self.model = m
        self.nnz = int(m.ratings.nnz)
        self.P0, self.Q0 = start_factors(cfg, self.seed, self.device)
        self.states, self.losses = [], []
        for epochs in mix['check_calls']:
            if mix['restart'] or not self.states:
                m.P, m.Q = self.P0.copy(), self.Q0.copy()
            self._call(epochs, False)
            self.states.append((m.P.copy(), m.Q.copy()))
            self.losses += [float(x) for x in
                            getattr(m, 'rmse_history', [])]
        if not mix['continue_from_check']:
            m.P, m.Q = None, None

    def window(self, seconds, trace):
        holder = {}
        calls, wall = 0, 0.0
        e = int(self.mix['epochs_a_call'])
        init = not self.mix['continue_from_check']
        ctx = (profiled(self.spans, holder) if trace
               else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                a = time.perf_counter()
                self._call(e, init)
                sync(self.device)
                wall += time.perf_counter() - a
                calls += 1
        swept = float(self.nnz) * e * calls
        return {'metrics': {self.cfg['train']['rate_metric']: swept / wall},
                'attempted': calls, 'failed': 0, 'trace': holder.get('trace'),
                'counters': {'calls': calls, 'epochs_a_call': e,
                             'ratings': self.nnz, 'wall_s': wall}}

    def release(self):
        self.model = None

    def reference(self):
        mod = importlib.import_module('reference.'
                                      + self.cfg['reference']['train'])
        return mod

    def work(self):
        '''Counts of the window's work for the readers, from the data.'''
        if self.work_cache is None:
            mod = self.reference()
            self.work_cache = mod.work(self.u, self.i, self.v, self.cfg,
                                       self.device)
        return self.work_cache

    def _reference(self, dtype=torch.float32, keep=None):
        """The reference's states after each check call and its losses
        (its own rmse of each epoch, or None where the loss is the
        objective of the states)."""
        mod = self.reference()
        ref = mod.Reference.build(self.u, self.i, self.v, self.cfg,
                                  self.device, keep=keep)
        calls = self.mix['check_calls']
        if self.mix['restart']:
            runs = [ref.run(self.P0, self.Q0, [c], dtype) for c in calls]
            hist = [h for r in runs for h in (r[0] or [])]
            states = [r[1][0] for r in runs]
        else:
            hist, states = ref.run(self.P0, self.Q0, calls, dtype)
        return ref, states, hist

    def _readings(self, ref, states, losses, ref_states, ref_losses):
        if hasattr(ref, 'losses'):
            losses, ref_losses = ref.losses(states), ref.losses(ref_states)
        start = (self.P0.astype(np.float64), self.Q0.astype(np.float64))
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(losses, ref_losses)) \
            if len(losses) == len(ref_losses) else float('inf')
        return {'loss_gap': loss_gap,
                'step1_gap': norm_gap(states[0], ref_states[0], start),
                'change_gap': norm_gap(states[-1], ref_states[-1], start)}

    def check(self):
        """The readings of the timed path against the reference: the
        worst step's loss gap, the first step's change and the last
        check state's change, each the worst leaf's gap of norms."""
        ref, states, hist = self._reference()
        return self._readings(ref, self.states, self.losses, states, hist)

    def faults(self):
        """The control's and each fault's readings, each put in the
        program's place: the reference in bfloat16, and the reference with
        half of every batch left out (the mean taken over the rest).  A
        step that returns its state unchanged reads 1 on the change gaps
        by their measure."""
        ref, states, hist = self._reference()
        half = (lambda n: torch.arange(n, device=self.device) % 2 == 0)
        out = {}
        for name, kw in (('control', {'dtype': torch.bfloat16}),
                         ('half_batch', {'keep': half})):
            _, st, h = self._reference(**kw)
            out[name] = self._readings(ref, st, h, states, hist)
        return out


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)



# ---------------------------------------------------------------- faults
# The faults a run of this kind can have, each planted under the
# program's public ``train()`` by ``monkeypatch.setattr`` (pytest's);
# ``tests/test_checks.py`` holds each to coming out not correct.

def unchanged_state(monkeypatch):
    '''A step that returns its state unchanged.'''
    from mfrec_tpu_torch.models import gd, wrmf
    monkeypatch.setattr(gd.GDRecommender, '_run_alternating',
                        lambda self, mode, verbose=False: None)
    monkeypatch.setattr(wrmf.als_ops, 'als_wrmf_train',
                        lambda P, Q, *a, **k: (P.clone(), Q.clone()))


def half_batch(monkeypatch):
    '''Every other rating of each batch masked out: each row's step is
    the mean over the rest.'''
    from mfrec_tpu_torch.data.ratings import Ratings
    from mfrec_tpu_torch.ops import sgd_mf
    orig = sgd_mf.sorted_pass_layout

    def layout(*a, **k):
        ub, ib, rb, mb, kl, lo, W = orig(*a, **k)
        mb = mb.copy()
        mb[:, 1::2] = 0.0
        return ub, ib, rb, mb, kl, lo, W

    monkeypatch.setattr(sgd_mf, 'sorted_pass_layout', layout)
    rows = Ratings.padded_rows

    def padded(self, *a, **k):
        out = []
        for r, idx, val, mask in rows(self, *a, **k):
            mask = np.array(mask)
            mask[:, 1::2] = 0.0
            out.append((r, idx, val, mask))
        return out

    monkeypatch.setattr(Ratings, 'padded_rows', padded)


FAULTS = [unchanged_state, half_batch]
