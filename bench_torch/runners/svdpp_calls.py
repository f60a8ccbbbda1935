'''
The ``svdpp_calls`` traffic: back-to-back public
``feature_training_implicit()`` (SVD++) calls of a ``GDRecommender`` over
the configuration's data, and the check of the epochs set-up drove
through that same call against the plain reference.

As ``train_calls``, with SVD++'s leaves: set-up hands the model a start
made from the seed (P and Q; Y starts at zero in every call) and runs the
mix's check calls, each from that start (``restart``); their P, Q, Y and
rmse histories are kept on the host.  Each window call is
``epochs_a_call`` epochs from a fresh draw (``initialize_model``), and
the rate counts the ratings of every whole call, times its epochs, over
their wall time.

Under ``--trace 1`` the program's own spans (``utils.profiling``) are
recorded over the window and joined to the benchmark's spans, which share
their clock, before the profiled block ends: a reader can then ask for
the device time inside ``svdpp.aggregate``, say.  Where the program has
no such span, such a reader finds nothing and returns None.  A caller
that has turned the recording on itself (``phases.py``) keeps it, and
what it records, to itself.

A kernel launched inside such a span lies about 0.1 ms before its end,
while ``lib.trace.profiled`` places the spans by one anchor whose error
is up to half of a cold ``record_function`` (1.5-2.7 ms), and the
profiler's launch times may drift from the host clock over a window
(1.2 ms over 55 s in one run).  So the window starts, and each call ends,
with a mark: a launch of ``torch.cuda._sleep``'s own kernel timed from a
host clock reading just before it (after one untimed launch, so that the
timed one is warm).  ``recentre`` moves each span by the error at its
time, interpolated between the marks.
'''
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from lib.trace import DeviceTrace, note, profiled
from runners import train_calls
from runners.train_calls import norm_gap, sync


class Runner(train_calls.Runner):

    def _call(self, epochs, initialize):
        train_calls.set_epochs(self.model, self.cfg, epochs)
        with self.spans.span('train'):
            self.model.feature_training_implicit(
                initialize_model=initialize)

    def setup(self):
        cfg, mix = self.cfg, self.mix
        self.u, self.i, self.v = train_calls.make_data(cfg, self.seed,
                                                       self.device)
        m = train_calls.make_model(cfg, self.device)
        m.seed(self.seed)
        m.set_ratings(self.u, self.i, self.v)
        self.model = m
        self.nnz = int(m.ratings.nnz)
        self.P0, self.Q0 = train_calls.start_factors(cfg, self.seed,
                                                     self.device)
        self.Y0 = np.zeros_like(self.Q0)
        self.states, self.losses = [], []
        for epochs in mix['check_calls']:
            if mix['restart'] or not self.states:
                m.P, m.Q = self.P0.copy(), self.Q0.copy()
            self._call(epochs, False)
            self.states.append((m.P.copy(), m.Q.copy(), m.Y.copy()))
            self.losses += [float(x) for x in m.rmse_history]
        if not mix['continue_from_check']:
            m.P, m.Q = None, None

    def window(self, seconds, trace):
        from mfrec_tpu_torch.utils import profiling
        holder = {}
        calls, wall = 0, 0.0
        e = int(self.mix['epochs_a_call'])
        init = not self.mix['continue_from_check']
        ctx = (profiled(self.spans, holder) if trace
               else contextlib.nullcontext())
        program = None
        own = trace and not profiling.enabled()
        marks = [] if trace and self.device.type == 'cuda' else None
        if marks is not None:
            torch.cuda._sleep(1)             # loaded before the first mark
            torch.cuda.synchronize()
        with ctx:
            if own:
                profiling.collect()
                profiling.enable()
            if marks is not None:
                mark(marks)
            try:
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    a = time.perf_counter()
                    self._call(e, init)
                    sync(self.device)
                    wall += time.perf_counter() - a
                    calls += 1
                    if marks is not None:
                        mark(marks)
            finally:
                if own:
                    profiling.disable()
                    program = profiling.collect()
                    # on the benchmark's clock, before the trace is reduced
                    self.spans.items.extend(
                        (s.name, s.tid, s.start_ns, s.end_ns)
                        for s in program.spans)
        if marks is not None and holder.get('trace') is not None:
            holder['trace'] = recentre(holder['trace'], self.spans.items,
                                       marks)
        counters = {'calls': calls, 'epochs_a_call': e, 'ratings': self.nnz,
                    'wall_s': wall}
        if program is not None:
            names = {}
            for s in program.spans:
                names[s.name] = names.get(s.name, 0) + 1
            print('bench: program spans %s; counters %s'
                  % (sorted(names.items()), sorted(program.counters.items())),
                  file=sys.stderr, flush=True)
        swept = float(self.nnz) * e * calls
        return {'metrics': {self.cfg['train']['rate_metric']: swept / wall},
                'attempted': calls, 'failed': 0, 'trace': holder.get('trace'),
                'counters': counters}

    def _reference(self, dtype=torch.float32, keep=None):
        """The reference's (P, Q, Y) after each check call and its rmse
        history.  The reference is deterministic up to the order of its
        float sums, so with ``restart`` it runs the longest call once and
        reads each call's state and losses from that run's prefix."""
        mod = self.reference()
        ref = mod.Reference.build(self.u, self.i, self.v, self.cfg,
                                  self.device, keep=keep)
        calls = self.mix['check_calls']
        if self.mix['restart']:
            ends = sorted(set(calls))
            steps = [b - a for a, b in zip([0] + ends[:-1], ends)]
            h, st = ref.run(self.P0, self.Q0, steps, dtype, self.Y0)
            at = dict(zip(ends, st))
            hist = [x for c in calls for x in h[:c]]
            states = [at[c] for c in calls]
        else:
            hist, states = ref.run(self.P0, self.Q0, calls, dtype, self.Y0)
        return ref, states, hist

    def _readings(self, ref, states, losses, ref_states, ref_losses):
        start = (self.P0.astype(np.float64), self.Q0.astype(np.float64),
                 self.Y0.astype(np.float64))
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(losses, ref_losses)) \
            if len(losses) == len(ref_losses) else float('inf')
        return {'loss_gap': loss_gap,
                'step1_gap': norm_gap(states[0], ref_states[0], start),
                'change_gap': norm_gap(states[-1], ref_states[-1], start)}


def mark(marks):
    '''Launch ``torch.cuda._sleep``'s kernel twice, the second time
    between two host clock readings: a moment both the host and the trace
    record (the launch starts a few microseconds after the first reading).
    The first launch warms the path the profiler instruments.'''
    torch.cuda._sleep(1)
    t0 = time.perf_counter_ns()
    torch.cuda._sleep(1)
    marks.append((t0, time.perf_counter_ns()))


def recentre(tr, items, marks):
    '''``tr`` with each span's ends and the window's moved by the error
    at their time: at each mark, its timed launch's start in the trace
    less its first host reading as the anchor placed it; between marks
    interpolated, beyond them the nearest.  ``items`` are the host spans
    ``tr.spans`` was made from, in order.  Where the trace holds another
    number of the marks' launches, the spans cannot be placed: ``tr``
    without its spans, with a note, so that a reader of the device time
    inside a span finds none and reads None, while the window and its
    device work stay for the readers of the whole window.'''
    spins = sorted(tr.launches[c][1] for name, _, _, c in tr.ops
                   if 'spin_kernel' in name and c in tr.launches)
    if not items or not marks or len(spins) != 2 * len(marks):
        note('%d marks, %d of their launches in the trace: spans dropped'
             % (len(marks), len(spins)))
        return DeviceTrace(tr.ops, tr.launches, [], tr.window)
    offset = tr.spans[0][2] - items[0][2] / 1e3
    at = [a / 1e3 + offset for a, _ in marks]
    err = [ts - t for ts, t in zip(spins[1::2], at)]

    def moved(x):
        return x + float(np.interp(x, at, err))

    note('spans moved onto %d launch marks: errors %s us, timed launches '
         '%s us' % (len(marks), ', '.join('%.1f' % x for x in err),
                    ', '.join('%.1f' % ((b - a) / 1e3) for a, b in marks)))
    return DeviceTrace(tr.ops, tr.launches,
                       [(n, t, moved(a), moved(b)) for n, t, a, b in
                        tr.spans], (moved(tr.window[0]),
                                    moved(tr.window[1])))


# ---------------------------------------------------------------- faults
# Planted under the public ``feature_training_implicit()`` by
# ``monkeypatch.setattr``; ``tests/test_checks.py`` holds each to coming
# out not correct.

def unchanged_state(monkeypatch):
    '''Epochs that return the state unchanged.'''
    from mfrec_tpu_torch.models import gd
    monkeypatch.setattr(gd.GDRecommender, '_run_alternating_implicit',
                        lambda self, *a, **k: None)


FAULTS = [unchanged_state, train_calls.half_batch]
